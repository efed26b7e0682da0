"""The port's MoE models (arctic-480b and kimi-k2-1t-a32b at their SMOKE
configs: head dim 32, 4 experts top-2, arctic's dense residual, kimi's
dense first layer and shared expert, untied heads) vs the JAX package's
reference backend on the same weights (JAX ``init_params`` through the
weight bridge), and against the port's own contracts, on the CPU.

Tolerances, with their reasons:
  * logits (fp32 head over bf16 activations): |diff| <= 0.05; both
    frameworks round every bf16 product and elementwise op, not at the
    same places, which moves logits of magnitude ~1-3 by ~1e-2 over two
    layers;
  * cache leaves (bf16 K/V): |diff| <= 2**-4 + 2**-6 |x|. Layer 0's
    leaves differ by a bf16 step at most; layer 1 projects a residual
    stream to which layer 0's MoE FFN added a sum of bf16 terms of
    magnitude up to ~4 (routed experts plus the dense residual), rounded
    at other places in the two frameworks (2**-6 to 2**-5 each), so a
    small leaf can carry about two such steps;
  * engine tokens at T=0: equal to the JAX engine's up to the first
    position whose JAX top-2 margin is at most 2 * LOGIT_TOL (a near-tie
    of random-init weights, after which the streams may rightly part);
  * routing near-ties: where a token's k-th and (k+1)-th router
    probabilities are within NEAR_TIE = 1e-3, the two frameworks' bf16
    roundings of the router input (~2**-8 relative, ~1e-4 in
    probability at the smoke width) may pick different experts. Such a
    token's later-layer K/V rows and its own logits are left out of the
    comparison (a flip changes them by O(1)); every other row is held to
    the tolerances above. Random init gives near-ties on ~10% of the
    routed tokens at the smoke width (4-8 of 74 in a prefill); each test
    asserts that at most MAX_TIE_SHARE = 20% of its tokens are left out,
    so a change that shrinks router margins fails instead of emptying
    the comparison.

Within the port the contracts are bitwise (``torch.equal`` / equal
tokens): paged decode == dense decode, verify rows == decode rows, paged
engine == dense engine, spec engine == non-spec engine. Chunked prefill
and prefix hits change which choices a capacity drops (capacity counts
per prefill group, in the JAX package too), so budgeted == monolithic
and hit == miss are asserted at capacity factor 100, where nothing
drops.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving.sampling import SamplerConfig as JSampler
from repro_torch.common import perf
from repro_torch.configs import ALL_IDS, get_config, get_smoke_config
from repro_torch.kernels import backend as KB
from repro_torch.kernels.ref import paged_gather_kv
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import InferenceEngine, _insert_slot, \
    _paged_scatter
from repro_torch.serving.sampling import SamplerConfig
from repro_torch.serving.specdec import SpecConfig

LOGIT_TOL = 0.05
LEAF_ATOL, LEAF_RTOL = 2.0 ** -4, 2.0 ** -6
NEAR_TIE = 1e-3
MAX_TIE_SHARE = 0.2
CACHE = 96
BS = 16
ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
PROMPTS = [list(range(5, 29)), list(range(40, 53))]    # 24 and 13 tokens
TOKS = np.array([[3, 7, 11, 13, 17], [4, 8, 12, 14, 18]])


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jax_smoke(request.param)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(request.param)
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")


def _jax_layers(jc, cfg):
    """The JAX cache's per-layer K/V leaves, in layer order."""
    out = []
    for si, (unit, R) in enumerate(cfg.segments):
        for r in range(R):
            for ui in range(len(unit)):
                out.append({n: np.asarray(jc["segments"][si][ui][n][r],
                                          np.float32) for n in ("k", "v")})
    return out


@contextlib.contextmanager
def _near_ties(offsets):
    """Record the port's router calls; yields a set that fills with the
    (batch row, absolute position) of every token whose route is a
    near-tie in some MoE layer. ``offsets``: the absolute position of
    each batch row's first token in the calls to come."""
    ties, orig = set(), KB.router_topk

    def record(logits, k):
        top = torch.sort(torch.softmax(logits.float(), -1), -1,
                         descending=True).values
        S = logits.shape[0] // len(offsets)
        for i in torch.nonzero(top[:, k - 1] - top[:, k] < NEAR_TIE
                               ).flatten().tolist():
            ties.add((i // S, offsets[i // S] + i % S))
        return orig(logits, k)
    KB.router_topk = record
    try:
        yield ties
    finally:
        KB.router_topk = orig


def _few_ties(ties, n_tokens):
    """The near-tie filter leaves most of the routed tokens compared."""
    assert len(ties) <= MAX_TIE_SHARE * n_tokens, \
        f"{len(ties)} of {n_tokens} routed tokens are near-ties"


def _logits_close(t, j, skip=()):
    """Logits rows (batch rows) not in ``skip``."""
    keep = [b for b in range(t.shape[0]) if b not in skip]
    np.testing.assert_allclose(t.float().numpy()[keep],
                               np.asarray(j, np.float32)[keep],
                               atol=LOGIT_TOL, rtol=0)


def _caches_close(tcache, jcache, cfg, rows, ties=()):
    """Every K/V leaf over the first ``rows`` rows; rows of near-tie
    tokens only in layer 0 (before any MoE output reaches a cache)."""
    for li, (t, j) in enumerate(zip(tcache["layers"],
                                    _jax_layers(jcache, cfg))):
        for n in ("k", "v"):
            a = t[n][:, :, :rows].float().numpy()
            b = j[n][:, :, :rows].copy()
            if li:
                for bi, s in ties:
                    a[bi, :, s] = b[bi, :, s] = 0.0
            np.testing.assert_allclose(a, b, atol=LEAF_ATOL,
                                       rtol=LEAF_RTOL, err_msg=f"{li}/{n}")


def _tied_rows(ties, pos):
    """Batch rows whose token at absolute position ``pos[b]`` is tied."""
    return {b for b, p in enumerate(pos) if (b, p) in ties}


def test_configs_are_the_jax_packages():
    from repro.configs import get_config as jax_config
    for arch in ARCHS:
        assert arch in ALL_IDS
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke(arch))


# -------------------------------------------------- model vs JAX model ----

def test_prefill_logits_and_cache(pair):
    jcfg, jp, model = pair
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 37))
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                        cache_len=CACHE)
    with _near_ties([0, 0]) as ties:
        tl, tc = TM.prefill(model, {"tokens": toks}, CACHE)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 512)
    _few_ties(ties, toks.size)
    _logits_close(tl, jl, _tied_rows(ties, [36, 36]))
    _caches_close(tc, jc, model.cfg, CACHE, ties)


def test_extend_logits_and_cache(pair):
    """A bucket-padded extend (11 valid tokens of 16): the pad rows go
    through the MoE FFN and take capacity on both sides."""
    jcfg, jp, model = pair
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (1, 30))
    ext = rng.integers(0, jcfg.vocab_size, (1, 16))
    ext[:, 11:] = 0
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                       cache_len=CACHE)
    with _near_ties([0]) as ties:
        _, tc = TM.prefill(model, {"tokens": toks}, CACHE)
    jl, jc = JM.prefill_extend(jp, jcfg, jc,
                               {"tokens": jnp.asarray(ext, jnp.int32)},
                               n_valid=11)
    with _near_ties([30]) as ext_ties:
        tl, tc = TM.prefill_extend(model, tc, {"tokens": ext}, n_valid=11)
    ties |= ext_ties
    _few_ties(ties, toks.size + ext.size)
    assert tc["pos"] == int(jc["pos"]) == 41
    _logits_close(tl, jl, _tied_rows(ties, [40]))
    _caches_close(tc, jc, model.cfg, 41, ties)


def test_decode_logits_and_cache(pair):
    jcfg, jp, model = pair
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 20))
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                       cache_len=CACHE)
    with _near_ties([0, 0]) as ties:
        _, tc = TM.prefill(model, {"tokens": toks}, CACHE)
    for i in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1))
        jl, jc = JM.decode_step(jp, jcfg, jc,
                                {"tokens": jnp.asarray(nxt, jnp.int32)})
        with _near_ties([20 + i, 20 + i]) as step_ties:
            tl, tc = TM.decode_step(model, tc, {"tokens": nxt})
        ties |= step_ties
        _logits_close(tl, jl, _tied_rows(ties, [20 + i] * 2))
    _few_ties(ties, toks.size + 3 * 2)
    _caches_close(tc, jc, model.cfg, 23, ties)


def test_verify_extend_matches_jax(pair):
    """W = 5 <= 8: the JAX package's one-group verify drops nothing, so
    its routing is the port's per-row routing."""
    jcfg, jp, model = pair
    cache = _cache(model, False, TOKS.shape[1])
    jc = JM.init_cache(jcfg, 2, CACHE)
    for b, p in enumerate(PROMPTS):
        _, c1 = JM.prefill(jp, jcfg, {"tokens": jnp.asarray([p])},
                           cache_len=CACHE)
        jc["segments"] = JE._insert_slot(jc["segments"], c1["segments"], b)
    jc["pos"] = jnp.asarray([len(p) for p in PROMPTS], jnp.int32)
    jl, _ = JM.verify_extend(jp, jcfg, jc,
                             {"tokens": jnp.asarray(TOKS, jnp.int32)})
    # the near-ties of the W rows, found on the decode steps that the
    # verify rows equal bitwise (test_verify_rows_are_decode_rows_bitwise)
    W, dcache, ties = TOKS.shape[1], _clone(cache), set()
    for w in range(W):
        with _near_ties([len(p) + w for p in PROMPTS]) as t:
            _, dcache = TM.decode_step(model, dcache,
                                       {"tokens": TOKS[:, w:w + 1]})
        ties |= t
    _few_ties(ties, TOKS.size)
    tl, _ = TM.verify_extend(model, cache, {"tokens": TOKS})
    for w in range(W):
        _logits_close(tl[:, w], jl[:, w],
                      _tied_rows(ties, [len(p) + w for p in PROMPTS]))


# ----------------------------------------------- within the port, bitwise ----

def _cache(model, paged: bool, W: int):
    """The two PROMPTS prefilled into a batched dense or paged cache."""
    cfg = model.cfg
    B = len(PROMPTS)
    nb = B * CACHE // BS
    cache = (TM.init_paged_cache(cfg, B, CACHE, nb, BS, "cpu") if paged
             else TM.init_cache(cfg, B, CACHE, "cpu"))
    for b, p in enumerate(PROMPTS):
        _, c1 = TM.prefill(model, {"tokens": [p]}, CACHE)
        if paged:
            blocks = [5 - b - 2 * i for i in
                      range(-(-(len(p) + W + 1) // BS))]       # shuffled
            blocks = [x % nb for x in blocks]
            _paged_scatter(cache, c1["layers"], blocks)
            cache["block_tab"][b, :len(blocks)] = torch.tensor(blocks)
        else:
            _insert_slot(cache, c1, b)
    cache["pos"] = torch.tensor([len(p) for p in PROMPTS],
                                dtype=torch.int32)
    return cache


def _clone(cache):
    out = {k: v.clone() for k, v in cache.items() if k != "layers"}
    out["layers"] = [{n: t.clone() for n, t in l.items()}
                     for l in cache["layers"]]
    return out


def test_paged_decode_is_dense_decode_bitwise(pair):
    _, _, model = pair
    dense, paged = _cache(model, False, 3), _cache(model, True, 3)
    for j in range(3):
        pos = dense["pos"].clone()
        dl, dense = TM.decode_step(model, dense, {"tokens": TOKS[:, j:j + 1]})
        paged["pos"] = pos
        pl, paged = TM.decode_step(model, paged, {"tokens": TOKS[:, j:j + 1]})
        assert torch.equal(dl, pl), j
    for dl_, pl_ in zip(dense["layers"], paged["layers"]):
        for n in ("k", "v"):
            g = paged_gather_kv(pl_[n], paged["block_tab"])
            for b, p in enumerate(PROMPTS):
                rows = len(p) + 3
                assert torch.equal(g[b, :, :rows], dl_[n][b, :, :rows])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_rows_are_decode_rows_bitwise(pair, paged):
    _, _, model = pair
    W = TOKS.shape[1]
    cache = _cache(model, paged, W)
    dcache, seq = _clone(cache), []
    for j in range(W):
        lg, dcache = TM.decode_step(model, dcache,
                                    {"tokens": TOKS[:, j:j + 1]})
        seq.append(lg)
    vlg, vcache = TM.verify_extend(model, cache, {"tokens": TOKS})
    assert torch.equal(torch.stack(seq, dim=1), vlg)
    for a, b in zip(dcache["layers"], vcache["layers"]):
        for n in ("k", "v"):
            assert torch.equal(a[n], b[n])


# ---------------------------------------------------------------- engine ----

def _serve(eng, prompts, max_new, prefix=None):
    if prefix is not None:
        eng.register_prefix("p", prefix)
    rids = [eng.add_request(p, max_new_tokens=max_new,
                            sampler=SamplerConfig(temperature=0.0),
                            prefix_key="p" if prefix is not None else None)
            for p in prompts]
    done = {r.request_id: r.output for r in eng.run_until_done()}
    return [done[r] for r in rids]


def test_engine_tokens_match_jax(pair):
    jcfg, jp, model = pair
    prompts = PROMPTS + [list(range(100, 131))]
    jeng = JE.InferenceEngine(jcfg, jp, max_batch=2, cache_len=CACHE,
                              seed=0, backend="reference")
    jrids = [jeng.add_request(p, max_new_tokens=6,
                              sampler=JSampler(temperature=0.0))
             for p in prompts]
    jdone = {r.request_id: r.output for r in jeng.run_until_done()}
    tout = _serve(InferenceEngine(model.cfg, model, max_batch=2,
                                  cache_len=CACHE), prompts, 6)
    equal = 0
    for ids, rid, tt in zip(prompts, jrids, tout):
        jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray([ids])},
                            cache_len=CACHE)
        for i, tok in enumerate(jdone[rid]):
            if tt[i] != tok:
                top2 = np.sort(np.asarray(jl[0], np.float32))[-2:]
                assert top2[1] - top2[0] <= 2 * LOGIT_TOL, (ids[0], i)
                break
            equal += 1
            jl, jc = JM.decode_step(jp, jcfg, jc,
                                    {"tokens": jnp.asarray([[tok]])})
    assert equal >= 6


@pytest.mark.parametrize("kw", [
    {"kv_mode": "paged", "block_size": BS},
    {"spec": 4},
    {"spec": 4, "kv_mode": "paged", "block_size": BS},
], ids=["paged", "spec", "paged_spec"])
def test_engine_modes_serve_the_dense_tokens(pair, kw):
    _, _, model = pair
    cfg = model.cfg
    kw = dict(kw)
    k = kw.pop("spec", None)
    if k:
        kw["spec_decode"] = SpecConfig(cfg, model, k=k)
    prefix = list(range(60, 80))
    prompts = [prefix + list(range(200 + 7 * i, 207 + 7 * i))
               for i in range(3)]
    dense = _serve(InferenceEngine(cfg, model, max_batch=2,
                                   cache_len=CACHE), prompts, 11, prefix)
    eng = InferenceEngine(cfg, model, max_batch=2, cache_len=CACHE, **kw)
    assert _serve(eng, prompts, 11, prefix) == dense
    st = eng.throughput_stats()
    if k:
        assert st["spec_rounds"] > 0 and st["spec_accept_rate"] == 1.0


@pytest.fixture
def no_drops(monkeypatch):
    """Capacity factor 100 (nothing drops) and a 32-token attention
    chunk, so short prompts cross chunk seams."""
    monkeypatch.setattr(perf, "FLAGS", perf.PerfFlags(
        attn_chunk=32, moe_capacity_factor=100.0))


def test_budget_and_prefix_equalities_without_drops(pair, no_drops):
    _, _, model = pair
    cfg = model.cfg
    rng = np.random.default_rng(5)
    prefix = [2] + rng.integers(6, cfg.vocab_size, 40).tolist()
    prompts = [prefix + rng.integers(6, cfg.vocab_size, n).tolist()
               for n in (3, 30, 9)]
    mono = _serve(InferenceEngine(cfg, model, max_batch=2,
                                  cache_len=CACHE), prompts, 5)
    budget = _serve(InferenceEngine(cfg, model, max_batch=2,
                                    cache_len=CACHE, prefill_budget=32),
                    prompts, 5)
    hit = _serve(InferenceEngine(cfg, model, max_batch=2, cache_len=CACHE),
                 prompts, 5, prefix)
    assert budget == mono
    assert hit == mono


def test_engine_runs_no_kernel_on_cpu(pair):
    _, _, model = pair
    KB.reset_launches()
    _serve(InferenceEngine(model.cfg, model, max_batch=2, cache_len=CACHE),
           PROMPTS[:1], 2)
    assert set(KB.launch_counts().values()) == {0}
    assert "moe_router_topk" in KB.launch_counts()


# ------------------------------------------------- launcher and bridge ----

@pytest.mark.parametrize("extra", [[], ["--kv-mode", "paged",
                                        "--spec-decode"]])
def test_serve_cli_runs_the_moe_smoke_configs(extra, capsys):
    for arch in ARCHS:
        res = serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "3", "--max-new", "6",
                          "--temperature", "0"] + extra)
        assert res["requests"] == 3
        assert all(len(o) == 6 for o in res["outputs"].values())
    assert "served 3 requests" in capsys.readouterr().out


def test_bridge_maps_moe_leaves_and_head(pair):
    jcfg, jp, model = pair
    tree = jax.tree.map(np.asarray, jp)
    np.testing.assert_array_equal(model.lm_head.float().numpy(),
                                  np.asarray(tree["lm_head"], np.float32))
    li = model.cfg.layer_kinds().index("moe")
    si = 0 if li == 0 else 1
    np.testing.assert_array_equal(
        model.layers[li].moe.w_gate.float().numpy(),
        np.asarray(tree["segments"][si][0]["moe"]["w_gate"][0], np.float32))
    lacking = dict(tree)
    del lacking["lm_head"]
    with pytest.raises(KeyError, match="lacks"):
        params_from_numpy(lacking, model.cfg, "cpu")
    extra = dict(tree)
    extra["segments"] = [list(seg) for seg in tree["segments"]]
    unit = dict(extra["segments"][si][0])
    unit["moe"] = dict(unit["moe"], bias=unit["moe"]["router"])
    extra["segments"][si][0] = unit
    with pytest.raises(KeyError, match="no model tensor"):
        params_from_numpy(extra, model.cfg, "cpu")
