"""The port's hymba (hybrid attention + SSM, sliding-window rings) vs the
JAX package's reference backend on the same weights (JAX
``init_params`` of hymba-smoke through the weight bridge), and against
the port's own contracts, on the CPU.

hymba-smoke: 2 layers (``hymba_g`` with a full cache, ``hymba_w`` with a
32-row ring), d 128, 4/2 heads of 32, SSM d_inner 128, n 8, K 4.

Tolerances, with their reasons:
  * logits (fp32 head over bf16 activations): |diff| <= LOGIT_TOL =
    0.05; both frameworks round the bf16 products, the conv and the
    activations at other places, and the JAX reference scans the SSM
    state in chunks (another fp32 order), which moves logits of
    magnitude ~1 by ~1e-2 over two layers;
  * bf16 cache leaves (K/V rows, conv state): |diff| <= 2**-4 + 2**-6
    |x|: layer 0's leaves are equal or a bf16 step apart, layer 1's
    project a residual stream that carries layer 0's rounding;
  * the fp32 SSM state h: |diff| <= H_TOL = 1e-2 (values O(0.1-1), its
    inputs carry bf16 steps of ~4e-3 relative);
  * engine tokens at T=0: equal to the JAX engine's up to the first
    position where the two streams differ, if any, where the two chosen
    tokens' logits must lie within 2 * LOGIT_TOL of each other (a
    near-tie of random-init weights, after which the streams may
    rightly part);
  * prefix hit vs miss: different computations (decode through the
    prefix tail and the suffix against one windowed prefill, in JAX
    too), so their tokens are not asserted equal; their admission
    logits agree within HIT_MISS_TOL = 0.05 (rounding of the two paths;
    a ring row or conv state out of place moves them by O(1)).

Within the port, bitwise: a second engine serves the same tokens, and a
request served from a recycled slot serves the tokens a fresh engine
serves it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving.sampling import SamplerConfig as JSampler
from repro_torch.configs import ALL_IDS, get_config, get_smoke_config
from repro_torch.kernels import backend as KB
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import model as TM
from repro_torch.models.blocks import _ring_from_prefill, block_apply
from repro_torch.models.convert import _walk, params_from_numpy
from repro_torch.serving.engine import InferenceEngine, _insert_slot
from repro_torch.serving.sampling import SamplerConfig
from repro_torch.serving.specdec import SpecConfig

ARCH = "hymba-1.5b"
LOGIT_TOL = 0.05
LEAF_ATOL, LEAF_RTOL = 2.0 ** -4, 2.0 ** -6
H_TOL = 1e-2
HIT_MISS_TOL = 0.05
CACHE = 128


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")


def _jax_layers(jc, cfg):
    """The JAX cache's per-layer leaves ({k, v, ssm: {h, conv}}, fp32
    numpy), in layer order."""
    out = []
    for si, (unit, R) in enumerate(cfg.segments):
        for r in range(R):
            for ui in range(len(unit)):
                c = jc["segments"][si][ui]
                f = lambda a: np.asarray(a[r], np.float32)
                out.append({"k": f(c["k"]), "v": f(c["v"]),
                            "ssm": {n: f(c["ssm"][n]) for n in ("h",
                                                                "conv")}})
    return out


def _caches_close(tcache, jcache, cfg):
    for li, (t, j) in enumerate(zip(tcache["layers"],
                                    _jax_layers(jcache, cfg))):
        for n in ("k", "v"):
            np.testing.assert_allclose(t[n].float().numpy(), j[n],
                                       atol=LEAF_ATOL, rtol=LEAF_RTOL,
                                       err_msg=f"{li}/{n}")
        np.testing.assert_allclose(t["ssm"]["h"].numpy(), j["ssm"]["h"],
                                   atol=H_TOL, rtol=0, err_msg=f"{li}/h")
        np.testing.assert_allclose(t["ssm"]["conv"].float().numpy(),
                                   j["ssm"]["conv"], atol=LEAF_ATOL,
                                   rtol=LEAF_RTOL, err_msg=f"{li}/conv")


def _logits_close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=LOGIT_TOL, rtol=0)


def test_configs_are_the_jax_packages():
    assert ARCH in ALL_IDS
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_smoke(ARCH))


def test_ring_packing_puts_position_p_at_row_p_mod_sc():
    k = torch.arange(40.0)[None, None, :, None]              # (1,1,40,1)
    ring = _ring_from_prefill(k, 32)[0, 0, :, 0]
    assert [int(ring[p % 32]) for p in range(8, 40)] == list(range(8, 40))
    short = _ring_from_prefill(k[:, :, :20], 32)[0, 0, :, 0]
    assert short[:20].tolist() == list(range(20)) and \
        not short[20:].any()


# -------------------------------------------------- model vs JAX model ----

def test_prefill_logits_and_every_cache_leaf(pair):
    """A 40-token prompt: the hymba_w ring holds its last 32 K/V rows in
    ring order, and the SSM state h and conv of both layers."""
    jcfg, jp, model = pair
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 40))
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                        cache_len=CACHE)
    tl, tc = TM.prefill(model, {"tokens": toks}, CACHE)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 512)
    assert tc["pos"] == 40
    shapes = [(tuple(c["k"].shape), tuple(c["ssm"]["h"].shape),
               tuple(c["ssm"]["conv"].shape)) for c in tc["layers"]]
    assert shapes == [((2, 2, CACHE, 32), (2, 128, 8), (2, 3, 128)),
                      ((2, 2, 32, 32), (2, 128, 8), (2, 3, 128))]
    _logits_close(tl, jl)
    _caches_close(tc, jc, model.cfg)


def test_decode_with_per_slot_positions_across_the_ring_wrap(pair):
    """Slots at 28 and 13 tokens decode 8 steps: slot 0's ring (32 rows)
    wraps at position 32, slot 1's does not."""
    jcfg, jp, model = pair
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, 28).tolist(),
               rng.integers(0, 512, 13).tolist()]
    jc = JM.init_cache(jcfg, 2, CACHE)
    tc = TM.init_cache(model.cfg, 2, CACHE, "cpu")
    for b, p in enumerate(prompts):
        _, j1 = JM.prefill(jp, jcfg, {"tokens": jnp.asarray([p])},
                           cache_len=CACHE)
        jc["segments"] = JE._insert_slot(jc["segments"], j1["segments"], b)
        _, t1 = TM.prefill(model, {"tokens": [p]}, CACHE)
        _insert_slot(tc, t1, b)
    jc["pos"] = jnp.asarray([28, 13], jnp.int32)
    tc["pos"] = torch.tensor([28, 13], dtype=torch.int32)
    for _ in range(8):
        nxt = rng.integers(0, 512, (2, 1))
        jl, jc = JM.decode_step(jp, jcfg, jc,
                                {"tokens": jnp.asarray(nxt, jnp.int32)})
        tl, tc = TM.decode_step(model, tc, {"tokens": nxt})
        _logits_close(tl, jl)
    assert tc["pos"].tolist() == [36, 21]
    _caches_close(tc, jc, model.cfg)


def test_extend_and_verify_raise_on_window_kinds(pair):
    _, _, model = pair
    cfg = model.cfg
    _, cache = TM.prefill(model, {"tokens": [[5, 6, 7]]}, CACHE)
    with pytest.raises(NotImplementedError, match="sliding-window ring"):
        TM.prefill_extend(model, cache, {"tokens": [[8, 9]]})
    x = torch.zeros(1, 2, cfg.d_model, dtype=torch.bfloat16)
    wl = cfg.layer_kinds().index("hymba_w")
    with pytest.raises(NotImplementedError,
                       match="verify over sliding-window ring"):
        block_apply(model.layers[wl], x, cfg, mode="verify",
                    cache=cache["layers"][wl], pos=torch.tensor([3]),
                    positions=torch.tensor([[3, 4]]))
    with pytest.raises(NotImplementedError, match="paged KV cache over"):
        TM.init_paged_cache(cfg, 2, CACHE, 16, 16, "cpu")


# ---------------------------------------------------------------- engine ----

def _workload(cfg):
    """A 40-token prefix (longer than the 32-row ring), 3 prefix hits and
    3 misses, 30-40 new tokens each."""
    rng = np.random.default_rng(5)
    prefix = [2] + rng.integers(6, cfg.vocab_size, 39).tolist()
    hits = [prefix + rng.integers(6, cfg.vocab_size, n).tolist()
            for n in (3, 9, 14)]
    misses = [rng.integers(6, cfg.vocab_size, n).tolist()
              for n in (20, 45, 33)]
    reqs = [(p, 30 + 2 * i, i % 2 == 0) for i, p in
            enumerate([hits[0], misses[0], hits[1], misses[1], hits[2],
                       misses[2]])]
    return prefix, reqs


def _serve(eng, prompts, max_new, prefix=None, hit=None):
    if prefix is not None:
        eng.register_prefix("p", prefix)
    hit = hit or [prefix is not None] * len(prompts)
    rids = [eng.add_request(p, max_new_tokens=m,
                            sampler=SamplerConfig(temperature=0.0),
                            prefix_key="p" if h else None)
            for p, m, h in zip(prompts, max_new, hit)]
    done = {r.request_id: r.output for r in eng.run_until_done()}
    return [done[r] for r in rids]


def test_engine_tokens_and_stats_match_jax(pair):
    jcfg, jp, model = pair
    cfg = model.cfg
    prefix, reqs = _workload(cfg)
    jeng = JE.InferenceEngine(jcfg, jp, max_batch=3, cache_len=CACHE,
                              seed=0, backend="reference")
    jeng.register_prefix("p", prefix)
    jrids = [jeng.add_request(p, max_new_tokens=m,
                              sampler=JSampler(temperature=0.0),
                              prefix_key="p" if h else None)
             for p, m, h in reqs]
    jdone = {r.request_id: r.output for r in jeng.run_until_done()}
    teng = InferenceEngine(cfg, model, max_batch=3, cache_len=CACHE)
    tout = _serve(teng, [p for p, _, _ in reqs], [m for _, m, _ in reqs],
                  prefix, [h for _, _, h in reqs])
    equal = 0
    for (p, _, _), rid, tt in zip(reqs, jrids, tout):
        jt = jdone[rid]
        n = next((i for i, (a, b) in enumerate(zip(jt, tt)) if a != b),
                 None)
        if n is None:
            assert len(jt) == len(tt)
            equal += len(jt)
            continue
        lg, c = TM.prefill(model, {"tokens": [p]}, CACHE)
        for t in tt[:n]:
            lg, c = TM.decode_step(model, c, {"tokens": [[t]]})
        gap = abs(float(lg[0, jt[n]]) - float(lg[0, tt[n]]))
        assert gap <= 2 * LOGIT_TOL, (p[:3], n, gap)
        equal += n
    # random-init hymba-smoke's top logits often lie within ~0.005 of
    # each other, so streams part early at near-ties (118 of 204 tokens
    # agree before they do); the floor keeps the comparison from emptying
    assert equal >= 100
    jst, tst = jeng.throughput_stats(), teng.throughput_stats()
    assert tst["prefix_hits"] == 3 and tst["prefills"] == 4
    assert tst["kv_bytes_allocated"] == 122_880
    assert {k: tst[k] for k in jst} == {k: (v if isinstance(v, str)
                                            else float(v))
                                        for k, v in jst.items()}


def test_second_engine_and_recycled_slots_serve_the_same_tokens(pair):
    """6 requests over 3 slots: the last three run in slots that served
    other requests (and whose SSM state and rings they overwrite); a
    fresh engine serving those three alone gives the same tokens."""
    _, _, model = pair
    cfg = model.cfg
    rng = np.random.default_rng(6)
    prompts = [rng.integers(6, cfg.vocab_size, n).tolist()
               for n in (12, 40, 7, 25, 36, 18)]
    max_new = [20, 8, 14, 30, 11, 26]
    make = lambda: InferenceEngine(cfg, model, max_batch=3, cache_len=CACHE)
    first = _serve(make(), prompts, max_new)
    assert _serve(make(), prompts, max_new) == first
    assert _serve(make(), prompts[3:], max_new[3:]) == first[3:]


def test_prefix_hit_admission_logits_close_to_a_miss(pair):
    """A 40-token prefix (prefilled, its ring wrapped) extended token by
    token through suffixes against monolithic prefills of the prompts."""
    _, _, model = pair
    cfg = model.cfg
    prefix, reqs = _workload(cfg)
    eng = InferenceEngine(cfg, model, max_batch=3, cache_len=CACHE)
    eng.register_prefix("p", prefix)
    pref = eng.prefixes["p"]
    for p, _, hit in reqs:
        if not hit:
            continue
        h_logits, h_cache = eng._extend_prefix(pref, p[len(prefix):])
        m_logits, m_cache = TM.prefill(model, {"tokens": [p]}, CACHE)
        assert h_cache["pos"] == m_cache["pos"] == len(p)
        diff = float((h_logits - m_logits).abs().max())
        assert diff <= HIT_MISS_TOL, diff
    # the registered prefix is untouched by the hits
    _, again = TM.prefill(model, {"tokens": [prefix]}, CACHE)
    for a, b in zip(pref.cache["layers"], again["layers"]):
        assert torch.equal(a["k"], b["k"])
        assert torch.equal(a["ssm"]["h"], b["ssm"]["h"])


@pytest.mark.parametrize("kw,match", [
    (dict(kv_mode="paged"), "kv_mode='paged' needs a pure-attention"),
    (dict(prefill_budget=64), "prefill_budget .chunked prefill. needs"),
    ("spec", "spec_decode target model needs a pure-attention"),
], ids=["paged", "budget", "spec"])
def test_engine_refuses_paged_budget_and_spec(pair, kw, match):
    _, _, model = pair
    if kw == "spec":
        kw = dict(spec_decode=SpecConfig(model.cfg, model, k=2))
    with pytest.raises(ValueError, match=match):
        InferenceEngine(model.cfg, model, max_batch=2, cache_len=CACHE, **kw)


def test_engine_runs_no_kernel_on_cpu(pair):
    _, _, model = pair
    KB.reset_launches()
    _serve(InferenceEngine(model.cfg, model, max_batch=2, cache_len=CACHE),
           [[5, 6, 7, 8]], [3])
    counts = KB.launch_counts()
    assert len(counts) == 9 and set(counts.values()) == {0}
    assert "ssm_scan" in counts


# ------------------------------------------------- launcher and bridge ----

def test_serve_cli_runs_hymba_smoke(capsys):
    res = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-new", "6",
                      "--temperature", "0"])
    assert res["requests"] == 3
    assert all(len(o) == 6 for o in res["outputs"].values())
    assert "served 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [["--kv-mode", "paged"],
                                   ["--prefill-budget", "64"],
                                   ["--spec-decode"]])
def test_serve_cli_refuses_what_the_engine_refuses(extra):
    with pytest.raises(ValueError, match="pure-attention|prefill_extend"):
        serve_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "1", "--max-new", "2"] + extra)


def test_bridge_copies_every_leaf_exactly(pair):
    """Every JAX leaf lands bit for bit in its model tensor, in the
    leaf's own dtype: the SSM's fp32 dt_bias, A_log and D stay fp32."""
    jcfg, jp, model = pair
    tensors = dict(model.named_parameters())
    tree = jax.tree.map(np.asarray, jp)
    seen = set()
    offset = 0
    for si, (unit, R) in enumerate(jcfg.segments):
        for ui in range(len(unit)):
            for key, leaf in _walk(tree["segments"][si][ui], ""):
                for r in range(R):
                    name = (f"layers.{offset + r * len(unit) + ui}."
                            + key.replace("/", "."))
                    t = tensors[name]
                    want = np.asarray(leaf[r])
                    assert str(t.dtype).split(".")[-1] == want.dtype.name, \
                        name
                    np.testing.assert_array_equal(
                        t.float().numpy(), want.astype(np.float32), name)
                    seen.add(name)
        offset += len(unit) * R
    for key in ("embed", "final_norm/scale"):
        name = key.replace("/", ".")
        np.testing.assert_array_equal(
            tensors[name].float().numpy(),
            np.asarray(tree[key.split("/")[0]] if key == "embed" else
                       tree["final_norm"]["scale"], np.float32))
        seen.add(name)
    assert seen == set(tensors)
    assert {n.split(".", 2)[2] for n in seen if n.startswith("layers.")} \
        >= {"ssm.dt_bias", "ssm.A_log", "ssm.D", "norm_a.scale",
            "norm_s.scale", "ssm.conv_w", "ssm.w_bc"}
