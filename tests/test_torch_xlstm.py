"""The port's xlstm (mLSTM + sLSTM, attention-free) vs the JAX package's
reference backend on the same weights (JAX ``init_params`` of xlstm-smoke
through the weight bridge), and against the port's own contracts, on the
CPU.

xlstm-smoke: 2 layers (``mlstm``: 4 heads of 32; ``slstm``: 4 heads of
32, FFN 170), d 128, vocab 512, sinusoidal positions (no rope).

Tolerances, with their reasons:
  * logits (fp32 head over bf16 activations): |diff| <= LOGIT_TOL =
    0.05; the JAX reference runs the mLSTM chunkwise (its numerator in
    another order), its sLSTM recurrent product rounds in bf16 at other
    places, and both frameworks round the bf16 products differently;
    read ~0.005 on logits of magnitude ~0.7;
  * mLSTM state: C and n within 2e-2 + 2e-2 |x| (their inputs k and v
    are bf16 products of a residual stream that carries the sinusoidal
    embedding and the earlier layer's rounding, ~4e-3 relative a step;
    read: 1.7e-4 at |C| up to ~13), m within 1e-3 (an fp32 gate product
    of that stream; read 6e-8);
  * sLSTM state: h within 2**-5 + 2**-6 |h|; m, its log-domain
    stabiliser, within M_TOL = 0.05 (bf16 steps of the recurrent
    preactivations, ~1e-2 at |pre| ~ 3, carried into m); c and n within
    (e^M_TOL - 1) + 1e-2 relative plus 5e-2, since both scale with
    exp(-m) while h = o c / n does not (``test_torch_mlstm.py``); read:
    m 0.018, c 0.12 of 12.6, n 0.24 of 20, h 0.002;
  * engine tokens at T=0: equal to the JAX engine's up to the first
    position where the two streams differ, if any, where the two chosen
    tokens' logits must lie within 2 * LOGIT_TOL of each other (a
    near-tie of random-init weights, after which the streams may
    rightly part).

The JAX side runs jitted, as its engine runs it (one compile per shape
instead of one per op), and the port's CPU ops run on one thread: the
recurrences are loops of small ops, which a thread pool only slows.

Within the port, bitwise: an extend is a prefill (the sequential
recurrence and fixed-size row products and norms give a row the same
bits at any chunking), so budgeted prefill ≡ monolithic (the repair of the padded
chunked-prefill tail), a prefix hit ≡ a miss, a second engine serves
the same tokens, and a recycled slot serves what a fresh engine does.
"""
import dataclasses
import math

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
from repro_torch.common import perf
from repro_torch.configs import ALL_IDS, get_config, get_smoke_config
from repro_torch.kernels import backend as KB
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import model as TM
from repro_torch.models.blocks import block_apply
from repro_torch.models.convert import _walk, params_from_numpy
from repro_torch.serving.engine import InferenceEngine, _insert_slot
from repro_torch.serving.sampling import SamplerConfig
from repro_torch.serving.specdec import SpecConfig

ARCH = "xlstm-125m"
LOGIT_TOL = 0.05
C_TOL = 2e-2
M_TOL = 0.05
SL_RTOL = math.exp(M_TOL) - 1 + 1e-2
H_ATOL, H_RTOL = 2.0 ** -5, 2.0 ** -6
CACHE = 128

j_prefill = jax.jit(JM.prefill, static_argnums=1,
                    static_argnames=("cache_len", "backend"))
j_extend = jax.jit(JM.prefill_extend, static_argnums=1,
                   static_argnames=("backend",))
j_decode = jax.jit(JM.decode_step, static_argnums=1,
                   static_argnames=("backend",))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")


@pytest.fixture
def small_chunk(monkeypatch):
    """A 16-token attention chunk, so short prompts cross chunk seams and
    leave tails that are not powers of two."""
    monkeypatch.setattr(perf, "FLAGS", perf.PerfFlags(attn_chunk=16))


def _jax_layers(jc, cfg):
    """The JAX cache's per-layer state ({"mlstm": (C, n, m)} or {"slstm":
    {c, n, h, m}}, fp32 numpy), in layer order."""
    out = []
    for si, (unit, R) in enumerate(cfg.segments):
        for r in range(R):
            for ui, kind in enumerate(unit):
                c = jc["segments"][si][ui][kind]
                f = lambda a: np.asarray(a[r], np.float32)
                out.append({kind: tuple(map(f, c)) if kind == "mlstm"
                            else {k: f(v) for k, v in c.items()}})
    return out


def _states_close(tcache, jcache, cfg):
    for li, (t, j) in enumerate(zip(tcache["layers"],
                                    _jax_layers(jcache, cfg))):
        assert set(t) == set(j), li
        if "mlstm" in t:
            for name, a, b in zip("Cnm", t["mlstm"], j["mlstm"]):
                tol = 1e-3 if name == "m" else C_TOL
                np.testing.assert_allclose(a.numpy(), b, atol=tol,
                                           rtol=0 if name == "m" else tol,
                                           err_msg=f"{li}/{name}")
            continue
        t, j = t["slstm"], j["slstm"]
        np.testing.assert_allclose(t["m"].numpy(), j["m"], atol=M_TOL,
                                   rtol=0, err_msg=f"{li}/m")
        for key in ("c", "n"):
            np.testing.assert_allclose(t[key].numpy(), j[key], atol=5e-2,
                                       rtol=SL_RTOL, err_msg=f"{li}/{key}")
        np.testing.assert_allclose(t["h"].numpy(), j["h"], atol=H_ATOL,
                                   rtol=H_RTOL, err_msg=f"{li}/h")


def _logits_close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=LOGIT_TOL, rtol=0)


def test_configs_are_the_jax_packages():
    assert ARCH in ALL_IDS
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_smoke(ARCH))


def test_full_width_model_has_the_jax_parameter_count():
    """xlstm-125m at full width and depth: 12 layers (three units of
    mlstm, mlstm, mlstm, slstm), mLSTM heads of 192, sLSTM FFN 1,024,
    the same parameter count as the JAX package's analytic one."""
    cfg = get_config(ARCH)
    model = TM.init_params(cfg, seed=0, device="cpu")
    assert [b.kind for b in model.layers] == \
        ["mlstm", "mlstm", "mlstm", "slstm"] * 3
    assert tuple(model.layers[0].mlstm.wq.shape) == (768, 768)
    assert tuple(model.layers[3].slstm.w_up.shape) == (768, 2048)
    assert tuple(model.layers[3].slstm.r_gates.shape) == (4, 192, 768)
    assert TM.count_params(model) == jax_config(ARCH).param_count()
    assert 80e6 < TM.count_params(model) < 90e6


# -------------------------------------------------- model vs JAX model ----

def test_prefill_logits_and_every_state_leaf(pair):
    jcfg, jp, model = pair
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 40))
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                       cache_len=CACHE, backend="reference")
    tl, tc = TM.prefill(model, {"tokens": toks}, CACHE)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 512)
    assert tc["pos"] == 40
    C, n, m = tc["layers"][0]["mlstm"]
    assert (tuple(C.shape), tuple(n.shape), tuple(m.shape)) == \
        ((2, 4, 32, 32), (2, 4, 32), (2, 4))
    assert "k" not in tc["layers"][0] and "k" not in tc["layers"][1]
    _logits_close(tl, jl)
    _states_close(tc, jc, model.cfg)


def test_extend_unpadded_matches_jax_and_is_the_prefill_bitwise(pair):
    """A 24-token prefill extended by 13 and then 7 tokens (no padding):
    logits and states against JAX's ``prefill_extend``, and bitwise the
    port's own 44-token prefill."""
    jcfg, jp, model = pair
    toks = np.random.default_rng(3).integers(0, 512, (1, 44))
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :24])},
                       cache_len=CACHE, backend="reference")
    tl, tc = TM.prefill(model, {"tokens": toks[:, :24]}, CACHE)
    for lo, hi in ((24, 37), (37, 44)):
        chunk = toks[:, lo:hi]
        jl, jc = j_extend(jp, jcfg, jc, {"tokens": jnp.asarray(chunk)},
                          backend="reference")
        tl, tc = TM.prefill_extend(model, tc, {"tokens": chunk})
        _logits_close(tl, jl)
        assert tc["pos"] == hi
    _states_close(tc, jc, model.cfg)
    whole, wc = TM.prefill(model, {"tokens": toks}, CACHE)
    assert torch.equal(whole, tl)
    for a, b in zip(wc["layers"], tc["layers"]):
        leaves = (zip(a["mlstm"], b["mlstm"]) if "mlstm" in a else
                  ((a["slstm"][k], b["slstm"][k]) for k in a["slstm"]))
        assert all(torch.equal(x, y) for x, y in leaves)


def test_decode_with_per_slot_positions(pair):
    """Slots at 28 and 13 tokens decode 8 steps from per-slot positions
    (the sinusoidal embedding at each slot's own position)."""
    jcfg, jp, model = pair
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, 28).tolist(),
               rng.integers(0, 512, 13).tolist()]
    jc = JM.init_cache(jcfg, 2, CACHE)
    tc = TM.init_cache(model.cfg, 2, CACHE, "cpu")
    for b, p in enumerate(prompts):
        _, j1 = j_prefill(jp, jcfg, {"tokens": jnp.asarray([p])},
                          cache_len=CACHE, backend="reference")
        jc["segments"] = JE._insert_slot(jc["segments"], j1["segments"], b)
        _, t1 = TM.prefill(model, {"tokens": [p]}, CACHE)
        _insert_slot(tc, t1, b)
    jc["pos"] = jnp.asarray([28, 13], jnp.int32)
    tc["pos"] = torch.tensor([28, 13], dtype=torch.int32)
    for _ in range(8):
        nxt = rng.integers(0, 512, (2, 1))
        jl, jc = j_decode(jp, jcfg, jc,
                          {"tokens": jnp.asarray(nxt, jnp.int32)},
                          backend="reference")
        tl, tc = TM.decode_step(model, tc, {"tokens": nxt})
        _logits_close(tl, jl)
    assert tc["pos"].tolist() == [36, 21]
    _states_close(tc, jc, model.cfg)


def test_verify_and_paged_raise_on_xlstm_kinds(pair):
    _, _, model = pair
    cfg = model.cfg
    _, cache = TM.prefill(model, {"tokens": [[5, 6, 7]]}, CACHE)
    x = torch.zeros(1, 2, cfg.d_model, dtype=torch.bfloat16)
    for li in range(2):
        with pytest.raises(NotImplementedError,
                           match="verify over recurrent xLSTM state"):
            block_apply(model.layers[li], x, cfg, mode="verify",
                        cache=cache["layers"][li], pos=torch.tensor([3]),
                        positions=torch.tensor([[3, 4]]))
    with pytest.raises(NotImplementedError, match="paged KV cache over"):
        TM.init_paged_cache(cfg, 2, CACHE, 16, 16, "cpu")


# ---------------------------------------------------------------- engine ----

def _workload(cfg):
    """A 40-token prefix, 3 prefix hits and 3 misses, 12-22 new tokens."""
    rng = np.random.default_rng(5)
    prefix = [2] + rng.integers(6, cfg.vocab_size, 39).tolist()
    hits = [prefix + rng.integers(6, cfg.vocab_size, n).tolist()
            for n in (3, 9, 14)]
    misses = [rng.integers(6, cfg.vocab_size, n).tolist()
              for n in (20, 45, 33)]
    reqs = [(p, 12 + 2 * i, i % 2 == 0) for i, p in
            enumerate([hits[0], misses[0], hits[1], misses[1], hits[2],
                       misses[2]])]
    return prefix, reqs


def _recording_engine(cfg, model, rec: dict, **kw):
    """An engine that records each request's admission logits."""
    eng = InferenceEngine(cfg, model, max_batch=3, cache_len=CACHE, **kw)
    first = eng._first_token

    def record(req, logits):
        rec[req.request_id] = logits.clone()
        return first(req, logits)
    eng._first_token = record
    return eng


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
    # the floor keeps the comparison from emptying at early near-ties
    assert equal >= 60
    jst, tst = jeng.throughput_stats(), teng.throughput_stats()
    assert tst["prefix_hits"] == 3 and tst["prefills"] == 4
    assert tst["kv_bytes_allocated"] == 0
    assert {k: tst[k] for k in jst} == {k: (v if isinstance(v, str)
                                            else float(v))
                                        for k, v in jst.items()}


def test_budgeted_prefill_is_monolithic_bitwise(pair, small_chunk):
    """Chunked prefill under ``prefill_budget`` against monolithic
    prefill, with 16-token chunks: prompts of 21-45 tokens leave tails
    of 5-13 tokens, none a power of two and each shorter than the room
    left, so a bucket-padded tail would step every mLSTM and sLSTM state
    through pad tokens. Admission logits and tokens bitwise equal."""
    _, _, model = pair
    cfg = model.cfg
    rng = np.random.default_rng(9)
    prompts = [rng.integers(6, cfg.vocab_size, n).tolist()
               for n in (21, 45, 27, 39, 30)]
    assert all(n % 16 & (n % 16 - 1) for n in map(len, prompts))
    runs = {}
    for name, kw in (("mono", {}), ("budget", dict(prefill_budget=16))):
        rec: dict = {}
        eng = _recording_engine(cfg, model, rec, **kw)
        out = _serve(eng, prompts, [12] * len(prompts))
        runs[name] = (out, [rec[i] for i in range(len(prompts))],
                      eng.throughput_stats())
    assert runs["budget"][2]["prefill_chunks"] > len(prompts)
    assert runs["budget"][0] == runs["mono"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["budget"][1],
                                                 runs["mono"][1]))


def test_prefix_hit_is_a_miss_bitwise(pair, small_chunk):
    """A 40-token prefix (a 32-token prefilled head and an 8-token
    extended tail) and hits that extend its copy by 3-14 tokens, against
    misses that prefill each prompt: admission logits and tokens bitwise
    equal; the registered prefix is untouched by the hits."""
    _, _, model = pair
    cfg = model.cfg
    prefix, reqs = _workload(cfg)
    hits = [p for p, _, h in reqs if h]
    runs = {}
    for name in ("hit", "miss"):
        rec: dict = {}
        eng = _recording_engine(cfg, model, rec)
        out = _serve(eng, hits, [10] * 3,
                     prefix if name == "hit" else None)
        runs[name] = (out, [rec[i] for i in range(3)])
        if name == "hit":
            assert eng.throughput_stats()["prefix_hits"] == 3
            pref = eng.prefixes["p"]
    assert runs["hit"][0] == runs["miss"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["hit"][1],
                                                 runs["miss"][1]))
    lg, again = TM.prefill(model, {"tokens": [prefix]}, CACHE)
    assert torch.equal(pref.logits, lg)
    for a, b in zip(pref.cache["layers"], again["layers"]):
        leaves = (zip(a["mlstm"], b["mlstm"]) if "mlstm" in a else
                  ((a["slstm"][k], b["slstm"][k]) for k in a["slstm"]))
        assert all(torch.equal(x, y) for x, y in leaves)


def test_second_engine_and_recycled_slots_serve_the_same_tokens(pair):
    """6 requests over 3 slots: the last three run in slots that served
    other requests (whose mLSTM C, n, m and sLSTM c, n, h, m they
    overwrite); a fresh engine serving those three alone gives the same
    tokens."""
    _, _, model = pair
    cfg = model.cfg
    rng = np.random.default_rng(6)
    prompts = [rng.integers(6, cfg.vocab_size, n).tolist()
               for n in (12, 40, 7, 25, 36, 18)]
    max_new = [12, 6, 9, 16, 7, 14]
    make = lambda: InferenceEngine(cfg, model, max_batch=3, cache_len=CACHE)
    first = _serve(make(), prompts, max_new)
    assert _serve(make(), prompts, max_new) == first
    assert _serve(make(), prompts[3:], max_new[3:]) == first[3:]


@pytest.mark.parametrize("kw,match", [
    (dict(kv_mode="paged"), "kv_mode='paged' needs a pure-attention"),
    ("spec", "spec_decode target model needs a pure-attention"),
], ids=["paged", "spec"])
def test_engine_refuses_paged_and_spec(pair, kw, match):
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
    assert len(counts) == 12 and set(counts.values()) == {0}
    assert "mlstm_scan" in counts


# ------------------------------------------------- launcher and bridge ----

@pytest.mark.parametrize("extra", [[], ["--prefill-budget", "16"]],
                         ids=["monolithic", "budget"])
def test_serve_cli_runs_xlstm_smoke(capsys, extra):
    res = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-new", "6",
                      "--temperature", "0"] + extra)
    assert res["requests"] == 3
    assert all(len(o) == 6 for o in res["outputs"].values())
    assert "served 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [["--kv-mode", "paged"],
                                   ["--spec-decode"]])
def test_serve_cli_refuses_what_the_engine_refuses(extra):
    with pytest.raises(ValueError, match="pure-attention"):
        serve_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "1", "--max-new", "2"] + extra)


def test_bridge_copies_every_leaf_of_a_repeated_unit_exactly():
    """The full config's layout (a unit of mlstm, mlstm, mlstm, slstm
    repeated 3 times: a leading R axis of 3 on every leaf) at the smoke
    config's widths: every JAX leaf lands bit for bit in its model
    tensor, in the leaf's own dtype (w_if, b_i, b_f and b_gates fp32)."""
    full = jax_config(ARCH)
    jcfg = dataclasses.replace(jax_smoke(ARCH), n_layers=12,
                               segments=full.segments)
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=12,
                              segments=full.segments)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(3),
                                                    jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tensors = dict(model.named_parameters())
    tree = jax.tree.map(np.asarray, jp)
    seen = set()
    for ui, kind in enumerate(cfg.segments[0][0]):
        for key, leaf in _walk(tree["segments"][0][ui], ""):
            assert leaf.shape[0] == 3, key
            for r in range(3):
                name = f"layers.{r * 4 + ui}." + key.replace("/", ".")
                t = tensors[name]
                want = np.asarray(leaf[r])
                assert str(t.dtype).split(".")[-1] == want.dtype.name, name
                np.testing.assert_array_equal(
                    t.float().numpy(), want.astype(np.float32), name)
                seen.add(name)
    seen |= {"embed", "final_norm.scale"}
    np.testing.assert_array_equal(tensors["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))
    assert seen == set(tensors)
    assert {n.split(".", 2)[2] for n in seen if n.startswith("layers.")} \
        >= {"mlstm.w_if", "mlstm.b_i", "mlstm.b_f", "mlstm.norm.scale",
            "slstm.b_gates", "slstm.r_gates", "slstm.norm_ffn.scale",
            "norm1.scale"}
