"""The port's speculative decoding (draft-verify): ``verify_extend``
against the JAX package's reference backend and against its own
contracts, and the engine's spec path, at the planner's SMOKE config on
the CPU.

Across frameworks: verify logits agree with the JAX reference backend's
``verify_extend`` within LOGIT_TOL (dense and paged), and the spec
engine's greedy tokens equal the JAX spec engine's up to a near-tie.

Within the port the contracts are bitwise: verify_extend's W logit rows
ARE the W sequential decode_step logits and it writes the same K/V rows
(``torch.equal``), dense and paged; and the spec engine emits exactly
the non-speculative engine's tokens and finish reasons, dense and paged,
greedy and seeded T=0.8, with a zero-agreement draft, and through paged
preemption and resume.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving.sampling import SamplerConfig as JSampler
from repro.serving.specdec import SpecConfig as JSpec
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import InferenceEngine, _insert_slot, \
    _paged_scatter
from repro_torch.serving.sampling import SamplerConfig
from repro_torch.serving.specdec import SpecConfig, SpecDecoder

BS = 16
CACHE = 128
LOGIT_TOL = 0.05
PREFIX = list(range(5, 25))
TOKS = np.array([[3, 7, 11, 13], [4, 8, 12, 14]])
PROMPTS = [list(range(5, 17)), list(range(30, 39))]


@pytest.fixture(scope="module")
def planner():
    cfg = get_smoke_config("planner-proxy-100m")
    return cfg, TM.init_params(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke("planner-proxy-100m")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("planner-proxy-100m")
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")


def make(planner, spec_k=None, draft=None, **kw):
    cfg, model = planner
    kw.setdefault("max_batch", 2)
    kw.setdefault("cache_len", CACHE)
    spec = (SpecConfig(cfg, model if draft is None else draft, k=spec_k)
            if spec_k else None)
    return InferenceEngine(cfg, model, spec_decode=spec, **kw)


def _prompts(n, suffix_len=6):
    return [PREFIX + list(range(200 + suffix_len * i,
                                200 + suffix_len * (i + 1)))
            for i in range(n)]


def _serve(eng, prompts, max_new=11, temperature=0.0, seeds=True):
    eng.register_prefix("hot", PREFIX)
    idx = {}
    for i, p in enumerate(prompts):
        rid = eng.add_request(
            p, max_new_tokens=max_new,
            sampler=SamplerConfig(temperature=temperature,
                                  top_k=40 if temperature else 0,
                                  seed=500 + i if seeds else None),
            prefix_key="hot")
        idx[rid] = i
    return {idx[r.request_id]: (tuple(r.output), r.finish_reason)
            for r in eng.run_until_done()}


# ----------------------------------------------------------- model level ----

def _cache(model, cfg, paged: bool, W: int):
    B = len(PROMPTS)
    nb = B * CACHE // BS
    cache = (TM.init_paged_cache(cfg, B, CACHE, nb, BS, "cpu") if paged
             else TM.init_cache(cfg, B, CACHE, "cpu"))
    for b, p in enumerate(PROMPTS):
        _, c1 = TM.prefill(model, {"tokens": [p]}, CACHE)
        if paged:
            blocks = list(range(b * 8, b * 8 + -(-(len(p) + W + 1) // BS)))
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


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_extend_matches_sequential_decode(planner, paged):
    """verify_extend's W logit rows are bitwise the W sequential
    decode_step logits, and it writes the same K/V rows."""
    cfg, model = planner
    W = TOKS.shape[1]
    cache = _cache(model, cfg, paged, W)
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


def test_verify_pos_rides_unchanged(planner):
    cfg, model = planner
    cache = TM.init_cache(cfg, 2, CACHE, "cpu")
    cache["pos"] = torch.tensor([5, 9], dtype=torch.int32)
    _, out = TM.verify_extend(model, cache, {"tokens": np.zeros((2, 3))})
    assert out["pos"].tolist() == [5, 9]


def test_verify_rows_past_the_cache_end_are_dropped(planner):
    """A window overhanging the cache end writes only its in-range rows
    and its logits still equal the decode rows that fit."""
    cfg, model = planner
    cache = _cache(model, cfg, False, 4)
    cache["pos"] = torch.tensor([CACHE - 2, 12], dtype=torch.int32)
    d = _clone(cache)
    lg0, d = TM.decode_step(model, d, {"tokens": TOKS[:, :1]})
    lg1, d = TM.decode_step(model, d, {"tokens": TOKS[:, 1:2]})
    vlg, _ = TM.verify_extend(model, cache, {"tokens": TOKS})
    assert torch.equal(vlg[:, 0], lg0) and torch.equal(vlg[:, 1], lg1)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_extend_matches_jax_reference(pair, paged):
    jcfg, jp, model = pair
    B, W = len(PROMPTS), TOKS.shape[1]
    nb = B * CACHE // BS
    if paged:
        jc = JM.init_paged_cache(jcfg, B, CACHE, nb, BS)
    else:
        jc = JM.init_cache(jcfg, B, CACHE)
    for b, p in enumerate(PROMPTS):
        _, c1 = JM.prefill(jp, jcfg, {"tokens": jnp.asarray([p])},
                           cache_len=CACHE)
        if paged:
            ids = np.full((CACHE // BS,), nb, np.int32)
            need = -(-(len(p) + W + 1) // BS)
            ids[:need] = range(b * 8, b * 8 + need)
            jc["segments"] = JE._paged_scatter(
                jc["segments"], c1["segments"], jnp.asarray(ids))
            jc["block_tab"] = jc["block_tab"].at[b].set(jnp.asarray(ids))
        else:
            jc = JE._insert_slot(jc, dict(c1), b)
    jc["pos"] = jnp.asarray([len(p) for p in PROMPTS], jnp.int32)
    jl, _ = JM.verify_extend(jp, jcfg, jc,
                             {"tokens": jnp.asarray(TOKS, jnp.int32)})
    tl, _ = TM.verify_extend(model, _cache(model, model.cfg, paged, W),
                             {"tokens": TOKS})
    assert tuple(tl.shape) == (B, W, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               atol=LOGIT_TOL, rtol=0)


# ---------------------------------------------------------- engine level ----

@pytest.mark.parametrize("kv_kw", [
    {}, {"kv_mode": "paged", "kv_blocks": 16, "block_size": BS},
], ids=["dense", "paged"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_parity(planner, kv_kw, temperature):
    prompts = _prompts(5)
    base = _serve(make(planner, **kv_kw), prompts, temperature=temperature)
    so = _serve(make(planner, spec_k=3, **kv_kw), prompts,
                temperature=temperature)
    assert base == so


def test_parity_survives_zero_agreement(planner):
    cfg, _ = planner
    prompts = _prompts(4)
    base = _serve(make(planner), prompts)
    eng = make(planner, spec_k=3,
               draft=TM.init_params(cfg, seed=7, device="cpu"))
    assert _serve(eng, prompts) == base
    st = eng.throughput_stats()
    assert st["spec_accept_rate"] < 0.5
    assert st["tokens_per_step"] >= 1.0


def test_parity_through_preempt_resume(planner):
    def run(**kw):
        eng = make(planner, spec_k=3, **kw)
        idx = {}
        for i in range(3):
            rid = eng.add_request(
                list(range(5, 45)), max_new_tokens=24,
                sampler=SamplerConfig(temperature=0.8, top_k=40,
                                      seed=77 + i))
            idx[rid] = i
        return {idx[r.request_id]: (tuple(r.output), r.finish_reason)
                for r in eng.run_until_done()}, eng
    dense, _ = run()
    paged, eng = run(kv_mode="paged", kv_blocks=7, block_size=BS)
    assert eng.stats["preemptions"] > 0
    assert eng.stats["resumes"] == eng.stats["preemptions"]
    assert dense == paged


def test_self_draft_speedup_and_stats(planner):
    """Self-draft at T=0: accept rate 1.0 when windows never truncate,
    tokens per target forward > 1.5x the non-speculative run's."""
    prompts = _prompts(4)
    base_eng = make(planner)
    base = _serve(base_eng, prompts, max_new=12)        # 12 = 3 windows
    eng = make(planner, spec_k=3)
    assert _serve(eng, prompts, max_new=12) == base
    st, bst = eng.throughput_stats(), base_eng.throughput_stats()
    assert st["spec_accept_rate"] == 1.0
    assert st["spec_rounds"] == st["decode_steps"]
    assert st["spec_drafted"] > 0 and st["spec_drafted"] % 3 == 0
    assert st["tokens_per_step"] > 1.5 * bst["tokens_per_step"]
    assert st["spec_k"] == 3 and bst["spec_k"] == 0


def test_spec_under_budgeted_prefill(planner):
    prompts = _prompts(3)
    base = _serve(make(planner), prompts)
    assert _serve(make(planner, spec_k=2, prefill_budget=16),
                  prompts) == base


def test_oversized_prompt_refused_upfront(planner):
    eng = make(planner, spec_k=2)
    rid = eng.add_request(list(range(5, 5 + CACHE + 10)), max_new_tokens=4)
    done = eng.run_until_done()
    assert len(done) == 1 and done[0].request_id == rid
    assert done[0].finish_reason == "cache_len" and done[0].output == []
    assert eng.is_idle()


def test_engine_reset_with_spec(planner):
    eng = make(planner, spec_k=3)
    first = _serve(eng, _prompts(3))
    eng.reset()
    assert eng.stats["spec_rounds"] == 0
    assert _serve(eng, _prompts(3)) == first


def test_spec_config_validation(planner):
    cfg, model = planner
    with pytest.raises(ValueError, match="k >= 1"):
        InferenceEngine(cfg, model, max_batch=2, cache_len=CACHE,
                        spec_decode=SpecConfig(cfg, model, k=0))
    with pytest.raises(ValueError, match="pure-attention"):
        SpecDecoder(SpecConfig(cfg.replace(segments=((("mlstm",), 2),)),
                               model, k=2), max_batch=2, cache_len=CACHE)


# ------------------------------------------------- engine vs JAX engine ----

@pytest.mark.parametrize("kv_kw", [
    {}, {"kv_mode": "paged", "kv_blocks": 16, "block_size": BS},
], ids=["dense", "paged"])
def test_spec_engine_tokens_match_jax(pair, kv_kw):
    """T=0 greedy with a self-draft: the port's spec tokens equal the JAX
    spec engine's, or first differ at a JAX near-tie (top-2 margin <= 2
    * LOGIT_TOL)."""
    jcfg, jp, model = pair
    prompts = [list(range(5, 25)), list(range(30, 61))]
    jeng = JE.InferenceEngine(jcfg, jp, max_batch=2, cache_len=CACHE,
                              backend="reference",
                              spec_decode=JSpec(jcfg, jp, k=3), **kv_kw)
    teng = InferenceEngine(model.cfg, model, max_batch=2, cache_len=CACHE,
                           spec_decode=SpecConfig(model.cfg, model, k=3),
                           **kv_kw)
    outs = []
    for eng, samp in ((jeng, JSampler), (teng, SamplerConfig)):
        rids = [eng.add_request(p, max_new_tokens=9,
                                sampler=samp(temperature=0.0))
                for p in prompts]
        done = {r.request_id: r.output for r in eng.run_until_done()}
        outs.append([done[r] for r in rids])
    assert teng.throughput_stats()["spec_rounds"] > 0
    equal = 0
    for ids, jt, tt in zip(prompts, *outs):
        jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray([ids])},
                            cache_len=CACHE)
        for i, tok in enumerate(jt):
            if i >= len(tt) or tt[i] != tok:
                top2 = np.sort(np.asarray(jl[0], np.float32))[-2:]
                assert top2[1] - top2[0] <= 2 * LOGIT_TOL, (ids[0], i)
                break
            equal += 1
            jl, jc = JM.decode_step(jp, jcfg, jc,
                                    {"tokens": jnp.asarray([[tok]])})
    assert equal >= 6
