"""The port's dense serving engine vs the JAX engine (reference backend)
and against its own contracts, at the planner's SMOKE config on the CPU.

Across frameworks at T=0: teacher-forced logits along the JAX engine's
tokens agree within LOGIT_TOL (bf16 roundings differ between the
frameworks; see test_torch_model.py), and the port's greedy tokens equal
the JAX engine's: the first position where they differ, if any, must be
one whose JAX top-2 margin is at most 2 * LOGIT_TOL (random-init weights
make near-ties, after which the two streams may rightly part).

Within the port: a prefix hit serves the tokens of a miss, and chunked
(budgeted) prefill the tokens of monolithic prefill.
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
from repro_torch.common import perf
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import ENGINE_STAT_KEYS, InferenceEngine
from repro_torch.serving.sampling import SamplerConfig

LOGIT_TOL = 0.05
CACHE_LEN = 128
PROMPTS = [f"Plot xview1 images around Tampa Bay with cloud cover below "
           f"{10 + i}%" for i in range(3)]


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke("planner-proxy-100m")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("planner-proxy-100m")
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, "cpu")


@pytest.fixture
def small_chunk(monkeypatch):
    """A 32-token attention chunk, so short prompts cross chunk seams."""
    monkeypatch.setattr(perf, "FLAGS", perf.PerfFlags(attn_chunk=32))


def _serve(eng, prompts, max_new, prefix_key=None):
    rids = [eng.add_request(p, max_new_tokens=max_new,
                            sampler=SamplerConfig(temperature=0.0),
                            prefix_key=prefix_key) for p in prompts]
    done = {r.request_id: r for r in eng.run_until_done()}
    return [done[r].output for r in rids]


def test_greedy_tokens_and_teacher_forced_logits_match_jax(pair):
    jcfg, jp, cfg, model = pair
    jeng = JE.InferenceEngine(jcfg, jp, max_batch=2, cache_len=CACHE_LEN,
                              seed=0, backend="reference")
    jrids = [jeng.add_request(p, max_new_tokens=6,
                              sampler=JSampler(temperature=0.0))
             for p in PROMPTS]
    jdone = {r.request_id: r for r in jeng.run_until_done()}
    jout = [jdone[r].output for r in jrids]
    tout = _serve(InferenceEngine(cfg, model, max_batch=2,
                                  cache_len=CACHE_LEN), PROMPTS, 6)
    equal = 0
    for rid in range(len(PROMPTS)):
        ids = jdone[jrids[rid]].prompt
        jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray([ids])},
                            cache_len=CACHE_LEN)
        tl, tc = TM.prefill(model, {"tokens": [ids]}, CACHE_LEN)
        for i, tok in enumerate(jout[rid]):
            j = np.asarray(jl[0], np.float32)
            np.testing.assert_allclose(tl[0].numpy(), j, atol=LOGIT_TOL,
                                       rtol=0)
            if tout[rid][i] != tok:
                top2 = np.sort(j)[-2:]
                assert top2[1] - top2[0] <= 2 * LOGIT_TOL, (rid, i)
                break                      # a near-tie: streams part here
            equal += 1
            jl, jc = JM.decode_step(jp, jcfg, jc,
                                    {"tokens": jnp.asarray([[tok]])})
            tl, tc = TM.decode_step(model, tc, {"tokens": [[tok]]})
    assert equal >= 6


def test_prefix_hit_serves_the_tokens_of_a_miss(pair, small_chunk):
    """A 75-token prefix: a 64-token head prefill plus a tail extend at
    the registration, then one padded suffix extend per hit."""
    _, _, cfg, model = pair
    rng = np.random.default_rng(0)
    prefix = [2] + rng.integers(6, cfg.vocab_size, 74).tolist()
    prompts = [prefix + rng.integers(6, cfg.vocab_size, 3 + 4 * i).tolist()
               for i in range(4)]
    hit_eng = InferenceEngine(cfg, model, max_batch=2, cache_len=CACHE_LEN)
    assert hit_eng.register_prefix("sys", prefix) == 75
    hit = _serve(hit_eng, prompts, 5, prefix_key="sys")
    miss = _serve(InferenceEngine(cfg, model, max_batch=2,
                                  cache_len=CACHE_LEN), prompts, 5)
    assert hit == miss
    st = hit_eng.throughput_stats()
    assert st["prefix_hits"] == 4 and st["prefix_tokens_saved"] == 300
    assert st["prefills"] == 1                 # the registration only


@pytest.mark.parametrize("budget,interleave", [(32, True), (64, True),
                                               (1, False)])
def test_budgeted_prefill_serves_the_tokens_of_monolithic(
        pair, small_chunk, budget, interleave):
    _, _, cfg, model = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(6, cfg.vocab_size, n).tolist()
               for n in (70, 9, 33, 100)]
    mono = _serve(InferenceEngine(cfg, model, max_batch=3,
                                  cache_len=CACHE_LEN), prompts, 4)
    eng = InferenceEngine(cfg, model, max_batch=3, cache_len=CACHE_LEN,
                          prefill_budget=budget, interleave=interleave)
    assert _serve(eng, prompts, 4) == mono
    st = eng.throughput_stats()
    assert st["prefill_chunks"] == 3 + 1 + 2 + 4
    assert (st["stall_ticks"] > 0) == (not interleave)


def test_prefix_hit_under_budget(pair, small_chunk):
    _, _, cfg, model = pair
    rng = np.random.default_rng(2)
    prefix = [2] + rng.integers(6, cfg.vocab_size, 40).tolist()
    prompts = [prefix + rng.integers(6, cfg.vocab_size, 50).tolist()]
    eng = InferenceEngine(cfg, model, max_batch=2, cache_len=CACHE_LEN,
                          prefill_budget=32)
    eng.register_prefix("p", prefix)
    out = _serve(eng, prompts, 4, prefix_key="p")
    # the registered prefix survives the hit: a second hit is identical
    assert _serve(eng, prompts, 4, prefix_key="p") == out
    assert out == _serve(InferenceEngine(cfg, model, max_batch=2,
                                         cache_len=CACHE_LEN), prompts, 4)


def test_stats_surface_matches_jax_engine(pair):
    _, _, cfg, model = pair
    assert ENGINE_STAT_KEYS == JE.ENGINE_STAT_KEYS
    eng = InferenceEngine(cfg, model, max_batch=2, cache_len=64)
    _serve(eng, PROMPTS[:2], 3)
    st = eng.throughput_stats()
    assert st["tokens_generated"] == 4 and st["decode_steps"] == 2
    assert st["admissions"] == 2 and st["prefills"] == 2
    kv = eng.kv_memory_stats()
    assert kv["kv_bytes_allocated"] == 2 * 2 * 2 * 2 * 64 * 64 * 2
    assert kv["kv_bytes_peak"] == kv["kv_bytes_allocated"]
    assert kv["kv_bytes_in_use"] == 0
    eng.reset()
    assert all(v == 0 for v in eng.stats.values())


def test_reset_engine_serves_the_same_tokens(pair):
    _, _, cfg, model = pair
    eng = InferenceEngine(cfg, model, max_batch=2, cache_len=64)
    first = _serve(eng, PROMPTS, 4)
    eng.reset()
    assert _serve(eng, PROMPTS, 4) == first


def test_finish_reasons(pair):
    _, _, cfg, model = pair
    eng = InferenceEngine(cfg, model, max_batch=1, cache_len=32)
    long = eng.add_request(list(range(6, 30)), max_new_tokens=50)
    late = eng.add_request(PROMPTS[1], max_new_tokens=4, sla_ticks=1)
    short = eng.add_request(PROMPTS[0], max_new_tokens=1)
    done = {r.request_id: r for r in eng.run_until_done()}
    assert done[long].finish_reason == "cache_len"
    assert done[short].finish_reason == "max_new_tokens"
    assert len(done[short].output) == 1
    assert done[late].finish_reason == "sla_expired"


def test_seeded_sampling_is_deterministic(pair):
    _, _, cfg, model = pair

    def run():
        eng = InferenceEngine(cfg, model, max_batch=2, cache_len=64, seed=5)
        rids = [eng.add_request(p, max_new_tokens=5,
                                sampler=SamplerConfig(temperature=1.0,
                                                      top_k=8, seed=i))
                for i, p in enumerate(PROMPTS)]
        done = {r.request_id: r.output for r in eng.run_until_done()}
        return [done[r] for r in rids]
    assert run() == run()


def test_sessions_collect_their_turns(pair):
    _, _, cfg, model = pair
    eng = InferenceEngine(cfg, model, max_batch=2, cache_len=64)
    a, b = eng.open_session("x"), eng.open_session()
    a.submit_turn(PROMPTS[0], max_new_tokens=2)
    b.submit_turn(PROMPTS[1], max_new_tokens=2)
    while not (a.idle and b.idle):
        fin = eng.step()
        a.collect(fin)
        b.collect(fin)
    assert len(a.turns) == len(b.turns) == 1
    assert a.turns[0].prefix_key == "x"


@pytest.mark.parametrize("kw", [{"kv_mode": "paged"},
                                {"spec_decode": "self"}])
def test_unported_modes_refused(pair, kw):
    """Paged KV and speculative decoding are ported now: each mode
    serves the dense engine's greedy tokens."""
    from repro_torch.serving.specdec import SpecConfig
    _, _, cfg, model = pair
    if kw.get("spec_decode") == "self":
        kw = {"spec_decode": SpecConfig(cfg, model, k=2)}
    eng = InferenceEngine(cfg, model, max_batch=2, cache_len=64, **kw)
    assert _serve(eng, PROMPTS, 4) == _serve(
        InferenceEngine(cfg, model, max_batch=2, cache_len=64), PROMPTS, 4)
    st = eng.throughput_stats()
    assert st["kv_mode"] == kw.get("kv_mode", "dense")
    assert (st["spec_rounds"] > 0) == ("spec_decode" in kw)


def test_engine_runs_no_kernel_on_cpu(pair):
    from repro_torch.kernels import backend as KB
    _, _, cfg, model = pair
    KB.reset_launches()
    _serve(InferenceEngine(cfg, model, max_batch=2, cache_len=64),
           PROMPTS[:1], 2)
    assert KB.launch_counts() == {
        "flash_prefill": 0, "flash_decode": 0, "flash_decode_paged": 0,
        "flash_verify": 0, "flash_verify_paged": 0,
        "moe_router_topk": 0, "ssm_scan": 0, "mlstm_scan": 0,
        "flash_prefill_bwd": 0}
    assert model.device == torch.device("cpu")
