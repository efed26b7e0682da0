"""The port's paged KV cache: model-level paged decode against the JAX
package's reference backend, and the engine's paged memory manager
against its own contracts, at the planner's SMOKE config on the CPU.

Across frameworks: paged decode logits agree with the JAX reference
backend's within LOGIT_TOL (the bf16 roundings of the two frameworks
differ; see test_torch_model.py), and the paged engine's greedy tokens
equal the JAX paged engine's up to a near-tie (as test_torch_engine.py
holds the dense engine).

Within the port the contracts are bitwise: paged decode IS dense decode
(logits and written K/V rows, ``torch.equal``), and the paged engine
emits exactly the dense engine's tokens through prefix sharing,
admission gating, preemption and resume, and eviction. Requests carry
sampler seeds at T=0.8, so outputs are a function of (prompt, seed) and
any divergence is a memory-manager fault, not sampling noise.
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
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import backend as KB
from repro_torch.kernels.ref import paged_gather_kv
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import InferenceEngine, _insert_slot, \
    _paged_scatter
from repro_torch.serving.sampling import SamplerConfig

BS = 16                       # block_size under test
CACHE = 128
LOGIT_TOL = 0.05
LEAF_ATOL, LEAF_RTOL = 2.0 ** -5, 2.0 ** -6     # test_torch_model.py's
PREFIX = list(range(5, 53))                     # 48 tokens = 3 full blocks


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


def make(planner, **kw):
    cfg, model = planner
    kw.setdefault("max_batch", 2)
    kw.setdefault("cache_len", CACHE)
    return InferenceEngine(cfg, model, **kw)


def _submit(eng, n=4, max_new=6, with_prefix=True, prompt_extra=0):
    if with_prefix:
        eng.register_prefix("p", PREFIX)
    for i in range(n):
        suffix = list(range(200 + 8 * i, 208 + 8 * i + prompt_extra))
        eng.add_request(PREFIX + suffix if with_prefix else suffix,
                        max_new_tokens=max_new,
                        sampler=SamplerConfig(temperature=0.8, top_k=40,
                                              seed=1000 + i),
                        prefix_key="p" if with_prefix else None)


def _outputs(eng):
    return {r.request_id: (tuple(r.output), r.finish_reason)
            for r in eng.run_until_done()}


# ----------------------------------------------------------- model level ----

PROMPTS = [list(range(5, 29)), list(range(40, 53))]    # 24 and 13 tokens


def _blocks(b, n):
    """Slot b's blocks: shuffled ids, enough for ``n`` rows."""
    order = [9, 2, 14, 5, 0, 11, 7, 3, 12, 6, 1, 15, 4, 10, 8, 13]
    need = -(-n // BS)
    return order[8 * b:8 * b + need]


def _torch_caches(model, cfg):
    """The same two prefilled slots as a dense and a paged cache."""
    B, nb = len(PROMPTS), 16
    dense = TM.init_cache(cfg, B, CACHE, "cpu")
    paged = TM.init_paged_cache(cfg, B, CACHE, nb, BS, "cpu")
    for b, p in enumerate(PROMPTS):
        _, c1 = TM.prefill(model, {"tokens": [p]}, CACHE)
        _insert_slot(dense, c1, b)
        blocks = _blocks(b, len(p) + 4)
        _paged_scatter(paged, c1["layers"], blocks)
        paged["block_tab"][b, :len(blocks)] = torch.tensor(blocks)
    pos = torch.tensor([len(p) for p in PROMPTS], dtype=torch.int32)
    dense["pos"], paged["pos"] = pos.clone(), pos.clone()
    return dense, paged


def test_paged_decode_matches_jax_reference(pair):
    jcfg, jp, model = pair
    B, nb = len(PROMPTS), 16
    jc = JM.init_paged_cache(jcfg, B, CACHE, nb, BS)
    for b, p in enumerate(PROMPTS):
        _, c1 = JM.prefill(jp, jcfg, {"tokens": jnp.asarray([p])},
                           cache_len=CACHE)
        ids = np.full((CACHE // BS,), nb, np.int32)
        blocks = _blocks(b, len(p) + 4)
        ids[:len(blocks)] = blocks
        jc["segments"] = JE._paged_scatter(jc["segments"], c1["segments"],
                                           jnp.asarray(ids))
        jc["block_tab"] = jc["block_tab"].at[b].set(jnp.asarray(ids))
    jc["pos"] = jnp.asarray([len(p) for p in PROMPTS], jnp.int32)
    _, tc = _torch_caches(model, model.cfg)
    rng = np.random.default_rng(0)
    for _ in range(3):
        nxt = rng.integers(6, jcfg.vocab_size, (B, 1))
        jl, jc = JM.decode_step(jp, jcfg, jc,
                                {"tokens": jnp.asarray(nxt, jnp.int32)})
        tl, tc = TM.decode_step(model, tc, {"tokens": nxt})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                                   atol=LOGIT_TOL, rtol=0)
    # every pool leaf of every layer, over the blocks the slots hold
    used = sorted(b for s in range(B) for b in
                  _blocks(s, len(PROMPTS[s]) + 4))
    for li, layer in enumerate(tc["layers"]):
        for n in ("k", "v"):
            j = np.asarray(jc["segments"][0][0][n], np.float32)[li]
            np.testing.assert_allclose(layer[n][used].float().numpy(),
                                       j[used], atol=LEAF_ATOL,
                                       rtol=LEAF_RTOL, err_msg=f"{li}/{n}")


def test_paged_decode_is_dense_decode_bitwise(planner):
    """Logits and the written K/V rows, three steps."""
    cfg, model = planner
    dense, paged = _torch_caches(model, cfg)
    rng = np.random.default_rng(1)
    for step in range(3):
        nxt = rng.integers(6, cfg.vocab_size, (2, 1))
        pos = dense["pos"].clone()
        dl, dense = TM.decode_step(model, dense, {"tokens": nxt})
        paged["pos"] = pos
        pl, paged = TM.decode_step(model, paged, {"tokens": nxt})
        assert torch.equal(dl, pl), step
    for dl_, pl_ in zip(dense["layers"], paged["layers"]):
        for n in ("k", "v"):
            g = paged_gather_kv(pl_[n], paged["block_tab"])
            for b, p in enumerate(PROMPTS):
                rows = len(p) + 3
                assert torch.equal(g[b, :, :rows], dl_[n][b, :, :rows])


def test_rows_with_nowhere_to_go_are_dropped(planner):
    """An idle slot (all-sentinel table, any pos) and a row past the
    logical capacity write nothing: every block outside the live slot's
    table keeps its bits (JAX drops such writes; clamping would hit the
    last block, which may belong to a live request)."""
    cfg, model = planner
    _, paged = _torch_caches(model, cfg)
    paged["block_tab"][1] = 16                  # slot 1 idle: sentinels
    paged["pos"] = torch.tensor([24, 500], dtype=torch.int32)
    before = [{n: t.clone() for n, t in l.items()} for l in paged["layers"]]
    _, paged = TM.decode_step(model, paged, {"tokens": [[7], [9]]})
    live = set(_blocks(0, 28))
    others = [b for b in range(16) if b not in live]
    for a, l in zip(before, paged["layers"]):
        for n in ("k", "v"):
            assert torch.equal(a[n][others], l[n][others])
    # past the capacity: slot 0 at pos == cache_len writes nowhere
    paged["pos"] = torch.tensor([CACHE, 0], dtype=torch.int32)
    before = [{n: t.clone() for n, t in l.items()} for l in paged["layers"]]
    TM.decode_step(model, paged, {"tokens": [[7], [9]]})
    for a, l in zip(before, paged["layers"]):
        for n in ("k", "v"):
            assert torch.equal(a[n], l[n])


# ---------------------------------------------------------- engine level ----

def test_dense_vs_paged_bitwise_parity_with_prefix_sharing(planner):
    dense = make(planner)
    _submit(dense)
    paged = make(planner, kv_mode="paged", block_size=BS)
    _submit(paged)
    assert _outputs(dense) == _outputs(paged)
    st = paged.stats
    assert st["prefix_hits"] == 4 and st["preemptions"] == 0
    assert st["admissions"] == st["prefix_hits"] + st["prefills"] \
        - st["prefix_registrations"]


def test_prefix_blocks_are_shared_not_copied(planner):
    eng = make(planner, kv_mode="paged", block_size=BS)
    _submit(eng, n=2, max_new=8)
    eng.step()                                   # both admitted, in flight
    ks = eng.kv_memory_stats()
    assert ks["kv_blocks_shared"] == len(PREFIX) // BS == 3
    assert eng.stats["prefix_hits"] == 2
    eng.run_until_done()
    ks = eng.kv_memory_stats()
    assert ks["kv_blocks_shared"] == 0
    assert ks["kv_blocks_used"] == eng.pool.blocks_needed(len(PREFIX))
    assert ks["kv_blocks_shared_peak"] >= 3


def test_preempt_resume_is_bit_reproducible(planner):
    def run(kv_mode, **kw):
        eng = make(planner, kv_mode=kv_mode, **kw)
        for i in range(3):
            eng.add_request(list(range(5, 45)), max_new_tokens=24,
                            sampler=SamplerConfig(temperature=0.8, top_k=40,
                                                  seed=77 + i))
        return _outputs(eng), eng
    d, _ = run("dense")
    p, eng = run("paged", block_size=BS, kv_blocks=7)
    assert eng.stats["preemptions"] > 0
    assert eng.stats["resumes"] == eng.stats["preemptions"]
    assert d == p


def test_admission_waits_for_free_blocks(planner):
    dense = make(planner)
    _submit(dense, n=2, max_new=4, with_prefix=False, prompt_extra=20)
    d = _outputs(dense)
    eng = make(planner, kv_mode="paged", block_size=BS, kv_blocks=3)
    _submit(eng, n=2, max_new=4, with_prefix=False, prompt_extra=20)
    eng.step()
    assert eng.busy_slots() == 1 and eng.queue_depth() == 1
    assert _outputs(eng) == d
    assert eng.stats["preemptions"] == 0


def test_oversize_prompt_finishes_cache_len_not_crash(planner):
    eng = make(planner, cache_len=64, kv_mode="paged", block_size=BS)
    eng.add_request(list(range(5, 75)), max_new_tokens=4)      # 70 tokens
    eng.add_request(list(range(5, 68)), max_new_tokens=8)      # 63 tokens
    done = {r.request_id: r for r in eng.run_until_done()}
    assert done[0].finish_reason == "cache_len" and not done[0].output
    assert done[1].finish_reason == "cache_len"
    assert eng.pool.free_blocks() == eng.pool.n_blocks


def test_kv_oom_finishes_impossible_requests(planner):
    ticks = iter(range(1, 10_000))
    eng = make(planner, kv_mode="paged", block_size=BS, kv_blocks=2,
               clock=lambda: float(next(ticks)))
    eng.add_request(list(range(5, 60)), max_new_tokens=4)     # needs 4 blk
    eng.add_request(list(range(5, 25)), max_new_tokens=2)     # fits
    done = {r.request_id: r for r in eng.run_until_done()}
    assert done[0].finish_reason == "kv_oom" and done[0].output == []
    assert done[1].finish_reason in ("eos", "max_new_tokens")
    assert done[0].first_token_t == done[0].finish_t > 0


def test_infeasible_reservation_leaves_pins_alone(planner):
    eng = make(planner, kv_mode="paged", block_size=BS, kv_blocks=8)
    eng.register_prefix("pin", PREFIX)                 # 3 blocks, pinned
    eng.add_request(list(range(5, 69)), max_new_tokens=4,
                    sampler=SamplerConfig(seed=1))     # 64 tok -> 5 blk
    eng.step()                                         # pool now full
    eng.add_request(list(range(5, 70)), max_new_tokens=2,
                    sampler=SamplerConfig(seed=2))     # needs 5 blocks
    eng.step()
    assert eng.queue_depth() == 1
    assert set(eng._prefix_tables) == {"pin"}
    assert eng.stats["prefix_evictions"] == 0
    done = eng.run_until_done()
    assert len(done) == 2 and eng.stats["prefix_evictions"] == 0


def test_cold_prefix_pins_are_lru_evicted(planner):
    eng = make(planner, kv_mode="paged", block_size=BS, kv_blocks=5)
    eng.register_prefix("a", PREFIX)                   # pins 3 blocks
    eng.register_prefix("b", list(range(60, 108)))     # needs the room
    assert eng.stats["prefix_evictions"] == 1
    assert set(eng._prefix_tables) == {"b"}
    eng.add_request(PREFIX + [200, 201], max_new_tokens=2,
                    sampler=SamplerConfig(seed=5), prefix_key="a")
    done = eng.run_until_done()
    assert eng.stats["prefix_hits"] == 1               # hit, unshared
    assert done[0].finish_reason in ("eos", "max_new_tokens")


def test_budgeted_paged_prefill_serves_the_dense_tokens(planner):
    dense = make(planner)
    _submit(dense, n=3)
    paged = make(planner, kv_mode="paged", block_size=BS, prefill_budget=32)
    _submit(paged, n=3)
    assert _outputs(paged) == _outputs(dense)
    assert paged.stats["prefill_chunks"] > 0


def test_dense_mode_refuses_paged_sizing_kwargs(planner):
    with pytest.raises(ValueError, match="paged"):
        make(planner, block_size=BS)
    with pytest.raises(ValueError, match="paged"):
        make(planner, kv_blocks=8)
    with pytest.raises(ValueError, match="multiple of block_size"):
        make(planner, kv_mode="paged", block_size=24)


def test_kv_memory_stats_schema_both_modes(planner):
    dense = make(planner)
    paged = make(planner, kv_mode="paged", block_size=BS)
    dks, pks = dense.kv_memory_stats(), paged.kv_memory_stats()
    assert set(dks) == set(pks)
    assert dks["kv_bytes_allocated"] == pks["kv_bytes_allocated"] > 0
    _submit(dense, n=2, with_prefix=False)
    dense.run_until_done()
    dks = dense.kv_memory_stats()
    assert dks["kv_bytes_peak"] == 2 * (dks["kv_bytes_allocated"] // 2)
    assert dense.throughput_stats()["kv_mode"] == "dense"
    _submit(paged, n=2, with_prefix=False)
    paged.run_until_done()
    st = paged.throughput_stats()
    assert st["kv_mode"] == "paged" and st["kv_blocks_used"] == 0
    assert st["kv_bytes_peak"] == st["kv_blocks_used_peak"] * (
        st["kv_bytes_allocated"] // st["kv_blocks_total"]) > 0


def test_reset_paged_engine_serves_the_same_tokens(planner):
    eng = make(planner, kv_mode="paged", block_size=BS, kv_blocks=7)
    _submit(eng, n=3, max_new=5)
    first = _outputs(eng)
    eng.reset()
    assert eng.pool.free_blocks() == 7 and not eng._prefix_tables
    _submit(eng, n=3, max_new=5)
    assert _outputs(eng) == first


def test_paged_engine_runs_no_kernel_on_cpu(planner):
    KB.reset_launches()
    eng = make(planner, kv_mode="paged", block_size=BS)
    _submit(eng, n=1, max_new=2)
    _outputs(eng)
    assert set(KB.launch_counts().values()) == {0}


# ------------------------------------------------- engine vs JAX engine ----

def test_paged_engine_tokens_match_jax(pair):
    """T=0 greedy: the port's paged tokens equal the JAX paged engine's,
    or first differ at a JAX near-tie (top-2 margin <= 2 * LOGIT_TOL)."""
    jcfg, jp, model = pair
    prompts = [list(range(5, 25)), list(range(30, 61)), list(range(70, 79))]
    jeng = JE.InferenceEngine(jcfg, jp, max_batch=2, cache_len=CACHE,
                              backend="reference", kv_mode="paged",
                              block_size=BS, kv_blocks=10)
    teng = InferenceEngine(model.cfg, model, max_batch=2, cache_len=CACHE,
                           kv_mode="paged", block_size=BS, kv_blocks=10)
    outs = []
    for eng, samp in ((jeng, JSampler), (teng, SamplerConfig)):
        rids = [eng.add_request(p, max_new_tokens=6,
                                sampler=samp(temperature=0.0))
                for p in prompts]
        done = {r.request_id: r.output for r in eng.run_until_done()}
        outs.append([done[r] for r in rids])
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
