"""The port's serving cluster (``serving/cluster.py``) and workload
generator (``serving/workload.py``): the cases of tests/test_cluster.py
on the port, and the same results as the JAX package's.

Against JAX: ``make_workload`` gives the same requests field by field;
``rendezvous_hash`` the same homes; the routers the same picks; at T = 0
the clusters (the smoke planner, the JAX weights through the bridge)
place every request on the same replica and give the same
``summary()``, key by key. Their tokens are equal except where a
request's greedy streams part at a near tie (teacher-forced JAX top-2
margin of at most 2 * LOGIT_TOL; the frameworks' logits differ within
LOGIT_TOL, tests/test_torch_engine.py).

Within the port: the same seeded T = 0.8 workload gives the same tokens
on 1 replica and on 4 under every router.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving import cluster as JCL
from repro.serving import workload as JWL
from repro_torch.configs import get_smoke_config
from repro_torch.core.agent import Agent
from repro_torch.core.gate import IntentGate, ScriptedIntentClassifier
from repro_torch.core.intents import build_intent_map
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.tools import DEFAULT_REGISTRY
from repro_torch.env.tasks import make_benchmark
from repro_torch.env.world import build_world
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import cluster as CL
from repro_torch.serving import workload as WL
from repro_torch.serving.cluster import (ROUTER_POLICIES, EngineCluster,
                                         IntentAffinityRouter, ReplicaView,
                                         make_router, rendezvous_hash)
from repro_torch.serving.pipeline import GeckOptPipeline, PipelineConfig
from repro_torch.serving.workload import (WorkloadConfig, make_workload,
                                          register_workload_prefixes,
                                          skewed_mix, uniform_mix)

LOGIT_TOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: its pool, under the suite's workers, slows
    these small ops ~10x (``test_torch_training.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def planner():
    jcfg = jax_smoke("planner-proxy-100m")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("planner-proxy-100m")
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, "cpu")


@pytest.fixture(scope="module")
def pool(planner):
    """Four replicas sharing one model; tests reset() them."""
    _, _, cfg, model = planner
    return EngineCluster(cfg, model, 4, max_batch=2, cache_len=192,
                         seed=0).replicas


def mkcluster(pool, policy, n=None, **kw):
    engines = pool[:n] if n else pool
    for e in engines:
        e.reset()
    return EngineCluster(engines=engines, router=policy, **kw)


# ----------------------------------------------------- router unit tests ----

def views(mod, *loads, holder=None):
    return [mod.ReplicaView(i, busy, q, holds_prefix=(i == holder))
            for i, (busy, q) in enumerate(loads)]


@pytest.mark.parametrize("policy,calls,expected", [
    ("round_robin", [(((0, 0), (0, 0), (0, 0)), None, None)] * 6,
     [0, 1, 2, 0, 1, 2]),
    ("least_loaded", [(((2, 3), (1, 0), (4, 0)), None, None),
                      (((1, 1), (0, 2), (2, 0)), None, None),   # tie -> 0
                      (((0, 9), (1, 0)), None, None)],          # queue load
     [1, 0, 1]),
    # the holder wins even when busier; no key -> least loaded
    ("intent_affinity", [(((4, 6), (0, 0), (0, 0)), "k", 0),
                         (((4, 6), (1, 0), (0, 0)), None, 0)], [0, 2]),
], ids=["round_robin_cycles", "least_loaded_min_then_lowest_index",
        "affinity_to_holder"])
def test_router_picks(policy, calls, expected):
    for mod in (JCL, CL):
        r = mod.make_router(policy)
        got = [r.select(views(mod, *loads, holder=holder), key)
               for loads, key, holder in calls]
        assert got == expected, mod.__name__


def test_affinity_without_holder_is_rendezvous_placement():
    r = make_router("intent_affinity")
    home = rendezvous_hash("k", range(3))
    assert r.select(views(CL, (0, 0), (0, 0), (0, 0)), "k") == home
    assert r.select(views(CL, (3, 5), (3, 5), (3, 5)), "k") == home


def test_affinity_spills_when_home_overloaded():
    r = IntentAffinityRouter(spill_load=8)
    assert r.select([ReplicaView(0, 4, 3, True), ReplicaView(1, 0, 0)],
                    "k") == 0                                    # 7 < 8
    assert r.select([ReplicaView(0, 4, 4, True), ReplicaView(1, 0, 0)],
                    "k") == 1                                    # 8 >= 8
    sla = IntentAffinityRouter(sla_spill=True)
    home = [ReplicaView(0, 4, 4, True), ReplicaView(1, 0, 0)]
    assert sla.select(home, "k", slack=9) == 0 and \
        sla.select(home, "k", slack=7) == 1


def test_rendezvous_hash_equals_jax_stable_and_spreading():
    keys = [f"intent:{i}" for i in range(1000)]
    for n in (1, 2, 4, 7):
        assert [rendezvous_hash(k, range(n)) for k in keys] == \
            [JCL.rendezvous_hash(k, range(n)) for k in keys]
    keys = keys[:16]
    homes = {k: rendezvous_hash(k, range(4)) for k in keys}
    assert len(set(homes.values())) >= 3       # keys spread over replicas
    # adding a replica only remaps keys the new replica wins
    grown = {k: rendezvous_hash(k, range(5)) for k in keys}
    assert all(grown[k] in (homes[k], 4) for k in keys)


def test_unknown_policy_and_sizing_kwargs_rejected(pool):
    with pytest.raises(ValueError):
        make_router("random")
    # engines= keeps the replicas' own configuration
    for kw in ({"max_batch": 16}, {"cache_len": 1024}):
        with pytest.raises(ValueError, match="mutually exclusive"):
            EngineCluster(engines=pool, **kw)
    with pytest.raises(ValueError, match="cfg and model"):
        EngineCluster(n_replicas=2)


# ----------------------------------------------------------- workloads ----

WORKLOADS = {
    "uniform": WorkloadConfig(n_sessions=12, seed=1, max_turns=3,
                              max_new_tokens=2),
    "poisson": WorkloadConfig(n_sessions=8, seed=2, profile="poisson",
                              max_turns=2, temperature=0.8),
    "bursty": WorkloadConfig(n_sessions=32, seed=0, profile="bursty",
                             max_turns=2, max_new_tokens=16,
                             temperature=0.8),
    "skewed": WorkloadConfig(n_sessions=16, seed=0, profile="poisson",
                             max_turns=2, long_frac=0.25),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_make_workload_equals_jax(name):
    cfg = WORKLOADS[name]
    mix = dict(skewed=skewed_mix(hot_frac=0.7)).get(name)
    ours = make_workload(WorkloadConfig(**{**vars(cfg), "intent_mix": mix}))
    jmix = JWL.skewed_mix(hot_frac=0.7) if mix else None
    theirs = JWL.make_workload(JWL.WorkloadConfig(
        **{**vars(cfg), "intent_mix": jmix}))
    assert [vars(w) for w in ours] == [vars(w) for w in theirs]
    assert WL.workload_intents(ours) == JWL.workload_intents(theirs)


# ------------------------------------------------- exact token parity ------

def test_token_parity_one_replica_vs_four_all_policies(pool):
    """The same seeded workload (T = 0.8 seeded samplers, multi-turn
    sessions, per-intent prefixes) through 1 replica and through 4 gives
    identical per-request outputs under every router policy."""
    reqs = make_workload(WorkloadConfig(
        n_sessions=8, seed=2, intent_mix=uniform_mix(),
        profile="poisson", max_turns=2, max_new_tokens=3,
        temperature=0.8))

    def serve(policy, n):
        cl = mkcluster(pool, policy, n=n)
        register_workload_prefixes(cl, reqs)
        stats = cl.run_workload(reqs)
        return stats.outputs(), stats.summary()

    ref_out, ref_sum = serve("round_robin", 1)
    assert len(ref_out) == len(reqs) == ref_sum["finished"]
    assert all(len(v) > 0 for v in ref_out.values())
    for policy in ROUTER_POLICIES:
        out, summ = serve(policy, 4)
        assert out == ref_out, policy
        assert summ["tokens_out"] == ref_sum["tokens_out"]
        assert sum(r["admissions"] for r in summ["per_replica"]) \
            == len(reqs)


def test_affinity_beats_round_robin_on_skewed_mix(pool):
    """On a skewed mix at 4 replicas affinity's prefix-hit ratio is 1.0
    and round-robin's at most 0.5, with identical tokens."""
    reqs = make_workload(WorkloadConfig(
        n_sessions=16, seed=0, intent_mix=skewed_mix(hot_frac=0.7),
        profile="poisson", max_turns=2, max_new_tokens=3,
        temperature=0.8))

    def serve(policy):
        cl = mkcluster(pool, policy)
        register_workload_prefixes(cl, reqs)
        stats = cl.run_workload(reqs)
        return stats.summary(), stats.outputs()

    rr, rr_out = serve("round_robin")
    aff, aff_out = serve("intent_affinity")
    assert aff["prefix_hit_ratio"] == 1.0 > rr["prefix_hit_ratio"]
    assert rr["prefix_hit_ratio"] <= 0.5
    assert aff_out == rr_out
    assert all(r["prefix_hits"] == r["admissions"]
               for r in aff["per_replica"] if r["admissions"])


@pytest.fixture(scope="module")
def jax_pool(planner):
    jcfg, jp, _, _ = planner
    return JCL.EngineCluster(jcfg, jp, 4, max_batch=2, cache_len=192,
                             seed=0).replicas


def _first_part_is_near_tie(planner, trace, ours):
    """Teacher-forced JAX logits along the JAX request's tokens: the
    first greedy token where ``ours`` parts has a top-2 margin of at
    most 2 * LOGIT_TOL."""
    jcfg, jp, _, _ = planner
    req = trace.request
    t = next(i for i, (a, b) in enumerate(zip(req.output, ours)) if a != b)
    ids = list(req.prompt) + list(req.output[:t])
    logits, _ = JM.prefill(jp, jcfg, {"tokens": jnp.asarray([ids])},
                           cache_len=192)
    top2 = np.sort(np.asarray(logits[0], np.float32))[-2:]
    return top2[1] - top2[0] <= 2 * LOGIT_TOL


@pytest.mark.parametrize("policy", ["round_robin", "intent_affinity"])
def test_placements_and_summary_equal_jax(planner, pool, jax_pool, policy):
    """T = 0, the skewed workload: the same replica for every request,
    the same summary key by key, the same tokens but at near ties."""
    cfg = WorkloadConfig(n_sessions=16, seed=0, profile="poisson",
                         max_turns=2, max_new_tokens=3)
    runs = []
    for mod, wl, engines in ((JCL, JWL, jax_pool),
                             (None, WL, pool)):
        for e in engines:
            e.reset()
        reqs = wl.make_workload(wl.WorkloadConfig(
            **{**vars(cfg), "intent_mix": wl.skewed_mix(hot_frac=0.7)}))
        cl = (mod.EngineCluster if mod else EngineCluster)(
            engines=engines, router=policy)
        wl.register_workload_prefixes(cl, reqs)
        runs.append(cl.run_workload(reqs))
    theirs, ours = runs
    assert [(t.index, t.replica) for t in ours.traces] == \
        [(t.index, t.replica) for t in theirs.traces]
    out, jout = ours.outputs(), theirs.outputs()
    assert sorted(out) == sorted(jout)
    parted = [t for t in theirs.traces if out[t.index] != jout[t.index]]
    assert len(parted) <= 2
    assert all(_first_part_is_near_tie(planner, t, out[t.index])
               for t in parted)
    s, js = ours.summary(), theirs.summary()
    assert set(s) == set(js)
    for key in js:
        assert s[key] == js[key], key


def test_least_loaded_spreads_bursts(pool):
    reqs = make_workload(WorkloadConfig(
        n_sessions=12, seed=4, profile="bursty", burst_size=12,
        inter_arrival=1.0, max_new_tokens=2))
    s = mkcluster(pool, "least_loaded").run_workload(reqs).summary()
    assert s["finished"] == len(reqs)
    assert all(r["admissions"] >= 2 for r in s["per_replica"])
    assert all(r["utilization"] > 0 for r in s["per_replica"])


def test_cluster_stats_schema(pool):
    reqs = make_workload(WorkloadConfig(
        n_sessions=6, seed=1, max_new_tokens=2, sla_ticks=64))
    cl = mkcluster(pool, "intent_affinity")
    register_workload_prefixes(cl, reqs)
    stats = cl.run_workload(reqs)
    s = stats.summary()
    assert s["finished"] == s["requests"] == len(reqs)
    assert 1 <= s["ttft_p50"] <= s["ttft_p95"] <= s["e2e_p95"]
    assert 0 <= s["queue_wait_p50"] <= s["queue_wait_p95"]
    assert s["sla_attainment"] == 1.0
    assert s["tokens_out"] >= s["tokens_decoded"] > 0
    for t in stats.traces:
        assert t.finish_tick >= t.admit_tick >= t.arrival_tick
        assert t.request.finish_reason is not None


@pytest.mark.parametrize("max_ticks,max_turns,max_new,sla", [
    (100_000, 1, 1, 64),         # terminal-at-admission flood
    (2, 2, 8, 4),                # cut off: unfinished count as misses
], ids=["utilization_bounded_by_one", "sla_counts_unfinished_as_misses"])
def test_one_replica_flood(pool, max_ticks, max_turns, max_new, sla):
    reqs = make_workload(WorkloadConfig(
        n_sessions=8, seed=6, inter_arrival=0.0, max_turns=max_turns,
        max_new_tokens=max_new, sla_ticks=sla))
    s = mkcluster(pool, "least_loaded", n=1).run_workload(
        reqs, max_ticks=max_ticks).summary()
    assert s["requests"] == len(reqs)
    assert all(0.0 <= r["utilization"] <= 1.0 for r in s["per_replica"])
    if max_ticks < 100_000:
        assert s["finished"] < s["requests"]
        assert s["sla_attainment"] < 1.0
    else:
        assert s["finished"] == len(reqs)


def test_run_workload_requires_fresh_cluster_and_reset_recycles(pool):
    reqs = make_workload(WorkloadConfig(n_sessions=5, seed=9,
                                        max_new_tokens=2, temperature=0.8))
    cl = mkcluster(pool, "intent_affinity")
    register_workload_prefixes(cl, reqs)
    first = cl.run_workload(reqs)
    with pytest.raises(RuntimeError):
        cl.run_workload(reqs)
    cl.reset()
    assert cl.is_idle() and cl.tick == 0 and not cl.prefixes
    register_workload_prefixes(cl, reqs)
    again = cl.run_workload(reqs)
    assert again.outputs() == first.outputs()
    assert again.summary() == first.summary()


def test_run_workload_rejects_orphaned_followups(pool):
    reqs = make_workload(WorkloadConfig(n_sessions=4, seed=3,
                                        max_turns=3, max_new_tokens=2))
    orphans = [w for w in reqs if w.turn > 0]
    assert orphans
    with pytest.raises(ValueError, match="predecessor"):
        mkcluster(pool, "least_loaded").run_workload(orphans)


# -------------------------------------------------- pipeline integration ----

def test_pipeline_targets_cluster(planner):
    """GeckOptPipeline(engine=EngineCluster) serves every session's
    planner turn off a prefix on the session's home replica."""
    _, _, cfg, model = planner
    world = build_world(0)
    tasks = make_benchmark(world, 4)
    imap = build_intent_map(make_benchmark(world, 32), DEFAULT_REGISTRY)
    gate = IntentGate(imap, ScriptedIntentClassifier(
        1.0, np.random.default_rng(0)), DEFAULT_REGISTRY.libraries())
    agent = Agent(DEFAULT_REGISTRY, world,
                  PlannerConfig(mode="cot", few_shot=False), gate=gate,
                  seed=0)
    cluster = EngineCluster(cfg, model, 2, router="intent_affinity",
                            max_batch=2, cache_len=4096)
    pipe = GeckOptPipeline(agent, PipelineConfig(
        max_concurrent=4, engine_max_new_tokens=2), engine=cluster)
    results = pipe.run(tasks)
    assert len(results) == 4
    summ = pipe.stats.summary()
    assert summ["engine_replicas"] == 2 and summ["engine_backend"] == "cpu"
    assert summ["engine_turns"] == 4
    agg = cluster.throughput_stats()
    assert agg["admissions"] == agg["prefix_hits"] == 4
    assert len(cluster.prefixes) <= 4
    assert all(es.idle for es in pipe._engine_sessions)
    assert cluster.is_idle()
