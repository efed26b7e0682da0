"""The port's concurrent GeckOpt pipeline (``serving/pipeline.py``) and its
launchers (``launch/serve_pipeline.py``, ``launch/serve.py`` with
retrieval), within the port and against the JAX package's.

Within the port the pipeline's Table-2 row equals the sequential
harness's, with and without an engine. Against JAX, on 5 tasks with the
smoke planner's engine (the JAX weights through the bridge), the task
results, the engine's prefix keys, prefix hits and turns are equal;
the engine's tokens are not compared across frameworks (logits agree
within tests/test_torch_model.py's 0.05, so a near-tie argmax may flip).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving import engine as JE
from repro_torch.configs import get_smoke_config
from repro_torch.core.agent import Agent
from repro_torch.core.gate import IntentGate, ScriptedIntentClassifier
from repro_torch.core.intents import build_intent_map
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.tools import DEFAULT_REGISTRY
from repro_torch.env.evaluator import evaluate, evaluate_results
from repro_torch.env.tasks import make_benchmark
from repro_torch.env.world import build_world
from repro_torch.launch import serve as SV
from repro_torch.launch import serve_pipeline as SP
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.neural_planner import NeuralIntentClassifier
from repro_torch.serving.pipeline import (GeckOptPipeline, PipelineConfig,
                                          evaluate_pipeline)


@pytest.fixture(scope="module")
def world():
    return build_world(0, n_images=200)


@pytest.fixture(scope="module")
def tasks(world):
    return make_benchmark(world, 32)


@pytest.fixture(scope="module")
def intent_map(world):
    return build_intent_map(make_benchmark(world, 64), DEFAULT_REGISTRY)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke("planner-proxy-100m")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jp),
                              get_smoke_config("planner-proxy-100m"), "cpu")
    return jcfg, jp, model


def _agent(world, intent_map, gated=True, compile_plans=False):
    gate = (IntentGate(intent_map, ScriptedIntentClassifier(
        0.97, np.random.default_rng(0)), DEFAULT_REGISTRY.libraries())
        if gated else None)
    return Agent(DEFAULT_REGISTRY, world,
                 PlannerConfig(mode="react", few_shot=False,
                               compile_plans=compile_plans),
                 gate=gate, seed=0)


def _fingerprint(r):
    ws = r.workspace
    return (tuple(r.executed_tools), r.completed_plan, r.fallback_used,
            r.intent_predicted, r.steps, tuple(ws.handles),
            ws.last_answer, str(ws.rng.bit_generator.state),
            r.ledger.total_tokens)


@pytest.mark.parametrize("gated,compile_plans", [
    (True, False), (False, False), (True, True)],
    ids=["gated", "ungated", "gated_compiled"])
def test_pipeline_row_equals_the_sequential_harness(world, tasks, intent_map,
                                                    gated, compile_plans):
    seq = evaluate(_agent(world, intent_map, gated, compile_plans), tasks)
    par = evaluate_pipeline(_agent(world, intent_map, gated, compile_plans),
                            tasks, max_concurrent=7)
    assert seq.row() == par.row()
    assert (seq.tokens_per_task, seq.gate_tokens) == \
        (par.tokens_per_task, par.gate_tokens)


def test_engine_mirroring_keeps_the_results(world, tasks, intent_map, pair):
    _, _, model = pair
    engine = InferenceEngine(model.cfg, model, max_batch=2, cache_len=4096)
    pipe = GeckOptPipeline(_agent(world, intent_map),
                           PipelineConfig(max_concurrent=4,
                                          engine_max_new_tokens=2),
                           engine=engine)
    mirrored = pipe.run(tasks[:6])
    plain = GeckOptPipeline(_agent(world, intent_map),
                            PipelineConfig(max_concurrent=4)).run(tasks[:6])
    assert [_fingerprint(r) for r in mirrored] == \
        [_fingerprint(r) for r in plain]
    st = engine.throughput_stats()
    assert pipe.stats.engine_turns == st["prefix_hits"] == 6
    assert st["prefills"] == st["prefix_registrations"] == \
        len(engine.prefixes)
    assert pipe.stats.summary()["engine_backend"] == "cpu"
    assert all(es.idle and len(es.turns) == 1
               and len(es.turns[0].output) == 2
               for es in pipe._engine_sessions)


def _engine_run(pkg, engine):
    """5 tasks through ``pkg``'s pipeline (a namespace of one package's
    modules) with a scripted gate, mirrored on ``engine``."""
    world = pkg.world.build_world(0, n_images=200)
    tasks = pkg.tasks.make_benchmark(world, 5)
    reg = pkg.tools.DEFAULT_REGISTRY
    imap = pkg.intents.build_intent_map(
        pkg.tasks.make_benchmark(world, 64), reg)
    gate = pkg.gate.IntentGate(imap, pkg.gate.ScriptedIntentClassifier(
        0.97, np.random.default_rng(0)), reg.libraries())
    agent = pkg.agent.Agent(reg, world, pkg.planner.PlannerConfig(
        mode="react", few_shot=False), gate=gate, seed=0)
    pipe = pkg.pipeline.GeckOptPipeline(agent, pkg.pipeline.PipelineConfig(
        max_concurrent=4, engine_max_new_tokens=2), engine=engine)
    results = pipe.run(tasks)
    st = engine.throughput_stats()
    return ([_fingerprint(r) for r in results],
            pkg.evaluator.evaluate_results(results).row(),
            sorted(engine.prefixes), st["prefix_hits"],
            pipe.stats.engine_turns, st["tokens_generated"])


def _modules(top):
    import importlib
    names = {"world": "env.world", "tasks": "env.tasks",
             "evaluator": "env.evaluator", "tools": "core.tools",
             "intents": "core.intents", "gate": "core.gate",
             "agent": "core.agent", "planner": "core.planner",
             "pipeline": "serving.pipeline"}
    return SimpleNamespace(**{k: importlib.import_module(f"{top}.{v}")
                              for k, v in names.items()})


def test_pipeline_with_engine_equals_the_reference(pair):
    """The same task results and the same prefix keys, hits, turns and
    token counts as the JAX pipeline on the JAX engine."""
    jcfg, jp, model = pair
    assert _engine_run(_modules("repro_torch"), InferenceEngine(
        model.cfg, model, max_batch=2, cache_len=4096)) == \
        _engine_run(_modules("repro"), JE.InferenceEngine(
            jcfg, jp, max_batch=2, cache_len=4096))


def test_pipeline_refuses_a_cluster(world, intent_map):
    """The refusal is lifted since the cluster was ported: a cluster is
    taken, its replica count and replica 0's scheduling knobs recorded
    (tests/test_torch_cluster.py serves a real one)."""
    cluster = SimpleNamespace(
        device=torch.device("cpu"), kv_mode="paged", spec_k=3,
        replicas=[SimpleNamespace(prefill_budget=64, admission="slack"),
                  SimpleNamespace(prefill_budget=None, admission="fifo")])
    summ = GeckOptPipeline(_agent(world, intent_map),
                           engine=cluster).stats.summary()
    assert (summ["engine_replicas"], summ["engine_kv_mode"],
            summ["engine_spec_k"], summ["engine_prefill_budget"],
            summ["engine_admission"]) == (2, "paged", 3, 64, "slack")


# -------------------------------------------------------------- launchers --

def test_serve_with_retrieval_runs_on_the_cpu(capsys):
    res = SV.main(["--smoke", "--device", "cpu", "--retriever-k", "4",
                   "--catalog-size", "64", "--requests", "4", "--max-new",
                   "3", "--max-batch", "2", "--temperature", "0"])
    out = capsys.readouterr().out
    assert "retrieval[k=4, catalog=64 tools]" in out
    assert res["requests"] == 4
    assert res["stats"]["prefix_hits"] == 4
    assert res["stats"]["prefills"] == res["toolset_prefixes"] >= 1


@pytest.mark.parametrize("argv,msg", [
    (["--replicas", "2"], "A6"),
    (["--router", "intent_affinity"], "A6"),
    (["--backend", "pallas"], "unrecognized"),
    (["--kv-blocks", "8"], "paged"),
    (["--retriever-k", "0"], "--retriever-k"),
    (["--spec-decode", "--draft-k", "0"], "--draft-k"),
    (["--replicas", "0"], "--replicas"),
    (["--replicas", "2", "--router", "random"], "--router"),
])
def test_serve_pipeline_refusals(argv, msg, capsys):
    if msg == "A6":
        # refused until the cluster (queue A6) was ported: parses now
        args = SP.parse_args(argv)
        assert (args.replicas, args.router) == (
            2 if "--replicas" in argv else 1, "intent_affinity")
        return
    with pytest.raises(SystemExit):
        SP.parse_args(argv)
    assert msg in capsys.readouterr().err


def test_serve_pipeline_refuses_other_stacks_and_needs_a_card():
    with pytest.raises(ValueError, match="'full' stacks"):
        SP.main(["--device", "cpu", "--smoke", "--arch", "xlstm-125m"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            SP.main(["--smoke", "--requests", "1"])


def test_serve_pipeline_cpu_run_equals_the_sequential_harness(capsys):
    """The launcher's run (batched neural gate, engine turns) gives the
    row of the sequential harness with the single-query neural gate."""
    res = SP.main(["--device", "cpu", "--smoke", "--requests", "5",
                   "--concurrency", "3"])
    out = capsys.readouterr().out
    for line in ("sessions in", "gate:", "engine:", "kv[dense]",
                 "quality:"):
        assert line in out
    model = res["engine"].model
    agent = SP.build_agent(SP.parse_args(["--device", "cpu"]),
                           NeuralIntentClassifier(model.cfg, model),
                           res["agent"].world, model.device)
    seq = [agent.run_task(t, task_seed=i)
           for i, t in enumerate(res["tasks"])]
    assert evaluate_results(seq).row() == res["row"]
    assert [r.intent_predicted for r in seq] == res["decisions"]
    st = res["stats"]
    assert st["prefix_hits"] == res["pipeline"]["engine_turns"] == 5
    assert st["prefix_registrations"] == len(res["prefixes"])
    assert len(res["gate_wave_ms"]) == res["pipeline"]["gate_batches"]


def test_serve_pipeline_on_a_cluster_gives_the_single_engine_row(capsys):
    """``--replicas 2 --router intent_affinity``: the same Table-2 row and
    gate decisions as one engine, every turn a prefix hit, the turns
    spread over the replicas."""
    base = ["--device", "cpu", "--smoke", "--requests", "5",
            "--concurrency", "3"]
    one = SP.main(base)
    res = SP.main(base + ["--replicas", "2", "--router", "intent_affinity"])
    out = capsys.readouterr().out
    assert "2 replica(s) x 4 slots" in out and "replica 1:" in out
    assert res["row"] == one["row"]
    assert res["decisions"] == one["decisions"]
    assert res["pipeline"]["engine_replicas"] == 2
    st = res["stats"]
    assert st["prefix_hits"] == res["pipeline"]["engine_turns"] == 5
    assert sum(r["admissions"] for r in st["per_replica"]) == 5
    assert sorted(res["prefixes"]) == sorted(one["prefixes"])
