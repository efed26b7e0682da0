"""The port's GeckOpt agent side (``repro_torch.core``, ``repro_torch.env``)
against the JAX package's, on the same seeds.

The copied modules must replay the reference exactly: the Table-2 row of
``evaluate`` with the scripted gate (every exposure, plan compiler on and
off) is compared for equality, as are the tokens per task and the gate's
tokens. The retriever's scores are computed by torch (fp32, TF32 off)
instead of a jitted JAX product, so they are held within 1e-5; what the
serving path reads — each retrieval's exposed top-k, its ``key_str`` and
the ``widen_once`` sequence — is held exactly. The full ranking is not:
the reference's own batched and single-query rankings differ in the tail
(its failing ``test_ranking_deterministic_and_batch_matches_single``).
"""
import numpy as np
import pytest

from repro.core import catalog as JC
from repro.core import retriever as JR
from repro.core.agent import Agent as JAgent
from repro.core.gate import IntentGate as JGate
from repro.core.gate import ScriptedIntentClassifier as JScripted
from repro.core.intents import build_intent_map as j_intent_map
from repro.core.planner import PlannerConfig as JPlannerConfig
from repro.core.tools import DEFAULT_REGISTRY as J_REGISTRY
from repro.env.evaluator import evaluate as j_evaluate
from repro.env.tasks import make_benchmark as j_benchmark
from repro.env.world import build_world as j_world
from repro_torch.core import catalog as TC
from repro_torch.core import retriever as TR
from repro_torch.core.agent import Agent as TAgent
from repro_torch.core.gate import IntentGate as TGate
from repro_torch.core.gate import ScriptedIntentClassifier as TScripted
from repro_torch.core.intents import build_intent_map as t_intent_map
from repro_torch.core.planner import PlannerConfig as TPlannerConfig
from repro_torch.core.tools import DEFAULT_REGISTRY as T_REGISTRY
from repro_torch.env.evaluator import evaluate as t_evaluate
from repro_torch.env.tasks import make_benchmark as t_benchmark
from repro_torch.env.world import build_world as t_world

N_TASKS = 40
SCORE_TOL = 1e-5
SIZES = (8, 48, 128, 512)
QUERIES = ["plot xview1 images near Tampa Bay",
           "how many ships are in the harbor",
           "transcribe the briefing recording",
           "what is the dominant land cover around Lagos",
           "search the web for the latest flood report",
           "tabulate the detections per image with a python script"]
INTENTS = ["load_filter_plot", "detection_analysis", None,
           "landcover_analysis", "ui_web_navigation", "code_analysis"]


@pytest.fixture(scope="module")
def sides():
    """(world, tasks, intent map) of each package at seed 0."""
    jw, tw = j_world(0, n_images=200), t_world(0, n_images=200)
    jt, tt = j_benchmark(jw, N_TASKS), t_benchmark(tw, N_TASKS)
    return ((jw, jt, j_intent_map(j_benchmark(jw, 64), J_REGISTRY)),
            (tw, tt, t_intent_map(t_benchmark(tw, 64), T_REGISTRY)))


def test_copied_generators_replay_the_reference(sides):
    (jw, jt, jmap), (tw, tt, tmap) = sides
    assert [(t.query, t.intent, repr(t.plan)) for t in jt] == \
        [(t.query, t.intent, repr(t.plan)) for t in tt]
    assert jmap.intent_to_libs == tmap.intent_to_libs
    assert J_REGISTRY.catalog_text() == T_REGISTRY.catalog_text()
    for n in SIZES:
        assert JC.build_catalog(n).catalog_text() == \
            TC.build_catalog(n).catalog_text()


def _agent(pkg, side, exposure, compile_plans):
    world, _, imap = side
    if pkg == "jax":
        Agent, Gate, Scripted, PC, reg = (JAgent, JGate, JScripted,
                                          JPlannerConfig, J_REGISTRY)
        retr = lambda: JR.ToolRetriever(
            reg, JC.catalog_intent_libraries(reg), k=8)
    else:
        Agent, Gate, Scripted, PC, reg = (TAgent, TGate, TScripted,
                                          TPlannerConfig, T_REGISTRY)
        retr = lambda: TR.ToolRetriever(
            reg, TC.catalog_intent_libraries(reg), k=8, device="cpu")
    gate = Gate(imap, Scripted(0.9, np.random.default_rng(0)),
                reg.libraries())
    return Agent(reg, world, PC(mode="react", few_shot=False,
                                compile_plans=compile_plans),
                 gate=gate, seed=0, exposure=exposure,
                 retriever=retr() if exposure == "retrieved" else None)


@pytest.mark.parametrize("compile_plans", [False, True],
                         ids=["linear", "compiled"])
@pytest.mark.parametrize("exposure", ["gated", "all", "retrieved"])
def test_table2_row_equals_the_reference(sides, exposure, compile_plans):
    jside, tside = sides
    j = j_evaluate(_agent("jax", jside, exposure, compile_plans), jside[1])
    t = t_evaluate(_agent("torch", tside, exposure, compile_plans),
                   tside[1])
    assert t.row() == j.row()
    assert (t.tokens_per_task, t.gate_tokens, t.n_tasks) == \
        (j.tokens_per_task, j.gate_tokens, j.n_tasks)


@pytest.mark.parametrize("n", SIZES)
def test_retriever_exposures_equal_the_reference(n):
    jreg, treg = JC.build_catalog(n, seed=0), TC.build_catalog(n, seed=0)
    jr = JR.ToolRetriever(jreg, JC.catalog_intent_libraries(jreg), k=8)
    tr = TR.ToolRetriever(treg, TC.catalog_intent_libraries(treg), k=8,
                          device="cpu")
    feats = jr.embedder.featurize_batch(QUERIES)
    rows = np.array([jr._intent_row.get(i, len(jr.intents))
                     for i in INTENTS])
    jscores = np.asarray(JR._fused_scores(
        feats, jr._tool_feats, jr._prior[rows], np.float32(jr.prior_weight)))
    np.testing.assert_allclose(tr.scores(feats, rows), jscores,
                               atol=SCORE_TOL, rtol=0)
    for single in (False, True):
        if single:
            je = [jr.retrieve(q, i) for q, i in zip(QUERIES, INTENTS)]
            te = [tr.retrieve(q, i) for q, i in zip(QUERIES, INTENTS)]
        else:
            je = jr.retrieve_batch(QUERIES, INTENTS)
            te = tr.retrieve_batch(QUERIES, INTENTS)
        for a, b in zip(je, te):
            for _ in range(4):              # k 8 -> 16 -> 32 -> 64 -> 128
                assert b.exposed == a.exposed and b.key_str == a.key_str
                assert (b.k, b.widens) == (a.k, a.widens)
                assert b.catalog_text(treg) == a.catalog_text(jreg)
                a.widen_once()
                b.widen_once()


def test_retriever_runs_on_the_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.ToolRetriever(T_REGISTRY, TC.catalog_intent_libraries(T_REGISTRY))
