"""Quickstart: GeckOpt on one query, on the port.

  PYTHONPATH=src python -m repro_torch.launch.quickstart

The counterpart of the JAX package's ``examples/quickstart.py``, with
its printed lines: builds the synthetic GeoLLM-Engine platform, runs one
task with the full tool catalog and once with intent-gating, and prints
the token ledgers — the paper's Figure-1 story on a single query. NumPy
over the port's ``core/`` and ``env/``; no device. ``main`` is the
command line and returns the two runs' numbers.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.agent import Agent
from repro_torch.core.gate import IntentGate, ScriptedIntentClassifier
from repro_torch.core.intents import build_intent_map
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.tools import DEFAULT_REGISTRY
from repro_torch.env.tasks import make_benchmark
from repro_torch.env.world import build_world


def main(argv=None) -> dict:
    argparse.ArgumentParser().parse_args(argv)
    world = build_world(seed=0)
    tasks = make_benchmark(world, n_tasks=16)
    task = tasks[0]      # "Plot <sensor> images around <city> ..."
    print(f"Task: {task.query}\n")

    # offline phase: mine the intent -> API-library map from a task corpus
    intent_map = build_intent_map(tasks, DEFAULT_REGISTRY)
    print("Mined intent map (paper Table 1):")
    for intent, libs in sorted(intent_map.intent_to_libs.items()):
        print(f"  {intent:22s} -> {', '.join(libs)}")

    cfg = PlannerConfig(mode="react", few_shot=False)

    # 1) baseline: full 58-tool catalog in every planner prompt
    base_agent = Agent(DEFAULT_REGISTRY, world, cfg, gate=None, seed=0)
    r0 = base_agent.run_task(task)

    # 2) GeckOpt: one cheap intent call gates the catalog first
    gate = IntentGate(intent_map,
                      ScriptedIntentClassifier(0.97,
                                               np.random.default_rng(0)),
                      DEFAULT_REGISTRY.libraries())
    gk_agent = Agent(DEFAULT_REGISTRY, world, cfg, gate=gate, seed=0)
    r1 = gk_agent.run_task(task)

    print(f"\n{'':24s}{'full catalog':>14s}{'+GeckOpt':>12s}")
    print(f"{'intent':24s}{'—':>14s}{r1.intent_predicted:>12s}")
    for key in ("total_tokens", "plan_steps", "requests"):
        a = r0.ledger.summary()[key]
        b = r1.ledger.summary()[key]
        print(f"{key:24s}{a:>14,}{b:>12,}")
    print(f"{'tools executed':24s}{len(r0.executed_tools):>14}"
          f"{len(r1.executed_tools):>12}")
    red = 1 - r1.ledger.total_tokens / r0.ledger.total_tokens
    print(f"\ntoken reduction: {100 * red:.1f}%  "
          f"(paper: up to 24.6% across the 5k-task benchmark)")
    return {"task": task.query, "intent": r1.intent_predicted,
            "full_catalog": r0.ledger.summary(),
            "geckopt": r1.ledger.summary(), "token_reduction": red}


if __name__ == "__main__":
    main()
