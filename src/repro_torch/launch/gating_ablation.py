"""Ablation: how the paper's trade-off moves with gate quality and
intent-map granularity, on the port.

  PYTHONPATH=src python -m repro_torch.launch.gating_ablation

The counterpart of the JAX package's ``examples/gating_ablation.py``,
with its printed lines. Sweeps (a) classifier accuracy, (b) coverage
quantile of the offline mining phase (narrower vs safer library sets),
and reports token reduction vs success delta — the operating curve
behind the paper's "negligible performance degradation within 1%"
claim. NumPy over the port's ``core/`` and ``env/``; no device.
``main`` is the command line and returns each sweep's rows.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.agent import Agent
from repro_torch.core.gate import IntentGate, ScriptedIntentClassifier
from repro_torch.core.intents import build_intent_map
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.tools import DEFAULT_REGISTRY
from repro_torch.env.evaluator import evaluate
from repro_torch.env.tasks import make_benchmark
from repro_torch.env.world import build_world

#: sweep 1's classifier accuracies and sweep 2's coverage quantiles
ACCURACIES = (1.0, 0.97, 0.9, 0.75, 0.5)
COVERAGES = (0.999, 0.98, 0.9, 0.75)


def _gated(world, tasks, cfg, imap, acc: float, name: str):
    gate = IntentGate(imap, ScriptedIntentClassifier(
        acc, np.random.default_rng(0)), DEFAULT_REGISTRY.libraries())
    return evaluate(Agent(DEFAULT_REGISTRY, world, cfg, gate=gate,
                          seed=0), tasks, name)


def main(argv=None) -> dict:
    argparse.ArgumentParser().parse_args(argv)
    world = build_world(0)
    tasks = make_benchmark(world, 96)
    corpus = make_benchmark(world, 256, seed=3)
    cfg = PlannerConfig(mode="cot", few_shot=False)
    base = evaluate(Agent(DEFAULT_REGISTRY, world, cfg, gate=None,
                          seed=0), tasks, "base")
    print(f"baseline: {base.tokens_per_task/1000:.2f}k tokens/task, "
          f"success {100*base.success_rate:.1f}%\n")

    def row(r, **kw):
        return dict(kw, token_reduction=1 - r.tokens_per_task
                    / base.tokens_per_task,
                    success_delta=r.success_rate - base.success_rate,
                    fallback_rate=r.fallback_rate)

    print("=== sweep 1: gate accuracy (coverage_q=0.98) ===")
    imap = build_intent_map(corpus, DEFAULT_REGISTRY, coverage_q=0.98)
    accuracy = []
    for acc in ACCURACIES:
        r = _gated(world, tasks, cfg, imap, acc, f"acc{acc}")
        red = 1 - r.tokens_per_task / base.tokens_per_task
        print(f"  acc={acc:4.2f}: -{100*red:5.1f}% tokens, success "
              f"{100*(r.success_rate-base.success_rate):+5.1f}pp, "
              f"fallback {100*r.fallback_rate:4.1f}%")
        accuracy.append(row(r, acc=acc))

    print("\n=== sweep 2: offline-mining coverage quantile ===")
    coverage = []
    for q in COVERAGES:
        imap = build_intent_map(corpus, DEFAULT_REGISTRY, coverage_q=q)
        n_libs = np.mean([len(v) for v in imap.intent_to_libs.values()])
        r = _gated(world, tasks, cfg, imap, 0.97, f"q{q}")
        red = 1 - r.tokens_per_task / base.tokens_per_task
        print(f"  q={q:5.3f} (avg {n_libs:.1f} libs/intent): "
              f"-{100*red:5.1f}% tokens, success "
              f"{100*(r.success_rate-base.success_rate):+5.1f}pp, "
              f"fallback {100*r.fallback_rate:4.1f}%")
        coverage.append(row(r, coverage_q=q, libs_per_intent=n_libs))
    return {"baseline": base.row(), "accuracy": accuracy,
            "coverage": coverage}


if __name__ == "__main__":
    main()
