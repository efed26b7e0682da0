"""Train the neural intent classifier (the GeckOpt gate) end to end, on
the card unless ``--device cpu`` is given.

The counterpart of the JAX package's ``examples/train_planner.py``:
trains the planner-proxy LM on (query -> intent) pairs generated by the
synthetic platform (``make_intent_dataset``: 512 training tasks, 16 rows
of 64 tokens a step, AdamW at lr 1e-3, no remat), reports the trained
gate's intent accuracy on held-out tasks, plugs it into the Table-2
harness against the ungated agent (tokens/task, success, fallback) and
saves its weights in the JAX package's npz format, which
``launch.serve --checkpoint`` and ``training.checkpoint.load_checkpoint``
read.

  PYTHONPATH=src python -m repro_torch.launch.train_planner \
      [--steps 300] [--eval-tasks 48] [--full] [--device cpu]

The default is the example's smoke config; ``--full`` trains the full
planner-proxy-100m. The gate scores a query's 8 intents in one forward
(``BatchedNeuralIntentClassifier``), whose decisions are the single-row
classifier's exactly. ``main`` is the command line and returns the
run's numbers.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.agent import Agent
from repro_torch.core.gate import IntentGate
from repro_torch.core.intents import build_intent_map
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.tools import DEFAULT_REGISTRY
from repro_torch.env.evaluator import evaluate
from repro_torch.env.tasks import make_benchmark
from repro_torch.env.world import build_world
from repro_torch.models.model import init_params, resolve_device
from repro_torch.serving.neural_planner import \
    BatchedNeuralIntentClassifier, make_intent_dataset
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import adamw_init

ARCH = "planner-proxy-100m"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--eval-tasks", type=int, default=48)
    ap.add_argument("--checkpoint", default="build/planner_gate.npz")
    ap.add_argument("--full", action="store_true",
                    help="train the full planner-proxy-100m (default: the "
                         "smoke config)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    world = build_world(0)
    train_tasks = make_benchmark(world, 512, seed=1)
    eval_tasks = make_benchmark(world, args.eval_tasks, seed=2)

    cfg = get_config(ARCH) if args.full else get_smoke_config(ARCH)
    model = init_params(cfg, seed=0, device=device).requires_grad_(True)
    opt = adamw_init(model)
    step_fn = make_train_step(cfg, lr=1e-3, remat=False)
    data = make_intent_dataset(train_tasks, seq_len=64, batch=16)

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        model, opt, metrics = step_fn(model, opt, next(data))
        losses.append(metrics["loss"])
        if step % 50 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"({time.time() - t0:.0f}s)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t0

    clf = BatchedNeuralIntentClassifier(cfg, model)
    decisions = [d[0] for d in clf.classify_batch(
        [t.query for t in eval_tasks])]
    acc = sum(d == t.intent for d, t in zip(decisions, eval_tasks)) \
        / max(len(eval_tasks), 1)
    print(f"\nneural gate intent accuracy: {100 * acc:.1f}% "
          f"on {len(eval_tasks)} held-out tasks")

    # plug the trained gate into the agent pipeline
    imap = build_intent_map(train_tasks, DEFAULT_REGISTRY)
    gate = IntentGate(imap, clf, DEFAULT_REGISTRY.libraries())
    pcfg = PlannerConfig(mode="cot", few_shot=False)
    base = evaluate(Agent(DEFAULT_REGISTRY, world, pcfg, gate=None,
                          seed=0), eval_tasks, "base")
    neural = evaluate(Agent(DEFAULT_REGISTRY, world, pcfg, gate=gate,
                            seed=0), eval_tasks, "neural-gate")
    red = 1 - neural.tokens_per_task / base.tokens_per_task
    print(f"tokens/task {base.tokens_per_task / 1000:.2f}k -> "
          f"{neural.tokens_per_task / 1000:.2f}k ({100 * red:.1f}% "
          f"reduction) | success {100 * base.success_rate:.1f}% -> "
          f"{100 * neural.success_rate:.1f}% | fallback "
          f"{100 * neural.fallback_rate:.1f}%")

    save_checkpoint(args.checkpoint, model)
    print(f"gate checkpoint -> {args.checkpoint}")
    return {"cfg": cfg.name, "steps": args.steps, "train_seconds": train_s,
            "losses": [float(x) for x in losses], "accuracy": acc,
            "eval_tasks": len(eval_tasks), "decisions": decisions,
            "base": {"tokens_per_task": base.tokens_per_task,
                     "success_rate": base.success_rate},
            "neural": {"tokens_per_task": neural.tokens_per_task,
                       "success_rate": neural.success_rate,
                       "fallback_rate": neural.fallback_rate},
            "token_reduction": red, "checkpoint": args.checkpoint,
            "device": str(device)}


if __name__ == "__main__":
    main()
