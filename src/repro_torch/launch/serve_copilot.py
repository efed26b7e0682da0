"""End-to-end driver: serve the Copilot platform on the port, on the card
unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve_copilot \
      [--requests 12] [--device cpu]

The counterpart of the JAX package's ``examples/serve_copilot.py``, with
its printed lines (the last one's seconds and tok/s are this run's).
Trains nothing: builds the planner-proxy LM's smoke config (random
weights from seed 0), serves it with the batched inference engine (4
slots, a 256-row cache), drives the agent loop over a stream of user
queries with GeckOpt gating off and on, reporting tokens and the planner
FLOPs they cost, then serves each query's gate prompt through the
engine (4 new tokens at T=0, continuous batching over the 4 slots).

``main`` is the command line; ``serve_copilot(cfg, model, args)`` runs
the example for any model built for ``cfg`` and returns the run's
numbers as a dict: the two agent reports, the engine's tokens by
request and its seconds.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.agent import Agent
from repro_torch.core.gate import IntentGate, ScriptedIntentClassifier
from repro_torch.core.intents import build_intent_map
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.tools import DEFAULT_REGISTRY
from repro_torch.env.evaluator import evaluate
from repro_torch.env.tasks import make_benchmark
from repro_torch.env.world import build_world
from repro_torch.models.model import count_params, init_params, \
    resolve_device
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampling import SamplerConfig

ARCH = "planner-proxy-100m"
#: the engine of the JAX example: slots, cache rows, new tokens a request
MAX_BATCH, CACHE_LEN, MAX_NEW = 4, 256, 4
#: the prefix of each gate prompt the engine serves
GATE_PROMPT = "classify intent: "


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no card raises)")
    return ap


def serve_copilot(cfg, model, args) -> dict:
    """The example's run with ``model``; prints its lines and returns
    the run's numbers."""
    device = model.device
    # --- the serving fleet: our own engine hosting the planner LM --------
    engine = InferenceEngine(cfg, model, max_batch=MAX_BATCH,
                             cache_len=CACHE_LEN)
    n_params = count_params(model)
    print(f"planner engine up: {n_params/1e6:.1f}M params, "
          f"{MAX_BATCH} slots")

    # --- the platform ------------------------------------------------------
    world = build_world(0)
    tasks = make_benchmark(world, args.requests)
    imap = build_intent_map(make_benchmark(world, 64), DEFAULT_REGISTRY)
    gate = IntentGate(imap, ScriptedIntentClassifier(
        0.97, np.random.default_rng(0)), DEFAULT_REGISTRY.libraries())
    pcfg = PlannerConfig(mode="react", few_shot=False)

    reports = {}
    for label, g in (("full-catalog", None), ("geckopt", gate)):
        agent = Agent(DEFAULT_REGISTRY, world, pcfg, gate=g, seed=0)
        rep = evaluate(agent, tasks, label)
        reports[label] = rep.row()
        # every planner token the agent consumed becomes engine prefill
        # work: 2*N flops/token — the paper's cloud-cost link
        flops = 2 * n_params * rep.tokens_per_task
        print(f"{label:14s} success={100*rep.success_rate:5.1f}% "
              f"tokens/task={rep.tokens_per_task/1000:6.2f}k "
              f"steps={rep.steps_per_task:.2f} "
              f"-> {flops:.2e} planner FLOPs/task")

    # --- batched engine serving of the actual gate prompts ----------------
    t0 = time.perf_counter()
    rids = [engine.add_request(GATE_PROMPT + t.query,
                               max_new_tokens=MAX_NEW,
                               sampler=SamplerConfig(temperature=0.0))
            for t in tasks]
    done = engine.run_until_done()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    st = engine.throughput_stats()
    tok_s = st["tokens_generated"] / max(dt, 1e-9)
    print(f"\ngate traffic served by the engine: {len(done)} requests in "
          f"{dt:.2f}s ({tok_s:.1f} tok/s, "
          f"continuous batching over {MAX_BATCH} slots)")
    by_id = {r.request_id: r for r in done}
    return {"reports": reports,
            "prompts": [list(by_id[i].prompt) for i in rids],
            "outputs": [list(by_id[i].output) for i in rids],
            "requests": len(done), "seconds": dt, "tok_s": tok_s}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(ARCH)
    return serve_copilot(cfg, init_params(cfg, seed=0, device=device), args)


if __name__ == "__main__":
    main()
