"""The concurrent GeckOpt serving pipeline on the port, on the card unless
``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve_pipeline \
      [--requests 12] [--concurrency 8] [--retriever-k 8 --catalog-size 128]
      [--replicas 4 --router intent_affinity]

The counterpart of the JAX package's ``examples/serve_pipeline.py``, with
its flags and its summary lines:

  * a ``BatchedNeuralIntentClassifier`` gates each admission wave in ONE
    (Q*8, L) forward of the planner (``flash_prefill`` at Q*8 rows on
    the card);
  * ``GeckOptPipeline`` runs N sessions through gate → (retrieve →) plan
    → execute concurrently;
  * an ``InferenceEngine`` serves each session's first planner turn at
    T=0 off a prefix cached once per intent (or per retrieved toolset);
    with ``--replicas N`` an ``EngineCluster`` of N 4-slot replicas
    sharing the model does, its ``--router`` placing each session (under
    ``intent_affinity`` on its prefix's home replica).

By default it serves the planner's full config (``planner-proxy-100m``,
random weights from seed 0); ``--smoke`` takes its 2-layer variant.
``--arch`` takes only dense stacks of ``"full"`` layers whose vocabulary
holds the tokenizer's ids: the gate's forward is ported for that kind
alone, and the engine encodes text with the 8,192-id tokenizer. There is
no ``--backend``: the device decides which attention runs.

``main`` is the command line; ``serve_pipeline(cfg, model, args)`` runs
one pipeline for any model built for ``cfg`` and returns the run's
numbers as a dict, with the seconds and the kernel launches of the
gate's waves, the prefix prefills and the engine's (or the cluster's)
steps (each closed by a device synchronize) beside the whole run's.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.agent import Agent
from repro_torch.core.catalog import (build_catalog, catalog_intent_libraries,
                                      catalog_intent_map)
from repro_torch.core.gate import IntentGate
from repro_torch.core.intents import INTENTS, build_intent_map
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.retriever import ToolRetriever
from repro_torch.core.tools import DEFAULT_REGISTRY
from repro_torch.env.evaluator import evaluate_results
from repro_torch.env.tasks import make_benchmark
from repro_torch.env.world import build_world
from repro_torch.kernels import backend as KB
from repro_torch.models.model import count_params, init_params, \
    resolve_device
from repro_torch.obs import Tracer
from repro_torch.obs.export import write_trace
from repro_torch.serving.cluster import ROUTER_POLICIES, EngineCluster
from repro_torch.serving.engine import InferenceEngine, check_servable
from repro_torch.serving.neural_planner import BatchedNeuralIntentClassifier
from repro_torch.serving.pipeline import GeckOptPipeline, PipelineConfig
from repro_torch.serving.sched import ADMISSION_POLICIES
from repro_torch.serving.specdec import SpecConfig
from repro_torch.serving.tokenizer import TOKENIZER

#: the engine's (each replica's) slots, as in the JAX example
MAX_BATCH = 4
#: the timed phases of a run: the gate's waves, the prefix prefills and
#: the engine's steps (the planner turns); the rest of a run is the host's
PHASES = ("gate", "prefix", "turns")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="planner-proxy-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no card raises)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve planner turns on an EngineCluster of N "
                         "replicas instead of one engine")
    ap.add_argument("--router", default="intent_affinity",
                    choices=ROUTER_POLICIES,
                    help="cluster routing policy (with --replicas > 1)")
    ap.add_argument("--kv-mode", default="dense", choices=("dense", "paged"),
                    help="KV-cache manager for the engine: dense slabs or "
                         "the paged pool with CoW prefix sharing")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged: physical KV blocks (default: the dense "
                         "budget)")
    ap.add_argument("--block-size", type=int, default=None,
                    help="paged: tokens per KV block (default: 16)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding for planner turns with a "
                         "self-draft (tokens stay bitwise identical)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens per speculative round (>= 1)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="chunked prefill: max prompt tokens per engine "
                         "step, interleaved with decode")
    ap.add_argument("--admission", default="fifo",
                    choices=ADMISSION_POLICIES,
                    help="admission-queue order")
    ap.add_argument("--catalog-size", type=int, default=None,
                    help="serve a generated tool catalog of N tools "
                         "(default: the base registry)")
    ap.add_argument("--retriever-k", type=int, default=None,
                    help="expose only the retrieved top-k toolset per "
                         "request instead of the gated library catalog")
    ap.add_argument("--trace-out", default="",
                    help="write the pipeline + engine trace here (.jsonl "
                         "= record per line, else Chrome trace-event JSON)")
    return ap


def validate_args(ap: argparse.ArgumentParser, args):
    """Invalid combinations error before any model is built."""
    if args.replicas < 1:
        ap.error(f"--replicas must be >= 1, got {args.replicas}")
    if args.kv_mode == "dense" and (args.kv_blocks is not None
                                    or args.block_size is not None):
        ap.error("--kv-blocks/--block-size apply only to --kv-mode paged")
    if args.spec_decode and args.draft_k < 1:
        ap.error(f"--spec-decode needs --draft-k >= 1, got {args.draft_k}")
    for flag, v in (("--prefill-budget", args.prefill_budget),
                    ("--catalog-size", args.catalog_size),
                    ("--retriever-k", args.retriever_k)):
        if v is not None and v < 1:
            ap.error(f"{flag} must be >= 1, got {v}")
    if args.requests < 0 or args.concurrency < 1:
        ap.error("--requests must be >= 0 and --concurrency >= 1")
    return args


def parse_args(argv=None):
    ap = build_parser()
    return validate_args(ap, ap.parse_args(argv))


def check_arch(cfg) -> None:
    """The gate needs the forward-only train mode (``"full"`` layers only)
    and the engine encodes text with the 8,192-id tokenizer."""
    check_servable(cfg)
    kinds = set(cfg.layer_kinds())
    if kinds != {"full"} or cfg.vocab_size < TOKENIZER.vocab_size:
        raise ValueError(
            f"{cfg.name}: the pipeline serves dense 'full' stacks with a "
            f"vocabulary of at least {TOKENIZER.vocab_size} ids (got kinds "
            f"{sorted(kinds)}, vocab {cfg.vocab_size})")


def cache_len_for(args) -> int:
    """The engine's cache: it must hold the longest per-intent planner
    prefix (~2.5k tokens of system prompt + catalog) plus the turn
    suffix; generated catalogs serialize wider gated-library subsets, so
    they get more room."""
    return 8192 if (args.catalog_size or 0) > 48 else 4096


class _Phases:
    """Host seconds and kernel launches of named phases, each closed by a
    device synchronize so the card's queued work lands in the phase that
    issued it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = dict.fromkeys(PHASES, 0.0)
        self.launches = {ph: dict.fromkeys(KB.launch_counts(), 0)
                         for ph in PHASES}
        self.waves: List[float] = []

    def timed(self, phase: str, fn, *a, **kw):
        c0 = KB.launch_counts()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.seconds[phase] += dt
        for k, n in KB.launch_counts().items():
            self.launches[phase][k] += n - c0[k]
        if phase == "gate":
            self.waves.append(dt)
        return out


class _TimedGate(BatchedNeuralIntentClassifier):
    def __init__(self, cfg, model, clock: _Phases):
        super().__init__(cfg, model)
        self._phases = clock

    def losses(self, queries):
        return self._phases.timed("gate", super().losses, queries)


class _Timed:
    """Times an engine's or a cluster's prefix registrations and steps."""

    def __init__(self, *a, seconds: _Phases, **kw):
        super().__init__(*a, **kw)
        self._phases = seconds

    def register_prefix(self, key, prefix_text_or_ids):
        return self._phases.timed("prefix", super().register_prefix, key,
                                  prefix_text_or_ids)

    def step(self):
        return self._phases.timed("turns", super().step)


class _TimedEngine(_Timed, InferenceEngine):
    pass


class _TimedCluster(_Timed, EngineCluster):
    pass


def build_agent(args, classifier, world, device) -> Agent:
    """The platform of the JAX example: the base registry gated by an
    intent map built from 64 tasks, or a generated catalog of
    ``--catalog-size`` tools; with ``--retriever-k`` the retrieved top-k
    toolset is what each prompt serializes."""
    if args.catalog_size is not None:
        registry = build_catalog(args.catalog_size, seed=0)
        imap = catalog_intent_map(registry)
    else:
        registry = DEFAULT_REGISTRY
        imap = build_intent_map(make_benchmark(world, 64), registry)
    gate = IntentGate(imap, classifier, registry.libraries())
    retriever = None
    if args.retriever_k is not None:
        retriever = ToolRetriever(registry,
                                  catalog_intent_libraries(registry),
                                  k=args.retriever_k, device=device)
    return Agent(registry, world, PlannerConfig(mode="react", few_shot=False),
                 gate=gate, seed=0, retriever=retriever,
                 exposure="gated" if retriever is None else "retrieved")


def serve_pipeline(cfg, model, args, tasks: Optional[list] = None) -> dict:
    """Run ``args.requests`` tasks (or ``tasks``) through the pipeline
    with ``model``; prints the example's summary lines and returns the
    run's numbers."""
    check_arch(cfg)
    device = model.device
    clock = _Phases(device)
    spec = (SpecConfig(draft_cfg=cfg, draft_model=model, k=args.draft_k)
            if args.spec_decode else None)
    tracer = Tracer() if args.trace_out else None
    kw = dict(max_batch=MAX_BATCH, cache_len=cache_len_for(args),
              kv_mode=args.kv_mode, kv_blocks=args.kv_blocks,
              block_size=args.block_size, spec_decode=spec,
              prefill_budget=args.prefill_budget, admission=args.admission,
              tracer=tracer, seconds=clock)
    engine = (_TimedCluster(cfg, model, args.replicas, router=args.router,
                            **kw)
              if args.replicas > 1 else _TimedEngine(cfg, model, **kw))
    classifier = _TimedGate(cfg, model, clock)
    print(f"planner engine up: {count_params(model) / 1e6:.1f}M params on "
          f"{device}, {args.replicas} replica(s) x {MAX_BATCH} slots; "
          f"batched intent gate ready")
    world = build_world(0)
    if tasks is None:
        tasks = make_benchmark(world, args.requests)
    agent = build_agent(args, classifier, world, device)
    if args.retriever_k is not None:
        print(f"toolset retrieval on: top-{args.retriever_k} of "
              f"{len(agent.registry.tools)} tools exposed per request")
    pipe = GeckOptPipeline(
        agent, PipelineConfig(max_concurrent=args.concurrency),
        engine=engine, tracer=tracer)
    t0 = time.perf_counter()
    results = pipe.run(tasks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    rep = evaluate_results(results, "pipeline")
    ps = pipe.stats.summary()
    es = engine.throughput_stats()
    tasks_s = len(results) / max(dt, 1e-9)
    wave_ms = [1000 * s for s in clock.waves]
    print(f"\n{len(results)} sessions in {dt:.2f}s ({tasks_s:.2f} tasks/s, "
          f"{args.concurrency} concurrent)")
    mgb = ps["mean_gate_batch"]          # None when no wave ran
    print(f"gate:    {ps['gate_batches']} batched calls, mean wave "
          f"{'n/a' if mgb is None else f'{mgb:.1f}'} queries "
          f"(vs {len(INTENTS) * len(results)} B=1 forwards sequentially)"
          + (f", {sum(wave_ms) / len(wave_ms):.1f} ms/wave" if wave_ms
             else ""))
    print(f"engine:  {ps['engine_turns']} planner turns over "
          f"{len(engine.prefixes)} prefixes — {es['prefix_hits']} prefix "
          f"hits, {es['prefix_tokens_saved']} prefill tokens saved, "
          f"{es['tokens_generated']} tokens decoded")
    print(f"kv[{es['kv_mode']}]: peak {es['kv_bytes_peak'] / 2**20:.1f} "
          f"MiB of {es['kv_bytes_allocated'] / 2**20:.1f} MiB"
          + (f" | shared-block frac {es['kv_shared_frac']:.2f}, "
             f"{es['preemptions']} preemptions"
             if es["kv_mode"] == "paged" else ""))
    if args.retriever_k is not None:
        print(f"retrieve: {ps['retrievals']} toolsets retrieved "
              f"(top-{args.retriever_k}), {ps['retrieval_widens']} "
              f"miss-and-widen escalations")
    if spec is not None:
        print(f"spec-decode[k={args.draft_k}]: {es['tokens_per_step']:.2f} "
              f"tokens/target-forward, accept rate "
              f"{es['spec_accept_rate']:.2f} over {es['spec_rounds']} "
              f"rounds")
    if args.replicas > 1:
        for r in es["per_replica"]:
            print(f"  replica {r['replica']}: {r['admissions']} turns, "
                  f"{r['prefix_hits']} prefix hits, "
                  f"{r['tokens_generated']} tokens")
    print(f"quality: success={100 * rep.success_rate:.1f}% "
          f"tokens/task={rep.tokens_per_task / 1000:.2f}k "
          f"steps={rep.steps_per_task:.2f} "
          f"fallback={100 * rep.fallback_rate:.1f}%")
    print("(gate weights are random here, so fallback is high)")
    if tracer is not None:
        write_trace(tracer, args.trace_out)
        print(f"trace: {len(tracer.records)} records -> {args.trace_out}")
    secs = dict(clock.seconds, total=dt)
    secs["host"] = dt - clock.seconds["gate"] - clock.seconds["prefix"] \
        - clock.seconds["turns"]
    return {"results": results, "report": rep, "row": rep.row(),
            "pipeline": ps, "stats": es, "seconds": secs,
            "tasks_s": tasks_s, "gate_wave_ms": wave_ms,
            "launches": clock.launches,
            "decisions": [r.intent_predicted for r in results],
            "prefixes": sorted(engine.prefixes), "engine": engine,
            "agent": agent, "tasks": tasks,
            "turns": [(list(r.prompt), r.prefix_key, list(r.output))
                      for es_ in pipe._engine_sessions for r in es_.turns]}


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    check_arch(cfg)
    return serve_pipeline(cfg, init_params(cfg, seed=0, device=device), args)


if __name__ == "__main__":
    main()
