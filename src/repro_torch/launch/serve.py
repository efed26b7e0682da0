"""Serving launcher of the port: run the inference engine on a batch of
requests, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --requests 4 --max-new 8 [--kv-mode paged] [--spec-decode]

With ``--replicas N`` (N > 1) it serves a synthetic mixed-intent workload
(serving/workload.py) on an N-replica ``EngineCluster`` instead (the
replicas share the model and its device) and reports the cluster's tick
metrics beside the wall seconds:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --replicas 2 --router intent_affinity --requests 8 --profile bursty \
      --skew 0.7 [--turns 2] [--sla-spill]

The command line is the JAX launcher's (``repro.launch.serve``) plus
``--device``; ``--arch`` takes the port's ids (``configs.ALL_IDS``: the
planner, the MoE families arctic-480b and kimi-k2-1t-a32b, the hybrid
attention + SSM hymba-1.5b, the recurrent xlstm-125m and the dense
qwen1.5-32b, qwen1.5-110b, starcoder2-3b and gemma2-2b; qwen2-vl-72b and
whisper-large-v3 are refused with the engine's NotImplementedError
before a model is built, as ``serving/engine.py:check_servable`` says
why).
``--backend`` is gone: the device decides which attention runs (Hopper
kernels on CUDA tensors, their plain versions on the CPU).
``--kv-mode paged`` (with ``--kv-blocks``, ``--block-size``) serves from
the paged block pool; ``--spec-decode`` drafts ``--draft-k`` tokens per
slot with a self-draft (the target's own weights: the repo ships no
trained draft) and verifies them in one target forward. hymba's
sliding-window rings and SSM state take none of these three, nor do
starcoder2's and gemma2's rings (``"local"`` layers): for them
``--kv-mode paged``, ``--prefill-budget`` and ``--spec-decode`` fail
with the engine's ``ValueError``, as in the JAX launcher. xlstm takes
``--prefill-budget`` (its state extends without padding) and refuses
the other two likewise. The cluster flags (``--router``, ``--profile``,
``--skew``, ``--turns``, ``--sla-spill``) are the JAX launcher's.
``--retriever-k`` retrieves a top-k toolset per request from
the base registry or, with ``--catalog-size``, a generated catalog
(``core/retriever.py``, scored on the model's device), registers each
toolset's catalog text as a shared engine prefix and prepends it to the
request's prompt, as the JAX launcher does; the cache grows to hold the
widest toolset prefix. ``--checkpoint`` loads a JAX-package npz through
the weight bridge. ``main`` is the command line: it builds the model and
hands it to ``serve``, which runs the engine (or, with ``--replicas``,
``serve_cluster`` the cluster) for any ``(cfg, model, args)`` (a
depth-cut full-width config, say) and returns the run's numbers as a
dict. Prompts are encoded into the model's vocabulary: the
engine's tokenizer folded into the config's ``vocab_size`` where that is
smaller than the tokenizer's (the smoke configs' 512 ids); the full
configs' vocabularies (32,001 to 256,000 ids) hold it whole.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.catalog import build_catalog, catalog_intent_libraries
from repro_torch.core.retriever import ToolRetriever
from repro_torch.core.tools import DEFAULT_REGISTRY
from repro_torch.models.convert import load_jax_checkpoint, \
    params_from_numpy
from repro_torch.models.model import init_params, resolve_device
from repro_torch.obs import Tracer
from repro_torch.obs.export import write_trace
from repro_torch.serving.cluster import ROUTER_POLICIES, EngineCluster
from repro_torch.serving.engine import InferenceEngine, check_servable
from repro_torch.serving.sampling import SamplerConfig
from repro_torch.serving.sched import ADMISSION_POLICIES
from repro_torch.serving.specdec import SpecConfig
from repro_torch.serving.tokenizer import SPECIALS, TOKENIZER, Tokenizer
from repro_torch.serving.workload import (PROFILES, WorkloadConfig,
                                          intent_prefix, make_workload,
                                          skewed_mix, uniform_mix)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="planner-proxy-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no card raises)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--checkpoint", default="",
                    help="JAX-package npz checkpoint to serve")
    ap.add_argument("--kv-mode", default="dense", choices=("dense", "paged"),
                    help="KV-cache manager: dense per-slot slabs or the "
                         "paged block pool with CoW prefix sharing")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged: physical KV blocks (default: the dense "
                         "budget, max_batch*cache_len/block_size)")
    ap.add_argument("--block-size", type=int, default=None,
                    help="paged: tokens per KV block (default: 16)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve an EngineCluster of N replicas (> 1)")
    ap.add_argument("--router", default="intent_affinity",
                    choices=ROUTER_POLICIES)
    ap.add_argument("--profile", default="uniform", choices=PROFILES,
                    help="workload arrival profile (cluster mode)")
    ap.add_argument("--skew", type=float, default=0.0,
                    help="hot-intent traffic fraction in [0, 1] "
                         "(0 = uniform mix, 1 = all hot)")
    ap.add_argument("--turns", type=int, default=1,
                    help="max turns per session (cluster mode)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="chunked prefill: max prompt tokens per engine "
                         "step (attn_chunk-aligned slabs, at least one), "
                         "interleaved with decode. Default: monolithic "
                         "admission-step prefill")
    ap.add_argument("--no-interleave", action="store_true",
                    help="with --prefill-budget: run each prefill to "
                         "completion before decoding")
    ap.add_argument("--admission", default="fifo",
                    choices=ADMISSION_POLICIES)
    ap.add_argument("--sla-spill", action="store_true",
                    help="intent_affinity router: spill a request to the "
                         "least-loaded replica when its SLA slack is "
                         "smaller than its home replica's load (cluster "
                         "mode)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding: draft --draft-k greedy "
                         "tokens per slot with a draft sharing the "
                         "target's weights, verify them in one target "
                         "forward (tokens identical to non-speculative "
                         "decoding at --temperature 0, and at any "
                         "temperature for seeded requests: the cluster "
                         "workload path; unseeded T>0 engine-stream "
                         "sampling draws another key schedule, like any "
                         "co-tenancy change)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens per speculative round (>= 1)")
    ap.add_argument("--catalog-size", type=int, default=None,
                    help="serve against a generated tool catalog of N "
                         "tools instead of the base registry; needs "
                         "--retriever-k (the launcher has no intent gate)")
    ap.add_argument("--retriever-k", type=int, default=None,
                    help="retrieve a top-k toolset per request, register "
                         "each toolset as a shared engine prefix and "
                         "prepend its catalog text to the prompt")
    ap.add_argument("--trace-out", default="",
                    help="write the request-lifecycle trace here: .jsonl "
                         "= record per line, else Chrome trace-event JSON")
    return ap


def validate_args(ap: argparse.ArgumentParser, args):
    """Invalid combinations error before any model is built (the JAX
    launcher's checks)."""
    if not 0.0 <= args.skew <= 1.0:
        ap.error(f"--skew must be in [0, 1], got {args.skew}")
    if args.replicas < 1:
        ap.error(f"--replicas must be >= 1, got {args.replicas}")
    if args.kv_mode == "dense" and (args.kv_blocks is not None
                                    or args.block_size is not None):
        ap.error("--kv-blocks/--block-size apply only to --kv-mode paged")
    if args.spec_decode and args.draft_k < 1:
        ap.error(f"--spec-decode needs --draft-k >= 1, got {args.draft_k}")
    if args.prefill_budget is not None and args.prefill_budget < 1:
        ap.error(f"--prefill-budget must be >= 1, "
                 f"got {args.prefill_budget}")
    if args.no_interleave and args.prefill_budget is None:
        ap.error("--no-interleave only applies with --prefill-budget")
    if args.sla_spill and args.replicas < 2:
        ap.error("--sla-spill needs --replicas >= 2 (router-level spill "
                 "has nowhere to go on one replica)")
    if args.catalog_size is not None and args.catalog_size < 1:
        ap.error(f"--catalog-size must be >= 1, got {args.catalog_size}")
    if args.retriever_k is not None and args.retriever_k < 1:
        ap.error(f"--retriever-k must be >= 1, got {args.retriever_k}")
    if args.catalog_size is not None and args.retriever_k is None:
        ap.error("--catalog-size needs --retriever-k: the launcher has no "
                 "intent gate, so a scaled catalog is only servable "
                 "through retrieved toolsets")
    if args.retriever_k is not None and args.replicas > 1:
        ap.error("--retriever-k applies to the single-engine prompt path; "
                 "cluster mode serves the synthetic intent workload "
                 "(launch/serve_pipeline.py runs retrieval against a "
                 "cluster)")
    return args


def parse_args(argv=None):
    """The validated arguments of a command line (``argv``)."""
    ap = build_parser()
    return validate_args(ap, ap.parse_args(argv))


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    check_servable(cfg)
    if args.checkpoint:
        model = params_from_numpy(load_jax_checkpoint(args.checkpoint), cfg,
                                  device)
    else:
        model = init_params(cfg, seed=0, device=device)
    return serve(cfg, model, args)


def _tokenizer(cfg) -> Tokenizer:
    """The engine's tokenizer folded into ``cfg``'s vocabulary."""
    return (TOKENIZER if cfg.vocab_size >= TOKENIZER.vocab_size
            else Tokenizer(cfg.vocab_size))


def request_texts(n: int):
    return [f"Plot xview1 images around Tampa Bay with cloud cover below "
            f"{10 + i}%" for i in range(n)]


def request_prompts(cfg, n: int):
    """The launcher's ``n`` request prompts, encoded into ``cfg``'s
    vocabulary."""
    tok = _tokenizer(cfg)
    return [tok.encode_with_specials(t) for t in request_texts(n)]


def retrieved_prompts(cfg, args, device):
    """With ``--retriever-k``: each request's retrieved toolset, as the
    JAX launcher builds them (no intent gate, so no prior). Returns
    ({toolset key: prefix ids}, [(prompt ids, key)], registry size),
    encoded into ``cfg``'s vocabulary: a prefix is <bos> + its catalog
    text, a prompt <bos> + catalog text + the task + <eos>."""
    registry = (build_catalog(args.catalog_size, seed=0)
                if args.catalog_size is not None else DEFAULT_REGISTRY)
    retriever = ToolRetriever(registry, catalog_intent_libraries(registry),
                              k=args.retriever_k, device=device)
    texts = request_texts(args.requests)
    exposures = retriever.retrieve_batch(texts, [None] * len(texts))
    tok = _tokenizer(cfg)
    catalog = {e.key_str: e.catalog_text(registry) for e in exposures}
    prefixes = {k: [SPECIALS["<bos>"]] + tok.encode(t)
                for k, t in catalog.items()}
    prompts = [(tok.encode_with_specials(f"{catalog[e.key_str]}\nTask: {t}"),
                e.key_str) for t, e in zip(texts, exposures)]
    return prefixes, prompts, len(registry.tools)


def _fmt(v) -> str:
    """Render a possibly-None metric ("n/a": empty percentile series)."""
    return "n/a" if v is None else f"{v:.0f}"


def cluster_workload(cfg, args):
    """The launcher's cluster workload (``args.requests`` sessions, seed
    0), its prompts encoded into ``cfg``'s vocabulary, and each intent
    prefix as <bos> + its ids. Returns (requests, {prefix key: ids})."""
    mix = (skewed_mix(hot_frac=args.skew) if args.skew > 0
           else uniform_mix())
    tok = _tokenizer(cfg)
    reqs, prefixes = [], {}
    for w in make_workload(WorkloadConfig(
            n_sessions=args.requests, intent_mix=mix, profile=args.profile,
            max_turns=args.turns, max_new_tokens=args.max_new,
            temperature=args.temperature, seed=0)):
        reqs.append(dataclasses.replace(
            w, prompt=tok.encode_with_specials(w.prompt)))
        if w.prefix_key and w.prefix_key not in prefixes:
            prefixes[w.prefix_key] = ([SPECIALS["<bos>"]]
                                      + tok.encode(intent_prefix(w.intent)))
    return reqs, prefixes


def serve_cluster(cfg, model, args, spec=None) -> dict:
    """The ``--replicas`` path: the seeded synthetic workload through an
    ``EngineCluster`` of ``args.replicas`` replicas sharing ``model``;
    prints the JAX launcher's summary lines with the wall seconds and
    returns the run's numbers (``summary`` in ticks, ``outputs`` by
    workload index)."""
    device = model.device
    # cluster engines run on the tick clock only, so the trace is
    # wall-free and byte-identical across same-seed runs
    tracer = Tracer() if args.trace_out else None
    cluster = EngineCluster(cfg, model, args.replicas, router=args.router,
                            max_batch=args.max_batch,
                            cache_len=args.cache_len, kv_mode=args.kv_mode,
                            kv_blocks=args.kv_blocks,
                            block_size=args.block_size, spec_decode=spec,
                            prefill_budget=args.prefill_budget,
                            interleave=not args.no_interleave,
                            admission=args.admission,
                            sla_spill=args.sla_spill, tracer=tracer)
    reqs, prefixes = cluster_workload(cfg, args)
    t0 = time.time()
    for key, ids in prefixes.items():
        cluster.register_prefix(key, ids)
    stats = cluster.run_workload(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    s = stats.summary()
    tok_s = s["tokens_out"] / max(dt, 1e-9)
    print(f"cluster[{args.replicas}x{args.max_batch} slots, "
          f"router={args.router}] served {s['finished']}/{s['requests']} "
          f"requests in {s['ticks']} ticks ({dt:.2f}s wall on {device}, "
          f"{1000 * dt / max(s['ticks'], 1):.2f} ms/tick, "
          f"{tok_s:.1f} tok/s)")
    print(f"ttft p50/p95/p99 {_fmt(s['ttft_p50'])}/{_fmt(s['ttft_p95'])}"
          f"/{_fmt(s['ttft_p99'])} ticks | "
          f"admit-wait p95 {_fmt(s['admit_wait_p95'])} | "
          f"e2e p50/p95 {_fmt(s['e2e_p50'])}/{_fmt(s['e2e_p95'])} | "
          f"SLA {100 * s['sla_attainment']:.1f}%"
          + (f" | {s['sla_expired']} expired in queue"
             if s["sla_expired"] else ""))
    print(f"prefix-hit ratio {s['prefix_hit_ratio']:.2f} | "
          f"{s['tokens_out']} tokens out")
    if spec is not None:
        print(f"spec-decode[k={spec.k}]: {s['tokens_per_step']:.2f} "
              f"tokens/target-forward over {s['spec_rounds']} rounds, "
              f"accept rate {s['spec_accept_rate']:.2f}")
    kv_line = (f"kv[{args.kv_mode}]: peak {s['kv_bytes_peak'] / 2**20:.1f} "
               f"MiB of {s['kv_bytes_allocated'] / 2**20:.1f} MiB")
    if args.kv_mode == "paged":
        kv_line += (f" | shared-block frac {s['kv_shared_frac']:.2f} | "
                    f"{s['preemptions']} preemptions, {s['resumes']} "
                    f"resumes, {s['prefix_evictions']} prefix evictions")
    print(kv_line)
    for r in s["per_replica"]:
        print(f"  replica {r['replica']}: {r['admissions']} admissions, "
              f"hit {r['hit_ratio']:.2f}, util {r['utilization']:.2f}")
    if tracer is not None:
        write_trace(tracer, args.trace_out)
        print(f"trace: {len(tracer.records)} records -> {args.trace_out}")
    return {"requests": s["finished"], "seconds": dt, "ticks": s["ticks"],
            "tok_s": tok_s, "tick_ms": 1000 * dt / max(s["ticks"], 1),
            "summary": s, "outputs": stats.outputs(),
            "placements": {t.index: t.replica for t in stats.traces},
            "cluster": cluster}


def serve(cfg, model, args, prompts=None) -> dict:
    """Serve ``args.requests`` requests with ``model`` (built for ``cfg``)
    under the engine settings of ``args`` (on a cluster with
    ``--replicas``); returns the run's numbers. ``prompts`` (id lists)
    replaces the launcher's request prompts."""
    device = model.device
    # no trained draft checkpoint ships with the repo: self-draft (perfect
    # agreement) stands in for a distilled small model, as in the JAX
    # launcher
    spec = (SpecConfig(draft_cfg=cfg, draft_model=model, k=args.draft_k)
            if args.spec_decode else None)
    if args.replicas > 1:
        return serve_cluster(cfg, model, args, spec)
    if args.retriever_k is not None:
        prefixes, prompts, n_tools = retrieved_prompts(cfg, args, device)
        # the cache must hold the widest toolset prefix + the turn; grow
        # it rather than refuse (register_prefix checks the fit)
        need = max(len(ids) for ids in prefixes.values()) \
            + args.max_new + 128
        if args.cache_len < need:
            print(f"cache-len {args.cache_len} -> {need} (toolset "
                  f"prefixes need the room)")
            args.cache_len = need
    else:
        prefixes = {}
        prompts = [(p, None) for p in (request_prompts(cfg, args.requests)
                                       if prompts is None else prompts)]
    tracer = Tracer() if args.trace_out else None
    engine = InferenceEngine(cfg, model, max_batch=args.max_batch,
                             cache_len=args.cache_len,
                             kv_mode=args.kv_mode,
                             kv_blocks=args.kv_blocks,
                             block_size=args.block_size,
                             spec_decode=spec,
                             prefill_budget=args.prefill_budget,
                             interleave=not args.no_interleave,
                             admission=args.admission, tracer=tracer,
                             # the launcher is the wall-clock boundary
                             clock=time.time)
    t0 = time.time()
    for key, ids in prefixes.items():
        engine.register_prefix(key, ids)
    for p, key in prompts:
        engine.add_request(p, max_new_tokens=args.max_new,
                           sampler=SamplerConfig(
                               temperature=args.temperature, top_k=40),
                           prefix_key=key)
    done = engine.run_until_done()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    st = engine.throughput_stats()
    tok_s = st["tokens_generated"] / max(dt, 1e-9)
    step_ms = 1000 * dt / max(engine.step_no, 1)
    print(f"served {len(done)} requests in {dt:.2f}s on {device} | "
          f"decode steps {st['decode_steps']} | {tok_s:.1f} tok/s | "
          f"{step_ms:.2f} ms/step")
    if prefixes:
        print(f"retrieval[k={args.retriever_k}, catalog={n_tools} tools]: "
              f"{len(prefixes)} toolset prefixes for {len(prompts)} "
              f"requests | {st['prefix_hits']} prefix hits, "
              f"{st['prefix_tokens_saved']} prefill tokens saved")
    if spec is not None:
        print(f"spec-decode[k={spec.k}]: {st['tokens_per_step']:.2f} "
              f"tokens/target-forward, accept rate "
              f"{st['spec_accept_rate']:.2f} over {st['spec_rounds']} "
              f"rounds")
    print(f"kv[{st['kv_mode']}]: peak {st['kv_bytes_peak'] / 2**20:.1f} "
          f"MiB of {st['kv_bytes_allocated'] / 2**20:.1f} MiB allocated"
          + (f" | {st['preemptions']} preemptions"
             if st["kv_mode"] == "paged" else ""))
    lat = [r.finish_t - r.enqueue_t for r in done]
    ttft = [r.first_token_t - r.enqueue_t for r in done]
    if done:
        print(f"p50 latency {sorted(lat)[len(lat) // 2] * 1000:.0f}ms | "
              f"p50 TTFT {sorted(ttft)[len(ttft) // 2] * 1000:.0f}ms")
    if tracer is not None:
        write_trace(tracer, args.trace_out)
        print(f"trace: {len(tracer.records)} records -> {args.trace_out}")
    return {"requests": len(done), "seconds": dt, "steps": engine.step_no,
            "tok_s": tok_s, "step_ms": step_ms, "stats": st,
            "spec_accept_rate": st["spec_accept_rate"],
            "preemptions": st["preemptions"],
            "toolset_prefixes": len(prefixes),
            "outputs": {r.request_id: list(r.output) for r in done}}


if __name__ == "__main__":
    main()
