"""Serving launcher of the port: run the inference engine on a batch of
requests, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --requests 4 --max-new 8 [--kv-mode paged] [--spec-decode]

The command line is the JAX launcher's (``repro.launch.serve``) plus
``--device``; ``--arch`` takes the port's ids (``configs.ALL_IDS``: the
planner, the MoE families arctic-480b and kimi-k2-1t-a32b, the hybrid
attention + SSM hymba-1.5b and the recurrent xlstm-125m).
``--backend`` is gone: the device decides which attention runs (Hopper
kernels on CUDA tensors, their plain versions on the CPU).
``--kv-mode paged`` (with ``--kv-blocks``, ``--block-size``) serves from
the paged block pool; ``--spec-decode`` drafts ``--draft-k`` tokens per
slot with a self-draft (the target's own weights: the repo ships no
trained draft) and verifies them in one target forward. hymba's
sliding-window rings and SSM state take none of these three: for it
``--kv-mode paged``, ``--prefill-budget`` and ``--spec-decode`` fail
with the engine's ``ValueError``, as in the JAX launcher. xlstm takes
``--prefill-budget`` (its state extends without padding) and refuses
the other two likewise. The cluster-only
flags (``--router``, ``--profile``, ``--skew``, ``--turns``) come back
with replicas; until then replicas, retrieval and SLA spill are refused
as not ported yet. ``--checkpoint`` loads a JAX-package npz through the
weight bridge. ``main`` is the command line: it builds the model and
hands it to ``serve``, which runs the engine for any ``(cfg, model,
args)`` (a depth-cut full-width config, say) and returns the run's
numbers as a dict. Prompts are encoded into the model's vocabulary: the
engine's tokenizer folded into the config's ``vocab_size`` where that is
smaller than the tokenizer's (the MoE smoke configs' 512 ids).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.convert import load_jax_checkpoint, \
    params_from_numpy
from repro_torch.models.model import init_params, resolve_device
from repro_torch.obs import Tracer
from repro_torch.obs.export import write_trace
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampling import SamplerConfig
from repro_torch.serving.sched import ADMISSION_POLICIES
from repro_torch.serving.specdec import SpecConfig
from repro_torch.serving.tokenizer import TOKENIZER, Tokenizer

# flags of the JAX launcher this slice does not serve, with the ROADMAP.md
# queue item that brings each
NOT_PORTED = {
    "replicas": "--replicas > 1 (queue A6)",
    "retriever_k": "--retriever-k (queue A8)",
    "catalog_size": "--catalog-size (queue A8)",
    "sla_spill": "--sla-spill (queue A6)",
}


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
    ap.add_argument("--replicas", type=int, default=1)
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
    ap.add_argument("--sla-spill", action="store_true")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding: draft --draft-k greedy "
                         "tokens per slot with a draft sharing the "
                         "target's weights, verify them in one target "
                         "forward (tokens identical to non-speculative "
                         "decoding at --temperature 0)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens per speculative round (>= 1)")
    ap.add_argument("--catalog-size", type=int, default=None)
    ap.add_argument("--retriever-k", type=int, default=None)
    ap.add_argument("--trace-out", default="",
                    help="write the request-lifecycle trace here: .jsonl "
                         "= record per line, else Chrome trace-event JSON")
    return ap


def validate_args(ap: argparse.ArgumentParser, args):
    """Invalid or unported combinations error before any model is built."""
    given = {"replicas": args.replicas > 1,
             "retriever_k": args.retriever_k is not None,
             "catalog_size": args.catalog_size is not None,
             "sla_spill": args.sla_spill}
    for key, on in given.items():
        if on:
            ap.error(f"{NOT_PORTED[key]} is not ported yet")
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
    if args.checkpoint:
        model = params_from_numpy(load_jax_checkpoint(args.checkpoint), cfg,
                                  device)
    else:
        model = init_params(cfg, seed=0, device=device)
    return serve(cfg, model, args)


def request_prompts(cfg, n: int):
    """The launcher's ``n`` request prompts, encoded into ``cfg``'s
    vocabulary."""
    tok = (TOKENIZER if cfg.vocab_size >= TOKENIZER.vocab_size
           else Tokenizer(cfg.vocab_size))
    return [tok.encode_with_specials(
        f"Plot xview1 images around Tampa Bay with cloud cover below "
        f"{10 + i}%") for i in range(n)]


def serve(cfg, model, args) -> dict:
    """Serve ``args.requests`` requests with ``model`` (built for ``cfg``)
    under the engine settings of ``args``; returns the run's numbers."""
    device = model.device
    # no trained draft checkpoint ships with the repo: self-draft (perfect
    # agreement) stands in for a distilled small model, as in the JAX
    # launcher
    spec = (SpecConfig(draft_cfg=cfg, draft_model=model, k=args.draft_k)
            if args.spec_decode else None)
    prompts = request_prompts(cfg, args.requests)
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
    for p in prompts:
        engine.add_request(p, max_new_tokens=args.max_new,
                           sampler=SamplerConfig(
                               temperature=args.temperature, top_k=40))
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
            "outputs": {r.request_id: list(r.output) for r in done}}


if __name__ == "__main__":
    main()
