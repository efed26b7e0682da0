"""Dry-run of the port: size every (architecture x input shape) pair on
the production meshes, on the CPU, with no card and no memory.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The JAX package lowers and compiles each step for 256 or 512 TPU chips
and reads XLA's analyses. The port sizes the same pairs from the same
sharding rules, in one process over ``launch/mesh.py:fake_mesh`` (the
fake process group stands in for every rank):

  * ``memory.argument_bytes``: one rank's bytes of the parameters, the
    optimizer state (train), the batch and the decode cache, from the
    placements of the rules and the meta shapes (``param_shapes``,
    ``batch_struct``, ``cache_struct``); ``output_bytes`` likewise
    (train: the parameters, the state and the metrics; prefill and
    decode: the vocab-sharded logits and the cache);
  * ``memory.temp_bytes`` is null: no compiler assigns buffers here, so
    there is no peak to read (``temp_reason`` says so);
  * a run of the step on the meta device over the fake mesh, the
    model's mesh path (``distributed/parallel.py``), counts one rank's
    ``flops`` (dispatched ops on local tensors, through
    ``torch.utils.flop_counter``'s formulas, plus the ``KB`` ops' own
    counts on the meta device, ``kernels/backend.py:META_FLOPS``) and
    its ``collectives``: each collective the step issues, with its group
    size and bytes, the moved bytes summed by the JAX package's ring
    formulas (``launch/hlo_stats.py``: all-gather out (g-1)/g,
    reduce-scatter out (g-1), all-reduce 2 (g-1)/g, all-to-all
    (g-1)/g, a send its bytes).

A decode step runs the engine's batched form: per-slot ``pos`` (B,)
in place of the struct's 0-d one. ``long_500k`` is skipped for
full-attention architectures with JAX's reason. One step is not
traced: an sLSTM stack's (xlstm) over more than ``SLSTM_TRACE_STEPS``
positions, whose per-step Python loop (25 ops a token) would take an
hour at 32,768; its record says ``trace: null`` with that reason, so
which records are traced does not depend on the host. Records go to
``results/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``.
``--profile prod`` takes ``launch/profiles.py``'s flags; their
fragments that only the JAX package has (``common/perf.py:
JAX_ONLY_FLAGS``) go into the record's ``not_applied`` with reasons.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time
import traceback
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import flop_registry

from repro_torch.common.config import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.common.perf import PerfFlags, set_flags, split_overrides
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import parallel as par
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import backend as KB
from repro_torch.launch.mesh import PRODUCTION, fake_mesh, teardown_fake
from repro_torch.models import inputs as inp
from repro_torch.models import model as MD
from repro_torch.training.optimizer import adamw_init, adamw_update

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
#: the longest sLSTM loop the dry-run traces (train_4k's 4,096 steps
#: take about 6 minutes on one CPU thread; prefill_32k's would take 8x)
SLSTM_TRACE_STEPS = 4096
TEMP_REASON = ("no compiler assigns buffers in the port: there is no "
               "peak of temporaries to read without a card")


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return ("full-attention architecture: long_500k requires "
                "sub-quadratic attention (DESIGN.md §Input-shape coverage)")
    return ""


def parse_strategy(spec: str) -> shd.ShardingStrategy:
    """'prefill_seq_axis=model,fsdp=False' -> ShardingStrategy."""
    strategy = shd.ShardingStrategy()
    if not spec:
        return strategy
    kw = {}
    for kv in spec.split(","):
        k, v = (t.strip() for t in kv.split("="))
        cur = getattr(strategy, k)
        kw[k] = (v == "True") if isinstance(cur, bool) else type(cur)(v)
    return strategy.replace(**kw)


# ------------------------------------------------------------------ bytes ----

def _tree_bytes(tree, specs, mesh) -> int:
    """One rank's bytes of a cache tree under its spec tree (the same
    structure, a spec at each tensor)."""
    if isinstance(tree, torch.Tensor):
        return shd.local_bytes(tree, specs, mesh)
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v, s, mesh) for v, s in zip(tree, specs))
    return 0


def sizes(cfg: ModelConfig, shape: ShapeConfig, mesh,
          strategy: shd.ShardingStrategy) -> dict:
    """One rank's argument and output bytes of the step, from the rules
    (the meta shapes and their placements)."""
    model = MD.param_shapes(cfg)
    pspec = shd.params_sharding(model, cfg, mesh, strategy)
    params = sum(shd.local_bytes(t, pspec[n], mesh)
                 for n, t in model.named_parameters())
    batch = inp.batch_struct(cfg, shape)
    bbytes = sum(shd.local_bytes(t, s, mesh) for t, s in zip(
        batch.values(), shd.batch_sharding(batch, cfg, shape, mesh,
                                           strategy).values()))
    arg = {"params": params, "batch": bbytes}
    if shape.mode == "train":
        ospec = shd.opt_state_sharding(model, cfg, mesh, strategy)
        opt = 4 + sum(2 * t.numel() * 4 // shd.shard_factor(ospec["m"][n],
                                                             mesh)
                      for n, t in model.named_parameters())
        arg["opt_state"] = opt
        out = params + opt + 12                    # loss, grad_norm, step
    else:
        lspec = shd.logits_sharding(cfg, shape, mesh, strategy)
        logits = (shape.global_batch * cfg.vocab_size * 4
                  // shd.shard_factor(lspec, mesh))
        cache = _cache(cfg, shape)
        cbytes = _tree_bytes(cache, shd.cache_sharding(cache, cfg, shape,
                                                       mesh, strategy), mesh)
        if shape.mode == "decode":
            arg["cache"] = cbytes
        out = logits + cbytes
    arg["total"] = sum(arg.values())
    return {"argument_bytes": arg, "output_bytes": out, "temp_bytes": None,
            "temp_reason": TEMP_REASON}


def _cache(cfg, shape):
    """The step's cache as meta tensors: decode's ``cache_struct``, or
    the cache a prefill fills."""
    if shape.mode == "decode":
        return inp.cache_struct(cfg, shape)
    enc = shape.seq_len if cfg.family == "audio" else 0
    rows = (min(shape.seq_len, MD.WHISPER_DEC_CACHE) if enc
            else shape.seq_len)
    c = MD.init_cache(cfg, shape.global_batch, rows, "meta", enc_len=enc)
    c["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return c


# ------------------------------------------------------------- the trace ----

_COLL_KIND = {"all_gather_into_tensor": "all-gather",
              "all_gather_into_tensor_out": "all-gather",
              "reduce_scatter_tensor": "reduce-scatter",
              "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
              "all_to_all_single": "all-to-all",
              "broadcast": "collective-permute",
              "broadcast_": "collective-permute"}


def _group_size(name: str, args, groups) -> int:
    """The group size of a functional collective: an argument of the
    gathers and scatters, else its group's, by name (``groups``)."""
    if name in ("all_gather_into_tensor", "all_gather_into_tensor_out"):
        return int(args[1])
    if name == "reduce_scatter_tensor":
        return int(args[2])
    return groups[args[-1]]


def _moved(kind: str, nbytes: float, g: int) -> float:
    """The ring estimates of ``launch/hlo_stats.py`` (JAX package)."""
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    return nbytes


class StepCounter(CommDebugMode):
    """One rank's flops and collectives of the ops dispatched while on.
    A ``CommDebugMode`` (PyTorch's dispatch mode for DTensor's
    collectives) without its module tracking: an op on DTensors returns
    NotImplemented, so DTensor runs it as local ops and collectives,
    which are counted (a matmul's flops by ``torch.utils.flop_counter``'s
    formulas, a collective's bytes by the ring formulas). ``groups`` maps
    a process group's name to its size."""

    def __init__(self, groups):
        super().__init__()
        self.group_sizes = dict(groups)
        self.flops = 0.0
        self.coll = defaultdict(float)
        self.count = defaultdict(int)
        self.groups = defaultdict(set)

    def __enter__(self):
        super(CommDebugMode, self).__enter__()
        return self

    def __exit__(self, *exc):
        return super(CommDebugMode, self).__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pk = getattr(func, "_overloadpacket", None)
        if pk in flop_registry:
            self.flops += float(flop_registry[pk](*args, **kwargs,
                                                  out_val=out))
        name = func.name().split("::")[-1].split(".")[0]
        if func.namespace in ("_c10d_functional", "c10d") \
                and name in _COLL_KIND:
            kind = _COLL_KIND[name]
            t = out if isinstance(out, torch.Tensor) else args[0]
            g = _group_size(name, args, self.group_sizes)
            if g > 1:
                nbytes = t.numel() * t.element_size()
                self.coll[kind] += _moved(kind, nbytes, g)
                self.count[kind] += 1
                self.groups[kind].add(g)
        return out

    def record(self) -> dict:
        out = {f"bytes_{k}": v for k, v in self.coll.items()}
        out.update({f"count_{k}": v for k, v in self.count.items()})
        out.update({f"groups_{k}": sorted(v) for k, v in self.groups.items()})
        out["collective_bytes"] = sum(self.coll.values())
        return out


def _decode_cache(cfg, shape):
    cache = inp.cache_struct(cfg, shape)
    cache["pos"] = torch.empty((shape.global_batch,), dtype=torch.int32,
                               device="meta")
    return cache


def run_step(model, cfg, shape, seq_axis=None):
    """The pair's step on ``model`` (meta; distributed or not)."""
    batch = inp.batch_struct(cfg, shape)
    if shape.mode == "train":
        model.requires_grad_(True)
        opt = adamw_init(model)
        if getattr(model, "mesh_ctx", None) is not None:
            opt = par.distribute_opt_state(opt, model)
        params = dict(model.named_parameters())
        loss = MD.train_loss(model, batch, remat=True)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        adamw_update(model, grads, opt)
        return
    if shape.mode == "prefill":
        rows = (min(shape.seq_len, MD.WHISPER_DEC_CACHE)
                if cfg.family == "audio" else shape.seq_len)
        MD.prefill(model, batch, rows, **({"seq_axis": seq_axis}
                                          if seq_axis else {}))
        return
    cache = _decode_cache(cfg, shape)
    if getattr(model, "mesh_ctx", None) is not None:
        cache = par.distribute_cache(cache, model)
    MD.decode_step(model, cache, batch)


def untraced_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """Why the pair's step is not traced ('' if it is)."""
    kinds = {k for unit, _ in cfg.segments for k in unit}
    if "slstm" in kinds and shape.mode != "decode" \
            and shape.seq_len > SLSTM_TRACE_STEPS:
        return (f"the sLSTM runs a per-step Python loop ({shape.seq_len} "
                f"steps); the dry-run traces at most {SLSTM_TRACE_STEPS}")
    return ""


def trace(cfg, shape, mesh, strategy):
    """(one rank's flops, flops by KB op, collectives) of the step over
    ``mesh`` on the meta device."""
    model = par.distribute_model(MD.param_shapes(cfg), cfg, mesh, strategy)
    seq_axis = (strategy.prefill_seq_axis
                if strategy.prefill_seq_axis != "none" else None)
    KB.META_FLOPS.clear()
    groups = {mesh.get_group(i).group_name: mesh.size(i)
              for i in range(mesh.ndim)}
    counter = StepCounter(groups)
    with counter:
        run_step(model, cfg, shape, seq_axis)
    kb = dict(KB.META_FLOPS)
    return counter.flops + sum(kb.values()), kb, counter.record()


def unsharded_flops(cfg, shape) -> float:
    """The step's flops on one device (no mesh), on the meta device."""
    KB.META_FLOPS.clear()
    counter = StepCounter({})
    with counter:
        run_step(MD.param_shapes(cfg), cfg, shape)
    return counter.flops + sum(KB.META_FLOPS.values())


def run_one(arch: str, shape_name: str, mesh_name: str,
            strategy: shd.ShardingStrategy = None, save: bool = True,
            verbose: bool = True, perf: str = "", tag: str = ""):
    kept, not_applied = split_overrides(perf)
    set_flags(PerfFlags().apply_overrides(kept))
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    strategy = strategy or shd.ShardingStrategy()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "perf": perf, "tag": tag, "strategy": strategy.__dict__,
           "not_applied": not_applied}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        _save(rec, save)
        if verbose:
            print(f"SKIP {arch} × {shape_name} × {mesh_name}: {reason}")
        return rec
    dims, names = PRODUCTION[mesh_name == "multi"]
    t0 = time.time()
    try:
        mesh = fake_mesh(dims, names)
        rec["n_devices"] = math.prod(dims)
        rec["memory"] = sizes(cfg, shape, mesh, strategy)
        t1 = time.time()
        why = untraced_reason(cfg, shape)
        if why:
            rec.update(trace=None, trace_reason=why)
        else:
            flops, by_op, coll = trace(cfg, shape, mesh, strategy)
            rec.update(trace="ok", flops=flops, flops_by_kb_op=by_op,
                       collectives=coll)
        rec["trace_s"] = round(time.time() - t1, 1)
        rec["status"] = "ok"
        if verbose:
            a = rec["memory"]["argument_bytes"]["total"] / 2 ** 30
            fl = rec.get("flops")
            cb = rec.get("collectives", {}).get("collective_bytes")
            print(f"OK   {arch} × {shape_name} × {mesh_name}: "
                  f"args={a:.2f}GiB flops={fl if fl is None else f'{fl:.3e}'} "
                  f"coll={cb if cb is None else f'{cb / 2 ** 30:.2f}GiB'} "
                  f"({rec['trace_s']}s)")
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"FAIL {arch} × {shape_name} × {mesh_name}: "
                  f"{rec['error'][:300]}")
    finally:
        teardown_fake()
        set_flags(PerfFlags())
    rec["seconds"] = round(time.time() - t0, 1)
    _save(rec, save)
    return rec


def _save(rec, save):
    if not save:
        return
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"__{rec['tag']}" if rec.get("tag") else ""
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"
    with open(os.path.join(RESULTS_DIR, name), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--perf", default="",
                    help="perf-flag overrides, e.g. 'moe_dispatch=shard_map'")
    ap.add_argument("--tag", default="",
                    help="suffix for the result file")
    ap.add_argument("--strategy", default="",
                    help="ShardingStrategy overrides, e.g. "
                         "'prefill_seq_axis=model,fsdp=False'")
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "prod"],
                    help="'prod' = tuned per-pair flags from "
                         "launch/profiles.py (explicit --perf/--strategy "
                         "are appended on top)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    torch.set_num_threads(1)
    # DTensor warns at every reduction over two mesh dims; the sweep's
    # records count those collectives
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    n_fail, t0 = 0, time.time()
    for arch in archs:
        for shape in shapes:
            perf, strat_spec = args.perf, args.strategy
            if args.profile == "prod":
                from repro_torch.launch.profiles import resolve
                base_perf, base_strat = resolve(arch, shape)
                perf = ",".join(s for s in (base_perf, args.perf) if s)
                strat_spec = ",".join(s for s in (base_strat,
                                                  args.strategy) if s)
            strategy = parse_strategy(strat_spec)
            for mesh in meshes:
                rec = run_one(arch, shape, mesh, strategy=strategy,
                              perf=perf, tag=args.tag)
                n_fail += rec["status"] == "error"
    print(f"dry-run complete in {time.time() - t0:.1f} s; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
