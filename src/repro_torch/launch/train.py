"""Training launcher of the port: train a config on synthetic packed LM
data, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch \
      planner-proxy-100m --steps 200 --batch 8 --seq 256 [--remat]

The command line is the JAX launcher's (``repro.launch.train``) plus
``--device``. One process is one card: without a launched process group,
and with ``--local``, the model trains on today's plain path, no
DTensor. Under a ``torchrun`` launch of 256 ranks (one card each) the
launcher takes the ``(16, 16)`` production mesh, as the JAX launcher
does without ``--local``; ``--multi-pod`` takes the ``(2, 16, 16)`` one
and needs 512 ranks. Any other world size raises, naming the size it
needs (``launch/mesh.py``). On a mesh the model and AdamW's state are
distributed by the sharding rules (``distributed/parallel.py``) and each
rank still draws the whole model first. Every family the engine serves
trains: the planner (planner-proxy-100m), the MoE stacks (arctic-480b,
kimi-k2-1t-a32b; the loss includes their load-balance terms),
hymba-1.5b, xlstm-125m and the dense qwen1.5-32b, qwen1.5-110b,
starcoder2-3b and gemma2-2b. The ``vlm`` (qwen2-vl-72b) and ``audio``
(whisper-large-v3) families raise ``NotImplementedError``, as the JAX
launcher cannot train them either: it feeds only ``PackedLMDataset``'s
tokens and labels, and their models read ``mrope_pos`` or ``frames``
from the batch. They train at the model level, ``training/loop.py``'s
``make_train_step`` on ``models/inputs.py:make_batch`` batches
(``train_run`` takes them as its ``batches``). It prints the loss and
tok/s every ``--log-every`` steps as the JAX launcher does and, with
``--checkpoint``, saves the weights in the JAX package's npz format
(whole tensors, gathered from a mesh's shards), which ``launch.serve
--checkpoint`` serves. ``main`` is the command line; ``train_run``
trains any ``(cfg, model, args)`` in place, distributed over ``mesh``
when given one, and returns the run's numbers.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import init_params, resolve_device
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import PackedLMDataset, synthetic_docs
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import adamw_init


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="planner-proxy-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--local", action="store_true",
                    help="1-device mesh (one card is the local mesh)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    mesh = launch_mesh(args)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh is not None else resolve_device(args.device))
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if cfg.family in ("vlm", "audio"):
        # a vlm's batch needs patch_embeds and mrope_pos, an audio
        # stack's frames; the JAX launcher feeds only tokens and labels
        # (src/repro/launch/train.py:64-65), so its model would read a
        # key the batch lacks
        needs = ("frames" if cfg.family == "audio"
                 else "patch_embeds and mrope_pos")
        raise NotImplementedError(
            f"{cfg.name}: launch.train does not train the {cfg.family!r} "
            f"family: its batches need {needs}, and the JAX launcher "
            f"feeds only PackedLMDataset's tokens and labels; train it "
            f"through training/loop.py's make_train_step on "
            f"models/inputs.py's make_batch batches")
    model = init_params(cfg, seed=0, device=device).requires_grad_(True)
    return train_run(cfg, model, args, mesh=mesh)


def launch_mesh(args):
    """The production mesh of a launched group (``--multi-pod``: the
    multi-pod one), or None: one process, one card (``--local`` too).
    A launch's group starts here from torchrun's environment."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not (args.multi_pod or (world > 1 and not args.local)):
        return None
    if world > 1 and not dist.is_initialized():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    return make_production_mesh(multi_pod=args.multi_pod)


def train_run(cfg, model, args, batches=None, mesh=None) -> dict:
    """``args.steps`` AdamW steps of ``model`` (trained in place), a
    batch a step from ``batches`` (any iterator of train batches, as
    ``models/inputs.py:make_batch`` gives a vlm or audio family; by
    default ``synthetic_docs`` packed into (batch, seq) windows). Each
    step ends in a synchronize on the card, so ``step_ms`` are the
    steps' wall times; ``losses`` holds every step's loss; tok/s counts
    ``args.batch`` x ``args.seq`` rows a step. With a ``mesh`` the model
    and the optimizer state are distributed over it first (the default
    ``ShardingStrategy``)."""
    if mesh is not None:
        from repro_torch.distributed.parallel import distribute_model, \
            distribute_opt_state
        distribute_model(model, cfg, mesh)
        opt_state = distribute_opt_state(adamw_init(model), model)
    else:
        opt_state = adamw_init(model)
    device = model.device
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    step_fn = make_train_step(cfg, lr=args.lr, remat=args.remat)
    data = batches if batches is not None else PackedLMDataset(
        synthetic_docs(cfg.vocab_size), args.batch, args.seq,
        cfg.vocab_size)
    losses, step_ms = [], []
    t0 = time.time()
    for step in range(args.steps):
        ts = time.time()
        model, opt_state, metrics = step_fn(model, opt_state, next(data))
        sync()
        step_ms.append(1e3 * (time.time() - ts))
        losses.append(metrics["loss"])
        if step % args.log_every == 0 or step == args.steps - 1:
            tput = (args.batch * args.seq * (step + 1)
                    / max(time.time() - t0, 1e-9))
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"tok/s {tput:,.0f}")
    dt = time.time() - t0
    if args.checkpoint:
        save_checkpoint(args.checkpoint, model)
        print(f"checkpoint -> {args.checkpoint}")
    return {"steps": args.steps, "seconds": dt,
            "tok_s": args.batch * args.seq * args.steps / max(dt, 1e-9),
            "losses": [float(x) for x in losses], "step_ms": step_ms}


if __name__ == "__main__":
    main()
