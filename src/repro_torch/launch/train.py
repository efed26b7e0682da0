"""Training launcher of the port: train a config on synthetic packed LM
data, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch \
      planner-proxy-100m --steps 200 --batch 8 --seq 256 [--remat]

The command line is the JAX launcher's (``repro.launch.train``) plus
``--device``. One card is the local mesh, so ``--local`` changes
nothing; ``--multi-pod`` (the production mesh) raises
``NotImplementedError``: sharding is ROADMAP.md queue A13. Every family
the engine serves trains: the planner (planner-proxy-100m), the MoE
stacks (arctic-480b, kimi-k2-1t-a32b; the loss includes their
load-balance terms), hymba-1.5b, xlstm-125m and the dense qwen1.5-32b,
qwen1.5-110b, starcoder2-3b and gemma2-2b. The ``vlm`` (qwen2-vl-72b)
and ``audio`` (whisper-large-v3) families raise ``NotImplementedError``,
as the JAX launcher cannot train them either: it feeds only
``PackedLMDataset``'s tokens and labels, and their models read
``mrope_pos`` or ``frames`` from the batch. They train at the model
level, ``training/loop.py``'s ``make_train_step`` on
``models/inputs.py:make_batch`` batches (``train_run`` takes them as
its ``batches``). It prints the loss and tok/s every
``--log-every`` steps as the JAX launcher does and, with
``--checkpoint``, saves the weights in the JAX package's npz format,
which ``launch.serve --checkpoint`` serves. ``main`` is the command
line; ``train_run`` trains any ``(cfg, model, args)`` in place and
returns the run's numbers.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
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
    if args.multi_pod:
        raise NotImplementedError("--multi-pod: the production mesh and "
                                  "its sharding are ROADMAP.md queue A13")
    device = resolve_device(args.device)
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
    return train_run(cfg, model, args)


def train_run(cfg, model, args, batches=None) -> dict:
    """``args.steps`` AdamW steps of ``model`` (trained in place), a
    batch a step from ``batches`` (any iterator of train batches, as
    ``models/inputs.py:make_batch`` gives a vlm or audio family; by
    default ``synthetic_docs`` packed into (batch, seq) windows). Each
    step ends in a synchronize on the card, so ``step_ms`` are the
    steps' wall times; ``losses`` holds every step's loss; tok/s counts
    ``args.batch`` x ``args.seq`` rows a step."""
    device = model.device
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    step_fn = make_train_step(cfg, lr=args.lr, remat=args.remat)
    opt_state = adamw_init(model)
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
