"""AdamW over a model's named parameters, with the JAX package's
arithmetic (``training/optimizer.py`` there).

The state holds fp32 m and v for every parameter of a ``Model``, keyed
by its name in ``named_parameters()``. ``adamw_update`` clips the
gradients by their global norm, takes the bias corrections from the
fp32 step, applies the decoupled weight decay inside the update and
computes the update in fp32, cast back to each parameter's dtype, in
the JAX function's order of operations. JAX returns new params and a new
state; here the model's parameters and the state's m and v are
overwritten in place, with the same operations in the same order, so
the same bits. A step then holds one copy of each (12 bytes a bf16
parameter with its gradient) and one parameter's fp32 temporaries at a
time: the functional form held every fp32 gradient twice and the old
beside the new m and v, ~30 bytes a parameter, which a one-layer
qwen2-vl-72b (3.4 B parameters) does not fit in 80 GB.

A model distributed over a mesh (``distributed/parallel.py``) has
DTensor parameters and gradients; the same code updates them shard by
shard (m and v laid out by ``parallel.distribute_opt_state``), and the
global gradient norm is the norm over the whole sharded leaves: each
leaf's sum of squares is a DTensor reduced over the mesh before the
square root.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _zeros(p):
    """fp32 zeros shaped as p; for a DTensor p, laid out as p (each rank
    its shard's zeros, on the shard's device)."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        return DTensor.from_local(
            torch.zeros_like(p.to_local(), dtype=torch.float32),
            p.device_mesh, p.placements, run_check=False)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(model) -> AdamWState:
    zeros = _zeros
    ps = dict(model.named_parameters())
    return AdamWState(step=0, m={n: zeros(p) for n, p in ps.items()},
                      v={n: zeros(p) for n, p in ps.items()})


@torch.no_grad()
def adamw_update(model, grads: Mapping[str, torch.Tensor],
                 state: AdamWState, *, lr=3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01, grad_clip: float = 1.0):
    """Returns (model, new_state, grad_norm), the model's parameters and
    ``state``'s m and v updated in place from ``grads`` (by parameter
    name); ``new_state`` holds those m and v and the next step. ``lr`` is
    a float or a 0-d fp32 tensor (``cosine_lr``)."""
    ps = dict(model.named_parameters())
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in
                           (grads[n].float() for n in ps)))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    step = state.step + 1
    stepf = torch.tensor(float(step), dtype=torch.float32)
    bc1 = (1.0 - torch.tensor(b1, dtype=torch.float32) ** stepf).item()
    bc2 = (1.0 - torch.tensor(b2, dtype=torch.float32) ** stepf).item()

    for n, p in ps.items():
        g = grads[n].float() * scale
        # m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g g, in place
        m = state.m[n].mul_(b1).add_((1 - b1) * g)
        v = state.v[n].mul_(b2).add_((1 - b2) * g * g)
        del g
        pf = p.float()
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pf
        p.copy_((pf - lr * u).to(p.dtype))
    return model, AdamWState(step=step, m=state.m, v=state.v), gnorm


def cosine_lr(step, *, base_lr: float, warmup: int, total: int,
              min_frac: float = 0.1):
    """Linear warm-up to ``base_lr``, then a cosine down to ``min_frac``
    of it, in fp32 (a 0-d tensor)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.minimum(warm, cos)
