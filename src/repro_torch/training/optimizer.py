"""AdamW over a model's named parameters, with the JAX package's
arithmetic (``training/optimizer.py`` there).

The state holds fp32 m and v for every parameter of a ``Model``, keyed
by its name in ``named_parameters()``. ``adamw_update`` clips the
gradients by their global norm, takes the bias corrections from the
fp32 step, applies the decoupled weight decay inside the update and
computes the update in fp32, cast back to each parameter's dtype, in
the JAX function's order of operations. JAX returns new params; here the
model's parameters are overwritten in place (it keeps one copy of its
weights).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def adamw_init(model) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    ps = dict(model.named_parameters())
    return AdamWState(step=0, m={n: zeros(p) for n, p in ps.items()},
                      v={n: zeros(p) for n, p in ps.items()})


@torch.no_grad()
def adamw_update(model, grads: Mapping[str, torch.Tensor],
                 state: AdamWState, *, lr=3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01, grad_clip: float = 1.0):
    """Returns (model, new_state, grad_norm), the model's parameters
    updated in place from ``grads`` (by parameter name). ``lr`` is a
    float or a 0-d fp32 tensor (``cosine_lr``)."""
    ps = dict(model.named_parameters())
    gf = {n: grads[n].float() for n in ps}
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in gf.values()))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    gf = {n: g * scale for n, g in gf.items()}

    step = state.step + 1
    stepf = torch.tensor(float(step), dtype=torch.float32)
    bc1 = (1.0 - torch.tensor(b1, dtype=torch.float32) ** stepf).item()
    bc2 = (1.0 - torch.tensor(b2, dtype=torch.float32) ** stepf).item()

    new_m, new_v = {}, {}
    for n, p in ps.items():
        g = gf[n]
        m = b1 * state.m[n] + (1 - b1) * g
        v = b2 * state.v[n] + (1 - b2) * g * g
        pf = p.float()
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pf
        p.copy_((pf - lr * u).to(p.dtype))
        new_m[n], new_v[n] = m, v
    return model, AdamWState(step=step, m=new_m, v=new_v), gnorm


def cosine_lr(step, *, base_lr: float, warmup: int, total: int,
              min_frac: float = 0.1):
    """Linear warm-up to ``base_lr``, then a cosine down to ``min_frac``
    of it, in fp32 (a 0-d tensor)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.minimum(warm, cos)
