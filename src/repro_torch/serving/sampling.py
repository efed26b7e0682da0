"""Token sampling policies.

Port of the JAX package's ``serving/sampling.py``, with JAX's draws:
greedy (T=0) is ``argmax``; T>0 applies top-k, then the Gumbel-max draw
of ``jax.random.categorical``, ``argmax(gumbel(key, (1, V)) + logits /
T)``, with the Gumbel bits of ``serving/prng.py``. So a row sampled with
a key gives the JAX package's token for that key wherever the two
packages' logits agree (and wherever they differ by less than the draw's
top-2 margin).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.serving.prng import Key, gumbel


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => no top-k truncation
    # Per-request sampling stream. None: the engine draws from its own
    # key, so tokens depend on engine seed and admission order. An int
    # decouples the request from its engine: token i is sampled with
    # fold_in(PRNGKey(seed), i), so outputs are a pure function of
    # (prompt, seed), the property the multi-replica cluster relies on
    # for exact token parity across routing policies
    # (serving/cluster.py).
    seed: Optional[int] = None


def sample(logits, keys: Optional[Sequence[Key]], cfg: SamplerConfig):
    """logits: (B, V) -> token ids (B,) int64 on the CPU. At T>0 row b
    draws with ``keys[b]`` over its own counters 0..V-1: the JAX
    package's ``sample(logits[b:b + 1], keys[b], cfg)``. ``keys`` is
    unused at T<=0."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).cpu()
    if len(keys) != logits.shape[0]:
        raise ValueError(f"{len(keys)} keys for {logits.shape[0]} rows")
    scaled = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -cfg.top_k][:, None]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, -1e30),
                             scaled)
    noise = gumbel(keys, scaled.shape[-1], scaled.device)
    return torch.argmax(noise + scaled, dim=-1).cpu()
