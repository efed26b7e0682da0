"""Token sampling policies.

Port of the JAX package's ``serving/sampling.py``. Greedy (T=0) is
``argmax``, which gives the JAX tokens whenever the logits agree. T>0
applies top-k, then a categorical draw from a ``torch.Generator``.
Per-request ``seed`` streams are deterministic within the port (token i
of a seeded request draws from a generator seeded by (seed, i)), but they
are not JAX's threefry bits: seeded T>0 parity with the JAX engine needs
threefry ported (ROADMAP.md queue A3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => no top-k truncation
    # Per-request sampling stream. None: the engine draws from its own
    # generator, so tokens depend on engine seed and admission order. An
    # int makes token i a pure function of (logits, seed, i).
    seed: Optional[int] = None


def request_generator(seed: int, i: int) -> torch.Generator:
    """The generator for token ``i`` of a request seeded with ``seed``."""
    return torch.Generator().manual_seed((seed * 1_000_003 + i) % (1 << 63))


def sample(logits, gen: Optional[torch.Generator], cfg: SamplerConfig):
    """logits: (B, V) fp32 -> token ids (B,) int64 (on the CPU)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).cpu()
    scaled = logits.float().cpu() / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -cfg.top_k][:, None]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, -1e30),
                             scaled)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]
