"""Performance flags the port reads.

Only the attention q-chunk length is carried over: the engine aligns
chunked prefill and prefix registration to it, exactly as the JAX
engine does, so both split a prompt at the same seams.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PerfFlags:
    # chunked-prefill slab width (tokens) and prefix-head alignment
    attn_chunk: int = 1024


FLAGS = PerfFlags()


def get_flags() -> PerfFlags:
    return FLAGS
