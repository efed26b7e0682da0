"""Performance flags the port reads.

Two knobs of the JAX package's ``common/perf.py`` are carried over: the
attention q-chunk length (the engine aligns chunked prefill and prefix
registration to it, exactly as the JAX engine does, so both split a
prompt at the same seams) and the MoE capacity-factor override. The JAX
package's MoE dispatch and sharding-constraint knobs are TPU/GSPMD
choices that compute the same function without a mesh; the port has one
dispatch (``models/moe.py``).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PerfFlags:
    # chunked-prefill slab width (tokens) and prefix-head alignment
    attn_chunk: int = 1024
    # override the per-arch MoE capacity factor (0.0 = use the config's)
    moe_capacity_factor: float = 0.0


FLAGS = PerfFlags()


def set_flags(flags: PerfFlags):
    global FLAGS
    FLAGS = flags


def get_flags() -> PerfFlags:
    return FLAGS
