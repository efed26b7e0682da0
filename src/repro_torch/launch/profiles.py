"""Tuned performance profiles per (architecture × workload): a copy of
the JAX package's ``launch/profiles.py``.

Codifies the EXPERIMENTS.md §Perf / §Prod-profile results as deployable
configurations: ``resolve(arch, shape)`` returns the (perf_spec,
strategy_spec) pair that won the hillclimb for that pair class, so
launchers and the dry-run can opt in with ``--profile prod`` instead of
hand-assembling flags.

Layering:
  1. BASE_PERF      — profile-wide winners, safe fleet-wide (all gated
                      internally on divisibility / seq-length / mesh).
  2. ARCH_PERF      — per-arch additions (MoE archs use the shard_map
                      expert-parallel dispatch).
  3. PAIR_OVERRIDES — per-(arch, shape) exceptions where the sweep showed
                      the base profile loses to GSPMD's own plan.
"""
from __future__ import annotations

from typing import Dict, Tuple

BASE_PERF = ("attn_constraint=auto,attn_chunk_remat=on,"
             "moe_constraint=auto,attn_window_slice=on,ssm_scan_chunk=4096")

ARCH_PERF: Dict[str, str] = {
    # shard_map expert-parallel dispatch: −58% bottleneck on kimi prefill,
    # −84% on kimi train (vs baseline); S=1 decode falls back internally.
    "kimi-k2-1t-a32b": "moe_dispatch=shard_map",
    "arctic-480b": "moe_dispatch=shard_map",
}

# (arch, shape) -> (perf_additions, strategy_spec)
PAIR_OVERRIDES: Dict[Tuple[str, str], Tuple[str, str]] = {
    # sequence-parallel prefill + wide q-chunks: 9.85 s -> 2.12 s
    ("gemma2-2b", "prefill_32k"): ("attn_chunk=4096",
                                   "prefill_seq_axis=model"),
    # 64-head wide models: GSPMD's seq-sharded-KV prefill beats the
    # q-head TP pin by ~8-10% — drop the attention constraint there.
    ("qwen1.5-110b", "prefill_32k"): ("attn_constraint=off", ""),
    ("qwen2-vl-72b", "prefill_32k"): ("attn_constraint=off", ""),
}


def resolve(arch: str, shape: str) -> Tuple[str, str]:
    """Return (perf_spec, strategy_spec) for a pair under the prod profile.

    Later fragments win inside PerfFlags.apply_overrides, so pair-level
    overrides are appended last.
    """
    perf = BASE_PERF
    if arch in ARCH_PERF:
        perf += "," + ARCH_PERF[arch]
    strategy = ""
    if (arch, shape) in PAIR_OVERRIDES:
        extra, strategy = PAIR_OVERRIDES[(arch, shape)]
        if extra:
            perf += "," + extra
    return perf, strategy
