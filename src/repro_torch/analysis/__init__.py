"""Determinism & hazard static-analysis suite of the port (``python -m
repro_torch.analysis``).

The JAX package's four analyzers (``repro.analysis``) over the port's
own tree, on one shared finding model:

  * RL0xx effects race detector   — tool handlers vs TOOL_EFFECTS;
  * RL1xx determinism lint        — wall-clock/stdlib-random/environ/
    unordered-set/float-key hygiene in core, serving, env, kernels;
  * RL2xx kernel contract checker — the ctypes boundary to the CUDA
    entries (argtypes against each ``extern "C"`` signature) and fp32
    exponents in the CUDA sources;
  * RL3xx kernel registry checker — the op surface, the kernel modules
    and sources every op reaches, the launch counters.
"""
from repro_torch.analysis.findings import (Finding, RULES, active,
                                           make_finding)
from repro_torch.analysis.runner import run_paths, run_repo

__all__ = ["Finding", "RULES", "active", "make_finding", "run_paths",
           "run_repo"]
