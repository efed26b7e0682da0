"""Fused MoE router (softmax + top-k): the Hopper kernel's wrapper and its
plain version.

Replaces the JAX package's Pallas TPU kernel ``moe_router_topk``
(``src/repro/kernels/moe_router.py``). The CUDA source,
``csrc/moe_router.cu``, carries the design note: one warp per token row
with the row's logits in registers (ceil(E / 32) a lane, a template
instance per size), the softmax by warp shuffles, each lane's
probabilities ordered once, then k passes of one ``redux.sync`` max and
one min over the lanes' heads (ties to the lowest expert id) and the
chosen weights renormalised by their sum clamped at 1e-9.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.router_topk_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import router_topk_ref

MAX_EXPERTS = 512     # logits one warp holds in registers (16 per lane)
MAX_K = 8
# logits, w, idx; T, E, k; stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def moe_router_topk(logits, k: int):
    """logits: (T,E) fp32 -> (weights (T,k) fp32, expert ids (T,k) int32),
    ids in descending order of probability."""
    if logits.device.type == "cpu":
        w, idx, _ = router_topk_ref(logits, k)
        return w, idx
    if logits.device.type != "cuda":
        raise ValueError(f"moe_router_topk: no kernel for device "
                         f"{logits.device}")
    _build.check_tensor("moe_router_topk", "logits", logits, torch.float32,
                        2, logits.device)
    T, E = logits.shape
    if E > MAX_EXPERTS or not 0 < k <= min(MAX_K, E):
        raise ValueError(f"moe_router_topk: unsupported E={E}, k={k} "
                         f"(E <= {MAX_EXPERTS}, 0 < k <= min({MAX_K}, E))")
    w = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    fn = _build.entry("moe_router", "moe_router_topk_f32", _ARGTYPES)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(logits.data_ptr(), w.data_ptr(), idx.data_ptr(), T, E, k,
                stream)
    _build.check_rc("moe_router_topk", rc)
    moe_router_topk.launches += 1
    return w, idx


moe_router_topk.launches = 0
