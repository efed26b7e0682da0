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

Its gradient is ``moe_router_bwd``, a kernel with no TPU counterpart
(``csrc/moe_router_bwd.cu``, a warp a token): the renormalised top-k of
a softmax depends only on the chosen logits, so a token's chosen expert
j gets ``w_j (dw_j - sum_i w_i dw_i)`` and every other expert 0. Its
plain version is ``ref.router_topk_bwd_ref`` (autograd through the
plain forward). ``MoeRouterFn`` joins the two for training: its forward
is ``moe_router_topk`` as it is, its backward the backward kernel (on
the CPU both plain versions); ``backend.router_topk`` goes through it
only when grad is enabled and the logits require it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import router_topk_bwd_ref, router_topk_ref

MAX_EXPERTS = 512     # logits one warp holds in registers (16 per lane)
MAX_K = 8
# logits, w, idx; T, E, k; stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# w, idx, dw, dlogits; T, E, k; stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p])


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


def moe_router_bwd(logits, w, idx, dw):
    """The gradient of ``moe_router_topk``'s weights: dlogits (T,E) fp32
    from the forward's logits (T,E) (their shape and device; the plain
    version recomputes from them), weights w (T,k) fp32, ids idx (T,k)
    int32 and the weights' cotangent dw (T,k)."""
    if logits.device.type == "cpu":
        return router_topk_bwd_ref(logits, w.shape[1], dw)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_router_bwd: no kernel for device "
                         f"{logits.device}")
    T, E = logits.shape
    k = w.shape[1] if w.ndim == 2 else 0
    for name, t, dtype in (("w", w, torch.float32), ("idx", idx, torch.int32),
                           ("dw", dw, torch.float32)):
        _build.check_tensor("moe_router_bwd", name, t, dtype, 2,
                            logits.device)
        if tuple(t.shape) != (T, k):
            raise ValueError(f"moe_router_bwd: {name} {tuple(t.shape)} != "
                             f"({T}, {k})")
    if E > MAX_EXPERTS or not 0 < k <= min(MAX_K, E):
        raise ValueError(f"moe_router_bwd: unsupported E={E}, k={k} "
                         f"(E <= {MAX_EXPERTS}, 0 < k <= min({MAX_K}, E))")
    dlogits = torch.empty((T, E), dtype=torch.float32, device=logits.device)
    fn = _build.entry("moe_router_bwd", "moe_router_bwd_f32", _BWD_ARGTYPES)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(w.data_ptr(), idx.data_ptr(), dw.data_ptr(),
                dlogits.data_ptr(), T, E, k, stream)
    _build.check_rc("moe_router_bwd", rc)
    moe_router_bwd.launches += 1
    return dlogits


moe_router_bwd.launches = 0


class MoeRouterFn(torch.autograd.Function):
    """``moe_router_topk`` with the backward kernel as its gradient: (w,
    idx) of (T,E) fp32 logits; idx has no gradient."""

    @staticmethod
    def forward(ctx, logits, k):
        w, idx = moe_router_topk(logits, k)
        ctx.save_for_backward(logits, w, idx)
        ctx.mark_non_differentiable(idx)
        return w, idx

    @staticmethod
    def backward(ctx, dw, _didx):
        logits, w, idx = ctx.saved_tensors
        return moe_router_bwd(logits, w, idx, dw.contiguous()), None
