"""Flash prefill attention: the Hopper kernel's wrapper and its plain
version.

Replaces the JAX package's Pallas TPU kernel ``flash_prefill``
(``src/repro/kernels/flash_prefill.py``). The CUDA source,
``csrc/flash_prefill.cu``, carries the design note: one warpgroup per
(64-row q tile, q head, batch), both products on the tensor cores
(``wgmma``; P rounded to bf16 for P V), Q and a ring of 64-key K/V tiles
loaded by TMA, fp32 m/l/acc, and row arithmetic that does not depend on
the row's place in its tile, so prefill and extend give the same bits
for a row at the same position; head dims 16 (the hd-32 tiles with the
columns past 16 read as zeros), 32, 64, 128 and 256.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.attention_ref``.

Its gradient is ``flash_prefill_bwd``, a kernel with no TPU counterpart
(``csrc/flash_prefill_bwd.cu``: dQ, dK, dV from q, k, v and dO, causal
or not, Sq rows over Sk keys, at every head dim of HEAD_DIMS, q_offset
0; three passes, every product on the tensor cores, P and dS rounded to
bf16 before theirs), whose plain version is ``ref.attention_bwd_ref``
(autograd through ``attention_ref``), with the same arguments.
``FlashPrefillFn`` joins the two for training: its forward is
``flash_prefill`` as it is, its backward the backward kernel (on the CPU
both plain versions). ``backend.attention`` goes through it only when
grad is enabled and an input requires it; every other call, serving's
among them, is the direct ``flash_prefill`` call.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref

#: the head dims the kernel and its backward are built for
HEAD_DIMS = (16, 32, 64, 128, 256)
# q, k, v, out; B, Hq, Hkv, Sq, Sk, hd, q_offset, causal, window;
# cap, scale; stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
# the backward's q tile: its lse/dsum scratch holds Sq rounded up to it
BWD_ROWS = 64
# q, k, v, dout, dq, dk, dv, lse, dsum; B, Hq, Hkv, Sq, Sk, hd, causal,
# window; cap, scale; stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                 + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def check_shapes(q, k, v):
    """Raise ValueError unless the kernel takes these operands: contiguous
    bf16 q (B,Hq,Sq,hd), k and v (B,Hkv,Sk,hd) on q's device, hd in
    HEAD_DIMS, Hq a multiple of Hkv."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_tensor("flash_prefill", name, t, torch.bfloat16, 4,
                            q.device)
    B, Hq, Sq, hd = q.shape
    Hkv = k.shape[1]
    if (hd not in HEAD_DIMS or k.shape[0] != B or k.shape[3] != hd
            or v.shape != k.shape or Hq % Hkv):
        raise ValueError(f"flash_prefill: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} (head dim in {HEAD_DIMS}, "
                         f"Hq % Hkv == 0)")


def flash_prefill(q, k, v, *, causal: bool = True, window: int = 0,
                  cap: float = 0.0, scale: float = 0.0, q_offset=0):
    """q: (B,Hq,Sq,hd); k,v: (B,Hkv,Sk,hd) bf16 -> (B,Hq,Sq,hd) bf16.

    q_offset: absolute position of q[0] (an int, or a 0-d tensor)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, cap=cap,
                             q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: no kernel for device {q.device}")
    check_shapes(q, k, v)
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    fn = _build.entry("flash_prefill", "flash_prefill_bf16", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Hq, Hkv, Sq, Sk, hd, int(q_offset), int(bool(causal)),
                int(window), float(cap), float(scale), stream)
    _build.check_rc("flash_prefill", rc)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def flash_prefill_bwd(q, k, v, dout, *, causal: bool = True,
                      window: int = 0, cap: float = 0.0, scale: float = 0.0,
                      q_offset=0):
    """The gradient of ``flash_prefill``: (dq, dk, dv) bf16 in q's, k's
    and v's shapes, from q, k, v and ``dout`` (q's shape, bf16); causal
    or not, Sq and Sk any, the forward's head dims (``check_shapes``).
    q_offset 0 only (training's prefill): any other raises ValueError.
    The arguments of ``attention_bwd_ref``, its plain version."""
    if int(q_offset) != 0:
        raise ValueError(f"flash_prefill_bwd: q_offset {int(q_offset)} "
                         f"(the backward takes q_offset 0 only)")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, dout, causal=causal,
                                 window=window, cap=cap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_bwd: no kernel for device "
                         f"{q.device}")
    check_shapes(q, k, v)
    _build.check_tensor("flash_prefill_bwd", "dout", dout, torch.bfloat16, 4,
                        q.device)
    if dout.shape != q.shape:
        raise ValueError(f"flash_prefill_bwd: dout {tuple(dout.shape)} != "
                         f"q {tuple(q.shape)}")
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale else 1.0 / math.sqrt(hd)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # each row's log-sum-exp and D = sum p dP, fp32 scratch of Sq rows
    # rounded up to the kernel's 64-row tiles (a tile's 64 values are one
    # aligned copy)
    lse = torch.empty((B, Hq, -(-Sq // BWD_ROWS) * BWD_ROWS),
                      dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    fn = _build.entry("flash_prefill_bwd", "flash_prefill_bwd_bf16",
                      _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in (q, k, v, dout, dq, dk, dv, lse,
                                         dsum)),
                B, Hq, Hkv, Sq, Sk, hd, int(bool(causal)), int(window),
                float(cap), float(scale), stream)
    _build.check_rc("flash_prefill_bwd", rc)
    flash_prefill_bwd.launches += 1
    return dq, dk, dv


flash_prefill_bwd.launches = 0


class FlashPrefillFn(torch.autograd.Function):
    """``flash_prefill`` with the backward kernel as its gradient: causal
    or not, Sq rows over Sk keys, every head dim of HEAD_DIMS, at
    q_offset 0."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale, q_offset):
        if int(q_offset) != 0:
            raise ValueError(f"flash_prefill: a backward at q_offset "
                             f"{int(q_offset)} (0 only)")
        out = flash_prefill(q, k, v, causal=causal, window=window, cap=cap,
                            scale=scale)
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, cap=cap, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(q, k, v, dout.contiguous(),
                                       **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
