"""Flash prefill attention: the Hopper kernel's wrapper and its plain
version.

Replaces the JAX package's Pallas TPU kernel ``flash_prefill``
(``src/repro/kernels/flash_prefill.py``). The CUDA source,
``csrc/flash_prefill.cu``, carries the design note: one warpgroup per
(64-row q tile, q head, batch), both products on the tensor cores
(``wgmma``; P rounded to bf16 for P V), Q and a ring of 64-key K/V tiles
loaded by TMA, fp32 m/l/acc, and row arithmetic that does not depend on
the row's place in its tile, so prefill and extend give the same bits
for a row at the same position; head dims 32, 64 and 128.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.attention_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

HEAD_DIMS = (32, 64, 128)     # the head dims the kernel is built for
# q, k, v, out; B, Hq, Hkv, Sq, Sk, hd, q_offset, causal, window;
# cap, scale; stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
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
