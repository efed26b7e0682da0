"""Flash GQA decode attention: the Hopper kernel's wrapper and its plain
version.

Replaces the JAX package's Pallas TPU kernel ``flash_decode``
(``src/repro/kernels/flash_decode.py``). The CUDA source,
``csrc/flash_decode.cu``, carries the design note: one block per
(kv head, slot) holding all G q rows, a loop over 128-key tiles only up
to the slot's ``kv_len``, fp32 m/l/acc, and 0 (not NaN) for
``kv_len == 0``. Its tile arithmetic is ``csrc/decode_tile.cuh``, which
the paged and verify kernels share; head dims 32, 64 and 128.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

HEAD_DIMS = (32, 64, 128)     # the head dims the kernels are built for
MAX_ROWS = 64     # the most q rows one block holds (decode_tile.cuh)
# q, k_cache, v_cache, kv_len, out; B, Hq, Hkv, Sk, hd; cap, scale; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def check_cache(kernel: str, q, k_cache, v_cache, W: int = 0):
    """Shared checks of the dense decode-family kernels: contiguous bf16
    q (B,Hq,hd) (decode: W = 0) or (B,Hq,W,hd) (verify), caches
    (B,Hkv,Sk,hd) on q's device, hd in HEAD_DIMS, Hq a multiple of Hkv
    and at most MAX_ROWS query rows per kv head. Raises ValueError."""
    for name, t, nd in (("q", q, 4 if W else 3),
                        ("k_cache", k_cache, 4), ("v_cache", v_cache, 4)):
        _build.check_tensor(kernel, name, t, torch.bfloat16, nd, q.device)
    B, Hq, hd = q.shape[0], q.shape[1], q.shape[-1]
    Hkv = k_cache.shape[1]
    if (hd not in HEAD_DIMS or k_cache.shape[0] != B
            or k_cache.shape[3] != hd or v_cache.shape != k_cache.shape
            or Hq % Hkv or Hq // Hkv * max(W, 1) > MAX_ROWS):
        raise ValueError(f"{kernel}: unsupported shapes q {tuple(q.shape)} "
                         f"caches {tuple(k_cache.shape)} (head dim in "
                         f"{HEAD_DIMS}, Hq % Hkv == 0, rows per kv head "
                         f"<= {MAX_ROWS})")


def flash_decode(q, k_cache, v_cache, kv_len, *, cap: float = 0.0,
                 scale: float = 0.0):
    """q: (B,Hq,hd); caches: (B,Hkv,Sk,hd) bf16; kv_len: scalar or (B,)
    int. Returns (B,Hq,hd) bf16."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len, cap=cap,
                                    scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    check_cache("flash_decode", q, k_cache, v_cache)
    B, Hq, hd = q.shape
    Hkv, Sk = k_cache.shape[1], k_cache.shape[2]
    kvl = _build.kv_len_i32(kv_len, B, q.device)
    scale = scale if scale else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    fn = _build.entry("flash_decode", "flash_decode_bf16", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                kvl.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sk, hd,
                float(cap), float(scale), stream)
    _build.check_rc("flash_decode", rc)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
