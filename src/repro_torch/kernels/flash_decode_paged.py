"""Paged flash GQA decode attention: the Hopper kernel's wrapper and its
plain version.

Replaces the JAX package's Pallas TPU kernel ``flash_decode_paged``
(``src/repro/kernels/flash_decode_paged.py``). The CUDA source,
``csrc/flash_decode_paged.cu``, carries the design note: flash_decode's
kernel and routine (``csrc/decode_warp.cuh``) with a paged source, which
fills each 128-key tile through the slot's block table in row boxes of
``gcd(bs, 128)`` rows (sentinel entries clamp to the last block), so the
output is bitwise flash_decode's on the gathered view at any block size.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.paged_decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import HEAD_DIMS
from repro_torch.kernels.ref import paged_decode_attention_ref

# q, k_pages, v_pages, block_tab, kv_len, out; B, Hq, Hkv, nb, bs, mb, hd;
# cap, scale; stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def check_pages(kernel: str, q, k_pages, v_pages, block_tab):
    """Shared shape checks of the paged kernels: pools (nb,Hkv,bs,hd)
    bf16, a (B,mb) int32 table, the head dim and Hq a multiple of Hkv.
    Raises ValueError."""
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _build.check_tensor(kernel, name, t, torch.bfloat16, 4, dev)
    _build.check_tensor(kernel, "block_tab", block_tab, torch.int32, 2, dev)
    B, Hq, hd = q.shape[0], q.shape[1], q.shape[-1]
    nb, Hkv, bs = k_pages.shape[:3]
    if (hd not in HEAD_DIMS or k_pages.shape[3] != hd
            or v_pages.shape != k_pages.shape or block_tab.shape[0] != B
            or Hq % Hkv):
        raise ValueError(f"{kernel}: unsupported shapes q {tuple(q.shape)} "
                         f"pages {tuple(k_pages.shape)} table "
                         f"{tuple(block_tab.shape)} (head dim in "
                         f"{HEAD_DIMS}, Hq % Hkv == 0)")


def flash_decode_paged(q, k_pages, v_pages, block_tab, kv_len, *,
                       cap: float = 0.0, scale: float = 0.0):
    """q: (B,Hq,hd); pages: (n_blocks,Hkv,bs,hd) bf16; block_tab: (B,mb)
    int32 (entries >= n_blocks are sentinels); kv_len: scalar or (B,)
    int, at most mb*bs. Returns (B,Hq,hd) bf16."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tab,
                                          kv_len, cap=cap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged: no kernel for device "
                         f"{q.device}")
    _build.check_tensor("flash_decode_paged", "q", q, torch.bfloat16, 3,
                        q.device)
    B, Hq, hd = q.shape
    nb, Hkv, bs = k_pages.shape[:3]
    check_pages("flash_decode_paged", q, k_pages, v_pages, block_tab)
    mb = block_tab.shape[1]
    kvl = _build.kv_len_i32(kv_len, B, q.device)
    scale = scale if scale else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    fn = _build.entry("flash_decode_paged", "flash_decode_paged_bf16",
                      _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tab.data_ptr(), kvl.data_ptr(), out.data_ptr(), B, Hq,
                Hkv, nb, bs, mb, hd, float(cap), float(scale), stream)
    _build.check_rc("flash_decode_paged", rc)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
