"""Speculative-verify attention, dense and paged: the Hopper kernels'
wrappers and their plain versions.

Replaces the JAX package's Pallas TPU kernels ``flash_verify`` and
``flash_verify_paged`` (``src/repro/kernels/flash_verify.py``). The CUDA
source, ``csrc/flash_verify.cu``, carries the design notes. Both run
flash_decode's routine (``csrc/decode_warp.cuh``): a warp per row,
blocks of at most four warps (eight at head dims 128 and 256) over (kv
head, slot, row blocks), so any G and W work, the slot's K/V tiles shared by a
block's warps through a ring the copy engine fills, from the dense cache
or through the block table. Row w at key limit ``kv_len - W + w + 1``
runs exactly flash_decode's operations for that limit in both, so every
verify row is bitwise the decode row at its position and paged is
bitwise dense on the gathered view.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version the CPU path takes,
``ref.verify_rows_ref`` / ``ref.paged_verify_rows_ref`` (W decode-shaped
calls, so CPU verify rows are bitwise CPU decode rows too). The fused
oracles ``ref.verify_attention_ref`` / ``ref.paged_verify_attention_ref``
are what both are held against.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import check_cache
from repro_torch.kernels.flash_decode_paged import check_pages
from repro_torch.kernels.ref import paged_verify_rows_ref, verify_rows_ref

# q, k_cache, v_cache, kv_len, out; B, Hq, Hkv, W, Sk, hd; cap, scale;
# stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
# q, k_pages, v_pages, block_tab, kv_len, out; B, Hq, Hkv, W, nb, bs, mb,
# hd; cap, scale; stream
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def flash_verify(q, k_cache, v_cache, kv_len, *, cap: float = 0.0,
                 scale: float = 0.0):
    """q: (B,Hq,W,hd); caches: (B,Hkv,Sk,hd) bf16; kv_len: scalar or
    (B,) int, the valid rows after the verify write (row w sits at
    kv_len - W + w). Returns (B,Hq,W,hd) bf16."""
    if q.device.type == "cpu":
        return verify_rows_ref(q, k_cache, v_cache, kv_len, cap=cap,
                               scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_verify: no kernel for device {q.device}")
    check_cache("flash_verify", q, k_cache, v_cache, q.shape[2])
    B, Hq, W, hd = q.shape
    Hkv, Sk = k_cache.shape[1], k_cache.shape[2]
    kvl = _build.kv_len_i32(kv_len, B, q.device)
    scale = scale if scale else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    fn = _build.entry("flash_verify", "flash_verify_bf16", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                kvl.data_ptr(), out.data_ptr(), B, Hq, Hkv, W, Sk, hd,
                float(cap), float(scale), stream)
    _build.check_rc("flash_verify", rc)
    flash_verify.launches += 1
    return out


def flash_verify_paged(q, k_pages, v_pages, block_tab, kv_len, *,
                       cap: float = 0.0, scale: float = 0.0):
    """q: (B,Hq,W,hd); pages: (n_blocks,Hkv,bs,hd) bf16; block_tab: (B,mb)
    int32 (entries >= n_blocks are sentinels); kv_len: scalar or (B,)
    int, the valid rows after the verify write. Returns (B,Hq,W,hd)
    bf16."""
    if q.device.type == "cpu":
        return paged_verify_rows_ref(q, k_pages, v_pages, block_tab, kv_len,
                                     cap=cap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_verify_paged: no kernel for device "
                         f"{q.device}")
    _build.check_tensor("flash_verify_paged", "q", q, torch.bfloat16, 4,
                        q.device)
    B, Hq, W, hd = q.shape
    nb, Hkv, bs = k_pages.shape[:3]
    check_pages("flash_verify_paged", q, k_pages, v_pages, block_tab)
    mb = block_tab.shape[1]
    kvl = _build.kv_len_i32(kv_len, B, q.device)
    scale = scale if scale else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    fn = _build.entry("flash_verify", "flash_verify_paged_bf16",
                      _PAGED_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tab.data_ptr(), kvl.data_ptr(), out.data_ptr(), B, Hq,
                Hkv, W, nb, bs, mb, hd, float(cap), float(scale), stream)
    _build.check_rc("flash_verify_paged", rc)
    flash_verify_paged.launches += 1
    return out


flash_verify.launches = 0
flash_verify_paged.launches = 0
