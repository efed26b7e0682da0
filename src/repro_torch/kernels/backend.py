"""The port's kernel op surface.

The op names and call signatures are those of the JAX package's
``kernels/backend.py:OP_SURFACE``, so each later slice fills in the same
names. There is no backend switch: every op dispatches by the device of
its tensors. A CUDA tensor goes to the hand-written Hopper kernel, a CPU
tensor to the kernel's plain PyTorch version; nothing falls back.
``attention`` with grad enabled goes through ``flash_prefill``'s
autograd Function, whose backward is a kernel too (``flash_prefill_bwd``,
no op of its own: the JAX package differentiates its reference).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_decode_paged import flash_decode_paged
from repro_torch.kernels.flash_prefill import FlashPrefillFn, \
    flash_prefill, flash_prefill_bwd
from repro_torch.kernels.flash_verify import flash_verify, \
    flash_verify_paged
from repro_torch.kernels.mlstm_scan import mlstm_scan as _mlstm_scan
from repro_torch.kernels.moe_router import moe_router_topk
from repro_torch.kernels.ssm_scan import ssm_scan

#: ``op -> (positional arg names, keyword-only arg names)``, as in the
#: JAX package.
OP_SURFACE: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "attention": (("q", "k", "v"),
                  ("causal", "window", "cap", "scale", "q_offset")),
    "decode_attention": (("q", "k_cache", "v_cache", "kv_len"),
                         ("cap", "scale")),
    "paged_decode_attention": (
        ("q", "k_pages", "v_pages", "block_tab", "kv_len"),
        ("cap", "scale")),
    "verify_attention": (("q", "k_cache", "v_cache", "kv_len"),
                         ("cap", "scale")),
    "paged_verify_attention": (
        ("q", "k_pages", "v_pages", "block_tab", "kv_len"),
        ("cap", "scale")),
    "router_topk": (("logits", "k"), ()),
    "selective_scan": (("dt", "x", "B_", "C_", "A", "h0"), ()),
    "mlstm_scan": (("q", "k", "v", "i_pre", "f_pre", "state"), ("scale",)),
}

OPS: Tuple[str, ...] = tuple(OP_SURFACE)

#: every ported kernel wrapper; each counts its launches in ``.launches``
KERNELS = (flash_prefill, flash_decode, flash_decode_paged, flash_verify,
           flash_verify_paged, moe_router_topk, ssm_scan, _mlstm_scan,
           flash_prefill_bwd)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def attention(q, k, v, *, causal=True, window=0, cap=0.0, scale=0.0,
              q_offset=0):
    """With grad enabled and an input requiring it, the kernel's backward
    (``flash_prefill_bwd``) is its gradient; otherwise the direct call."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashPrefillFn.apply(q, k, v, causal, window, cap, scale,
                                    q_offset)
    return flash_prefill(q, k, v, causal=causal, window=window, cap=cap,
                         scale=scale, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, kv_len, *, cap=0.0, scale=0.0):
    return flash_decode(q, k_cache, v_cache, kv_len, cap=cap, scale=scale)


def paged_decode_attention(q, k_pages, v_pages, block_tab, kv_len, *,
                           cap=0.0, scale=0.0):
    return flash_decode_paged(q, k_pages, v_pages, block_tab, kv_len,
                              cap=cap, scale=scale)


def verify_attention(q, k_cache, v_cache, kv_len, *, cap=0.0, scale=0.0):
    return flash_verify(q, k_cache, v_cache, kv_len, cap=cap, scale=scale)


def paged_verify_attention(q, k_pages, v_pages, block_tab, kv_len, *,
                           cap=0.0, scale=0.0):
    return flash_verify_paged(q, k_pages, v_pages, block_tab, kv_len,
                              cap=cap, scale=scale)


def router_topk(logits, k):
    """logits: (T,E) fp32 -> (weights (T,k) fp32, ids (T,k) int32)."""
    return moe_router_topk(logits, k)


def selective_scan(dt, x, B_, C_, A, h0=None):
    """dt, x: (B,S,di); B_, C_: (B,S,n); A: (di,n); h0: (B,di,n) or None
    (zeros); fp32 -> (y (B,S,di) fp32, h_last (B,di,n) fp32)."""
    return ssm_scan(dt, x, B_, C_, A, h0)


def mlstm_scan(q, k, v, i_pre, f_pre, state=None, *, scale=0.0):
    """q, k, v: (B,H,S,hd); i_pre, f_pre: (B,H,S); state: (C (B,H,hd,hd),
    n (B,H,hd), m (B,H)) or None (fresh); fp32 -> (h (B,H,S,hd) fp32,
    the state after the last step)."""
    return _mlstm_scan(q, k, v, i_pre, f_pre, state, scale=scale)
