"""The port's kernel op surface.

The op names and call signatures are those of the JAX package's
``kernels/backend.py:OP_SURFACE``, so each later slice fills in the same
names. There is no backend switch: every op dispatches by the device of
its tensors. A CUDA tensor goes to the hand-written Hopper kernel, a CPU
tensor to the kernel's plain PyTorch version; nothing falls back.
With grad enabled and an input requiring it, ``attention``,
``router_topk``, ``selective_scan`` and ``mlstm_scan`` go through their
kernels' autograd Functions, whose backwards are kernels too
(``flash_prefill_bwd``, ``moe_router_bwd``, ``ssm_scan_bwd`` and
``mlstm_scan_bwd``, no ops of their own: the JAX package differentiates
its references); every other call, serving's among them, is the direct
kernel call.

On the meta device (the dry-run's sizing of a full-width step, which
holds no data) ``attention``, ``decode_attention``, ``router_topk``,
``selective_scan`` and ``mlstm_scan`` return empty outputs of their
shapes and dtypes, differentiable, and add the flops of the call (and
of its backward, when one runs) to ``META_FLOPS``: no kernel or plain
version runs, and a 32k-step scan is not stepped.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_decode_paged import flash_decode_paged
from repro_torch.kernels.flash_prefill import FlashPrefillFn, \
    flash_prefill, flash_prefill_bwd
from repro_torch.kernels.flash_verify import flash_verify, \
    flash_verify_paged
from repro_torch.kernels.mlstm_scan import MlstmScanFn, \
    mlstm_scan as _mlstm_scan, mlstm_scan_bwd
from repro_torch.kernels.moe_router import MoeRouterFn, moe_router_bwd, \
    moe_router_topk
from repro_torch.kernels.ref import mlstm_zero_state
from repro_torch.kernels.ssm_scan import SsmScanFn, ssm_scan, ssm_scan_bwd

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


def check_op_signature(op: str, impl: Callable) -> Optional[str]:
    """Return a defect description if ``impl`` cannot accept the
    declared :data:`OP_SURFACE` call for ``op``, else None (the JAX
    package's rule, ``repro.kernels.backend.check_op_signature``).

    Rules: the leading positional parameter names must match the
    surface exactly (callers pass them positionally); every declared
    keyword-only name must be accepted; any parameter beyond the
    surface must have a default (so surface-shaped calls still bind).
    """
    pos_names, kw_names = OP_SURFACE[op]
    try:
        params = list(inspect.signature(impl).parameters.values())
    except (TypeError, ValueError):          # builtins / C callables
        return None
    pos = [p for p in params if p.kind in (p.POSITIONAL_ONLY,
                                           p.POSITIONAL_OR_KEYWORD)]
    kws = {p.name: p for p in params if p.kind == p.KEYWORD_ONLY}
    has_var_kw = any(p.kind == p.VAR_KEYWORD for p in params)
    got = tuple(p.name for p in pos[:len(pos_names)])
    if got != pos_names:
        return (f"positional params {got} != declared {pos_names}")
    for extra in pos[len(pos_names):]:
        if extra.default is extra.empty:
            return (f"extra positional param {extra.name!r} without a "
                    f"default breaks surface-shaped calls")
    if not has_var_kw:
        missing = [n for n in kw_names if n not in kws]
        if missing:
            return f"missing keyword params {missing}"
    for name, p in kws.items():
        if name not in kw_names and p.default is p.empty:
            return (f"extra keyword-only param {name!r} without a "
                    f"default breaks surface-shaped calls")
    return None

#: every ported kernel wrapper; each counts its launches in ``.launches``
KERNELS = (flash_prefill, flash_decode, flash_decode_paged, flash_verify,
           flash_verify_paged, moe_router_topk, ssm_scan, _mlstm_scan,
           flash_prefill_bwd, moe_router_bwd, ssm_scan_bwd, mlstm_scan_bwd)


#: flops of the calls made on the meta device, by op (``_bwd``: their
#: backwards); the dry-run resets and reads it
META_FLOPS: Dict[str, float] = {}


def _meta(t) -> bool:
    return t is not None and t.device.type == "meta"


class _MetaOp(torch.autograd.Function):
    """Empty outputs of the given (shape, dtype)s; the forward's and the
    backward's flops are counted in ``META_FLOPS``."""

    @staticmethod
    def forward(ctx, name, flops, bwd_flops, outs, *inputs):
        META_FLOPS[name] = META_FLOPS.get(name, 0.0) + flops
        ctx.name, ctx.bwd_flops = name, bwd_flops
        ctx.ins = [(t.shape, t.dtype) if isinstance(t, torch.Tensor)
                   else None for t in inputs]
        return tuple(torch.empty(s, dtype=d, device="meta") for s, d in outs)

    @staticmethod
    def backward(ctx, *grads):
        key = ctx.name + "_bwd"
        META_FLOPS[key] = META_FLOPS.get(key, 0.0) + ctx.bwd_flops
        return (None,) * 4 + tuple(
            torch.empty(s[0], dtype=s[1], device="meta")
            if s is not None and s[1].is_floating_point else None
            for s in ctx.ins)


def _pairs(Sq: int, Sk: int, causal: bool, window: int, q_offset) -> int:
    """(query, key) pairs an attention call scores."""
    if not causal:
        return Sq * Sk
    i = int(q_offset) + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Sk)
    lo = np.maximum(i - window + 1, 0) if window else 0
    return int(np.maximum(hi - lo, 0).sum())


def _meta_attention(q, k, v, causal, window, q_offset, kv_rows=None):
    B, Hq, Sq, hd = q.shape
    pairs = (Sq * kv_rows if kv_rows is not None
             else _pairs(Sq, k.shape[2], causal, window, q_offset))
    fl = 4.0 * B * Hq * pairs * hd
    return _MetaOp.apply("attention" if kv_rows is None
                         else "decode_attention", fl, 2.5 * fl,
                         [(tuple(q.shape), q.dtype)], q, k, v)[0]


def _grad(*ts) -> bool:
    """Grad is enabled and one of ``ts`` (tensors or None) requires it."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def attention(q, k, v, *, causal=True, window=0, cap=0.0, scale=0.0,
              q_offset=0):
    """With grad enabled and an input requiring it, the kernel's backward
    (``flash_prefill_bwd``) is its gradient; otherwise the direct call."""
    if _meta(q):
        return _meta_attention(q, k, v, causal, window, q_offset)
    if _grad(q, k, v):
        return FlashPrefillFn.apply(q, k, v, causal, window, cap, scale,
                                    q_offset)
    return flash_prefill(q, k, v, causal=causal, window=window, cap=cap,
                         scale=scale, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, kv_len, *, cap=0.0, scale=0.0):
    if _meta(q):
        return _meta_attention(q[:, :, None], k_cache, v_cache, False, 0, 0,
                               k_cache.shape[2])[:, :, 0]
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
    """logits: (T,E) fp32 -> (weights (T,k) fp32, ids (T,k) int32). With
    grad, the weights' gradient is ``moe_router_bwd``."""
    if _meta(logits):
        T, E = logits.shape
        return _MetaOp.apply("router_topk", T * E * (k + 4.0),
                             3.0 * T * E, [((T, k), torch.float32),
                                           ((T, k), torch.int32)], logits)
    if _grad(logits):
        return MoeRouterFn.apply(logits, k)
    return moe_router_topk(logits, k)


def selective_scan(dt, x, B_, C_, A, h0=None):
    """dt, x: (B,S,di); B_, C_: (B,S,n); A: (di,n); h0: (B,di,n) or None
    (zeros); fp32 -> (y (B,S,di) fp32, h_last (B,di,n) fp32). With grad,
    the gradient is ``ssm_scan_bwd``."""
    if _meta(x):
        B, S, di = x.shape
        n = A.shape[-1]
        fl = 7.0 * B * S * di * n
        return _MetaOp.apply("selective_scan", fl, 2.0 * fl,
                             [((B, S, di), torch.float32),
                              ((B, di, n), torch.float32)],
                             dt, x, B_, C_, A, h0)
    if _grad(dt, x, B_, C_, A, h0):
        if h0 is None:
            h0 = torch.zeros((x.shape[0], x.shape[2], A.shape[-1]),
                             dtype=torch.float32, device=x.device)
        return SsmScanFn.apply(dt, x, B_, C_, A, h0)
    return ssm_scan(dt, x, B_, C_, A, h0)


def mlstm_scan(q, k, v, i_pre, f_pre, state=None, *, scale=0.0):
    """q, k, v: (B,H,S,hd); i_pre, f_pre: (B,H,S); state: (C (B,H,hd,hd),
    n (B,H,hd), m (B,H)) or None (fresh); fp32 -> (h (B,H,S,hd) fp32,
    the state after the last step). With grad, the gradient is
    ``mlstm_scan_bwd``."""
    if _meta(q):
        B, H, S, hd = q.shape
        f32 = torch.float32
        fl = 6.0 * B * H * S * hd * hd
        h, C, n, m = _MetaOp.apply(
            "mlstm_scan", fl, 2.0 * fl,
            [((B, H, S, hd), f32), ((B, H, hd, hd), f32), ((B, H, hd), f32),
             ((B, H), f32)], q, k, v, i_pre, f_pre, *(state or ()))
        return h, (C, n, m)
    if _grad(q, k, v, i_pre, f_pre, *(state or ())):
        B, H, _, hd = q.shape
        if state is None:
            state = mlstm_zero_state(B, H, hd, q.device)
        h, C, n, m = MlstmScanFn.apply(q, k, v, i_pre, f_pre, *state, scale)
        return h, (C, n, m)
    return _mlstm_scan(q, k, v, i_pre, f_pre, state, scale=scale)
