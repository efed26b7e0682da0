"""Core model primitives: norms, rotary embeddings, attention, MLPs.

Ports of the JAX package's ``models/layers.py`` for the served planner's
``"full"`` layers. Parameters live in small ``nn.Module``s whose tensor
names and layouts are the JAX param tree's (``x @ wq`` with wq of shape
(d, q_dim)), so the weight bridge maps leaves one to one. The ops are
plain tensor functions. Attention goes through the kernel op surface
(``kernels/backend.py``), which picks the Hopper kernel or its plain
version by device; the projections and the MLP stay ``torch.matmul``,
as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import backend as KB


def normal_param(shape, std, gen, dtype, device):
    """Seeded normal init (fp32 draw, cast) — drawn on the CPU so the same
    seed gives the same weights on every device; 0 std means zeros."""
    if std == 0.0:
        t = torch.zeros(shape, dtype=torch.float32)
    else:
        t = torch.randn(shape, generator=gen, dtype=torch.float32) * std
    return nn.Parameter(t.to(dtype).to(device), requires_grad=False)


def dense_param(shape, gen, dtype, device, scale: float = 1.0):
    return normal_param(shape, scale / math.sqrt(shape[0]), gen, dtype,
                        device)


# ----------------------------------------------------------------- norms ----

class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = normal_param((d,), 0.0, None, dtype, device)

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


def rmsnorm(scale, x, eps: float = 1e-6):
    """fp32 RMS normalisation; the zero-initialised scale enters as
    ``1 + scale``, as in the JAX package."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


# ------------------------------------------------------------------ rope ----

def rope_freqs(d_head: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float):
    """x: (..., S, d_head); positions: broadcastable to (..., S). fp32
    math, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention ----

def attention(q, k, v, *, causal: bool, window: int = 0, cap: float = 0.0,
              scale: float = 0.0, q_offset=0, kv_len=None):
    """q: (B,Hq,Sq,hd); k,v: (B,Hkv,Sk,hd). The JAX package's dispatch
    (``layers.py:144-153``): a single-token query against a ``kv_len``'d
    cache is decode attention; ``kv_len=None`` is prefill / extend with
    absolute query positions from ``q_offset``. Multi-token queries
    against a ``kv_len``'d cache are speculative verify, which
    ``models/blocks.py`` sends to ``KB.verify_attention`` itself."""
    if kv_len is not None and q.shape[2] == 1 and not window:
        out = KB.decode_attention(q[:, :, 0].contiguous(), k, v, kv_len,
                                  cap=cap, scale=scale)
        return out[:, :, None]
    if kv_len is None:
        return KB.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window, cap=cap,
                            scale=scale, q_offset=q_offset)
    raise ValueError(
        "multi-token attention against a kv_len'd cache is speculative "
        "verify: call KB.verify_attention (models/blocks.py does)")


# --------------------------------------------------------- attn projections --

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        if cfg.qkv_bias:
            raise NotImplementedError("qkv_bias comes with the qwen "
                                      "family (ROADMAP.md queue A12)")
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        self.wq = dense_param((d, qd), gen, dtype, device)
        self.wk = dense_param((d, kvd), gen, dtype, device)
        self.wv = dense_param((d, kvd), gen, dtype, device)
        self.wo = dense_param((qd, d), gen, dtype, device)


def qkv_proj(p: Attention, x, cfg: ModelConfig):
    """x: (B,S,d) -> q (B,Hq,S,hd), k,v (B,Hkv,S,hd) (pre-RoPE)."""
    B, S, _ = x.shape
    q = (x @ p.wq).reshape(B, S, cfg.n_heads, cfg.d_head).transpose(1, 2)
    k = (x @ p.wk).reshape(B, S, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    v = (x @ p.wv).reshape(B, S, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    return q, k, v


def out_proj(p: Attention, attn_out):
    """attn_out: (B,H,S,hd) -> (B,S,d)."""
    B, H, S, hd = attn_out.shape
    return attn_out.transpose(1, 2).reshape(B, S, H * hd) @ p.wo


# -------------------------------------------------------------------- mlp ----

class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, act: str, gen, dtype, device):
        super().__init__()
        if act != "silu_glu":
            raise NotImplementedError(f"mlp_act {act!r} comes with its "
                                      f"model family (ROADMAP.md queue A12)")
        self.act = act
        self.w_gate = dense_param((d, d_ff), gen, dtype, device)
        self.w_up = dense_param((d, d_ff), gen, dtype, device)
        self.w_down = dense_param((d_ff, d), gen, dtype, device)


def mlp(p: MLP, x):
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
