"""Core model primitives: norms, rotary embeddings, attention, MLPs.

Ports of the JAX package's ``models/layers.py`` for the attention layers
of the served planner and the MoE families. Parameters live in small
``nn.Module``s whose tensor names and layouts are the JAX param tree's
(``x @ wq`` with wq of shape (d, q_dim)), so the weight bridge maps
leaves one to one. The ops are
plain tensor functions. Attention goes through the kernel op surface
(``kernels/backend.py``), which picks the Hopper kernel or its plain
version by device; the projections and the MLP stay ``torch.matmul``,
as the JAX package leaves them to XLA.

Prefill and extend run every row-wise product in calls of a fixed
number of rows per product (``matmul_rows``, ``fixed=True``): cuBLAS
picks its kernel by shape, and on an H100 a (32, 7168) @ (7168, 1024)
product takes a split-K kernel whose rows differ in the last bits from
the same rows inside a (1050, 7168) product. A chunk seam or a prefix
hit feeds a token's row to calls of other sizes than a monolithic
prefill does, so only fixed-size calls keep chunked prefill and prefix
hits bitwise monolithic. The rows of a call (``row_block``) shrink as
the product widens, so the zero padding of the last call stays under
``ROW_CALL_MACS`` multiply-adds while a narrow model (the planner)
makes few calls. Decode and verify keep their one call of the batch's
rows (every step has the same shape).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import backend as KB


#: multiply-adds of one fixed-size product call (``row_block``)
ROW_CALL_MACS = 2 ** 31


def row_block(K: int, N: int) -> int:
    """Rows of each fixed-size call of a (K, N) product: the largest
    power of two with at most ROW_CALL_MACS multiply-adds, within
    [128, 1024] (planner widths 1024, kimi-k2's 128-512)."""
    rows = max(ROW_CALL_MACS // (K * N), 1)
    return max(128, min(1024, 1 << (rows.bit_length() - 1)))


def matmul_rows(x, w, fixed: bool = False):
    """x (..., K) @ w (K, N). ``fixed``: in calls of exactly
    ``row_block(K, N)`` rows, the last one zero-padded, so each row's
    result does not depend on how many rows the caller passes (see the
    module note)."""
    if not fixed:
        return x @ w
    lead, (K, N) = x.shape[:-1], w.shape
    rb = row_block(K, N)
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    n = -(-M // rb)
    if n * rb != M:
        x2 = F.pad(x2, (0, 0, 0, n * rb - M))
    # one call (most prefill chunks at narrow widths) needs no cat
    out = x2 @ w if n == 1 else torch.cat([x2[i * rb:(i + 1) * rb] @ w
                                           for i in range(n)])
    return out[:M].reshape(*lead, N)


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


def expert_param(n: int, shape, std, gen, dtype, device):
    """A stack of ``n`` expert matrices (n, *shape), N(0, std), drawn one
    expert at a time ON ``device`` from a generator there, seeded from
    ``gen``. Expert stacks are most of an MoE model's weights (27-34 GB
    at full width): one CPU generator would take minutes and a whole-stack
    fp32 draw would need twice the stack's memory, so each expert is
    drawn in fp32 and cast into its slot. The same seed gives the same
    stacks on the same device type, and other bits on the card than on
    the CPU; a comparison across devices copies one model to the other."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    dev_gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.empty((n, *shape), dtype=dtype, device=device)
    for e in range(n):
        t[e] = (torch.randn(shape, generator=dev_gen, dtype=torch.float32,
                            device=device) * std).to(dtype)
    return nn.Parameter(t, requires_grad=False)


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


def qkv_proj(p: Attention, x, cfg: ModelConfig, fixed: bool = False):
    """x: (B,S,d) -> q (B,Hq,S,hd), k,v (B,Hkv,S,hd) (pre-RoPE)."""
    B, S, _ = x.shape
    mm = lambda w: matmul_rows(x, w, fixed)
    q = mm(p.wq).reshape(B, S, cfg.n_heads, cfg.d_head).transpose(1, 2)
    k = mm(p.wk).reshape(B, S, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    v = mm(p.wv).reshape(B, S, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    return q, k, v


def out_proj(p: Attention, attn_out, fixed: bool = False):
    """attn_out: (B,H,S,hd) -> (B,S,d)."""
    B, H, S, hd = attn_out.shape
    return matmul_rows(attn_out.transpose(1, 2).reshape(B, S, H * hd), p.wo,
                       fixed)


# -------------------------------------------------------------------- mlp ----

class MLP(nn.Module):
    """SiLU-GLU MLP of any width: the planner's and arctic's d_ff, kimi's
    dense layer (top_k * d_expert) and the MoE dense residual and shared
    expert."""

    def __init__(self, d: int, d_ff: int, act: str, gen, dtype, device):
        super().__init__()
        if act != "silu_glu":
            raise NotImplementedError(f"mlp_act {act!r} comes with its "
                                      f"model family (ROADMAP.md queue A12)")
        self.act = act
        self.w_gate = dense_param((d, d_ff), gen, dtype, device)
        self.w_up = dense_param((d, d_ff), gen, dtype, device)
        self.w_down = dense_param((d_ff, d), gen, dtype, device)


def mlp(p: MLP, x, fixed: bool = False):
    h = F.silu(matmul_rows(x, p.w_gate, fixed)) * matmul_rows(x, p.w_up,
                                                              fixed)
    return matmul_rows(h, p.w_down, fixed)
