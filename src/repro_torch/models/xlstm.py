"""xLSTM blocks: the mLSTM (matrix memory) and the sLSTM (scalar memory).

Port of the JAX package's ``models/xlstm.py``. The parameters keep the
JAX leaf names, shapes and dtypes (``mlstm_init``, ``slstm_init``):

  * ``MLSTM``: bf16 ``up`` (d, 2 dh), ``wq``, ``wk``, ``wv`` (dh, dh),
    ``down`` (dh, d) and ``norm`` (dh); fp32 ``w_if`` (dh, 2H) drawn at
    0.1 / sqrt(dh), ``b_i`` = 0 and ``b_f`` = +3 (open forget gates),
    with dh = d proj_factor / 2 and heads of hd = dh / H;
  * ``SLSTM``: bf16 ``w_gates`` (d, 4d), ``r_gates`` (H, hd, 4 hd) drawn
    N(0, 1) / sqrt(hd), ``w_up`` (d, 2 d_ff), ``w_down`` (d_ff, d) with
    d_ff = int(d 4/3 / 2) 2, ``norm_ffn`` (d); fp32 ``b_gates`` (4d: z
    and i 0, f +3, o 0), with hd = d / H.

The forward follows the JAX functions' dtype steps: q, k and v are bf16
products cast to fp32, the gate preactivations an fp32 product, ``h`` is
cast back to the input's dtype, and the sLSTM's recurrent product takes
``h_prev`` in bf16. The mLSTM's recurrence runs through the kernel op
surface (``KB.mlstm_scan``: the Hopper ``mlstm_scan`` on the card, its
sequential plain version on the CPU). That is the JAX package's
non-reference path (``mlstm_seq`` with a kernel backend), the sequential
recurrence; the JAX reference backend runs the chunkwise form
(``_mlstm_chunk``: the same function, its numerator summed in another
order), so the two differ by rounding, which the tests hold with stated
tolerances. The sLSTM has no TPU kernel: its input projection is one
product over all S rows (the rows are independent), its recurrent
``R h`` a per-step loop, as JAX's ``lax.scan`` is.

``fixed`` (prefill and extend) runs every row product and norm in
fixed-size calls (``layers.matmul_rows``, ``layers.rmsnorm``), so a
row's bits do not depend on how a prompt is chunked. States keep the
JAX layout: the mLSTM's a tuple ``(C (B,H,hd,hd), n (B,H,hd), m
(B,H))``, the sLSTM's a dict ``{c, n, h, m}`` of (B,H,hd), all fp32.
Each block returns a new state; it never writes the one it is given.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import backend as KB
from repro_torch.kernels.ref import mlstm_zero_state
from repro_torch.models import layers as L


def _mlstm_dims(cfg: ModelConfig):
    """(d_in, dh, H, hd) of ``cfg``'s mLSTM: the up-projection's width,
    the inner width and its heads."""
    d_in = int(cfg.d_model * cfg.xlstm.proj_factor / 2) * 2
    dh = d_in // 2
    return d_in, dh, cfg.n_heads, dh // cfg.n_heads


def _f32_param(t: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(t.to(device), requires_grad=False)


class MLSTM(nn.Module):
    """The mLSTM block's parameters (the JAX ``mlstm_init`` tree)."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        d = cfg.d_model
        d_in, dh, H, _ = _mlstm_dims(cfg)
        f32 = torch.float32
        self.up = L.dense_param((d, d_in), gen, dtype, device)
        self.wq = L.dense_param((dh, dh), gen, dtype, device)
        self.wk = L.dense_param((dh, dh), gen, dtype, device)
        self.wv = L.dense_param((dh, dh), gen, dtype, device)
        self.w_if = L.dense_param((dh, 2 * H), gen, f32, device, scale=0.1)
        self.b_i = _f32_param(torch.zeros((H,), dtype=f32), device)
        self.b_f = _f32_param(torch.full((H,), 3.0, dtype=f32), device)
        self.norm = L.RMSNorm(dh, cfg.norm_eps, dtype, device)
        self.down = L.dense_param((dh, d), gen, dtype, device)


class SLSTM(nn.Module):
    """The sLSTM block's parameters (the JAX ``slstm_init`` tree)."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        hd = d // H
        d_ff = int(d * 4 / 3 / 2) * 2
        f32 = torch.float32
        self.w_gates = L.dense_param((d, 4 * d), gen, dtype, device)
        self.r_gates = L.normal_param((H, hd, 4 * hd), 1.0 / math.sqrt(hd),
                                      gen, dtype, device)
        self.b_gates = _f32_param(torch.cat([
            torch.zeros((2 * d,), dtype=f32), torch.full((d,), 3.0, dtype=f32),
            torch.zeros((d,), dtype=f32)]), device)
        self.w_up = L.dense_param((d, 2 * d_ff), gen, dtype, device)
        self.w_down = L.dense_param((d_ff, d), gen, dtype, device)
        self.norm_ffn = L.RMSNorm(d, cfg.norm_eps, dtype, device)


# ------------------------------------------------------------------ mLSTM ----

def mlstm_state_init(cfg: ModelConfig, batch: int, device):
    """Fresh mLSTM state of ``batch`` rows: C and n zeros, m -1e30."""
    _, _, H, hd = _mlstm_dims(cfg)
    return mlstm_zero_state(batch, H, hd, device)


def mlstm_seq(p: MLSTM, x_in, cfg: ModelConfig, state, fixed: bool = False):
    """x_in: (B,S,dh) inner activations -> (y (B,S,dh), new state)."""
    B, S, dh = x_in.shape
    H = cfg.n_heads
    hd = dh // H

    def to_heads(t):
        return t.reshape(B, S, H, hd).transpose(1, 2).float().contiguous()
    q = to_heads(L.matmul_rows(x_in, p.wq, fixed))
    k = to_heads(L.matmul_rows(x_in, p.wk, fixed))
    v = to_heads(L.matmul_rows(x_in, p.wv, fixed))
    gif = L.matmul_rows(x_in.float(), p.w_if, fixed).reshape(B, S, 2, H)
    i_pre = (gif[:, :, 0].transpose(1, 2)
             + p.b_i[None, :, None]).contiguous()
    f_pre = (gif[:, :, 1].transpose(1, 2)
             + p.b_f[None, :, None]).contiguous()
    h, new_state = KB.mlstm_scan(q, k, v, i_pre, f_pre, state,
                                 scale=1.0 / math.sqrt(hd))
    return h.transpose(1, 2).reshape(B, S, dh).to(x_in.dtype), new_state


def mlstm_block(p: MLSTM, x, cfg: ModelConfig, state, fixed: bool = False):
    """Full mLSTM block: up-proj -> mLSTM ⊙ silu(gate) -> down-proj."""
    inner, gate = torch.chunk(L.matmul_rows(x, p.up, fixed), 2, dim=-1)
    y, new_state = mlstm_seq(p, inner, cfg, state, fixed)
    y = L.rmsnorm(p.norm.scale, y, cfg.norm_eps, fixed) * F.silu(gate)
    return L.matmul_rows(y, p.down, fixed), new_state


# ------------------------------------------------------------------ sLSTM ----

def slstm_state_init(cfg: ModelConfig, batch: int, device):
    """Fresh sLSTM state of ``batch`` rows: c, n, h zeros, m -1e30."""
    H = cfg.n_heads
    hd = cfg.d_model // H

    def z():
        return torch.zeros((batch, H, hd), dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, H, hd), -1e30, dtype=torch.float32,
                            device=device)}


def slstm_step(p: SLSTM, wx_t, state, cfg: ModelConfig):
    """One timestep. wx_t: (B,4,H,hd) fp32, the step's input projection
    ``x_t @ w_gates``; state: dict(c, n, h, m) each (B,H,hd) fp32.
    Returns (h_t, new state)."""
    B, _, H, hd = wx_t.shape
    c, n, h_prev, m = state["c"], state["n"], state["h"], state["m"]
    rh = torch.einsum("bhd,hde->bhe", h_prev.to(p.r_gates.dtype),
                      p.r_gates)
    rh = rh.float().reshape(B, H, 4, hd).transpose(1, 2)
    pre = wx_t + rh + p.b_gates.reshape(4, H, hd)[None]
    z_pre, i_pre, f_pre, o_pre = pre.unbind(1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    logf = F.logsigmoid(f_pre)
    m_t = torch.maximum(logf + m, i_pre)
    fw = torch.exp(logf + m - m_t)
    iw = torch.exp(i_pre - m_t)
    c_t = fw * c + iw * z
    n_t = fw * n + iw
    h_t = o * c_t / torch.clamp(n_t, min=1e-6)
    return h_t, {"c": c_t, "n": n_t, "h": h_t, "m": m_t}


def slstm_seq(p: SLSTM, x, cfg: ModelConfig, state, fixed: bool = False):
    """x: (B,S,d). The input projection over all rows at once, then the
    sequential recurrence. Returns (y (B,S,d) in x's dtype, new state)."""
    B, S, d = x.shape
    H = cfg.n_heads
    wx = L.matmul_rows(x, p.w_gates, fixed).float().reshape(
        B, S, 4, H, d // H)
    hs = []
    for t in range(S):
        h_t, state = slstm_step(p, wx[:, t], state, cfg)
        hs.append(h_t)
    return torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype), state


def slstm_block(p: SLSTM, x, cfg: ModelConfig, state, fixed: bool = False):
    """sLSTM + gated FFN sub-block (the caller adds the residual)."""
    y, new_state = slstm_seq(p, x, cfg, state, fixed)
    h = L.rmsnorm(p.norm_ffn.scale, x + y, cfg.norm_eps, fixed)
    up, gate = torch.chunk(L.matmul_rows(h, p.w_up, fixed), 2, dim=-1)
    ffn = L.matmul_rows(F.silu(gate) * up, p.w_down, fixed)
    return y + ffn, new_state
