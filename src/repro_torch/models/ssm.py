"""Mamba-style selective state-space layer of the hymba hybrid blocks.

Port of the JAX package's ``models/ssm.py``. The parameters keep the JAX
leaf names, shapes and dtypes (``ssm_init``): bf16 ``in_proj`` (d, 2di),
``conv_w`` (K, di), ``conv_b``, ``w_bc`` (di, 2n), ``w_dt`` (di,
dt_rank), ``dt_proj`` (dt_rank, di), ``out_proj`` (di, d); fp32
``dt_bias``, ``A_log`` (di, n) and ``D``. The forward follows the JAX
function's dtype steps: the depthwise causal conv is bf16 products
summed in the JAX order (a sum of shifted products; not ``F.conv1d``,
which cuDNN runs in TF32 on the card), ``dt`` is the softplus in the
activation dtype, then fp32, the scan runs in fp32 through the kernel op
surface (``KB.selective_scan``: the Hopper ``ssm_scan`` on the card, its
sequential plain version on the CPU), then ``y + x D``, ``y silu(z)``,
cast to bf16, and ``out_proj``. Under grad (training) the scan's
gradient is its backward kernel (``KB.selective_scan`` goes through
``SsmScanFn``).

The JAX reference scans in chunks with an associative scan; the port's
scan is sequential everywhere, so the two sum the state in other orders
(a rounding difference, held by the tests with stated tolerances).

The state is ``{"h": (B, di, n) fp32, "conv": (B, K-1, di) bf16}``: the
scan's last state and the last K-1 pre-conv rows. ``ssm_forward``
returns a new state; it never writes the one it is given.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import backend as KB
from repro_torch.models import layers as L


def _dims(cfg: ModelConfig):
    """(d_inner, d_state, d_conv, dt_rank) of ``cfg``'s SSM."""
    s = cfg.ssm
    return (s.expand * cfg.d_model, s.d_state, s.d_conv,
            s.dt_rank or max(1, math.ceil(cfg.d_model / 16)))


class SSM(nn.Module):
    """The mamba layer's parameters (the JAX ``ssm_init`` tree)."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        d = cfg.d_model
        di, n, K, dt_rank = _dims(cfg)
        f32 = torch.float32
        self.in_proj = L.dense_param((d, 2 * di), gen, dtype, device)
        self.conv_w = L.normal_param((K, di), 1.0 / math.sqrt(K), gen, dtype,
                                     device)
        self.conv_b = L.normal_param((di,), 0.0, None, dtype, device)
        self.w_bc = L.dense_param((di, 2 * n), gen, dtype, device)
        self.w_dt = L.dense_param((di, dt_rank), gen, dtype, device)
        self.dt_proj = L.dense_param((dt_rank, di), gen, dtype, device)
        self.dt_bias = nn.Parameter(
            torch.full((di,), -4.6, dtype=f32, device=device),
            requires_grad=False)                    # softplus^-1(0.01)
        self.A_log = nn.Parameter(torch.log(
            torch.arange(1, n + 1, dtype=f32, device=device)
        ).expand(di, n).contiguous(), requires_grad=False)
        self.D = nn.Parameter(torch.ones((di,), dtype=f32, device=device),
                              requires_grad=False)
        self.out_proj = L.dense_param((di, d), gen, dtype, device)


def _causal_conv(x, w, b):
    """x: (B,S,di); depthwise causal conv with kernel w (K,di) and bias
    b: the sum over i of x shifted by K-1-i rows times w[i], in x's dtype
    and the JAX order, plus b."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return out + b


def _ssm_params(p: SSM, x, fixed: bool = False):
    """x: (B,S,di) post-conv activations -> dt (B,S,di), B_, C_ (B,S,n),
    all fp32 and contiguous."""
    bc = L.matmul_rows(x, p.w_bc, fixed).float()
    B_, C_ = (t.contiguous() for t in torch.chunk(bc, 2, dim=-1))
    dt = F.softplus(L.matmul_rows(L.matmul_rows(x, p.w_dt, fixed),
                                  p.dt_proj, fixed)
                    + p.dt_bias.to(x.dtype))
    return dt.float(), B_, C_


def selective_scan(p: SSM, x, h0, fixed: bool = False):
    """Selective SSM over a sequence. x: (B,S,di) conv+silu activations;
    h0: (B,di,n) fp32 initial state. Returns (y (B,S,di) fp32 with the
    skip ``x D`` added, h_last (B,di,n) fp32)."""
    A = -torch.exp(p.A_log)                                   # (di, n)
    dt, B_, C_ = _ssm_params(p, x, fixed)
    xf = x.float().contiguous()
    y, h_last = KB.selective_scan(dt, xf, B_, C_, A, h0.contiguous())
    return y + xf * p.D, h_last


def ssm_forward(p: SSM, x, cfg: ModelConfig, state=None,
                fixed: bool = False):
    """The mamba layer over a sequence. x: (B,S,d); state: None (fresh)
    or ``{"h", "conv"}``. ``fixed``: row products in fixed-size calls
    (prefill and extend, as ``layers.matmul_rows``). Returns (y (B,S,d),
    new state)."""
    B, S, _ = x.shape
    K = cfg.ssm.d_conv
    xi, z = torch.chunk(L.matmul_rows(x, p.in_proj, fixed), 2, dim=-1)
    if state is not None:
        prev = state["conv"].to(xi.dtype)                     # (B,K-1,di)
        xi_ext = torch.cat([prev, xi], dim=1)
        conv = _causal_conv(xi_ext, p.conv_w, p.conv_b)[:, K - 1:]
        h0 = state["h"]
    else:
        xi_ext = F.pad(xi, (0, 0, K - 1, 0))
        conv = _causal_conv(xi, p.conv_w, p.conv_b)
        h0 = torch.zeros((B, xi.shape[-1], cfg.ssm.d_state),
                         dtype=torch.float32, device=x.device)
    y, h_last = selective_scan(p, F.silu(conv), h0, fixed)
    y = (y * F.silu(z.float())).to(x.dtype)
    new_state = {"h": h_last,
                 "conv": xi_ext[:, -(K - 1):].to(torch.bfloat16).contiguous()}
    return L.matmul_rows(y, p.out_proj, fixed), new_state


def ssm_init_state(cfg: ModelConfig, batch: int, device):
    """Zero SSM state of ``batch`` rows."""
    di, n, K, _ = _dims(cfg)
    return {"h": torch.zeros((batch, di, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, K - 1, di), dtype=torch.bfloat16,
                                device=device)}
