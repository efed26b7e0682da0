"""Mixture-of-experts FFN with capacity-bounded dispatch.

Port of the JAX package's ``models/moe.py``. The router runs in fp32 (a
full fp32 product, never TF32) and picks each token's top-k experts
through the kernel op surface (``KB.router_topk``: the Hopper
``moe_router_topk`` kernel on the card, its plain version on the CPU).

The JAX package has several dispatch modes (one-hot einsums, gather,
shard_map) that choose how a TPU mesh exchanges tokens; without a mesh
they compute one function, and the port keeps one dispatch with that
function (the JAX package's ``_dispatch_gather``):

  * each batch row is its own group with capacity ``C = capacity(S)``;
  * the position of token s's j-th choice in its expert's buffer is a
    running count over the flattened (s, j) order of its row, and a
    choice at or past C is dropped (pad tokens of a bucket-padded extend
    count, as in the JAX package);
  * tokens are gathered into (E, B*C, d) buffers that go through one
    ``torch.bmm`` each for gate, up and down, as the JAX package leaves
    the expert products to XLA. On an H100 these products give a column
    the same bits whatever B*C is; the router's and the shared MLPs' 2-D
    products do not, so in prefill and extend (``fixed``) they go in
    fixed-size calls (``layers.py``'s note), and a token's bits do not
    depend on its group's size;
  * each token sums its kept choices' outputs weighted by the routing
    weights cast to the activation dtype, in choice order.

The load-balance loss is computed only when a caller asks for it
(``with_aux``): training does (``model.train_loss`` adds it), no serve
mode does. Under grad the routing weights' gradient is the router's
backward kernel (``KB.router_topk`` goes through ``MoeRouterFn``); the
expert products and the dispatch are differentiated by autograd.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig, MoEConfig
from repro_torch.common.perf import get_flags
from repro_torch.kernels import backend as KB
from repro_torch.models import layers as L


class MoE(nn.Module):
    """Router (d, E) fp32, expert stacks w_gate/w_up (E, d, dff) and
    w_down (E, dff, d), optional dense residual and shared expert MLPs:
    the JAX package's shapes and init (``moe.py:31-51``)."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        mcfg = cfg.moe
        if cfg.mlp_act != "silu_glu":
            raise NotImplementedError(
                f"mlp_act {cfg.mlp_act!r}: the expert stacks are SiLU-GLU, "
                f"as in every MoE config of the JAX package")
        d, dff, E = cfg.d_model, mcfg.d_expert, mcfg.n_experts
        self.router = L.dense_param((d, E), gen, torch.float32, device,
                                    scale=0.1)
        self.w_gate = L.expert_param(E, (d, dff), 1 / math.sqrt(d), gen,
                                     dtype, device)
        self.w_up = L.expert_param(E, (d, dff), 1 / math.sqrt(d), gen,
                                   dtype, device)
        self.w_down = L.expert_param(E, (dff, d), 1 / math.sqrt(dff), gen,
                                     dtype, device)
        self.dense_residual = (
            L.MLP(d, mcfg.dense_residual_ff, cfg.mlp_act, gen, dtype, device)
            if mcfg.dense_residual_ff else None)
        self.shared_expert = (
            L.MLP(d, mcfg.shared_expert_ff, cfg.mlp_act, gen, dtype, device)
            if mcfg.shared_expert_ff else None)


def capacity(mcfg: MoEConfig, n_tokens: int) -> int:
    """Slots per expert for a group of ``n_tokens`` tokens: the capacity
    factor (the flag's override, else the config's) times the even share
    k * n / E, at least 8 and rounded up to a multiple of 8."""
    cf = get_flags().moe_capacity_factor or mcfg.capacity_factor
    c = int(math.ceil(cf * mcfg.top_k * n_tokens / mcfg.n_experts))
    return max(8, -(-c // 8) * 8)


def router_topk(p: MoE, x, mcfg: MoEConfig, fixed: bool = False):
    """x: (B,S,d) -> (weights (B,S,k) fp32, ids (B,S,k) int32, logits
    (B,S,E) fp32). The logits are a full fp32 product: TF32 is turned off
    first, so no caller's setting reaches it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    logits = L.matmul_rows(x.float(), p.router, fixed)
    B, S, E = logits.shape
    w, idx = KB.router_topk(logits.reshape(B * S, E), mcfg.top_k)
    k = mcfg.top_k
    return w.reshape(B, S, k), idx.reshape(B, S, k), logits


def load_balance_loss(probs, idx, mcfg: MoEConfig):
    """Switch/GShard auxiliary loss E * sum_e(f_e * p_e) over the top-1
    choices; probs: (B,S,E) router softmax, idx: (B,S,k)."""
    E = mcfg.n_experts
    f = F.one_hot(idx[..., 0].long(), E).float().mean(dim=(0, 1))
    return E * torch.sum(f * probs.float().mean(dim=(0, 1)))


def _dispatch(p: MoE, x, w, idx, mcfg: MoEConfig):
    """Capacity-bounded dispatch and combine (see the module note).
    x: (B,S,d); w, idx: (B,S,k). Returns (B,S,d) in x's dtype."""
    B, S, d = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    C = capacity(mcfg, S)
    flat = idx.reshape(B, S * K).long()                       # (B, S*K)
    counts = F.one_hot(flat, E).cumsum(dim=1)                 # (B,S*K,E)
    pos = counts.gather(2, flat[..., None])[..., 0] - 1       # running
    keep = pos < C
    # column b*C + pos of expert e's (E, B*C, d) buffer; dropped choices
    # write to one spare row past the buffers
    n = E * B * C
    col = torch.arange(B, device=x.device)[:, None] * C + pos
    slot = torch.where(keep, flat * (B * C) + col, n).reshape(-1)
    buf = x.new_zeros((n + 1, d))
    buf[slot] = x[:, :, None].expand(B, S, K, d).reshape(B * S * K, d)
    xe = buf[:-1].view(E, B * C, d)
    # the expert-stacked SiLU-GLU
    h = F.silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    del buf, xe
    ye = torch.bmm(h, p.w_down)
    out = ye.view(-1, d)[torch.clamp(slot, max=n - 1)]
    out = out.view(B, S, K, d).float()
    # weights in the activation dtype (0 if dropped); products and their
    # sum in fp32 in choice order, rounded once
    wk = (w * keep.view(B, S, K)).to(x.dtype).float()
    y = out[:, :, 0] * wk[:, :, 0, None]
    for j in range(1, K):
        y = y + out[:, :, j] * wk[:, :, j, None]
    return y.to(x.dtype)


def moe_ffn(p: MoE, x, cfg: ModelConfig, *, fixed: bool = False,
            with_aux: bool = False):
    """The MoE FFN layer: (B,S,d) -> (y (B,S,d), aux loss or None).
    ``fixed``: the 2-D products in fixed-size calls (prefill and extend)."""
    mcfg = cfg.moe
    w, idx, logits = router_topk(p, x, mcfg, fixed)
    y = _dispatch(p, x, w, idx, mcfg)
    if p.dense_residual is not None:
        y = y + L.mlp(p.dense_residual, x, fixed)
    if p.shared_expert is not None:
        y = y + L.mlp(p.shared_expert, x, fixed)
    aux = None
    if with_aux:
        aux = load_balance_loss(torch.softmax(logits, dim=-1), idx,
                                mcfg) * mcfg.aux_loss_weight
    return y, aux
