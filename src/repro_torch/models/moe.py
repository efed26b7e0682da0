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

Under a mesh with a ``model`` axis, ``moe_dispatch="shard_map"`` runs
the expert-parallel dispatch (``_dispatch_ep``, the JAX package's
``_dispatch_shard_map``) per rank: the rank owns E/m contiguous
experts, gathers its own choices from the ``model``-replicated tokens
into buffers of ``capacity`` of its LOCAL tokens (all B*S of them, in
(token, choice) order, as JAX counts them) and returns its share of the
combine, summed over the ``model`` group by the caller
(``distributed/parallel.py``). Its capacity differs from the one
dispatch's (a row's S tokens), so the two agree where no choice is
dropped. At S = 1 and without a mesh the one dispatch runs, as JAX
falls back.

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


def balance_stats(probs, idx, E: int):
    """(f, p) of the load-balance loss: the share of tokens whose top-1
    choice is each expert and the mean router probability of each, (E,)
    fp32 over the (B,S) tokens."""
    f = F.one_hot(idx[..., 0].long(), E).float().mean(dim=(0, 1))
    return f, probs.float().mean(dim=(0, 1))


def aux_term(f, p, mcfg: MoEConfig):
    """The layer's aux loss of ``balance_stats``' (f, p): the
    Switch/GShard load-balance loss E * sum_e(f_e * p_e) over the top-1
    choices, times its weight (the mesh path sums f and p over its batch
    shards first)."""
    return mcfg.n_experts * torch.sum(f * p) * mcfg.aux_loss_weight


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
    return _combine(out.view(B, S, K, d).float(), w, keep.view(B, S, K),
                    x.dtype)


def _combine(out, w, keep, dtype):
    """Each token's kept choices' outputs out (B,S,K,d) fp32, weighted
    by w (B,S,K) cast to ``dtype`` (0 if dropped), summed in fp32 in
    choice order and rounded once."""
    wk = (w * keep).to(dtype).float()
    y = out[:, :, 0] * wk[:, :, 0, None]
    for j in range(1, out.shape[2]):
        y = y + out[:, :, j] * wk[:, :, j, None]
    return y.to(dtype)


def _dispatch_ep(p, x, w, idx, mcfg: MoEConfig, rank: int):
    """The expert-parallel dispatch of one ``model`` rank (module note):
    p holds the rank's E/m experts ``[rank * E/m, (rank + 1) * E/m)``;
    x (B,S,d), w, idx (B,S,k) are the rank's tokens. Returns the rank's
    share of the combine (B,S,d) in x's dtype."""
    B, S, d = x.shape
    N, K = B * S, mcfg.top_k
    el = p.w_gate.shape[0]
    C = capacity(mcfg, N)
    loc = idx.reshape(N * K).long() - rank * el              # local ids
    mine = (loc >= 0) & (loc < el)
    e_loc = torch.where(mine, loc, el)                       # el: overflow
    counts = F.one_hot(e_loc, el + 1).cumsum(dim=0)
    pos = counts.gather(1, e_loc[:, None])[:, 0] - 1
    keep = mine & (pos < C)
    n = el * C
    slot = torch.where(keep, e_loc * C + pos, n)
    buf = x.new_zeros((n + 1, d))
    buf[slot] = x.reshape(N, 1, d).expand(N, K, d).reshape(N * K, d)
    xe = buf[:-1].view(el, C, d)
    h = F.silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    del buf, xe
    ye = torch.bmm(h, p.w_down)
    out = ye.reshape(n, d)[torch.clamp(slot, max=n - 1)]
    return _combine(out.view(B, S, K, d).float(), w,
                    keep.view(B, S, K), x.dtype)


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
        aux = aux_term(*balance_stats(torch.softmax(logits, dim=-1), idx,
                                      mcfg.n_experts), mcfg)
    return y, aux
