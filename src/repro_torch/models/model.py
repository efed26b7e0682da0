"""The model: init / prefill / extend / decode / verify, and training's
loss (``train_loss``).

Port of the JAX package's ``models/model.py`` for the dense planner
(``"full"`` layers, tied head), the MoE families (``"moe"`` and
``"dense"`` layers, untied ``lm_head``) and the hybrid hymba
(``"hymba_g"`` / ``"hymba_w"`` layers: attention in parallel with a
mamba SSM) and xlstm (``"mlstm"`` / ``"slstm"`` layers, attention-free).
The JAX package scans stacked per-segment params; the port keeps one
``Block`` per layer and runs them in a Python loop.
Caches are ``{"layers": [{"k", "v"}, ...], "pos": ...}`` with the JAX
per-layer layout (B, Hkv, cache_len, hd) bf16 (``min(window,
cache_len)`` ring rows for a sliding-window layer; a hymba layer also
holds ``"ssm": {"h", "conv"}``; an xLSTM layer holds only its recurrent
state, ``"mlstm": (C, n, m)`` or ``"slstm": {c, n, h, m}``, and no K/V,
which a dense decode never reads); ``pos`` is a Python int
for a B=1 prefill/extend cache and a (B,) int tensor for the batched
decode cache. A paged cache (``init_paged_cache``) holds per-layer block
pools (n_blocks, Hkv, bs, hd) and a (B, cache_len // bs) int32
``block_tab``; ``decode_step`` and ``verify_extend`` take either. Their
``pos`` and ``block_tab`` may be host tensors (the engine keeps them on
the host): they go to the device once per call, and the write plan of
the step (``blocks.write_plan``) is computed from the host copies.

The head (the tied embedding, or ``lm_head`` (d, V) when the config does
not tie them) is computed in fp32 with full fp32 products, as the JAX
package's head is: ``_logits`` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` before its matmul, so
no caller's TF32 setting can reach it. At kimi-k2's vocab the fp32 copy
of ``lm_head`` is a 4.7 GB temporary per call: keeping it would hold
4.7 GB more, and a bf16 product would be another function.

``train_loss`` is the JAX package's training forward and loss over a
``"full"`` stack, differentiable (its attention's gradient on the card
is ``flash_prefill``'s backward kernel); ``forward_hidden`` is the same
forward without the loss, under ``no_grad``, for the intent gate.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.blocks import Block, block_apply, \
    block_cache_init, block_paged_cache_init, write_plan


def resolve_device(device=None) -> torch.device:
    """The device entry points run on: CUDA unless the caller asks for
    another. No card and no explicit device raises; nothing falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device; none is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


class Model(nn.Module):
    """Embedding, the layer stack, the final norm and, untied, the head."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        if cfg.n_enc_layers or cfg.final_softcap or cfg.emb_scale_by_sqrt_d \
                or cfg.family not in ("dense", "moe", "hybrid", "ssm"):
            raise NotImplementedError(
                f"{cfg.name}: only the dense, MoE, hybrid (hymba) and "
                f"xLSTM stacks are ported (ROADMAP.md queue A12)")
        self.cfg = cfg
        self.embed = L.normal_param((cfg.vocab_size, cfg.d_model), 0.02, gen,
                              dtype, device)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.layers = nn.ModuleList(
            Block(kind, cfg, gen, dtype, device)
            for kind in cfg.layer_kinds())
        self.lm_head = (None if cfg.tie_embeddings else
                        L.dense_param((cfg.d_model, cfg.vocab_size), gen,
                                      dtype, device))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype=torch.bfloat16) -> Model:
    """Seeded random weights with the JAX package's shapes, std and zero
    init (``model.py:34-65``): embedding N(0, 0.02), projections
    N(0, 1/fan_in), norm scales 0. Drawn on the CPU from one
    ``torch.Generator`` so a seed gives the same weights on any device,
    except the MoE expert stacks, which are drawn on ``device`` from a
    generator seeded from it (``layers.expert_param``). They are not the
    JAX package's bits (threefry vs Philox): tests that compare the two
    load JAX weights through ``models/convert.py``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return Model(cfg, gen, dtype, dev).eval()


def count_params(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> dict:
    """Zero dense cache, each layer sized by its kind; ``pos`` 0."""
    return {"layers": [block_cache_init(cfg, batch, cache_len, device, kind)
                       for kind in cfg.layer_kinds()],
            "pos": 0}


def init_paged_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     n_blocks: int, block_size: int, device) -> dict:
    """Paged decode cache: per-layer block pools (n_blocks, Hkv, bs, hd)
    bf16 shared by every slot, a (batch, cache_len // block_size) int32
    ``block_tab`` filled with the sentinel ``n_blocks``, and a (batch,)
    ``pos``. ``cache_len`` stays each slot's LOGICAL capacity; the
    physical budget is n_blocks * block_size rows, independent of batch
    (serving/kvpool.py assigns the block ids). Pure-attention stacks
    only: a hymba layer raises ``NotImplementedError``."""
    if cache_len % block_size:
        raise ValueError(f"cache_len {cache_len} must be a multiple of "
                         f"block_size {block_size}")
    return {"layers": [block_paged_cache_init(cfg, n_blocks, block_size,
                                              device, kind)
                       for kind in cfg.layer_kinds()],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "block_tab": torch.full((batch, cache_len // block_size),
                                    n_blocks, dtype=torch.int32,
                                    device=device)}


# ------------------------------------------------------------------ stack ----

def _apply_stack(model: Model, x, *, mode, cache, pos, positions,
                 block_tab=None, plan=None):
    new_layers: List[dict] = []
    for blk, c in zip(model.layers, cache["layers"]):
        x, nc = block_apply(blk, x, model.cfg, mode=mode, cache=c, pos=pos,
                            positions=positions, block_tab=block_tab,
                            plan=plan)
        new_layers.append(nc)
    return x, new_layers


def _step_inputs(model: Model, cache, W: int):
    """(pos on the device, block table on the device or None, the step's
    write plan or None) of a decode (W=1) or verify step. A dense decode
    writes at min(pos, Sc-1) and needs no plan."""
    pos = cache["pos"]
    tab = cache.get("block_tab")
    plan = None
    if tab is not None:
        nb, _, bs, _ = cache["layers"][0]["k"].shape
        plan = write_plan(pos, W, tab.shape[1] * bs, model.device, tab, nb,
                          bs)
        tab = tab.to(model.device, torch.int32).contiguous()
    elif W > 1:
        plan = write_plan(pos, W, cache["layers"][0]["k"].shape[2],
                          model.device)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(model.device)
    return pos, tab, plan


def _tokens(model: Model, batch) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], dtype=torch.long,
                           device=model.device)


def _embed_inputs(model: Model, tokens, pos=None):
    """Token embedding and absolute positions (B,S): from 0, from a scalar
    ``pos``, or per slot from a (B,) ``pos``. A stack without rope (xlstm)
    adds the sinusoidal embedding at those positions, as the JAX
    package's ``_embed_inputs`` does."""
    B, S = tokens.shape
    x = model.embed[tokens]
    ar = torch.arange(S, device=tokens.device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos.to(tokens.device).long()[:, None] + ar[None, :]
    else:
        positions = (int(pos or 0) + ar)[None, :].expand(B, S)
    if model.cfg.rope_kind == "none":
        x = x + _sin_at(model.cfg.d_model, positions).to(x.dtype)
    return x, positions


def _sin_at(d: int, positions):
    """Sinusoidal embedding (B,S,d) fp32 at positions (B,S): sin then cos
    of ``pos / 10000 ** (2i / d)``."""
    pos = positions.float()[..., None]
    dim = torch.arange(0, d, 2, dtype=torch.float32,
                       device=positions.device)
    ang = pos / (10_000.0 ** (dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _logits(model: Model, x):
    """fp32 head: (…, d) -> (…, V) fp32, never in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if model.lm_head is None:
        return x.float() @ model.embed.float().T
    return x.float() @ model.lm_head.float()


# ------------------------------------------------------------- public API ----

@torch.no_grad()
def forward_hidden(model: Model, batch):
    """The JAX package's training forward without the loss (its
    ``_apply_stack(mode="train")`` then the final norm), forward only:
    (B, S, d) final-normed hidden states of ``batch["tokens"]`` from
    position 0, no cache. Every product and norm runs in fixed-size row
    calls, so a row's bits do not depend on B. Dense ``"full"`` stacks
    only (``blocks.block_apply``)."""
    tokens = _tokens(model, batch)
    x, positions = _embed_inputs(model, tokens)
    for blk in model.layers:
        x, _ = block_apply(blk, x, model.cfg, mode="train", cache=None,
                           pos=0, positions=positions)
    return L.rmsnorm(model.final_norm.scale, x, model.cfg.norm_eps,
                     fixed=True)


def xent_chunked(model: Model, x, labels, chunk: int = 256):
    """Mean next-token cross-entropy of final-normed hidden states x
    (B,S,d) against labels (B,S) (< 0: no label), the fp32 head taken
    over ``chunk`` positions at a time so (B,S,V) logits never
    materialise: the JAX package's ``xent_chunked``."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"xent_chunked: {S} positions are not a multiple "
                         f"of the {chunk}-position chunk")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        cols = slice(c * chunk, (c + 1) * chunk)
        logits = _logits(model, x[:, cols])                  # (B,C,V) fp32
        lc = labels[:, cols]
        picked = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
        mask = (lc >= 0).float()
        tot = tot + torch.sum((torch.logsumexp(logits, dim=-1) - picked)
                              * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp(cnt, min=1.0)


def _train_block(blk: Block, x, positions, cfg: ModelConfig):
    return block_apply(blk, x, cfg, mode="train", cache=None, pos=0,
                       positions=positions)[0]


def train_loss(model: Model, batch, remat: bool = True):
    """The training forward and its scalar LM loss, differentiable: the
    JAX package's ``train_loss`` for a ``"full"`` stack (its MoE aux term
    is 0 there; ``block_apply`` refuses train mode over every other kind).
    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``, non-reentrant), as the JAX package wraps
    each unit in ``jax.checkpoint``. Tokens and labels move to the
    model's device."""
    tokens = _tokens(model, batch)
    labels = torch.as_tensor(batch["labels"], dtype=torch.long,
                             device=model.device)
    x, positions = _embed_inputs(model, tokens)
    for blk in model.layers:
        if remat:
            x = checkpoint(_train_block, blk, x, positions, model.cfg,
                           use_reentrant=False)
        else:
            x = _train_block(blk, x, positions, model.cfg)
    x = L.rmsnorm(model.final_norm.scale, x, model.cfg.norm_eps, fixed=True)
    return xent_chunked(model, x, labels)


@torch.no_grad()
def prefill(model: Model, batch, cache_len: int):
    """Process a prompt; returns (last-token logits (B,V) fp32, filled
    cache with ``pos`` = prompt length)."""
    tokens = _tokens(model, batch)
    B, S = tokens.shape
    x, positions = _embed_inputs(model, tokens)
    cache = init_cache(model.cfg, B, cache_len, model.device)
    x, layers = _apply_stack(model, x, mode="prefill", cache=cache, pos=0,
                             positions=positions)
    x_last = L.rmsnorm(model.final_norm.scale, x[:, -1:], model.cfg.norm_eps)
    return _logits(model, x_last)[:, 0], {"layers": layers, "pos": S}


@torch.no_grad()
def prefill_extend(model: Model, cache, batch, n_valid=None):
    """Chunked-prefill continuation: advance a pre-filled cache (scalar
    ``pos``) through S new tokens in one pass, updating it in place.

    ``n_valid`` (default S) supports bucket-padded calls: logits are taken
    at row n_valid-1 and ``pos`` advances by n_valid, so pad rows beyond
    it are never attended (causal mask) and are overwritten by later
    writes before they become visible."""
    pos = int(cache["pos"])
    tokens = _tokens(model, batch)
    S = tokens.shape[1]
    n_valid = S if n_valid is None else int(n_valid)
    x, positions = _embed_inputs(model, tokens, pos=pos)
    x, layers = _apply_stack(model, x, mode="extend", cache=cache, pos=pos,
                             positions=positions)
    last = L.rmsnorm(model.final_norm.scale, x[:, n_valid - 1:n_valid],
                     model.cfg.norm_eps)
    return _logits(model, last)[:, 0], {"layers": layers,
                                        "pos": pos + n_valid}


@torch.no_grad()
def decode_step(model: Model, cache, batch):
    """One decode step. batch["tokens"]: (B,1); ``cache["pos"]`` a scalar
    or a (B,) tensor of per-slot fill levels. A cache with a
    ``block_tab`` decodes against its paged pools; the table rides
    through unchanged (the engine owns it). Returns (logits (B,V) fp32,
    cache with ``pos + 1``), the cache updated in place."""
    pos, tab, plan = _step_inputs(model, cache, 1)
    tokens = _tokens(model, batch)
    x, positions = _embed_inputs(model, tokens, pos=pos)
    x, layers = _apply_stack(model, x, mode="decode", cache=cache, pos=pos,
                             positions=positions, block_tab=tab, plan=plan)
    x = L.rmsnorm(model.final_norm.scale, x, model.cfg.norm_eps)
    out = {"layers": layers, "pos": pos + 1}
    if tab is not None:
        out["block_tab"] = tab
    return _logits(model, x)[:, 0], out


@torch.no_grad()
def verify_extend(model: Model, cache, batch):
    """Speculative-decode verify: score W = K+1 positions per slot in ONE
    forward against a continuous-batching cache (dense or paged) with
    per-slot (B,) fill levels.

    batch["tokens"]: (B, W), per slot the carried last token and its K
    draft proposals. Returns logits for all W positions ((B, W, V) fp32;
    row i is the target distribution after tokens[:, :i+1]) and the cache
    with the W K/V rows written at [pos_b, pos_b + W), rows past the
    capacity dropped. ``pos`` comes back UNCHANGED: the engine advances
    each slot by its accepted length on the host, and that truncation is
    the whole rejected-token rollback. The layers and the head run per
    row at decode's shape, as the JAX package's head does, so row i is
    bitwise the logits of the i'th sequential ``decode_step``."""
    tokens = _tokens(model, batch)
    W = tokens.shape[1]
    pos, tab, plan = _step_inputs(model, cache, W)
    x, positions = _embed_inputs(model, tokens, pos=pos)
    x, layers = _apply_stack(model, x, mode="verify", cache=cache, pos=pos,
                             positions=positions, block_tab=tab, plan=plan)
    logits = torch.stack(
        [_logits(model, L.rmsnorm(model.final_norm.scale,
                                  x[:, i:i + 1].contiguous(),
                                  model.cfg.norm_eps))[:, 0]
         for i in range(W)], dim=1)                              # (B,W,V)
    out = {"layers": layers, "pos": pos}
    if tab is not None:
        out["block_tab"] = tab
    return logits, out
