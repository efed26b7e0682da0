"""Per-layer blocks of the port.

Port of the JAX package's ``models/blocks.py`` for the ``"full"`` layer
kind (full causal self-attention + SiLU-GLU MLP) in the modes the dense
serving engine runs:

  mode="prefill" full-sequence forward, returns a filled KV cache
  mode="extend"  multi-token continuation against a pre-filled B=1 cache
                 (chunked prefill: writes S new K/V rows at [pos, pos+S)
                 and attends with q_offset=pos)
  mode="decode"  single-token forward against the batched cache, with a
                 scalar or per-slot (B,) ``pos``

JAX arrays are immutable; here the extend and decode writes update the
cache tensors IN PLACE (the engine clones a shared prefix cache before it
extends it). Other kinds and modes (train, verify, paged) raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L

MODES = ("prefill", "extend", "decode")


class Block(nn.Module):
    """One transformer layer of kind ``"full"``."""

    def __init__(self, kind: str, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        if kind != "full":
            raise NotImplementedError(
                f"layer kind {kind!r} comes with its model family "
                f"(ROADMAP.md queue A12)")
        self.kind = kind
        d = cfg.d_model
        self.norm1 = L.RMSNorm(d, cfg.norm_eps, dtype, device)
        self.attn = L.Attention(cfg, gen, dtype, device)
        self.norm2 = L.RMSNorm(d, cfg.norm_eps, dtype, device)
        self.mlp = L.MLP(d, cfg.d_ff, cfg.mlp_act, gen, dtype, device)


def block_cache_init(cfg: ModelConfig, batch: int, cache_len: int, device):
    """Zero-initialised dense KV cache for one full-attention layer."""
    shape = (batch, cfg.n_kv_heads, cache_len, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _attn_sublayer(p: Block, x, cfg: ModelConfig, mode: str, cache, pos,
                   positions):
    """Attention sub-layer. Returns (y, cache)."""
    q, k, v = L.qkv_proj(p.attn, x, cfg)
    if cfg.rope_kind != "rope":
        raise NotImplementedError(f"rope_kind {cfg.rope_kind!r} comes with "
                                  f"its model family (ROADMAP.md queue A12)")
    q = L.apply_rope(q, positions[:, None], cfg.rope_theta)
    k = L.apply_rope(k, positions[:, None], cfg.rope_theta)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)

    if mode == "prefill":
        out = L.attention(q, k, v, causal=True, cap=cfg.attn_softcap,
                          scale=cfg.attn_scale)
        Sc = cache["k"].shape[2]
        n = min(k.shape[2], Sc)
        cache["k"][:, :, :n] = k[:, :, :n]
        cache["v"][:, :, :n] = v[:, :, :n]
        return L.out_proj(p.attn, out), cache

    if mode == "extend":
        # rows [pos, pos+S); a start past Sc-S clamps, as JAX's
        # dynamic_update_slice does (the engine caps pad widths so it
        # never needs to)
        Sc, S = cache["k"].shape[2], k.shape[2]
        start = max(0, min(int(pos), Sc - S))
        cache["k"][:, :, start:start + S] = k
        cache["v"][:, :, start:start + S] = v
        out = L.attention(q, cache["k"], cache["v"], causal=True,
                          q_offset=pos, cap=cfg.attn_softcap,
                          scale=cfg.attn_scale)
        return L.out_proj(p.attn, out), cache

    if mode == "decode":
        # Write this token's K/V row at min(pos, Sc-1). The JAX package
        # blends a one-hot in fp32 (cache*(1-oh) + new*oh, cast to bf16):
        # the written row becomes exactly the bf16 new value and every
        # other row keeps its bits, so this indexed write is bitwise the
        # same update.
        Sc = cache["k"].shape[2]
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            slot = torch.clamp(pos, max=Sc - 1).long()
            rows = torch.arange(x.shape[0], device=slot.device)
            cache["k"][rows, :, slot] = k[:, :, 0]
            cache["v"][rows, :, slot] = v[:, :, 0]
            kv_len = torch.clamp(pos + 1, max=Sc)
        else:
            slot = min(int(pos), Sc - 1)
            cache["k"][:, :, slot] = k[:, :, 0]
            cache["v"][:, :, slot] = v[:, :, 0]
            kv_len = min(int(pos) + 1, Sc)
        out = L.attention(q, cache["k"], cache["v"], causal=False,
                          kv_len=kv_len, cap=cfg.attn_softcap,
                          scale=cfg.attn_scale)
        return L.out_proj(p.attn, out), cache

    raise _mode_not_ported(mode)


def _mode_not_ported(mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"mode {mode!r}: train comes with the training slice (ROADMAP.md "
        f"queue A11), verify and paged KV with the next serving slice "
        f"(queue A4/A5, B3-B5)")


def block_apply(p: Block, x, cfg: ModelConfig, *, mode: str, cache,
                pos, positions):
    """Returns (x_out, cache)."""
    if mode not in MODES:
        raise _mode_not_ported(mode)
    h = L.rmsnorm(p.norm1.scale, x, cfg.norm_eps)
    attn_y, cache = _attn_sublayer(p, h, cfg, mode, cache, pos, positions)
    x = x + attn_y
    h2 = L.rmsnorm(p.norm2.scale, x, cfg.norm_eps)
    return x + L.mlp(p.mlp, h2), cache
