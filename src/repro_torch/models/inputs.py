"""Concrete model inputs of every family: the numpy part of the JAX
package's ``models/inputs.py`` (``make_batch`` and the shape rules of
its ``batch_struct``), returning torch tensors.

  train:   {"tokens", "labels"} (+frames | +patch_embeds, mrope_pos)
  prefill: {"tokens"} (+frames | +patch_embeds, mrope_pos)
  decode:  {"tokens" (B,1)} (+mrope_pos (3,B,1))

whisper's ``frames`` (B, S, d) and qwen2-vl's ``patch_embeds`` (B,
n_vision, d) stand in for the mel/conv front end and the vision encoder,
as in the JAX package: precomputed embeddings, drawn N(0, 1) and rounded
to bf16. A whisper batch's decoder prompt is ``_whisper_dec_len(S)``
tokens beside the S encoder frames. The draws are the JAX package's:
one ``np.random.default_rng(seed)`` in its key order, so a port batch
holds the values of JAX's ``make_batch`` for the same shape and seed.
``batch_struct`` and ``cache_struct`` are the dry-run's stand-ins for an
assigned shape: meta tensors (no storage) with the JAX package's shapes
and dtypes (int32 ids, bf16 embeddings; a decode cache from
``model.init_cache``, a whisper cache of ``WHISPER_DEC_CACHE`` decoder
rows beside the S encoder rows, ``pos`` a 0-d int32).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.models.model import WHISPER_DEC_CACHE, init_cache

MODES = ("train", "prefill", "decode")


def _whisper_dec_len(seq_len: int) -> int:
    """The decoder prompt's length beside ``seq_len`` encoder frames."""
    return max(16, min(WHISPER_DEC_CACHE, seq_len // 128))


def batch_shapes(cfg: ModelConfig, mode: str, batch: int,
                 seq_len: int) -> Dict[str, tuple]:
    """{key: (shape, "int" | "float")} of a batch, in the JAX package's
    key order (which is its draw order)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} (modes: {MODES})")
    B, S = batch, seq_len
    if mode == "decode":
        out = {"tokens": ((B, 1), "int")}
        if cfg.rope_kind == "mrope":
            out["mrope_pos"] = ((3, B, 1), "int")
        return out
    if cfg.family == "audio":
        Sd = _whisper_dec_len(S)
        out = {"tokens": ((B, Sd), "int"),
               "frames": ((B, S, cfg.d_model), "float")}
        if mode == "train":
            out["labels"] = ((B, Sd), "int")
        return out
    out = {"tokens": ((B, S), "int")}
    if cfg.family == "vlm":
        out["patch_embeds"] = ((B, cfg.n_vision_tokens, cfg.d_model),
                               "float")
        out["mrope_pos"] = ((3, B, S), "int")
    if mode == "train":
        out["labels"] = ((B, S), "int")
    return out


def make_batch(cfg: ModelConfig, mode: str, batch: int, seq_len: int,
               seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """The JAX package's ``make_batch`` for (cfg, mode, batch, seq_len):
    ids uniform in [0, vocab), ``mrope_pos`` with t = h = w = the index
    (the text layout), embeddings N(0, 1) in bf16; int64 and bf16
    tensors on ``device``."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, (shape, kind) in batch_shapes(cfg, mode, batch,
                                           seq_len).items():
        if key == "mrope_pos":
            arr = np.broadcast_to(np.arange(shape[-1], dtype=np.int32),
                                  shape)
            t = torch.from_numpy(arr.copy()).long()
        elif kind == "int":
            t = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape,
                                              dtype=np.int32)).long()
        else:
            t = torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(torch.bfloat16)
        out[key] = t.to(device)
    return out


def grid_mrope_pos(batch: int, seq_len: int, n_vision: int,
                   grid_w: int) -> torch.Tensor:
    """M-RoPE ids (3, batch, seq_len) of one image followed by text, as
    qwen2-vl lays them out: patch i at t 0, h i // grid_w, w i % grid_w;
    the text after it at t = h = w = one past the largest patch id, then
    counting up. Rows of decode step j are ``[..., S + j]`` of a longer
    call. Unlike the text layout, its three rows differ, so a wrong
    section split shows."""
    if not 0 < n_vision <= seq_len:
        raise ValueError(f"{n_vision} patches in {seq_len} positions")
    i = torch.arange(n_vision)
    vis = torch.stack([torch.zeros_like(i), i // grid_w, i % grid_w])
    start = int(vis.max()) + 1
    text = start + torch.arange(seq_len - n_vision)
    pos = torch.cat([vis, text.expand(3, -1)], dim=1)         # (3, S)
    return pos[:, None, :].expand(3, batch, seq_len).contiguous()


def batch_struct(cfg: ModelConfig, shape: ShapeConfig
                 ) -> Dict[str, torch.Tensor]:
    """The batch of ``shape`` as meta tensors, the JAX package's
    ``batch_struct``: int32 ids and M-RoPE positions, bf16 frames and
    patch embeddings; a decode batch is its tokens (and positions)."""
    meta = {"int": torch.int32, "float": torch.bfloat16}
    return {k: torch.empty(shp, dtype=meta[kind], device="meta")
            for k, (shp, kind) in batch_shapes(
                cfg, shape.mode, shape.global_batch, shape.seq_len).items()}


def cache_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The decode cache of ``shape`` as meta tensors, the JAX package's
    ``cache_struct`` (per layer, without its stack axis): a whisper
    cache holds ``WHISPER_DEC_CACHE`` decoder rows and S encoder rows."""
    if shape.mode != "decode":
        raise ValueError(f"cache_struct: {shape.name} is a "
                         f"{shape.mode!r} shape, not a decode one")
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        cache = init_cache(cfg, B, WHISPER_DEC_CACHE, "meta", enc_len=S)
    else:
        cache = init_cache(cfg, B, S, "meta")
    cache["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return cache
