"""Per-layer blocks of the port.

Port of the JAX package's ``models/blocks.py`` for the layer kinds
``"full"`` (full causal self-attention + MLP), ``"local"`` (the same over
a sliding window: starcoder2, gemma2), ``"dense"`` (the
same inside an MoE model, with a ``top_k * d_expert`` wide MLP),
``"moe"`` (full attention + the mixture-of-experts FFN of
``models/moe.py``) and hymba's ``"hymba_g"`` / ``"hymba_w"`` (attention,
global or over a sliding window, in parallel with the mamba layer of
``models/ssm.py``: ``x + 0.5 (norm_a(attn) + norm_s(ssm))``, then the
MLP), and xlstm's ``"mlstm"`` / ``"slstm"`` (``models/xlstm.py``:
``x + block(norm1(x))``, no attention), and whisper's ``"enc"`` (an
encoder layer: ``"full"`` with non-causal self-attention, no rope, no
cache) and ``"encdec"`` (a decoder layer: causal self-attention, then
``norm_x`` and a cross-attention over the encoder's output, then the
MLP), in the modes the serving engine runs:

  mode="prefill" full-sequence forward, returns a filled KV cache
  mode="extend"  multi-token continuation against a pre-filled B=1 cache
                 (chunked prefill: writes S new K/V rows at [pos, pos+S)
                 and attends with q_offset=pos)
  mode="decode"  single-token forward against the batched cache, with a
                 scalar or per-slot (B,) ``pos``; with a ``block_tab`` the
                 cache leaves are paged block pools (n_blocks, Hkv, bs,
                 hd) shared by every slot
  mode="verify"  speculative verify: W = K+1 tokens per slot at per-slot
                 positions [pos_b, pos_b + W), dense or paged
  mode="train"   the JAX package's full-sequence training forward with no
                 cache, over every kind: the intent gate scores (query,
                 intent) rows with it under ``torch.no_grad()``
                 (serving/neural_planner.py), and ``model.train_loss``
                 differentiates it (the gradients of its attention,
                 router, selective scan and mLSTM scan are those
                 kernels' backward kernels); it returns (x, aux), aux the
                 MoE layer's load-balance term (0 for every other kind)

JAX arrays are immutable; here the extend, decode and verify writes
update the cache tensors IN PLACE (the engine clones a shared prefix
cache before it extends it). The JAX package blends a one-hot in fp32
(cache*(1-oh) + new*oh, cast to bf16), which writes exactly the bf16 new
value and keeps every other row's bits, so an indexed write is bitwise
the same update. JAX drops writes that have nowhere to go
(``.at[...].set(mode="drop")``): sentinel table entries of idle slots,
verify rows at or past the logical capacity, slots whose table is all
sentinel. Torch index writes do not drop (they raise on the CPU and
device-assert on CUDA), and clamping the index would overwrite a block
that may belong to a live request, so ``write_plan`` filters those rows
out on the host before the write.

Verify runs every row-wise operation (norms, projections, rope, MLP or
MoE FFN) per row at decode's (B, 1, d) shape, and the attention through
a kernel whose rows are bitwise decode rows: a matmul or reduction may
pick another kernel or blocking for (B*W, d) rows than for (B, d) rows
and round the last bits differently, and the engine promises that
verify logits ARE the decode logits. For an MoE layer this also gives
decode's routing semantics: each row is a group of one token, whose
capacity (8) never drops a choice. The JAX package's verify routes all W
rows as one group with capacity(W), which can drop choices once W > 8;
at W <= 8 the two agree. Train mode runs prefill's arithmetic (the
fixed-size row calls, so a row's bits do not depend on the batch) and
keeps no K/V and no state: a hymba layer's SSM and an xLSTM layer start
from a fresh state, as the JAX package's train mode does.

A sliding-window layer (``"local"``, ``"hymba_w"``) keeps a ring of
``Sc = min(window, cache_len)`` rows: prefill attends over the window
and packs the last Sc K/V rows in ring order (``_ring_from_prefill``),
decode writes position p at row ``p % Sc`` and reads ``min(p+1, Sc)``
rows. Extend and verify over a ring raise, as in the JAX package (the
engine decodes through prompt tails instead). A hymba layer's cache also
holds its SSM state ``{"ssm": {"h", "conv"}}``; each mode replaces it
with the state ``ssm_forward`` returns (prefill starts from zeros).
An xLSTM layer's cache is its recurrent state alone, no K/V:
``{"mlstm": (C, n, m)}`` or ``{"slstm": {c, n, h, m}}`` (the JAX
layouts); prefill starts from a fresh state, extend and decode carry the
cache's, and each mode replaces it with the state the block returns.
Verify over recurrent state raises, as in the JAX package (it cannot be
rolled back by KV-length truncation). Paged pools exist only for the
pure-attention kinds.

An ``"encdec"`` layer's cache also holds its cross-attention's K/V,
``ck`` and ``cv`` (B, Hkv, enc_len, hd) bf16: prefill projects them from
the encoder's output (``memory``) and writes them, decode reads them
back, and train mode projects them without a cache. The cross-attention
is ``L.attention(q, ck, cv, causal=False)``: ``flash_prefill`` at
Sq = the decoder's rows over Sk = enc_len, one row in decode, as the
JAX package calls it. Extend and verify over an encoder-decoder stack
raise, as the JAX package's asserts do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig, WINDOW_KINDS
from repro_torch.kernels import backend as KB
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X

MODES = ("prefill", "extend", "decode", "verify", "train")
#: kinds without recurrent state or rings: the only ones with paged pools,
#: bucket-padded extends and speculative verify
PURE_ATTENTION_KINDS = ("full", "dense", "moe")
HYMBA_KINDS = ("hymba_g", "hymba_w")
XLSTM_KINDS = ("mlstm", "slstm")
#: whisper's encoder and decoder layers
ENCDEC_KINDS = ("enc", "encdec")
#: ``"local"`` (starcoder2, gemma2): ``"full"`` over a sliding-window ring
KINDS = (PURE_ATTENTION_KINDS + ("local",) + HYMBA_KINDS + XLSTM_KINDS
         + ENCDEC_KINDS)
#: modes whose row-wise products and norms run in fixed-size calls
FIXED_MODES = ("prefill", "extend", "train")


class Block(nn.Module):
    """One layer of a kind in ``KINDS`` (the JAX package's ``block_init``
    shapes)."""

    def __init__(self, kind: str, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"layer kind {kind!r} (kinds: {KINDS})")
        self.kind = kind
        d = cfg.d_model
        self.norm1 = L.RMSNorm(d, cfg.norm_eps, dtype, device)
        if kind == "mlstm":
            self.mlstm = X.MLSTM(cfg, gen, dtype, device)
            return
        if kind == "slstm":
            self.slstm = X.SLSTM(cfg, gen, dtype, device)
            return
        self.attn = L.Attention(cfg, gen, dtype, device)
        self.norm2 = L.RMSNorm(d, cfg.norm_eps, dtype, device)
        if kind == "moe":
            self.moe = M.MoE(cfg, gen, dtype, device)
        elif kind in HYMBA_KINDS:
            self.ssm = S.SSM(cfg, gen, dtype, device)
            self.norm_a = L.RMSNorm(d, cfg.norm_eps, dtype, device)
            self.norm_s = L.RMSNorm(d, cfg.norm_eps, dtype, device)
            self.mlp = L.MLP(d, cfg.d_ff, cfg.mlp_act, gen, dtype, device)
        elif kind == "encdec":
            self.norm_x = L.RMSNorm(d, cfg.norm_eps, dtype, device)
            self.xattn = L.Attention(cfg, gen, dtype, device)
            self.mlp = L.MLP(d, cfg.d_ff, cfg.mlp_act, gen, dtype, device)
        else:
            dff = (cfg.moe.top_k * cfg.moe.d_expert
                   if kind == "dense" and cfg.moe is not None else cfg.d_ff)
            self.mlp = L.MLP(d, dff, cfg.mlp_act, gen, dtype, device)


def block_cache_init(cfg: ModelConfig, batch: int, cache_len: int, device,
                     kind: str = "full", enc_len: int = 0):
    """Zero-initialised dense cache for one layer of ``kind``: K/V of
    ``cache_len`` rows, or ``min(window, cache_len)`` ring rows for a
    sliding-window kind, plus the SSM state for a hymba kind and the
    cross-attention's ``ck``/``cv`` of ``enc_len`` rows for an
    ``"encdec"`` kind; an xLSTM kind's fresh recurrent state alone."""
    if kind == "mlstm":
        return {"mlstm": X.mlstm_state_init(cfg, batch, device)}
    if kind == "slstm":
        return {"slstm": X.slstm_state_init(cfg, batch, device)}
    Sc = min(cfg.window, cache_len) if kind in WINDOW_KINDS else cache_len
    shape = (batch, cfg.n_kv_heads, Sc, cfg.d_head)
    c = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
         "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
    if kind in HYMBA_KINDS:
        c["ssm"] = S.ssm_init_state(cfg, batch, device)
    if kind == "encdec":
        shape = (batch, cfg.n_kv_heads, enc_len, cfg.d_head)
        c["ck"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
        c["cv"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return c


def block_paged_cache_init(cfg: ModelConfig, n_blocks: int, block_size: int,
                           device, kind: str = "full"):
    """Zero-initialised paged block pool for one layer. Paged caching
    covers the pure-attention kinds only: recurrent state and ring
    buffers have no block-table layout."""
    if kind not in PURE_ATTENTION_KINDS:
        raise NotImplementedError(
            f"paged KV cache over {kind!r} layers (pure-attention stacks "
            f"only)")
    shape = (n_blocks, cfg.n_kv_heads, block_size, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


# (slot, row of the window, destination block or row[, offset in block])
WritePlan = Tuple[torch.Tensor, ...]


def write_plan(pos, W: int, capacity: int, device, block_tab=None,
               n_blocks: int = 0, block_size: int = 0) -> WritePlan:
    """Where the W new K/V rows of each slot go, rows with nowhere to go
    dropped. Row w of slot b sits at logical position pos_b + w; it is
    dropped at or past ``capacity`` (Sc dense, mb*bs paged) and, paged,
    when its table entry is a sentinel (>= n_blocks). Computed on the
    host from ``pos`` and ``block_tab`` (free when the caller keeps them
    on the host, as the engine does); returns device index tensors:
    dense (slot, w, row), paged (slot, w, block, offset)."""
    p = torch.as_tensor(pos).cpu().long().reshape(-1)
    rows = p[:, None] + torch.arange(W)[None, :]                  # (B, W)
    ok = rows < capacity
    if block_tab is not None:
        tab = torch.as_tensor(block_tab).cpu().long()
        j = torch.clamp(rows // block_size, 0, tab.shape[1] - 1)
        blk = torch.gather(tab, 1, j)
        ok &= (blk >= 0) & (blk < n_blocks)
    bi, wi = ok.nonzero(as_tuple=True)
    if block_tab is None:
        plan = (bi, wi, rows[bi, wi])
    else:
        plan = (bi, wi, blk[bi, wi], rows[bi, wi] % block_size)
    return tuple(t.to(device) for t in plan)


def _write_rows(cache, k, v, plan: WritePlan) -> None:
    """Write k/v rows (B, Hkv, W, hd) where ``plan`` says, in place."""
    bi, wi = plan[0], plan[1]
    if len(plan) == 3:                                   # dense (B,Hkv,Sc,hd)
        cache["k"][bi, :, plan[2]] = k[bi, :, wi]
        cache["v"][bi, :, plan[2]] = v[bi, :, wi]
    else:                                                # pool (nb,Hkv,bs,hd)
        cache["k"][plan[2], :, plan[3]] = k[bi, :, wi]
        cache["v"][plan[2], :, plan[3]] = v[bi, :, wi]


def _rope_qkv(p: Block, h, cfg: ModelConfig, positions, fixed=False):
    """Projections and rope of (B, S, d) normed rows at (B, S)
    positions, or (3, B, S) (t, h, w) positions under M-RoPE: q
    (B,Hq,S,hd), bf16 k and v (B,Hkv,S,hd). No rope for ``rope_kind``
    ``"none"`` (sinusoidal positions are in the embedding) or an
    ``"enc"`` layer, as in the JAX package. ``fixed``: products in
    fixed-size calls (prefill and extend)."""
    q, k, v = L.qkv_proj(p.attn, h, cfg, fixed)
    q, k = rope(p.kind, q, cfg, positions), rope(p.kind, k, cfg, positions)
    return q, k.to(torch.bfloat16), v.to(torch.bfloat16)


def rope(kind: str, t, cfg: ModelConfig, positions):
    """``_rope_qkv``'s rotation of q or k (B,H,S,hd) of a ``kind``
    layer."""
    if cfg.rope_kind == "rope" and kind != "enc":
        return L.apply_rope(t, positions[:, None], cfg.rope_theta)
    if cfg.rope_kind == "mrope":
        return L.apply_mrope(t, positions[:, :, None],      # (3,B,1,S)
                             cfg.rope_theta, cfg.mrope_sections)
    return t


def prefill_rows(t, Sc: int, window: int):
    """The rows a prefill's k or v (B,H,S,hd) leaves in an Sc-row
    cache, from its row 0: in a ring (``window``) all Sc rows in ring
    order, else the first min(S, Sc) positions. Both the plain and the
    mesh prefill write these."""
    if window:
        return _ring_from_prefill(t, Sc)
    return t[:, :, :min(t.shape[2], Sc)]


def decode_slot(pos, Sc: int, window: int):
    """The cache row a decode step at ``pos`` (an int, or a (B,) tensor
    of per-slot positions) writes: ``pos % Sc`` in a ring, else
    ``min(pos, Sc-1)``."""
    if isinstance(pos, torch.Tensor) and pos.ndim:
        return (pos % Sc if window else torch.clamp(pos, max=Sc - 1)).long()
    return int(pos) % Sc if window else min(int(pos), Sc - 1)


def decode_kv_len(pos, Sc: int):
    """The keys a decode step at ``pos`` reads: ``min(pos + 1, Sc)``."""
    if isinstance(pos, torch.Tensor) and pos.ndim:
        return torch.clamp(pos + 1, max=Sc)
    return min(int(pos) + 1, Sc)


def _ring_from_prefill(k, Sc: int):
    """The last Sc rows of k (B,H,S,hd) in ring order (position p at row
    p % Sc), zero-padded to Sc rows when S < Sc."""
    S = k.shape[2]
    if S <= Sc:
        return F.pad(k, (0, 0, 0, Sc - S))
    return torch.roll(k[:, :, -Sc:], S % Sc, dims=2)


def _attn_sublayer(p: Block, x, cfg: ModelConfig, mode: str, cache, pos,
                   positions, block_tab, plan):
    """Attention sub-layer of prefill, extend, decode and train mode.
    Returns (y, cache)."""
    fixed = mode in FIXED_MODES
    window = cfg.window if p.kind in WINDOW_KINDS else 0
    if window and mode == "extend":
        raise NotImplementedError(
            "extend over sliding-window ring buffers; decode "
            "token-by-token instead")
    q, k, v = _rope_qkv(p, x, cfg, positions, fixed)

    if mode == "train":
        out = L.attention(q, k, v, causal=p.kind != "enc", window=window,
                          cap=cfg.attn_softcap, scale=cfg.attn_scale)
        return L.out_proj(p.attn, out, fixed), cache

    if mode == "prefill":
        out = L.attention(q, k, v, causal=True, window=window,
                          cap=cfg.attn_softcap, scale=cfg.attn_scale)
        Sc = cache["k"].shape[2]
        for n, t in (("k", k), ("v", v)):
            rows = prefill_rows(t, Sc, window)
            cache[n][:, :, :rows.shape[2]] = rows
        return L.out_proj(p.attn, out, fixed), cache

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
        return L.out_proj(p.attn, out, fixed), cache

    if block_tab is not None:
        # paged decode: the row lands in block block_tab[b, pos // bs] at
        # offset pos % bs; the read walks the slot's blocks (the kernel on
        # the card, the gathered view's decode attention on the CPU), so
        # paged and dense decode are bitwise equal
        nb, _, bs, _ = cache["k"].shape
        capacity = block_tab.shape[1] * bs
        if plan is None:
            plan = write_plan(pos, 1, capacity, x.device, block_tab, nb, bs)
        _write_rows(cache, k, v, plan)
        kv_len = torch.clamp(pos + 1, max=capacity)
        out = KB.paged_decode_attention(
            q[:, :, 0].contiguous(), cache["k"], cache["v"], block_tab,
            kv_len, cap=cfg.attn_softcap, scale=cfg.attn_scale)
        return L.out_proj(p.attn, out[:, :, None]), cache

    # dense decode: write this token's K/V row at min(pos, Sc-1), or at
    # pos % Sc in a ring
    Sc = cache["k"].shape[2]
    slot = decode_slot(pos, Sc, window)
    if isinstance(slot, torch.Tensor):
        rows = torch.arange(x.shape[0], device=slot.device)
        cache["k"][rows, :, slot] = k[:, :, 0]
        cache["v"][rows, :, slot] = v[:, :, 0]
    else:
        cache["k"][:, :, slot] = k[:, :, 0]
        cache["v"][:, :, slot] = v[:, :, 0]
    kv_len = decode_kv_len(pos, Sc)
    out = L.attention(q, cache["k"], cache["v"], causal=False,
                      kv_len=kv_len, cap=cfg.attn_softcap,
                      scale=cfg.attn_scale)
    return L.out_proj(p.attn, out), cache


def _cross_sublayer(p: Block, x, cfg: ModelConfig, mode: str, cache,
                    memory):
    """An ``"encdec"`` layer's cross-attention over the encoder's output
    ``memory`` (B, enc_len, d): k and v projected from it (prefill, where
    they are written to the cache's ``ck``/``cv``, and train) or read
    from the cache (decode); q from the normed rows x; non-causal, no
    rope. Returns y (B, S, d)."""
    fixed = mode in FIXED_MODES
    if mode == "decode":
        k, v = cache["ck"], cache["cv"]
    else:
        k, v = (t.to(torch.bfloat16)
                for t in L.kv_proj(p.xattn, memory, cfg, fixed))
        if mode == "prefill":
            cache["ck"].copy_(k)
            cache["cv"].copy_(v)
    q = L.q_proj(p.xattn, x, cfg, fixed)
    out = L.attention(q, k, v, causal=False, cap=cfg.attn_softcap,
                      scale=cfg.attn_scale)
    return L.out_proj(p.xattn, out, fixed)


def _mlp_tail(p: Block, x, cfg: ModelConfig, fixed: bool = False,
              with_aux: bool = False):
    """The MLP (or MoE FFN) sub-layer: (x_out, the MoE layer's aux term
    when ``with_aux``, else None)."""
    h2 = L.rmsnorm(p.norm2.scale, x, cfg.norm_eps, fixed)
    if p.kind == "moe":
        y, aux = M.moe_ffn(p.moe, h2, cfg, fixed=fixed, with_aux=with_aux)
        return x + y, aux
    return x + L.mlp(p.mlp, h2, fixed), None


def _verify_block(p: Block, x, cfg: ModelConfig, cache, pos, positions,
                  block_tab, plan):
    """Speculative verify of one layer. x: (B, W, d); per slot the W rows
    at positions [pos_b, pos_b + W). Every row-wise operation runs per
    row at decode's (B, 1, d) shape (see the module note); the W rows'
    K/V are written first, then one verify attention reads them with row
    w at kv_len pos + w + 1: exactly what W sequential decode steps would
    write and read. ``pos`` is not advanced: the engine truncates to the
    accepted length on the host, and that is the whole rollback."""
    W = x.shape[1]
    rows = [x[:, w:w + 1].contiguous() for w in range(W)]
    qkv = [_rope_qkv(p, L.rmsnorm(p.norm1.scale, r, cfg.norm_eps), cfg,
                     positions[..., w:w + 1]) for w, r in enumerate(rows)]
    q, k, v = (torch.cat([t[i] for t in qkv], dim=2) for i in range(3))
    if block_tab is not None:
        nb, _, bs, _ = cache["k"].shape
        if plan is None:
            plan = write_plan(pos, W, block_tab.shape[1] * bs, x.device,
                              block_tab, nb, bs)
        _write_rows(cache, k, v, plan)
        out = KB.paged_verify_attention(q, cache["k"], cache["v"],
                                        block_tab, pos + W,
                                        cap=cfg.attn_softcap,
                                        scale=cfg.attn_scale)
    else:
        if plan is None:
            plan = write_plan(pos, W, cache["k"].shape[2], x.device)
        _write_rows(cache, k, v, plan)
        out = KB.verify_attention(q, cache["k"], cache["v"], pos + W,
                                  cap=cfg.attn_softcap, scale=cfg.attn_scale)
    ys = []
    for w, r in enumerate(rows):
        a = out[:, :, w].contiguous()[:, :, None]       # decode's layout
        ys.append(_mlp_tail(p, r + L.out_proj(p.attn, a), cfg)[0])
    return torch.cat(ys, dim=1), cache


def _xlstm_block(p: Block, x, cfg: ModelConfig, mode: str, cache):
    """An mLSTM or sLSTM layer: ``x + block(norm1(x))``, its state fresh
    at prefill and train and carried at extend and decode. Returns
    (x_out, the state after the last step)."""
    if mode == "verify":
        raise NotImplementedError(
            "verify over recurrent xLSTM state (it cannot be rolled back "
            "by KV-length truncation)")
    kind = p.kind
    if mode in ("prefill", "train"):
        init = (X.mlstm_state_init if kind == "mlstm"
                else X.slstm_state_init)
        state = init(cfg, x.shape[0], x.device)
    else:
        state = cache[kind]
    fn = X.mlstm_block if kind == "mlstm" else X.slstm_block
    fixed = mode in FIXED_MODES
    y, state = fn(getattr(p, kind),
                  L.rmsnorm(p.norm1.scale, x, cfg.norm_eps, fixed), cfg,
                  state, fixed)
    return x + y, state


def block_apply(p: Block, x, cfg: ModelConfig, *, mode: str, cache,
                pos, positions, block_tab=None,
                plan: Optional[WritePlan] = None, memory=None):
    """Returns (x_out, cache), or in train mode (x_out, aux): the MoE
    layer's load-balance term, a 0-d fp32 tensor (0 for every other
    kind). ``block_tab`` (decode and verify): the (B, mb) int32 block
    table of a paged cache, on x's device. ``plan``: the step's
    ``write_plan``, computed once by the model for all layers (computed
    here when None). ``memory``: the encoder's output (B, enc_len, d),
    which an ``"encdec"`` layer attends to in prefill and train."""
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode!r} (modes: {MODES})")
    if p.kind in ENCDEC_KINDS and mode in ("extend", "verify"):
        raise NotImplementedError(
            f"{mode} over an encoder-decoder stack (the JAX package "
            f"asserts it away too)")
    if p.kind == "enc" and mode != "train":
        raise ValueError(f"an 'enc' layer runs in train mode only (the "
                         f"encoder keeps no cache), got {mode!r}")
    train = mode == "train"
    if p.kind in XLSTM_KINDS:
        x, state = _xlstm_block(p, x, cfg, mode, cache)
        if train:
            return x, _zero_aux(x)
        cache[p.kind] = state
        return x, cache
    if mode == "verify":
        if p.kind in WINDOW_KINDS:
            raise NotImplementedError(
                "verify over sliding-window ring buffers")
        if p.kind in HYMBA_KINDS:
            raise NotImplementedError(
                "verify over recurrent SSM state (it cannot be rolled "
                "back by KV-length truncation)")
        return _verify_block(p, x, cfg, cache, pos, positions, block_tab,
                             plan)
    fixed = mode in FIXED_MODES
    h = L.rmsnorm(p.norm1.scale, x, cfg.norm_eps, fixed)
    attn_y, cache = _attn_sublayer(p, h, cfg, mode, cache, pos, positions,
                                   block_tab, plan)
    if p.kind in HYMBA_KINDS:
        ssm_y, state = S.ssm_forward(
            p.ssm, h, cfg,
            None if mode in ("prefill", "train") else cache["ssm"], fixed)
        if not train:
            cache["ssm"] = state
        attn_y = 0.5 * (L.rmsnorm(p.norm_a.scale, attn_y, cfg.norm_eps,
                                  fixed)
                        + L.rmsnorm(p.norm_s.scale, ssm_y, cfg.norm_eps,
                                    fixed))
    x = x + attn_y
    if p.kind == "encdec":
        x = x + _cross_sublayer(
            p, L.rmsnorm(p.norm_x.scale, x, cfg.norm_eps, fixed), cfg, mode,
            cache, memory)
    x, aux = _mlp_tail(p, x, cfg, fixed, with_aux=train)
    if train:
        return x, _zero_aux(x) if aux is None else aux
    return x, cache


def _zero_aux(x):
    """The aux term of a block without an MoE layer."""
    return torch.zeros((), dtype=torch.float32, device=x.device)
