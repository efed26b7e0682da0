"""The model: init / prefill / extend / decode / verify, and training's
loss (``train_loss``).

Port of the JAX package's ``models/model.py`` for the dense planner
(``"full"`` layers, tied head), the dense qwen1.5 (``"full"``, q/k/v
biases, untied head), starcoder2 (``"local"``: sliding-window rings,
GELU MLP) and gemma2 (``"local"`` and ``"full"``, attention and final
softcaps, GELU-GLU, the embedding scaled by sqrt(d)), the MoE families
(``"moe"`` and
``"dense"`` layers, untied ``lm_head``) and the hybrid hymba
(``"hymba_g"`` / ``"hymba_w"`` layers: attention in parallel with a
mamba SSM) and xlstm (``"mlstm"`` / ``"slstm"`` layers, attention-free),
the vision-language qwen2-vl (``"full"`` layers under M-RoPE: a batch
carries ``mrope_pos``, its (t, h, w) position ids (3, B, S), and in
prefill and train ``patch_embeds`` (B, n_vision, d), spliced over the
first rows of the token embedding) and the encoder-decoder whisper (an
``encoder`` of ``"enc"`` layers over a batch's ``frames`` (B, S_enc, d)
plus sinusoidal positions, then ``"encdec"`` decoder layers that
cross-attend to its output; a decoder cache of at most
``WHISPER_DEC_CACHE`` rows).
The JAX package scans stacked per-segment params; the port keeps one
``Block`` per layer and runs them in a Python loop.
Caches are ``{"layers": [{"k", "v"}, ...], "pos": ...}`` with the JAX
per-layer layout (B, Hkv, cache_len, hd) bf16 (``min(window,
cache_len)`` ring rows for a sliding-window layer; a hymba layer also
holds ``"ssm": {"h", "conv"}``; an xLSTM layer holds only its recurrent
state, ``"mlstm": (C, n, m)`` or ``"slstm": {c, n, h, m}``, and no K/V,
which a dense decode never reads); ``pos`` is a Python int
for a B=1 prefill/extend cache and a (B,) int tensor for the batched
decode cache; an ``"encdec"`` layer's cache also holds its
cross-attention K/V ``ck``/``cv`` (B, Hkv, enc_len, hd). A paged cache
(``init_paged_cache``) holds per-layer block
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

``train_loss`` is the JAX package's training forward and loss over any
of these stacks, differentiable, with the MoE layers' load-balance
terms added (on the card the gradients of its attention, router,
selective scan and mLSTM scan are backward kernels);
``forward_hidden`` is the same forward without the loss, under
``no_grad``, for the intent gate.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.blocks import Block, block_apply, \
    block_cache_init, block_paged_cache_init, write_plan

#: whisper's decoder cache rows: its decoder context is capped at 448
#: positions (the JAX package's ``models/model.py:29``)
WHISPER_DEC_CACHE = 448


def resolve_device(device=None) -> torch.device:
    """The device entry points run on: CUDA unless the caller asks for
    another. No card and no explicit device raises; nothing falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device; none is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


class Encoder(nn.Module):
    """whisper's encoder: ``"enc"`` layers and their final norm (the JAX
    package's ``params["encoder"]``)."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(Block("enc", cfg, gen, dtype, device)
                                    for _ in range(cfg.n_enc_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)


class Model(nn.Module):
    """Embedding, the layer stack, the final norm, untied the head, and
    with ``n_enc_layers`` the encoder (drawn last, so the other
    families' seeded weights do not depend on it)."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
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
        self.encoder = (Encoder(cfg, gen, dtype, device)
                        if cfg.n_enc_layers else None)

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


def param_shapes(cfg: ModelConfig, dtype=torch.bfloat16) -> Model:
    """The ``Model`` of ``cfg`` on the meta device: every tensor's shape
    and dtype, no storage and no draw (a full-width kimi-k2 builds in
    about a second). The dry-run sizes its sharding from it."""
    return Model(cfg, None, dtype, torch.device("meta")).eval()


def count_params(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device, enc_len: int = 0) -> dict:
    """Zero dense cache, each layer sized by its kind (an ``"encdec"``
    layer's ``ck``/``cv`` by ``enc_len``); ``pos`` 0."""
    return {"layers": [block_cache_init(cfg, batch, cache_len, device, kind,
                                        enc_len)
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
                 block_tab=None, plan=None, memory=None):
    new_layers: List[dict] = []
    for blk, c in zip(model.layers, cache["layers"]):
        x, nc = block_apply(blk, x, model.cfg, mode=mode, cache=c, pos=pos,
                            positions=positions, block_tab=block_tab,
                            plan=plan, memory=memory)
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


def _embed_inputs(model: Model, tokens, pos=None, batch=None):
    """Token embedding and absolute positions (B,S): from 0, from a scalar
    ``pos``, or per slot from a (B,) ``pos``. A stack without rope
    (xlstm, whisper's decoder) adds the sinusoidal embedding at those
    positions, as the JAX package's ``_embed_inputs`` does. A vlm
    ``batch`` with ``patch_embeds`` (B, n_vision, d) has them spliced
    over the first n_vision rows; under M-RoPE the positions are the
    batch's ``mrope_pos`` (3, B, S)."""
    return finish_embed(model.cfg, model.embed[tokens], tokens, pos, batch)


def finish_embed(cfg: ModelConfig, x, tokens, pos=None, batch=None):
    """``_embed_inputs`` after the lookup ``x`` (B,S,d) of ``tokens``:
    the scale, the patch splice and the positions."""
    B, S = tokens.shape
    batch = batch or {}
    if cfg.emb_scale_by_sqrt_d:
        # sqrt(d) rounded to the embedding's dtype first, as the JAX
        # package multiplies by jnp.asarray(d ** 0.5, x.dtype)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if cfg.family == "vlm" and batch.get("patch_embeds") is not None:
        pe = torch.as_tensor(batch["patch_embeds"]).to(x.device, x.dtype)
        if pe.shape[0] != B or pe.shape[1] > S or pe.shape[2] != x.shape[2]:
            raise ValueError(
                f"patch_embeds {tuple(pe.shape)} must be (B={B}, n <= "
                f"S={S}, d={x.shape[2]}): the patches take the first rows "
                f"of the sequence")
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    if cfg.rope_kind == "mrope":
        if batch.get("mrope_pos") is None:
            raise ValueError(f"{cfg.name}: an M-RoPE stack needs the "
                             f"batch's mrope_pos (3, B, S)")
        positions = torch.as_tensor(batch["mrope_pos"]).to(x.device).long()
        if tuple(positions.shape) != (3, B, S):
            raise ValueError(f"mrope_pos {tuple(positions.shape)} != "
                             f"(3, {B}, {S})")
        return x, positions
    ar = torch.arange(S, device=tokens.device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos.to(tokens.device).long()[:, None] + ar[None, :]
    else:
        positions = (int(pos or 0) + ar)[None, :].expand(B, S)
    if cfg.rope_kind == "none":
        x = x + _sin_at(cfg.d_model, positions).to(x.dtype)
    return x, positions


def _sin_at(d: int, positions):
    """Sinusoidal embedding (B,S,d) fp32 at positions (B,S): sin then cos
    of ``pos / 10000 ** (2i / d)``."""
    pos = positions.float()[..., None]
    dim = torch.arange(0, d, 2, dtype=torch.float32,
                       device=positions.device)
    ang = pos / (10_000.0 ** (dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encoder_input(cfg: ModelConfig, frames, dtype):
    """The encoder's input of frame embeddings (B, S_enc, d) on their
    device: (the frames in ``dtype`` plus the sinusoidal positions
    0..S_enc-1 in that dtype, those positions (B, S_enc))."""
    x = frames.to(dtype)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    return x + _sin_at(cfg.d_model, positions).to(x.dtype), positions


def _encode(model: Model, frames, remat: bool = False):
    """whisper's encoder over frame embeddings (B, S_enc, d): the
    sinusoidal positions added (``encoder_input``), the ``"enc"`` layers
    in train mode (non-causal self-attention, no rope, no cache), each
    under ``torch.utils.checkpoint`` with ``remat``, and the encoder's
    final norm: the JAX package's ``_encode``."""
    enc = model.encoder
    x, positions = encoder_input(
        model.cfg, torch.as_tensor(frames).to(model.device),
        model.embed.dtype)
    for blk in enc.layers:
        if remat:
            x, _ = checkpoint(_train_block, blk, x, positions, model.cfg,
                              use_reentrant=False)
        else:
            x, _ = _train_block(blk, x, positions, model.cfg)
    return L.rmsnorm(enc.final_norm.scale, x, model.cfg.norm_eps, fixed=True)


def _memory(model: Model, batch, remat: bool = False):
    """The encoder's output over ``batch["frames"]`` for an
    encoder-decoder stack, else None."""
    if not model.cfg.n_enc_layers:
        return None
    if batch.get("frames") is None:
        raise ValueError(f"{model.cfg.name}: an encoder-decoder stack "
                         f"needs the batch's frames (B, S_enc, d)")
    return _encode(model, batch["frames"], remat)


def _head(model: Model):
    """The head (d, V) in fp32: the tied embedding's transpose or
    ``lm_head``, cast."""
    if model.lm_head is None:
        return model.embed.float().T
    return model.lm_head.float()


def _logits(model: Model, x, head=None):
    """fp32 head: (…, d) -> (…, V) fp32, never in TF32; with
    ``final_softcap`` (gemma2) ``cap * tanh(logits / cap)`` in fp32.
    ``head``: ``_head(model)``, cast here when not given."""
    torch.backends.cuda.matmul.allow_tf32 = False
    logits = x.float() @ (_head(model) if head is None else head)
    cap = model.cfg.final_softcap
    if cap:
        logits = cap * torch.tanh(logits / cap)
    return logits


def prefill_cache_len(cfg: ModelConfig, cache_len: int) -> int:
    """The decoder cache's rows of a prefill asked for ``cache_len``: an
    encoder-decoder stack's are capped at ``WHISPER_DEC_CACHE``."""
    return min(cache_len, WHISPER_DEC_CACHE) if cfg.n_enc_layers \
        else cache_len


def check_decoder_cap(cfg: ModelConfig, cache) -> None:
    """An encoder-decoder stack's decode at a position (any slot's)
    past its decoder cache raises ValueError, before anything is
    written (the JAX package would overwrite the last row). ``pos`` may
    be an int, a tensor or a DTensor (its whole tensor is read); a
    meta one (the dry-run's sizing) has no values to check."""
    if not cfg.n_enc_layers:
        return
    rows = cache["layers"][0]["k"].shape[2]
    pos = torch.as_tensor(cache["pos"])
    if pos.device.type == "meta":
        return
    if isinstance(pos, DTensor):
        pos = pos.full_tensor()
    last = int(pos.max())
    if last >= rows:
        raise ValueError(f"{cfg.name}: decode at position {last} past the "
                         f"{rows}-row decoder cache")


def _no_encdec(model: Model, what: str) -> None:
    if model.cfg.n_enc_layers:
        raise NotImplementedError(f"{what}: encoder-decoder stacks "
                                  f"({model.cfg.name}) take prefill and "
                                  f"decode_step only")


def _mesh(model) -> bool:
    """The model's parameters are DTensors (``parallel.distribute_model``)."""
    return getattr(model, "mesh_ctx", None) is not None


def _parallel():
    from repro_torch.distributed import parallel
    return parallel


def _no_mesh(model: Model, what: str) -> None:
    if _mesh(model):
        raise NotImplementedError(
            f"{what} under a mesh: the mesh path runs train_loss, prefill "
            f"and decode_step (dense caches) only")


# ------------------------------------------------------------- public API ----

@torch.no_grad()
def forward_hidden(model: Model, batch):
    """The JAX package's training forward without the loss (its
    ``_apply_stack(mode="train")`` then the final norm), forward only:
    (B, S, d) final-normed hidden states of ``batch["tokens"]`` from
    position 0, no cache. Every product and norm runs in fixed-size row
    calls, so a row's bits do not depend on B."""
    _no_mesh(model, "forward_hidden")
    tokens = _tokens(model, batch)
    memory = _memory(model, batch)
    x, positions = _embed_inputs(model, tokens, batch=batch)
    for blk in model.layers:
        x, _ = block_apply(blk, x, model.cfg, mode="train", cache=None,
                           pos=0, positions=positions, memory=memory)
    return L.rmsnorm(model.final_norm.scale, x, model.cfg.norm_eps,
                     fixed=True)


def xent_chunked(model: Model, x, labels, chunk: int = 256):
    """Mean next-token cross-entropy of final-normed hidden states x
    (B,S,d) against labels (B,S) (< 0: no label), the fp32 head taken
    over ``chunk`` positions at a time so (B,S,V) logits never
    materialise: the JAX package's ``xent_chunked``. The head is cast to
    fp32 once for all chunks: a cast a chunk would keep one fp32 copy a
    chunk for the backward (5 GB each at qwen2-vl-72b's head) and sum the
    head's gradient in bf16, chunk by chunk."""
    tot, cnt = xent_sums(model, x, labels, chunk)
    return tot / torch.clamp(cnt, min=1.0)


def xent_sums(model: Model, x, labels, chunk: int = 256):
    """(the summed loss, the count of labels) of ``xent_chunked``; the
    mesh path sums them over the batch shards before the division."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"xent_chunked: {S} positions are not a multiple "
                         f"of the {chunk}-position chunk")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    head = _head(model)
    for c in range(S // chunk):
        cols = slice(c * chunk, (c + 1) * chunk)
        logits = _logits(model, x[:, cols], head)            # (B,C,V) fp32
        lc = labels[:, cols]
        picked = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
        mask = (lc >= 0).float()
        tot = tot + torch.sum((torch.logsumexp(logits, dim=-1) - picked)
                              * mask)
        cnt = cnt + torch.sum(mask)
    return tot, cnt


def _train_block(blk: Block, x, positions, cfg: ModelConfig, memory=None):
    """One block in train mode: (x, its MoE aux term, 0 for other
    kinds)."""
    return block_apply(blk, x, cfg, mode="train", cache=None, pos=0,
                       positions=positions, memory=memory)


def train_loss(model: Model, batch, remat: bool = True):
    """The training forward and its scalar loss, differentiable: the JAX
    package's ``train_loss``, the LM loss plus the sum of the MoE layers'
    load-balance terms (each ``moe.aux_term``,
    added in layer order; 0 in a stack without MoE layers). ``remat``
    recomputes each block in the backward (``torch.utils.checkpoint``,
    non-reentrant), as the JAX package wraps each unit in
    ``jax.checkpoint``: the block returns its aux term through the
    checkpoint, so remat and no remat sum the same terms in the same
    order. An encoder-decoder stack encodes ``batch["frames"]`` first.
    Tokens and labels move to the model's device. A model distributed
    over a mesh (``distributed/parallel.py``) runs its mesh path."""
    if _mesh(model):
        return _parallel().train_loss(model, batch, remat)
    tokens = _tokens(model, batch)
    labels = torch.as_tensor(batch["labels"], dtype=torch.long,
                             device=model.device)
    memory = _memory(model, batch, remat)
    x, positions = _embed_inputs(model, tokens, batch=batch)
    aux = torch.zeros((), dtype=torch.float32, device=model.device)
    for blk in model.layers:
        if remat:
            x, a = checkpoint(_train_block, blk, x, positions, model.cfg,
                              memory, use_reentrant=False)
        else:
            x, a = _train_block(blk, x, positions, model.cfg, memory)
        aux = aux + a
    x = L.rmsnorm(model.final_norm.scale, x, model.cfg.norm_eps, fixed=True)
    return xent_chunked(model, x, labels) + aux


@torch.no_grad()
def prefill(model: Model, batch, cache_len: int, seq_axis=None):
    """Process a prompt; returns (last-token logits (B,V) fp32, filled
    cache with ``pos`` = prompt length). An encoder-decoder stack encodes
    ``batch["frames"]`` first, its decoder cache capped at
    ``WHISPER_DEC_CACHE`` rows, its cross-attention K/V cached.

    A model distributed over a mesh runs its mesh path: DTensor logits
    and cache; ``seq_axis`` (a mesh axis name) pins the residual
    stream's seq dim to it per layer (``annotate.constrain_seq``), the
    sequence-parallel prefill. Without a mesh it is a no-op, as in the
    JAX package."""
    if _mesh(model):
        return _parallel().prefill(model, batch, cache_len, seq_axis)
    tokens = _tokens(model, batch)
    B, S = tokens.shape
    memory = _memory(model, batch)
    enc_len = 0 if memory is None else memory.shape[1]
    cache_len = prefill_cache_len(model.cfg, cache_len)
    x, positions = _embed_inputs(model, tokens, batch=batch)
    cache = init_cache(model.cfg, B, cache_len, model.device, enc_len)
    x, layers = _apply_stack(model, x, mode="prefill", cache=cache, pos=0,
                             positions=positions, memory=memory)
    x_last = L.rmsnorm(model.final_norm.scale, x[:, -1:], model.cfg.norm_eps)
    return _logits(model, x_last)[:, 0], {"layers": layers, "pos": S}


@torch.no_grad()
def prefill_extend(model: Model, cache, batch, n_valid=None):
    """Chunked-prefill continuation: advance a pre-filled cache (scalar
    ``pos``) through S new tokens in one pass, updating it in place.

    ``n_valid`` (default S) supports bucket-padded calls: logits are taken
    at row n_valid-1 and ``pos`` advances by n_valid, so pad rows beyond
    it are never attended (causal mask) and are overwritten by later
    writes before they become visible. An encoder-decoder stack raises,
    as the JAX package asserts."""
    _no_encdec(model, "prefill_extend")
    _no_mesh(model, "prefill_extend")
    pos = int(cache["pos"])
    tokens = _tokens(model, batch)
    S = tokens.shape[1]
    n_valid = S if n_valid is None else int(n_valid)
    x, positions = _embed_inputs(model, tokens, pos=pos, batch=batch)
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
    cache with ``pos + 1``), the cache updated in place. Under M-RoPE
    the batch carries ``mrope_pos`` (3, B, 1). An encoder-decoder
    stack's decode past its decoder cache raises ValueError and writes
    nothing (the JAX package would overwrite the last row)."""
    if _mesh(model):
        return _parallel().decode_step(model, cache, batch)
    check_decoder_cap(model.cfg, cache)
    pos, tab, plan = _step_inputs(model, cache, 1)
    tokens = _tokens(model, batch)
    x, positions = _embed_inputs(model, tokens, pos=pos, batch=batch)
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
    bitwise the logits of the i'th sequential ``decode_step``. An
    encoder-decoder stack raises, as the JAX package asserts."""
    _no_encdec(model, "verify_extend")
    _no_mesh(model, "verify_extend")
    tokens = _tokens(model, batch)
    W = tokens.shape[1]
    pos, tab, plan = _step_inputs(model, cache, W)
    x, positions = _embed_inputs(model, tokens, pos=pos, batch=batch)
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
