"""The model under a device mesh: DTensor parameters, optimizer state,
batches and caches laid out by the sharding rules, and the forward of
``models/model.py`` run per rank on local shards.

``distribute_model`` turns every parameter into a DTensor with the
placements of its rule (``sharding.params_sharding``), so the trained
tensors are DTensors; ``distribute_opt_state``, ``distribute_batch`` and
``distribute_cache`` do the same for AdamW's m and v (ZeRO-1), a batch
and a decode cache. ``model.train_loss``, ``model.prefill`` and
``model.decode_step`` of such a model run ``train_loss``, ``prefill``
and ``decode_step`` here.

Each piece of a layer is one ``local_call``: the helper that runs a
function of local shards under ``local_map``. Its inputs are first
redistributed to the layout the piece computes in; each rank runs the
plain code (``models/layers.py``, ``blocks.py``, ``moe.py``, ``ssm.py``,
``xlstm.py``) and the ``KB`` ops on its shards, and the outputs come
back as DTensors. A replicated input of a piece whose work is split
along a mesh dim gets a ``Partial`` gradient there (each rank's share of
it), so autograd's DTensor redistributes reduce the gradients.

  * embedding: vocab-parallel over ``model`` (each rank looks up its
    rows, the others' tokens read 0, summed over ``model``);
  * attention: q/k/v projected and roped per rank, pinned by
    ``annotate.constrain_attn``, the ``KB`` op on local heads (a rank
    with q heads over ``model`` and replicated K/V picks the K/V heads
    its q heads read), the out-projection's partial sums reduced over
    ``model``; whisper's cross-attention the same over the encoder's
    output;
  * MLPs (and an MoE layer's dense residual and shared expert):
    Megatron tensor parallel when ``model`` divides d_ff, else
    replicated over ``model``;
  * MoE: the router per rank on its batch shard; the one dispatch with
    every expert, or with ``moe_dispatch="shard_map"`` (S > 1, E a
    multiple of ``model``) the expert-parallel dispatch
    (``moe._dispatch_ep``) on the rank's E/m experts, its share summed
    over ``model``;
  * hymba's SSM and the xLSTM blocks: batch-parallel (over ``model`` too
    when it divides the batch), every channel on the rank;
  * the loss: the head gathered, each rank's sums over its batch shard
    added over the batch axes; prefill's and decode's logits come out
    vocab-sharded (``logits_sharding``).

A decode cache is held in its rule's layout (seq over ``model`` by
default). A decode step writes the new K/V row on the rank that owns its
position, and redistributes the cache to the attention layout (whole
heads' key ranges) before the kernel: the simplest correct layout, whose
cost the dry-run's collective bytes show (a split-K combine across ranks
would avoid the gather). The paged cache, extend and verify have no mesh
path (``model.py`` raises).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ShapeConfig, WINDOW_KINDS
from repro_torch.common.perf import get_flags
from repro_torch.distributed import annotate as A
from repro_torch.distributed import sharding as shd
from repro_torch.models import blocks as BL
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models import moe as M
from repro_torch.models import ssm as SS

FIXED_MODES = BL.FIXED_MODES


@dataclass
class MeshCtx:
    """A model's mesh and sharding strategy."""
    mesh: Any
    strategy: shd.ShardingStrategy

    @property
    def names(self):
        return tuple(self.mesh.mesh_dim_names)

    @property
    def m(self) -> int:
        return shd.mesh_shape(self.mesh).shape.get("model", 1)

    def pl(self, spec, partial=()):
        """Placements of ``spec``, ``Partial()`` on the mesh dims named
        in ``partial``."""
        out = shd.placements(spec, self.mesh)
        for a in partial:
            if a in self.names:
                out[self.names.index(a)] = Partial()
        return tuple(out)

    def fit(self, dim: int, axes):
        return shd._fit(self.mesh, dim, axes) if axes else None

    def bax(self, B: int):
        """Batch axes of the residual stream (and of a batch)."""
        return self.fit(B, shd.dp_axes(self.mesh, self.strategy)) \
            if B > 1 else None

    def scan_bax(self, B: int):
        """Batch axes of the recurrent pieces: the batch axes and
        ``model`` where they divide B, else the residual's."""
        dp = shd.dp_axes(self.mesh, self.strategy)
        both = dp + ("model",) if "model" in self.names else dp
        if B > 1 and both and B % shd._axis_size(self.mesh, both) == 0:
            return both if len(both) > 1 else both[0]
        return self.bax(B)

    def rank(self, name: str) -> int:
        return self.mesh.get_local_rank(name) if name in self.names else 0

    def batch_partial(self, B: int):
        """Mesh axes a batch-sharded sum is partial over."""
        b = self.bax(B)
        return () if b is None else (b,) if isinstance(b, str) else b


def _distribute(t, mesh, placements):
    """A DTensor of a tensor every rank holds whole (the same seeded
    weights, batch or cache): each rank keeps its shard, cut in mesh-dim
    order as ``distribute_tensor`` cuts it, and nothing is sent. A shard
    that is the whole tensor (every sharded mesh dim of size 1) is the
    tensor itself, not a copy: a card that holds a model can distribute
    it over the one-rank mesh in place. The rules only shard dims that
    divide evenly."""
    local = t
    for i, p in enumerate(placements):
        if p.is_shard() and mesh.size(i) > 1:
            local = local.chunk(mesh.size(i), dim=p.dim)[
                mesh.get_local_rank(i)]
    if local.shape != t.shape and t.device.type != "meta":
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, list(placements),
                              run_check=False)


def _ctx(model) -> MeshCtx:
    return model.mesh_ctx


def _dev(model) -> torch.device:
    """The device of the model's local shards (meta in the dry-run)."""
    return model.embed.to_local().device


def to(ctx: MeshCtx, t, spec):
    """``t`` redistributed to ``spec`` (a no-op when it is laid out so)."""
    if not isinstance(t, DTensor):
        return t
    pl = ctx.pl(spec)
    if tuple(t.placements) == pl:
        return t
    return t.redistribute(ctx.mesh, pl)


def _flatten(tree):
    """(the leaves of a tree of dicts, lists and tuples, a function that
    rebuilds the tree from new leaves). None is no leaf, as local_map's
    own flattening has it."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            return ("dict", [(k, walk(v)) for k, v in t.items()])
        if isinstance(t, (list, tuple)):
            return ("seq", type(t), [walk(v) for v in t])
        if t is None:
            return ("none",)
        leaves.append(t)
        return ("leaf",)
    spec = walk(tree)

    def build(new):
        it = iter(new)

        def b(s):
            if s[0] == "dict":
                return {k: b(v) for k, v in s[1]}
            if s[0] == "seq":
                return s[1](b(v) for v in s[2])
            return None if s[0] == "none" else next(it)
        return b(spec)
    return leaves, build


def local_call(ctx: MeshCtx, fn, args, out_placements):
    """``fn(*args)`` on local shards under ``local_map``: every DTensor
    leaf of ``args`` (a tuple of trees) enters as its local tensor;
    ``fn`` returns a tuple of tensors, wrapped as DTensors with
    ``out_placements`` (one placements tuple each). A replicated input
    on a mesh dim that another input is sharded on gets a ``Partial``
    gradient there (see the module note)."""
    flat, build = _flatten(args)
    sharded = {i for a in flat if isinstance(a, DTensor)
               for i, p in enumerate(a.placements) if p.is_shard()}
    in_pl = tuple(tuple(a.placements) if isinstance(a, DTensor) else None
                  for a in flat)
    in_grad = tuple(
        tuple(Partial() if p.is_replicate() and i in sharded else p
              for i, p in enumerate(a.placements))
        if isinstance(a, DTensor) else None for a in flat)

    def body(*leaves):
        return fn(*build(leaves))
    return local_map(body, out_placements=tuple(out_placements),
                     in_placements=in_pl, in_grad_placements=in_grad,
                     device_mesh=ctx.mesh)(*flat)


def _view(mod, tensors: Dict[str, torch.Tensor], prefix: str = ""):
    """A namespace with ``mod``'s attributes (kind, act, eps, cfg ...),
    its submodules as namespaces and its parameters from ``tensors``
    (by dotted name under ``prefix``; absent ones None): what the plain
    layer functions read of a module."""
    ns = SimpleNamespace(**{k: v for k, v in vars(mod).items()
                            if not k.startswith("_") and k != "training"})
    for name, child in mod._modules.items():
        setattr(ns, name, None if child is None
                else _view(child, tensors, f"{prefix}{name}."))
    for name in mod._parameters:
        setattr(ns, name, tensors.get(prefix + name))
    return ns


def _local_cfg(cfg, n_heads: int, n_kv_heads: int):
    """``cfg`` with a rank's head counts (no re-validation: a rank may
    hold fewer q than K/V heads)."""
    c = copy.copy(cfg)
    object.__setattr__(c, "n_heads", n_heads)
    object.__setattr__(c, "n_kv_heads", n_kv_heads)
    return c


def _n(ctx: MeshCtx, axes) -> int:
    return shd._axis_size(ctx.mesh, axes)


def _bspec(b, ndim: int, dim: int = 0):
    return tuple(b if i == dim else None for i in range(ndim))


# ---------------------------------------------------------- distribution ----

def distribute_model(model, cfg, mesh, strategy=None):
    """Every parameter of ``model`` a DTensor with its rule's placements
    (``sharding.params_sharding``), in place; ``model.mesh_ctx`` set.
    Returns the model."""
    strategy = strategy or shd.ShardingStrategy()
    specs = shd.params_sharding(model, cfg, mesh, strategy)
    for name in specs:        # one tensor held twice at a time, at most
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        p = mod._parameters[attr]
        mod._parameters[attr] = nn.Parameter(
            _distribute(p.detach(), mesh, shd.placements(specs[name], mesh)),
            requires_grad=p.requires_grad)
        del p
    model.mesh_ctx = MeshCtx(mesh, strategy)
    return model


def distribute_opt_state(opt_state, model):
    """AdamW's m and v as DTensors with the ZeRO-1 placements
    (``sharding.opt_state_sharding``)."""
    ctx = _ctx(model)
    specs = shd.opt_state_sharding(model, model.cfg, ctx.mesh, ctx.strategy)

    def put(t, spec):
        pl = shd.placements(spec, ctx.mesh)
        if isinstance(t, DTensor):
            return t.redistribute(ctx.mesh, pl)
        return _distribute(t, ctx.mesh, pl)
    return type(opt_state)(
        step=opt_state.step,
        m={n: put(t, specs["m"][n]) for n, t in opt_state.m.items()},
        v={n: put(t, specs["v"][n]) for n, t in opt_state.v.items()})


_FLOAT_KEYS = ("frames", "patch_embeds")


def distribute_batch(batch, model, mode: str):
    """A batch (numpy, tensors or DTensors) as DTensors laid out by
    ``sharding.batch_sharding``: ids and M-RoPE positions int64,
    embeddings in the model's dtype, on the mesh's device."""
    ctx = _ctx(model)
    out, plain = {}, {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            out[k] = v
            continue
        t = torch.as_tensor(v)
        t = (t.to(model.embed.dtype) if k in _FLOAT_KEYS
             else t.to(torch.long))
        plain[k] = t.to(_dev(model))
    if plain:
        tok = plain.get("tokens", batch.get("tokens"))
        shape = ShapeConfig("run", tok.shape[1], tok.shape[0], mode)
        specs = shd.batch_sharding(plain, model.cfg, shape, ctx.mesh,
                                   ctx.strategy)
        for k, t in plain.items():
            out[k] = _distribute(t, ctx.mesh,
                                 shd.placements(specs[k], ctx.mesh))
    return out


def _cache_shape(B: int) -> ShapeConfig:
    """A decode shape of batch B: what the cache rules read of one."""
    return ShapeConfig("run", 0, B, "decode")


def distribute_cache(cache, model):
    """A dense decode cache (``model.init_cache``'s tree) as DTensors
    laid out by ``sharding.cache_sharding``; a tensor ``pos`` replicated,
    an int ``pos`` kept."""
    ctx = _ctx(model)
    B = _batch_of(cache)
    shape = _cache_shape(B)

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, keys + (str(i),))
                              for i, v in enumerate(node))
        if not isinstance(node, torch.Tensor) or isinstance(node, DTensor):
            return node
        if keys == ("pos",):
            return _distribute(node, ctx.mesh,
                               [Replicate()] * len(ctx.names))
        spec = shd.cache_spec(keys, node, model.cfg, shape, ctx.mesh,
                              ctx.strategy)
        return _distribute(node, ctx.mesh, shd.placements(spec, ctx.mesh))
    return walk(cache, ())


def _batch_of(cache) -> int:
    return _flatten(cache["layers"][0])[0][0].shape[0]


def _store(ctx: MeshCtx, t, keys, cfg, B: int):
    """``t`` (a cache leaf) redistributed to its rule's layout."""
    spec = shd.cache_spec(keys, t, cfg, _cache_shape(B), ctx.mesh,
                          ctx.strategy)
    return to(ctx, t, spec)


def full(t):
    """The whole tensor of a DTensor (a plain tensor as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


# ------------------------------------------------------------ embeddings ----

def _embed(ctx: MeshCtx, model, tokens, pos, batch):
    """Vocab-parallel lookup, then ``model.finish_embed`` per rank:
    (x (B,S,d) in the residual layout, positions)."""
    cfg = model.cfg
    B, S = tokens.shape
    b = ctx.bax(B)
    vtp = "model" in ctx.names and cfg.vocab_size % ctx.m == 0
    w = to(ctx, model.embed, ("model" if vtp else None, None))
    rank = ctx.rank("model") if vtp else 0

    def lookup(t, w):
        vl = w.shape[0]
        tl = t - rank * vl
        ok = (tl >= 0) & (tl < vl)
        e = w[tl.clamp(0, vl - 1)]
        return (torch.where(ok[..., None], e,
                            torch.zeros((), dtype=e.dtype, device=e.device)),)
    (x,) = local_call(ctx, lookup, (to(ctx, tokens, (b, None)), w),
                      [ctx.pl((b, None, None), ("model",) if vtp else ())])
    x = to(ctx, x, (b, None, None))
    extra = {k: to(ctx, batch[k], (None, b, None) if k == "mrope_pos"
                   else (b, None, None))
             for k in ("patch_embeds", "mrope_pos") if k in batch}
    pos = to(ctx, pos, (b,)) if isinstance(pos, DTensor) else pos
    pspec = (None, b, None) if cfg.rope_kind == "mrope" else (b, None)

    def finish(x, t, pos, extra):
        return MD.finish_embed(cfg, x, t, pos, extra)
    return local_call(ctx, finish, (x, to(ctx, tokens, (b, None)), pos,
                                    extra),
                      [ctx.pl((b, None, None)), ctx.pl(pspec)])


def _positions_to(ctx, positions, b):
    spec = (None, b, None) if positions.ndim == 3 else (b, None)
    return to(ctx, positions, spec)


# ------------------------------------------------------------- attention ----

def _kv_heads(ctx: MeshCtx, Hq: int, Hkv: int):
    """The K/V heads a rank's q heads read, when q heads are over
    ``model`` and K/V heads replicated: a contiguous run of whole groups
    where the rank's q heads align with GQA groups, else one K/V head a
    q head (MHA)."""
    m = ctx.m
    hl, G = Hq // m, Hq // Hkv
    heads = range(ctx.rank("model") * hl, (ctx.rank("model") + 1) * hl)
    need = [h // G for h in heads]
    return sorted(set(need)) if hl % G == 0 or G % hl == 0 else need


def attention_call(ctx: MeshCtx, q, k, v, **kw):
    """``layers.attention`` (the ``KB`` op) per rank on pinned
    (``annotate.constrain_attn``) DTensor operands: a DTensor with q's
    placements. ``kv_len`` may be an int or a (B,) DTensor."""
    q, k, v, _ = A.constrain_attn(q, k, v)
    qh = q.placements[ctx.names.index("model")].is_shard() \
        if "model" in ctx.names else False
    kvh = k.placements[ctx.names.index("model")].is_shard() \
        if "model" in ctx.names else False
    sel = (_kv_heads(ctx, q.shape[1], k.shape[1])
           if qh and not kvh and ctx.m > 1 else None)
    kv_len = kw.pop("kv_len", None)
    if isinstance(kv_len, DTensor):
        kv_len = to(ctx, kv_len, (_fitted_batch(q),))

    def fn(q, k, v, kv_len):
        if sel is not None:
            idx = torch.tensor(sel, device=k.device)
            k, v = k.index_select(1, idx), v.index_select(1, idx)
        return (L.attention(q, k, v, kv_len=kv_len, **kw),)
    return local_call(ctx, fn, (q, k, v, kv_len), [tuple(q.placements)])[0]


def _fitted_batch(t):
    """The batch axes of a DTensor's dim 0 (names, in mesh order)."""
    names = t.device_mesh.mesh_dim_names
    axes = tuple(n for n, p in zip(names, t.placements)
                 if p.is_shard() and p.dim == 0)
    return None if not axes else axes if len(axes) > 1 else axes[0]


def _wspec(t, model_dim=None):
    """A weight's spec in a piece: replicated but for ``model`` on
    ``model_dim``."""
    return tuple("model" if i == model_dim else None for i in range(t.ndim))


def _attn_weights(ctx, p, prefix: str, qh, kvh, with_q=True, with_kv=True):
    W = {}
    names = (("wq", "bq", qh),) if with_q else ()
    names += (("wk", "bk", kvh), ("wv", "bv", kvh)) if with_kv else ()
    for w, bias, ax in names:
        W[f"{prefix}.{w}"] = to(ctx, getattr(p, w),
                                _wspec(getattr(p, w), 1 if ax else None))
        if getattr(p, bias, None) is not None:
            W[f"{prefix}.{bias}"] = to(ctx, getattr(p, bias),
                                       ("model" if ax else None,))
    return W


def _out_proj(ctx, p, out, cfg, fixed, B):
    """attn_out (B,H,S,hd), pinned, through ``wo`` per rank; the partial
    sums over ``model`` (heads over it) reduced: (B,S,d) residual."""
    out = A.constrain_attn_out(out, cfg.n_kv_heads)
    b = _fitted_batch(out)
    qh = "model" in ctx.names and out.placements[
        ctx.names.index("model")].is_shard() and \
        out.placements[ctx.names.index("model")].dim == 1
    wo = to(ctx, p.wo, _wspec(p.wo, 0 if qh else None))
    wide = qh and ctx.m > 1

    def fn(out, wo):
        if wide:
            out, wo = out.float(), wo.float()
        return (L.out_proj(SimpleNamespace(wo=wo), out, fixed),)
    (y,) = local_call(ctx, fn, (out, wo),
                      [ctx.pl((b, None, None), ("model",) if qh else ())])
    return _rounded(to(ctx, y, (ctx.bax(B), None, None)), p.wo.dtype)


def _rounded(y, dtype):
    """A reduced row-parallel product, rounded once to ``dtype`` (its
    partial sums over ``model`` were fp32: see ``_mlp``)."""
    return y if y.dtype == dtype else y.to(dtype)


def _heads(ctx, cfg, B):
    """(q spec, kv spec, the local config) of a layer's attention."""
    qs, kvs = A.attn_specs(ctx.mesh, B, cfg.n_heads, cfg.n_kv_heads)
    return qs, kvs, _local_cfg(cfg, cfg.n_heads // _n(ctx, qs[1]),
                               cfg.n_kv_heads // _n(ctx, kvs[1]))


def _self_attn(ctx, blk, x, cfg, mode, cache, pos, positions, B, S, li):
    """The attention sub-layer of ``blocks._attn_sublayer`` (train,
    prefill, decode) under the mesh; ``cache`` is the layer's cache in
    decode, the cache's length in prefill. Returns (y residual, the
    prefill's ``{"k", "v"}``, decode's cache updated in place, or
    None)."""
    fixed = mode in FIXED_MODES
    window = cfg.window if blk.kind in WINDOW_KINDS else 0
    qs, kvs, cfg_l = _heads(ctx, cfg, B)
    b = qs[0]
    xin = to(ctx, x, (b, None, None))
    pin = _positions_to(ctx, positions, b)
    norm = {"norm1.scale": to(ctx, blk.norm1.scale, (None,))}

    def proj(x, positions, W):
        pv = _view(blk, W)
        h = L.rmsnorm(pv.norm1.scale, x, cfg.norm_eps, fixed)
        return BL._rope_qkv(pv, h, cfg_l, positions, fixed)
    if (qs[1] is None) == (kvs[1] is None):
        W = dict(norm, **_attn_weights(ctx, blk.attn, "attn", qs[1], kvs[1]))
        q, k, v = local_call(ctx, proj, (xin, pin, W),
                             [ctx.pl(qs), ctx.pl(kvs), ctx.pl(kvs)])
    else:
        # q heads over model, K/V replicated: two pieces, so that the
        # K/V side's gradients are the replicated ones they are
        Wq = dict(norm, **_attn_weights(ctx, blk.attn, "attn", qs[1], None,
                                        with_kv=False))
        Wkv = dict(norm, **_attn_weights(ctx, blk.attn, "attn", None, None,
                                         with_q=False))

        def qfn(x, positions, W):
            pv = _view(blk, W)
            h = L.rmsnorm(pv.norm1.scale, x, cfg.norm_eps, fixed)
            q = L.q_proj(pv.attn, h, cfg_l, fixed)
            return (BL.rope(pv.kind, q, cfg_l, positions),)

        def kvfn(x, positions, W):
            pv = _view(blk, W)
            h = L.rmsnorm(pv.norm1.scale, x, cfg.norm_eps, fixed)
            k, v = L.kv_proj(pv.attn, h, cfg_l, fixed)
            return (BL.rope(pv.kind, k, cfg_l, positions).to(torch.bfloat16),
                    v.to(torch.bfloat16))
        (q,) = local_call(ctx, qfn, (xin, pin, Wq), [ctx.pl(qs)])
        k, v = local_call(ctx, kvfn, (xin, pin, Wkv), [ctx.pl(kvs)] * 2)
    kw = dict(cap=cfg.attn_softcap, scale=cfg.attn_scale)
    new = None
    if mode == "train":
        out = attention_call(ctx, q, k, v, causal=blk.kind != "enc",
                             window=window, **kw)
    elif mode == "prefill":
        out = attention_call(ctx, q, k, v, causal=True, window=window, **kw)
        Sc = min(window, cache) if window else cache

        def pack(k, v):
            def one(t):
                c = t.new_zeros(t.shape[:2] + (Sc,) + t.shape[3:])
                rows = BL.prefill_rows(t, Sc, window)
                c[:, :, :rows.shape[2]] = rows
                return c
            return one(k), one(v)
        kc, vc = local_call(ctx, pack, (k, v), [ctx.pl(kvs)] * 2)
        new = {n: _store(ctx, t, ("layers", str(li), n), cfg, B)
               for n, t in (("k", kc), ("v", vc))}
    else:                                              # decode
        Sc = cache["k"].shape[2]
        for n, t in (("k", k), ("v", v)):
            _write_row(ctx, cache[n], t, pos, window)
        kv_len = BL.decode_kv_len(pos, Sc)
        out = attention_call(ctx, q, cache["k"], cache["v"], causal=False,
                             kv_len=kv_len, **kw)
        new = cache
    return _out_proj(ctx, blk.attn, out, cfg, fixed, B), new


@torch.no_grad()
def _write_row(ctx: MeshCtx, c, row, pos, window: int) -> None:
    """Write the step's K/V row (B, Hkv, 1, hd) into the cache DTensor c
    (B, Hkv, Sc, hd) in its layout, on the rank whose seq shard holds
    the row's slot (``blocks.decode_slot``), in place: the dense decode
    write of ``blocks._attn_sublayer``."""
    pl = [p if p.is_shard() and p.dim in (0, 1) else Replicate()
          for p in c.placements]
    r = row.redistribute(ctx.mesh, pl).to_local()[:, :, 0]
    loc = c.to_local()
    Sc, Sl = c.shape[2], loc.shape[2]
    seq_dims = [i for i, p in enumerate(c.placements)
                if p.is_shard() and p.dim == 2]
    idx = 0
    for i in seq_dims:
        idx = idx * c.device_mesh.size(i) + c.device_mesh.get_local_rank(i)
    lo = idx * Sl
    if isinstance(pos, DTensor):
        bpl = [p if p.is_shard() and p.dim == 0 else Replicate()
               for p in c.placements]
        pos = pos.redistribute(ctx.mesh, bpl).to_local().long()
    slot = BL.decode_slot(pos, Sc, window)
    if not isinstance(slot, torch.Tensor):
        if lo <= slot < lo + Sl:
            loc[:, :, slot - lo] = r
        return
    li = slot - lo
    ok = (li >= 0) & (li < Sl)
    li = li.clamp(0, Sl - 1)
    rows = torch.arange(loc.shape[0], device=loc.device)
    cur = loc[rows, :, li]
    loc[rows, :, li] = torch.where(ok[:, None, None], r, cur)


def _cross_attn(ctx, blk, x, cfg, mode, cache, memory, B, li):
    """``blocks._cross_sublayer`` under the mesh: (y residual, the new
    ``ck``/``cv`` (prefill) or None)."""
    fixed = mode in FIXED_MODES
    qs, kvs, cfg_l = _heads(ctx, cfg, B)
    b = qs[0]
    Wq = {"norm_x.scale": to(ctx, blk.norm_x.scale, (None,))}
    Wq.update(_attn_weights(ctx, blk.xattn, "xattn", qs[1], kvs[1],
                            with_kv=False))

    def qfn(x, W):
        pv = _view(blk, W)
        h = L.rmsnorm(pv.norm_x.scale, x, cfg.norm_eps, fixed)
        return (L.q_proj(pv.xattn, h, cfg_l, fixed),)
    (q,) = local_call(ctx, qfn, (to(ctx, x, (b, None, None)), Wq),
                      [ctx.pl(qs)])
    new = None
    if mode == "decode":
        k, v = cache["ck"], cache["cv"]
    else:
        Wkv = _attn_weights(ctx, blk.xattn, "xattn", qs[1], kvs[1],
                            with_q=False)

        def kvfn(mem, W):
            k, v = L.kv_proj(_view(blk, W).xattn, mem, cfg_l, fixed)
            return k.to(torch.bfloat16), v.to(torch.bfloat16)
        k, v = local_call(ctx, kvfn, (to(ctx, memory, (b, None, None)), Wkv),
                          [ctx.pl(kvs)] * 2)
        if mode == "prefill":
            new = {n: _store(ctx, t, ("layers", str(li), n), cfg, B)
                   for n, t in (("ck", k), ("cv", v))}
    out = attention_call(ctx, q, k, v, causal=False, cap=cfg.attn_softcap,
                         scale=cfg.attn_scale)
    return _out_proj(ctx, blk.xattn, out, cfg, fixed, B), new


# ---------------------------------------------------------- mlp / moe ----

def _mlp(ctx, mlp, scale, x, cfg, fixed, B):
    """``layers.mlp`` of norm(x) (``scale``: the norm's; None: no norm)
    under the mesh: tensor parallel over ``model`` when it divides d_ff.
    Returns the reduced (B,S,d) residual."""
    b = ctx.bax(B)
    tp = "model" in ctx.names and mlp.w_up.shape[1] % ctx.m == 0
    W = {k: to(ctx, getattr(mlp, k),
               _wspec(getattr(mlp, k),
                      (0 if k == "w_down" else 1) if tp else None))
         for k in ("w_gate", "w_up", "w_down")
         if getattr(mlp, k, None) is not None}
    wide = tp and ctx.m > 1

    def fn(x, s, W):
        h = x if s is None else L.rmsnorm(s, x, cfg.norm_eps, fixed)
        pv = _view(mlp, W)
        if not wide:
            return (L.mlp(pv, h, fixed),)
        # each rank's partial down-projection in fp32, summed over model
        # in fp32 and rounded once, as the unsharded product's
        # accumulator is: bf16 partial sums would round twice more
        return (L.matmul_rows(L.mlp_hidden(pv, h, fixed).float(),
                              pv.w_down.float(), fixed),)
    sc = None if scale is None else to(ctx, scale, (None,))
    (y,) = local_call(ctx, fn, (to(ctx, x, (b, None, None)), sc, W),
                      [ctx.pl((b, None, None), ("model",) if tp else ())])
    return _rounded(to(ctx, y, (b, None, None)), mlp.w_down.dtype)


def _moe(ctx, moe, scale, x, cfg, fixed, with_aux, B, S):
    """``moe.moe_ffn`` of norm(x) under the mesh (module note): (y
    residual, the load-balance term or None)."""
    mcfg = cfg.moe
    E = mcfg.n_experts
    b = ctx.bax(B)
    xs = to(ctx, x, (b, None, None))
    sc = to(ctx, scale, (None,)) if scale is not None else None

    def norm(x, s):
        return x if s is None else L.rmsnorm(s, x, cfg.norm_eps, fixed)

    def route(x, s, r):
        h = norm(x, s)
        w, idx, logits = M.router_topk(SimpleNamespace(router=r), h, mcfg,
                                       fixed)
        if not with_aux:
            return w, idx
        f, pm = M.balance_stats(torch.softmax(logits, dim=-1), idx, E)
        frac = x.shape[0] / B
        return w, idx, f * frac, pm * frac
    outs = [ctx.pl((b, None, None))] * 2
    if with_aux:
        outs += [ctx.pl((None,), ctx.batch_partial(B))] * 2
    r = local_call(ctx, route, (xs, sc, to(ctx, moe.router, (None, None))),
                   outs)
    w, idx = r[0], r[1]
    ep = (get_flags().moe_dispatch == "shard_map" and S > 1
          and "model" in ctx.names and E % ctx.m == 0)
    exp = {n: to(ctx, getattr(moe, n), ("model" if ep else None, None, None))
           for n in ("w_gate", "w_up", "w_down")}
    rank = ctx.rank("model")

    def dispatch(x, s, w, idx, W):
        h = norm(x, s)
        pv = SimpleNamespace(**W)
        if ep:
            return (M._dispatch_ep(pv, h, w, idx, mcfg, rank),)
        return (M._dispatch(pv, h, w, idx, mcfg),)
    (y,) = local_call(ctx, dispatch, (xs, sc, w, idx, exp),
                      [ctx.pl((b, None, None), ("model",) if ep else ())])
    y = to(ctx, y, (b, None, None))
    for extra in (moe.dense_residual, moe.shared_expert):
        if extra is not None:
            y = y + _mlp(ctx, extra, scale, xs, cfg, fixed, B)
    aux = None
    if with_aux:
        f, pm = (to(ctx, t, (None,)) for t in r[2:])
        aux = M.aux_term(f, pm, mcfg)
    return y, aux


# ------------------------------------------------------- recurrent parts ----

def _ssm(ctx, blk, x, cfg, mode, cache, B):
    """hymba's SSM of norm1(x), batch-parallel: (y residual, new state
    {"h", "conv"} or None)."""
    fixed = mode in FIXED_MODES
    sb = ctx.scan_bax(B)
    W = {"norm1.scale": to(ctx, blk.norm1.scale, (None,))}
    W.update({f"ssm.{n}": to(ctx, t, (None,) * t.ndim)
              for n, t in blk.ssm.named_parameters()})
    state = None
    if mode == "decode":
        state = {"h": to(ctx, cache["ssm"]["h"], (sb, None, None)),
                 "conv": to(ctx, cache["ssm"]["conv"], (sb, None, None))}

    def fn(x, W, state):
        pv = _view(blk, W)
        h = L.rmsnorm(pv.norm1.scale, x, cfg.norm_eps, fixed)
        y, st = SS.ssm_forward(pv.ssm, h, cfg, state, fixed)
        return y, st["h"], st["conv"]
    y, h, conv = local_call(ctx, fn, (to(ctx, x, (sb, None, None)), W, state),
                            [ctx.pl((sb, None, None))] * 3)
    return to(ctx, y, (ctx.bax(B), None, None)), {"h": h, "conv": conv}


def _xlstm(ctx, blk, x, cfg, mode, cache, B):
    """An xLSTM block, batch-parallel: (x + y residual, new state)."""
    fixed = mode in FIXED_MODES
    sb = ctx.scan_bax(B)
    kind = blk.kind
    W = {"norm1.scale": to(ctx, blk.norm1.scale, (None,))}
    W.update({f"{kind}.{n}": to(ctx, t, (None,) * t.ndim)
              for n, t in getattr(blk, kind).named_parameters()})
    state = None
    if mode == "decode":
        leaves, build = _flatten(cache[kind])
        state = build([to(ctx, t, _bspec(sb, t.ndim)) for t in leaves])
    rebuild = []

    def fn(x, W, state):
        c = {kind: state} if state is not None else None
        y, st = BL._xlstm_block(_view(blk, W), x, cfg, mode, c)
        leaves, build = _flatten(st)
        rebuild.append(build)
        return (y,) + tuple(leaves)
    ndims = (4, 3, 2) if kind == "mlstm" else (3, 3, 3, 3)
    outs = local_call(ctx, fn, (to(ctx, x, (sb, None, None)), W, state),
                      [ctx.pl((sb, None, None))]
                      + [ctx.pl(_bspec(sb, n)) for n in ndims])
    st = rebuild[0](outs[1:])
    return to(ctx, outs[0], (ctx.bax(B), None, None)), st


def _hymba_mix(ctx, blk, a, s, cfg, fixed, B):
    b = ctx.bax(B)

    def fn(a, s, na, ns):
        return (0.5 * (L.rmsnorm(na, a, cfg.norm_eps, fixed)
                       + L.rmsnorm(ns, s, cfg.norm_eps, fixed)),)
    return local_call(ctx, fn, (a, s, to(ctx, blk.norm_a.scale, (None,)),
                                to(ctx, blk.norm_s.scale, (None,))),
                      [ctx.pl((b, None, None))])[0]


# ----------------------------------------------------------------- block ----

def _block(ctx, blk, x, cfg, mode, cache, pos, positions, memory, li,
           cache_len=0):
    """``blocks.block_apply`` under the mesh: (x, the layer's new cache
    (prefill, decode) or None, the MoE aux term (train) or None)."""
    B, S, _ = x.shape
    fixed = mode in FIXED_MODES
    train = mode == "train"
    new: Dict[str, Any] = {}
    if blk.kind in BL.XLSTM_KINDS:
        x, st = _xlstm(ctx, blk, x, cfg, mode, cache, B)
        if not train:
            new[blk.kind] = _store_tree(ctx, st, ("layers", str(li),
                                                  blk.kind), cfg, B)
        return x, (None if train else new), None
    attn_y, kv = _self_attn(ctx, blk, x, cfg, mode,
                            cache if mode == "decode" else cache_len, pos,
                            positions, B, S, li)
    if kv is not None:
        new.update({k: kv[k] for k in ("k", "v")})
    if blk.kind in BL.HYMBA_KINDS:
        ssm_y, st = _ssm(ctx, blk, x, cfg, mode, cache, B)
        if not train:
            new["ssm"] = _store_tree(ctx, st, ("layers", str(li), "ssm"),
                                     cfg, B)
        attn_y = _hymba_mix(ctx, blk, attn_y, ssm_y, cfg, fixed, B)
    x = x + attn_y
    if blk.kind == "encdec":
        y, ckv = _cross_attn(ctx, blk, x, cfg, mode, cache, memory, B, li)
        x = x + y
        if mode == "prefill":
            new.update(ckv)
        elif mode == "decode":
            new.update({k: cache[k] for k in ("ck", "cv")})
    aux = None
    if blk.kind == "moe":
        y, aux = _moe(ctx, blk.moe, blk.norm2.scale, x, cfg, fixed, train,
                      B, S)
    else:
        y = _mlp(ctx, blk.mlp, blk.norm2.scale, x, cfg, fixed, B)
    x = x + y
    return x, (None if train else new), aux


def _store_tree(ctx, tree, keys, cfg, B):
    if isinstance(tree, dict):
        return {k: _store_tree(ctx, v, keys + (str(k),), cfg, B)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_store_tree(ctx, v, keys + (str(i),), cfg, B)
                          for i, v in enumerate(tree))
    return _store(ctx, tree, keys, cfg, B)


def _train_block(ctx, blk, x, positions, cfg, memory):
    x, _, aux = _block(ctx, blk, x, cfg, "train", None, 0, positions,
                       memory, 0)
    return x, aux


# ------------------------------------------------------------ head, loss ----

def _head_tensors(ctx, model, vocab_model: bool):
    """The head's tensors (tied embedding or lm_head) and the final norm,
    the vocab over ``model`` or replicated."""
    W = {"final_norm.scale": to(ctx, model.final_norm.scale, (None,))}
    if model.lm_head is None:
        W["embed"] = to(ctx, model.embed,
                        ("model" if vocab_model else None, None))
    else:
        W["lm_head"] = to(ctx, model.lm_head,
                          (None, "model" if vocab_model else None))
    return W


def _logits_out(ctx, model, x, B):
    """Last-row logits (B,V) fp32, vocab-sharded as ``logits_sharding``."""
    cfg = model.cfg
    spec = shd.logits_sharding(cfg, ShapeConfig("run", 1, B, "decode"),
                               ctx.mesh, ctx.strategy)
    vm = spec[1] is not None
    b = ctx.bax(B)
    W = _head_tensors(ctx, model, vm)

    def fn(x, W):
        v = _view(model, W)
        xl = L.rmsnorm(v.final_norm.scale, x[:, -1:], cfg.norm_eps)
        return (MD._logits(v, xl)[:, 0],)
    (lg,) = local_call(ctx, fn, (to(ctx, x, (b, None, None)), W),
                       [ctx.pl((b, "model" if vm else None))])
    return to(ctx, lg, spec)


def _loss(ctx, model, x, labels, B):
    """``xent_chunked`` of the final-normed x: each rank's sums over its
    batch shard (the head gathered), added over the batch axes."""
    cfg = model.cfg
    b = ctx.bax(B)
    W = _head_tensors(ctx, model, False)

    def fn(x, labels, W):
        v = _view(model, W)
        h = L.rmsnorm(v.final_norm.scale, x, cfg.norm_eps, fixed=True)
        return MD.xent_sums(v, h, labels)
    tot, cnt = local_call(ctx, fn, (to(ctx, x, (b, None, None)),
                                    to(ctx, labels, (b, None)), W),
                          [ctx.pl((), ctx.batch_partial(B))] * 2)
    tot, cnt = to(ctx, tot, ()), to(ctx, cnt, ())
    return tot / torch.clamp(cnt, min=1.0)


# --------------------------------------------------------------- encoder ----

def _encode(ctx, model, frames, remat=False):
    cfg = model.cfg
    B = frames.shape[0]
    b = ctx.bax(B)
    dtype = model.embed.dtype

    def fn(f):
        return MD.encoder_input(cfg, f, dtype)
    x, positions = local_call(ctx, fn, (to(ctx, frames, (b, None, None)),),
                              [ctx.pl((b, None, None)), ctx.pl((b, None))])
    for blk in model.encoder.layers:
        if remat:
            x, _ = checkpoint(_train_block, ctx, blk, x, positions, cfg,
                              None, use_reentrant=False)
        else:
            x, _ = _train_block(ctx, blk, x, positions, cfg, None)

    def norm(x, s):
        return (L.rmsnorm(s, x, cfg.norm_eps, fixed=True),)
    return local_call(ctx, norm, (x, to(ctx, model.encoder.final_norm.scale,
                                        (None,))),
                      [ctx.pl((b, None, None))])[0]


def _memory(ctx, model, batch, remat=False):
    if not model.cfg.n_enc_layers:
        return None
    if batch.get("frames") is None:
        raise ValueError(f"{model.cfg.name}: an encoder-decoder stack "
                         f"needs the batch's frames (B, S_enc, d)")
    return _encode(ctx, model, batch["frames"], remat)


# ------------------------------------------------------------ public API ----

def train_loss(model, batch, remat: bool = True):
    """``model.train_loss`` under the mesh: a replicated 0-d DTensor."""
    ctx = _ctx(model)
    cfg = model.cfg
    batch = distribute_batch(batch, model, "train")
    memory = _memory(ctx, model, batch, remat)
    x, positions = _embed(ctx, model, batch["tokens"], 0, batch)
    aux = _distribute(torch.zeros((), dtype=torch.float32,
                                  device=_dev(model)),
                      ctx.mesh, [Replicate()] * len(ctx.names))
    for blk in model.layers:
        if remat:
            x, a = checkpoint(_train_block, ctx, blk, x, positions, cfg,
                              memory, use_reentrant=False)
        else:
            x, a = _train_block(ctx, blk, x, positions, cfg, memory)
        if a is not None:
            aux = aux + a
    return _loss(ctx, model, x, batch["labels"], x.shape[0]) + aux


@torch.no_grad()
def prefill(model, batch, cache_len: int, seq_axis=None):
    """``model.prefill`` under the mesh: (logits (B,V) vocab-sharded, the
    cache in its rule's layout, ``pos`` the prompt length)."""
    ctx = _ctx(model)
    cfg = model.cfg
    batch = distribute_batch(batch, model, "prefill")
    tokens = batch["tokens"]
    S = tokens.shape[1]
    memory = _memory(ctx, model, batch)
    cache_len = MD.prefill_cache_len(cfg, cache_len)
    x, positions = _embed(ctx, model, tokens, 0, batch)
    layers = []
    for li, blk in enumerate(model.layers):
        x = A.constrain_seq(x, seq_axis)
        x, c, _ = _block(ctx, blk, x, cfg, "prefill", None, 0, positions,
                         memory, li, cache_len)
        x = A.constrain_seq(x, seq_axis)
        layers.append(c)
    return _logits_out(ctx, model, x, x.shape[0]), {"layers": layers,
                                                    "pos": S}


@torch.no_grad()
def decode_step(model, cache, batch):
    """``model.decode_step`` under the mesh (dense caches): logits (B,V)
    vocab-sharded and the cache, updated in place, with ``pos + 1``."""
    ctx = _ctx(model)
    cfg = model.cfg
    MD.check_decoder_cap(cfg, cache)
    batch = distribute_batch(batch, model, "decode")
    pos = cache["pos"]
    if isinstance(pos, torch.Tensor) and not isinstance(pos, DTensor):
        pos = _distribute(pos.to(_dev(model)), ctx.mesh,
                          [Replicate()] * len(ctx.names))
    x, positions = _embed(ctx, model, batch["tokens"], pos, batch)
    layers = []
    for li, (blk, c) in enumerate(zip(model.layers, cache["layers"])):
        x, c, _ = _block(ctx, blk, x, cfg, "decode", c, pos, positions, None,
                         li)
        layers.append(c)
    return (_logits_out(ctx, model, x, x.shape[0]),
            {"layers": layers, "pos": pos + 1})
