"""Logical-axis -> mesh-axis sharding rules for params, optimizer state,
batches and KV/state caches: the JAX package's
``distributed/sharding.py``, with DTensor placements as its output.

The rules are *path-based* and guarded by divisibility: a tensor dim is
only sharded over a mesh-axis tuple whose total size divides it
(``_fit``), so odd head counts (qwen1.5-32b kv=40, whisper kv=20, hymba
kv=5) degrade to replication. They are pure: they read only the axis
names and sizes of a mesh, a ``MeshShape`` or a ``DeviceMesh``
(``mesh_shape``), so they are held against the JAX package's with no
process group.

A spec is the per-dim tuple a JAX ``PartitionSpec`` holds: ``None``, an
axis name, or a tuple of names in mesh order. ``placements`` turns it
into DTensor placements: mesh dim i is ``Shard(d)`` where tensor dim d
names its axis, else ``Replicate()``; a dim over ``("data", "model")``
takes both mesh dims, in mesh order, as JAX's does.

The port keeps one tensor a layer where the JAX package stacks a
segment's layers over a leading axis R; a layer tensor's spec here is
JAX's spec of its stacked leaf without that leading ``None``. Each port
tensor is paired with its JAX leaf through the weight bridge's path
names (``models/convert.py:jax_leaf``), whose keys the rules read; a
cache leaf's path is its place in the port's cache tree, whose names are
the JAX tree's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig

Spec = Tuple[object, ...]


class MeshShape(NamedTuple):
    """Axis names and sizes of a mesh, all the rules read."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))


def mesh_shape(mesh) -> MeshShape:
    """A ``MeshShape`` of a ``MeshShape`` or a named ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


@dataclass(frozen=True)
class ShardingStrategy:
    fsdp: bool = True                  # shard weight d_model dims over data
    zero1: bool = True                 # shard optimizer m/v like fsdp
    decode_cache_seq: str = "model"    # decode KV cache seq axis: model|data|both|none
    shard_vocab: bool = True           # embed/lm_head vocab over model
    batch_over_pod: bool = True        # fold pod axis into the batch axes
    prefill_seq_axis: str = "none"     # shard prefill activations' seq dim

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def dp_axes(mesh, strategy: ShardingStrategy) -> Tuple[str, ...]:
    mesh = mesh_shape(mesh)
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if not strategy.batch_over_pod:
        axes = tuple(a for a in axes if a != "pod")
    return axes


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh_shape(mesh).shape[a]
    return n


def _fit(mesh, dim: int, axes):
    """Return axes if dim divisible by their product, else progressively
    drop trailing axes; None if nothing fits."""
    if axes is None:
        return None
    mesh = mesh_shape(mesh)
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    while axes:
        if dim % _axis_size(mesh, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
        axes = axes[:-1]
    return None


def _spec(mesh, shape, *per_dim) -> Spec:
    """A spec applying _fit per dim."""
    assert len(per_dim) == len(shape), (shape, per_dim)
    return tuple(_fit(mesh, d, ax) for d, ax in zip(shape, per_dim))


def _none(n: int) -> Spec:
    return (None,) * n


# ----------------------------------------------------------------- params ----

def param_spec(path_keys, leaf, cfg: ModelConfig, mesh,
               strategy: ShardingStrategy) -> Spec:
    keys = path_keys
    name = keys[-1] if keys else ""
    shape = tuple(leaf.shape)
    dat = "data" if strategy.fsdp else None
    mdl = "model"

    def stacked(spec_tail):
        """Prepend None for the layer-stack axis if leaf is stacked."""
        return _none(len(shape) - len(spec_tail)) + tuple(spec_tail)

    if name in ("embed", "lm_head"):
        vocab_ax = mdl if strategy.shard_vocab else None
        if name == "embed":
            return _spec(mesh, shape, vocab_ax, dat)
        return _spec(mesh, shape, dat, vocab_ax)
    if name == "scale" or "norm" in name or name in ("b_gates", "dt_bias",
                                                     "b_i", "b_f", "D"):
        return _none(len(shape))

    # MoE expert weights: (E, d, ff) — experts over model.
    if "moe" in keys and name in ("w_gate", "w_up", "w_down"):
        tail = [mdl, dat, None] if name != "w_down" else [mdl, None, dat]
        return stacked(_spec(mesh, shape[-3:], *tail))
    if "moe" in keys and name == "router":
        return stacked(_spec(mesh, shape[-2:], dat, mdl))

    two_d = {
        # attention
        "wq": (dat, mdl), "wk": (dat, mdl), "wv": (dat, mdl),
        "wo": (mdl, dat),
        # mlp
        "w_gate": (dat, mdl), "w_up": (dat, mdl), "w_down": (mdl, dat),
        # ssm
        "in_proj": (dat, mdl), "w_bc": (mdl, None), "w_dt": (mdl, None),
        "dt_proj": (None, mdl), "out_proj": (mdl, dat),
        # xlstm
        "up": (dat, mdl), "down": (mdl, dat), "w_gates": (dat, mdl),
        "w_if": (mdl, None),
    }
    one_d = {"bq": mdl, "bk": mdl, "bv": mdl, "conv_b": mdl}
    if name in two_d and len(shape) >= 2:
        return stacked(_spec(mesh, shape[-2:], *two_d[name]))
    if name in one_d and len(shape) >= 1:
        return stacked(_spec(mesh, shape[-1:], one_d[name]))
    if name == "conv_w":  # (K, di)
        return stacked(_spec(mesh, shape[-2:], None, mdl))
    if name == "A_log":   # (di, n)
        return stacked(_spec(mesh, shape[-2:], mdl, None))
    if name == "r_gates":  # (H, hd, 4hd)
        return stacked(_spec(mesh, shape[-3:], None, None, mdl))
    return _none(len(shape))


def tensor_spec(name: str, t, cfg: ModelConfig, mesh,
                strategy: ShardingStrategy) -> Spec:
    """The spec of the model tensor ``name``: the rule of its JAX leaf
    (the leaf with its stack axis, for a layer tensor), the stack axis
    dropped. Where a rule reads the stack axis as a tensor dim (a MoE
    layer's dense residual or shared expert, whose names are the
    experts'), JAX may split the stack over ``model``: a layer each on
    some ranks, which one tensor a layer cannot hold. Such a tensor is
    replicated over those axes; no production config meets it."""
    from repro_torch.models.convert import jax_leaf, stack_len
    keys, r = jax_leaf(cfg, name)
    if r is None:
        return param_spec(keys, t, cfg, mesh, strategy)
    shape = (stack_len(cfg, keys),) + tuple(t.shape)
    return param_spec(keys, torch.empty(shape, device="meta"), cfg, mesh,
                      strategy)[1:]


def params_sharding(model, cfg: ModelConfig, mesh,
                    strategy: ShardingStrategy) -> Dict[str, Spec]:
    """{parameter name: spec} of a ``Model`` (a ``param_shapes`` one
    will do), each by the rule of its JAX leaf (``tensor_spec``)."""
    return {n: tensor_spec(n, p, cfg, mesh, strategy)
            for n, p in model.named_parameters()}


def opt_state_sharding(model, cfg: ModelConfig, mesh,
                       strategy: ShardingStrategy) -> Dict[str, object]:
    """ZeRO-1: m/v take the fsdp spec even if params are model-only.
    {"m": {name: spec}, "v": {name: spec}, "step": ()}, the layout of
    ``training/optimizer.py:AdamWState``."""
    st = strategy.replace(fsdp=strategy.fsdp or strategy.zero1)
    specs = params_sharding(model, cfg, mesh, st)
    return {"m": dict(specs), "v": dict(specs), "step": ()}


# ------------------------------------------------------------ batch/cache ----

def batch_sharding(batch, cfg: ModelConfig, shape: ShapeConfig, mesh,
                   strategy: ShardingStrategy) -> Dict[str, Spec]:
    """{batch key: spec}; ``batch`` maps keys to tensors (or anything
    with a ``shape``)."""
    dp = dp_axes(mesh, strategy)
    # Sequence-parallel prefill (context parallelism): shard the prompt's
    # seq dim over `prefill_seq_axis`.
    sax = (strategy.prefill_seq_axis
           if (shape.mode == "prefill"
               and strategy.prefill_seq_axis != "none") else None)

    def fn(name, leaf):
        shp = tuple(leaf.shape)
        if name == "mrope_pos":        # (3, B, S)
            bax = dp if shp[1] > 1 else None
            return _spec(mesh, shp, None, bax, sax)
        bax = dp if shp[0] > 1 else None
        if name in ("tokens", "labels"):
            return _spec(mesh, shp, bax, sax)
        if name in ("frames", "patch_embeds"):
            return _spec(mesh, shp, bax, sax, None)
        return _none(len(shp))

    return {k: fn(k, v) for k, v in batch.items()}


def cache_spec(keys, leaf, cfg: ModelConfig, shape: ShapeConfig, mesh,
               strategy: ShardingStrategy) -> Spec:
    """The spec of one cache leaf at path ``keys`` (the JAX rule over the
    leaf with its stack axis, which is then dropped)."""
    dp = dp_axes(mesh, strategy)
    seq_ax = {"model": ("model",), "data": ("data",),
              "both": ("data", "model"), "none": None}[
                  strategy.decode_cache_seq]
    B = shape.global_batch
    batch_sharded = B % _axis_size(mesh, dp) == 0 and B > 1
    name = keys[-1]
    if name == "pos" or len(leaf.shape) == 0:
        return ()
    shp = (1,) + tuple(leaf.shape)                       # the stack axis
    bax = dp if batch_sharded else None
    # Batch-sharded caches put seq on `model`; unsharded-batch (B=1,
    # long_500k) caches can spread seq over every axis.
    if batch_sharded:
        sax = ("model",) if seq_ax is not None else None
    else:
        sax = seq_ax
    if name in ("k", "v", "ck", "cv"):   # (R, B, Hkv, S, hd)
        spec = _spec(mesh, shp, None, bax, None, sax, None)
    elif name == "h" and "ssm" in keys:    # (R, B, di, n)
        spec = _spec(mesh, shp, None, bax, "model", None)
    elif name == "conv":                   # (R, B, K-1, di)
        spec = _spec(mesh, shp, None, bax, None, "model")
    elif "mlstm" in keys:                  # (R,B,H,hd[,hd]) fp32
        spec = _spec(mesh, shp, None, bax, *([None] * (len(shp) - 2)))
    elif "slstm" in keys:                  # (R,B,H,hd)
        spec = _spec(mesh, shp, None, bax, None, None)
    else:
        spec = _none(len(shp))
    return spec[1:]


def cache_sharding(cache, cfg: ModelConfig, shape: ShapeConfig, mesh,
                   strategy: ShardingStrategy):
    """The cache tree (``model.init_cache``'s: ``{"layers": [...],
    "pos"}``, an mLSTM state a tuple) with a spec at every leaf."""
    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, keys + (str(i),)) for i, v in enumerate(node)]
            return type(node)(out)
        if not isinstance(node, torch.Tensor):
            return ()
        return cache_spec(keys, node, cfg, shape, mesh, strategy)
    return walk(cache, ())


def logits_sharding(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    strategy: ShardingStrategy) -> Spec:
    dp = dp_axes(mesh, strategy)
    B = shape.global_batch
    bax = dp if (B % _axis_size(mesh, dp) == 0 and B > 1) else None
    if bax is not None and len(bax) == 1:    # as a PartitionSpec holds it
        bax = bax[0]
    vax = "model" if (strategy.shard_vocab
                      and cfg.vocab_size % mesh_shape(mesh).shape["model"]
                      == 0) else None
    return (bax, vax)


# ------------------------------------------------------------- placements ----

def placements(spec: Spec, mesh):
    """DTensor placements of ``spec`` on ``mesh`` (one a mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = mesh_shape(mesh)
    out = [Replicate() for _ in mesh.names]
    for d, ax in enumerate(spec):
        axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
        idx = [mesh.names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in mesh order {mesh.names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def shard_factor(spec: Spec, mesh) -> int:
    """How many ways ``spec`` splits its tensor: the product of the sizes
    of the axes it names."""
    n = 1
    for ax in spec:
        n *= _axis_size(mesh, ax)
    return n


def local_bytes(t: torch.Tensor, spec: Spec, mesh) -> int:
    """Bytes of one rank's shard of ``t`` under ``spec`` (the rules only
    shard a dim over axes whose product divides it)."""
    return t.numel() * t.element_size() // shard_factor(spec, mesh)
