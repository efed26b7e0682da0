"""Weight bridge: the JAX package's params into the port's ``Model``,
and back.

The JAX params tree (``models/model.py:34-65`` there) is nested dicts and
lists whose layer leaves carry a leading stacked axis R per segment:
``segments[si][ui][name...][r]`` is layer ``offset(si) + r * len(unit) +
ui``. ``params_from_numpy`` takes that tree with numpy leaves (as
``jax.tree.map(np.asarray, params)`` gives it) and copies every leaf into
the matching ``Model`` tensor, checking each shape. A leaf's path is its
tensor's name with '/' for '.': ``attn/wq``, with ``qkv_bias`` (qwen1.5,
starcoder2) ``attn/bq``, ``attn/bk`` and ``attn/bv``, ``mlp/w_gate``
(GLU MLPs; the ``"gelu"`` MLP has ``mlp/w_up`` and ``mlp/w_down``
only), the MoE
leaves ``moe/router``, ``moe/w_gate`` (E, d, dff), ``moe/w_up``,
``moe/w_down``, ``moe/dense_residual/*`` and ``moe/shared_expert/*``,
hymba's ``ssm/*`` (``in_proj``, ``conv_w``, ``conv_b``, ``w_bc``,
``w_dt``, ``dt_proj``, ``out_proj`` in bf16; ``dt_bias``, ``A_log``, ``D``
in fp32), ``norm_a/scale`` and ``norm_s/scale``, xlstm's ``mlstm/*``
(``up``, ``wq``, ``wk``, ``wv``, ``down``, ``norm/scale`` in bf16;
``w_if``, ``b_i``, ``b_f`` in fp32) and ``slstm/*`` (``w_gates``,
``r_gates``, ``w_up``, ``w_down``, ``norm_ffn/scale`` in bf16;
``b_gates`` in fp32), each under a unit of four kinds repeated R times
at full width, whisper's ``"encdec"`` layers' ``norm_x/scale`` and
``xattn/*`` (the cross-attention's projections), and at the top
``embed``, ``final_norm/scale``, untied (the MoE stacks, qwen1.5,
qwen2-vl) ``lm_head`` and, with an encoder (whisper), ``encoder/layers/*``
(its ``"enc"`` layers' leaves, stacked over the encoder's layers as a
segment's are over R) and ``encoder/final_norm/scale``. A tree that
lacks a model tensor or holds a leaf the model lacks raises.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; they go through fp32, which holds every
bf16 value exactly, and are cast back. ``load_jax_checkpoint`` reads the
path-keyed npz that the JAX package's ``training/checkpoint.py`` writes
(bf16 stored as fp32) with numpy alone. fp32 leaves are copied as they
are, bit for bit. ``params_to_numpy`` is the inverse: a model's
weights as that tree, layer leaves stacked over R, bf16 as fp32.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.model import Model, init_params


def _to_tensor(leaf, like: torch.Tensor, key: str) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)} != model "
                         f"{tuple(like.shape)}")
    return t.to(like.dtype)


def _walk(tree, prefix: str) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def layer_slot(cfg: ModelConfig, i: int) -> Tuple[int, int, int]:
    """(segment, unit kind, repeat) of layer ``i`` in the JAX tree: the
    layer is ``segments[si][ui][...][r]``."""
    offset = 0
    for si, (unit, R) in enumerate(cfg.segments):
        if i < offset + len(unit) * R:
            r, ui = divmod(i - offset, len(unit))
            return si, ui, r
        offset += len(unit) * R
    raise IndexError(f"{cfg.name} has {offset} layers, not {i + 1}")


def jax_leaf(cfg: ModelConfig, name: str):
    """(the JAX tree's path keys, the index along the leaf's stack axis
    or None) of the model tensor ``name``: ``layers.5.attn.wq`` is
    ``segments/si/ui/attn/wq`` at ``layer_slot(cfg, 5)``'s r,
    ``encoder.layers.2.attn.wq`` is ``encoder/layers/attn/wq`` at 2, a
    top-level tensor its own path, unstacked. The keys are strings, as
    the JAX package's sharding rules read a path."""
    parts = name.split(".")
    if parts[0] == "layers":
        si, ui, r = layer_slot(cfg, int(parts[1]))
        return ("segments", str(si), str(ui), *parts[2:]), r
    if parts[:2] == ["encoder", "layers"]:
        return ("encoder", "layers", *parts[3:]), int(parts[2])
    return tuple(parts), None


def stack_len(cfg: ModelConfig, keys) -> int:
    """The length of the stack axis of the JAX leaf at ``keys`` (a
    ``jax_leaf`` path of a stacked leaf): its segment's R, or the
    encoder's layer count."""
    if keys[0] == "segments":
        return cfg.segments[int(keys[1])][1]
    return cfg.n_enc_layers


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> Model:
    """A ``Model`` holding the JAX params ``tree`` (numpy leaves)."""
    model = init_params(cfg, seed=0, device=device)
    tensors: Dict[str, torch.Tensor] = dict(model.named_parameters())
    filled = set()

    def put(name: str, leaf, key: str):
        dst = tensors[name]
        dst.data.copy_(_to_tensor(leaf, dst, key).to(dst.device))
        filled.add(name)

    def put_stacked(subtree, where: str, R: int, layer_name):
        """Each leaf of ``subtree`` stacked over R layers: row r into
        the tensor ``layer_name(r) + key``."""
        for key, leaf in _walk(subtree, ""):
            arr = np.asarray(leaf)
            if arr.shape[:1] != (R,):
                raise ValueError(f"{where}/{key}: leading axis "
                                 f"{arr.shape[:1]} != ({R},)")
            for r in range(R):
                name = layer_name(r) + key.replace("/", ".")
                if name not in tensors:
                    raise KeyError(f"{where}/{key}: no model tensor {name}")
                put(name, arr[r], f"{where}/{key}[{r}]")

    offset = 0
    for si, (unit, R) in enumerate(cfg.segments):
        for ui in range(len(unit)):
            put_stacked(tree["segments"][si][ui], f"segments/{si}/{ui}", R,
                        lambda r: f"layers.{offset + r * len(unit) + ui}.")
        offset += len(unit) * R
    top = {k: v for k, v in tree.items() if k != "segments"}
    if "encoder" in top:
        top["encoder"] = dict(top["encoder"])
        put_stacked(top["encoder"].pop("layers"), "encoder/layers",
                    cfg.n_enc_layers, lambda r: f"encoder.layers.{r}.")
    for key, leaf in _walk(top, ""):
        name = key.replace("/", ".")
        if name not in tensors:
            raise KeyError(f"{key}: no model tensor {name}")
        put(name, leaf, key)
    missing = sorted(set(tensors) - filled)
    if missing:
        raise KeyError(f"params tree lacks {missing}")
    return model


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The params tree of a JAX-package npz checkpoint, numpy leaves.

    Keys are '/'-joined tree paths; an all-digit component is a list
    index. Leaves stay fp32 (the checkpoint's lossless bf16 upcast)."""
    root: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = root
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out
    return listify(root)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy (a DTensor's whole tensor, gathered)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _put(tree: Dict[str, Any], path, leaf) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = leaf


def params_to_numpy(model: Model) -> Dict[str, Any]:
    """The JAX params tree of ``model``'s weights, numpy leaves:
    ``segments[si][ui]`` holds each leaf of unit kind ui stacked over the
    segment's R layers; bf16 leaves as fp32 (exact), fp32 leaves as they
    are. ``params_from_numpy`` of it rebuilds the model bit for bit."""
    named = dict(model.named_parameters())
    tree: Dict[str, Any] = {}
    for name, t in named.items():
        if not name.startswith(("layers.", "encoder.layers.")):
            _put(tree, name.split("."), _np(t))

    def stacked(first: str, layer_name, R: int) -> Dict[str, Any]:
        """Each leaf of the layer named ``first`` stacked over the R
        layers ``layer_name(r)``."""
        leaves: Dict[str, Any] = {}
        for name in named:
            if name.startswith(first):
                key = name[len(first):]
                _put(leaves, key.split("."), np.stack([
                    _np(named[layer_name(r) + key]) for r in range(R)]))
        return leaves

    segments = []
    offset = 0
    for unit, R in model.cfg.segments:
        segments.append([
            stacked(f"layers.{offset + ui}.",
                    lambda r: f"layers.{offset + r * len(unit) + ui}.",
                    R) for ui in range(len(unit))])
        offset += len(unit) * R
    tree["segments"] = segments
    if model.encoder is not None:
        tree["encoder"]["layers"] = stacked(
            "encoder.layers.0.", lambda r: f"encoder.layers.{r}.",
            model.cfg.n_enc_layers)
    return tree
