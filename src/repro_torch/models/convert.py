"""Weight bridge: the JAX package's params into the port's ``Model``.

The JAX params tree (``models/model.py:34-65`` there) is nested dicts and
lists whose layer leaves carry a leading stacked axis R per segment:
``segments[si][ui][name...][r]`` is layer ``offset(si) + r * len(unit) +
ui``. ``params_from_numpy`` takes that tree with numpy leaves (as
``jax.tree.map(np.asarray, params)`` gives it) and copies every leaf into
the matching ``Model`` tensor, checking each shape. A leaf's path is its
tensor's name with '/' for '.': ``attn/wq``, ``mlp/w_gate``, the MoE
leaves ``moe/router``, ``moe/w_gate`` (E, d, dff), ``moe/w_up``,
``moe/w_down``, ``moe/dense_residual/*`` and ``moe/shared_expert/*``,
hymba's ``ssm/*`` (``in_proj``, ``conv_w``, ``conv_b``, ``w_bc``,
``w_dt``, ``dt_proj``, ``out_proj`` in bf16; ``dt_bias``, ``A_log``, ``D``
in fp32), ``norm_a/scale`` and ``norm_s/scale``, xlstm's ``mlstm/*``
(``up``, ``wq``, ``wk``, ``wv``, ``down``, ``norm/scale`` in bf16;
``w_if``, ``b_i``, ``b_f`` in fp32) and ``slstm/*`` (``w_gates``,
``r_gates``, ``w_up``, ``w_down``, ``norm_ffn/scale`` in bf16;
``b_gates`` in fp32), each under a unit of four kinds repeated R times
at full width, and at the top
``embed``, ``final_norm/scale`` and, untied, ``lm_head``. A tree that
lacks a model tensor or holds a leaf the model lacks raises.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; they go through fp32, which holds every
bf16 value exactly, and are cast back. ``load_jax_checkpoint`` reads the
path-keyed npz that the JAX package's ``training/checkpoint.py`` writes
(bf16 stored as fp32) with numpy alone. fp32 leaves are copied as they
are, bit for bit.
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


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> Model:
    """A ``Model`` holding the JAX params ``tree`` (numpy leaves)."""
    model = init_params(cfg, seed=0, device=device)
    tensors: Dict[str, torch.Tensor] = dict(model.named_parameters())
    filled = set()

    def put(name: str, leaf, key: str):
        dst = tensors[name]
        dst.data.copy_(_to_tensor(leaf, dst, key).to(dst.device))
        filled.add(name)

    offset = 0
    for si, (unit, R) in enumerate(cfg.segments):
        for ui in range(len(unit)):
            for key, leaf in _walk(tree["segments"][si][ui], ""):
                arr = np.asarray(leaf)
                if arr.shape[:1] != (R,):
                    raise ValueError(f"segments/{si}/{ui}/{key}: leading "
                                     f"axis {arr.shape[:1]} != ({R},)")
                for r in range(R):
                    li = offset + r * len(unit) + ui
                    name = f"layers.{li}." + key.replace("/", ".")
                    if name not in tensors:
                        raise KeyError(f"segments/{si}/{ui}/{key}: no "
                                       f"model tensor {name}")
                    put(name, arr[r], f"segments/{si}/{ui}/{key}[{r}]")
        offset += len(unit) * R
    for key, leaf in _walk({k: v for k, v in tree.items()
                            if k != "segments"}, ""):
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
