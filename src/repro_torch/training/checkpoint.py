"""Flat-npz checkpoints in the JAX package's format
(``training/checkpoint.py`` there), so each framework reads the other's
files.

The npz maps each leaf's '/'-joined path in the JAX params tree
(``segments/0/0/attn/wq``, list indices as numbers) to its array, bf16
stored as its exact fp32 upcast. ``save_checkpoint`` writes a model's
tree (``convert.params_to_numpy``) atomically: a ``.tmp`` file, then
``os.replace``. ``load_checkpoint`` reads any such file into a fresh
``Model`` (``convert.load_jax_checkpoint`` + ``params_from_numpy``),
casting each leaf back to the model's dtype.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.common.config import ModelConfig
from repro_torch.models.convert import _walk, load_jax_checkpoint, \
    params_from_numpy, params_to_numpy
from repro_torch.models.model import Model


def save_checkpoint(path: str, model: Model) -> None:
    arrays = dict(_walk(params_to_numpy(model), ""))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, cfg: ModelConfig, device=None) -> Model:
    """A ``Model`` of ``cfg`` on ``device`` (cuda unless given) holding the
    checkpoint's weights."""
    return params_from_numpy(load_jax_checkpoint(path), cfg, device)
