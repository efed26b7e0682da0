"""Helpers of the port's per-family training tests
(``test_torch_train_{moe,hymba,xlstm,dense_families,multimodal}.py``):
the JAX reference's loss and gradients, the port's on bridged weights
with and without remat, and the map from the port's parameter names to
the JAX tree's leaves.

Tolerances, with their reasons (those of ``test_torch_training.py``):
  * the loss: |diff| <= LOSS_TOL = 2e-2 (an fp32 logsumexp over the head
    of a bf16 residual stream that both frameworks round at other
    places);
  * gradients: each leaf's relative norm ||port - JAX|| / ||JAX|| <=
    GRAD_REL = 3e-2: both in the parameters' dtype, every bf16 rounding
    of an activation or a partial gradient on the way back lands
    elsewhere in the two frameworks, and the JAX reference runs its
    scans in other orders (the SSM's chunked associative scan, the
    mLSTM's chunkwise form) than the port's sequential ones.
"""
import numpy as np
import torch

import jax

from repro.models import model as JM
from repro.training import data as JD
from repro_torch.models import model as TM
from repro_torch.models.convert import _walk, params_from_numpy

LOSS_TOL = 2e-2
GRAD_REL = 3e-2
B, S = 2, 64


def batch_of(jcfg):
    """JAX's packed synthetic data, one (B, S) batch (numpy)."""
    b = next(JD.PackedLMDataset(JD.synthetic_docs(jcfg.vocab_size, 0), B, S,
                                jcfg.vocab_size))
    return {k: np.asarray(v) for k, v in b.items()}


def jax_value_and_grad(jcfg, jp, batch):
    """JAX's loss and gradients: one jitted value_and_grad of
    ``train_loss`` on the reference backend, remat off."""
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JM.train_loss(p, jcfg, batch, remat=False)))(jp)
    return float(loss), grads


def bridged(jp, cfg):
    """The port's model on JAX's weights, trainable, on the CPU."""
    model = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return model.requires_grad_(True)


def port_grads(model, batch):
    """{remat: (loss, {name: gradient})} without and with remat."""
    params = dict(model.named_parameters())
    out = {}
    for remat in (False, True):
        loss = TM.train_loss(model, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(params.values()))
        out[remat] = (float(loss.detach()), dict(zip(params, grads)))
    return out


def flat(tree):
    """A JAX (or numpy) tree as {path: fp32 numpy leaf}."""
    return dict(_walk(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   tree), ""))


def jax_leaf(fl, name, cfg):
    """The JAX tree's leaf of a port parameter name (a layer's leaf
    sliced out of its segment's stacked axis, an encoder layer's out of
    the encoder's)."""
    if name.startswith("encoder.layers."):
        parts = name.split(".")
        return fl["encoder/layers/" + "/".join(parts[3:])][int(parts[2])]
    if not name.startswith("layers."):
        return fl[name.replace(".", "/")]
    parts = name.split(".")
    li, rest = int(parts[1]), "/".join(parts[2:])
    offset = 0
    for si, (unit, R) in enumerate(cfg.segments):
        if li < offset + len(unit) * R:
            r, ui = divmod(li - offset, len(unit))
            return fl[f"segments/{si}/{ui}/{rest}"][r]
        offset += len(unit) * R
    raise KeyError(name)


def grad_rel_errors(grads, jgrads, cfg):
    """{name: relative norm error} of the port's gradients against
    JAX's."""
    fl = flat(jgrads)
    out = {}
    for name, g in grads.items():
        j = jax_leaf(fl, name, cfg)
        out[name] = float(np.linalg.norm(g.float().numpy() - j)
                          / max(np.linalg.norm(j), 1e-30))
    return out


def assert_remat_bitwise(pg):
    assert pg[False][0] == pg[True][0]
    for name, g in pg[False][1].items():
        assert torch.equal(g, pg[True][1][name]), name


def autograd_nodes(t):
    """The type names of every node in ``t``'s backward graph."""
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.add(type(f).__name__)
        stack += [g for g, _ in f.next_functions]
    return names
