"""Helpers of the port's qwen2-vl and whisper tests
(``test_torch_vlm.py``, ``test_torch_whisper.py``): both families are
held at the model level, not through an engine (the JAX engine feeds
``prefill`` only tokens), on the same bridged weights and the same
inputs, built as ``tests/test_arch_smoke.py`` builds them. The dense
families' tests (``test_torch_dense_families.py``) redraw their weights
with ``redrawn`` too.

Weights: JAX ``init_params`` with its zero-initialised biases and norm
scales redrawn non-zero from a seed (zeros would hide a missing bias or
a norm scale read as 0), given to both frameworks: JAX as arrays, the
port through the weight bridge.

Tolerances, with their reasons:
  * logits and the train loss: |diff| <= LOGIT_TOL = 0.05, as
    ``tests/test_torch_dense_families.py``: an fp32 head over a bf16
    residual stream that the two frameworks round at other places;
  * prefill then decode against the full-sequence forward, within the
    port: the JAX package's own bound (``tests/test_arch_smoke.py``),
    |diff| <= 0.05 * max |logit| + 0.05.

Token ids stay below the smoke vocabulary (512): JAX fills out-of-range
embedding rows with NaN.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy

LOGIT_TOL = 0.05
BIAS_STD, SCALE_STD = 0.5, 0.2
B, S, STEPS, CACHE = 2, 24, 8, 64


def redrawn(tree, seed):
    """The numpy params tree with every q/k/v bias and norm scale drawn
    N(0, BIAS_STD) / N(0, SCALE_STD) in its own dtype."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        std = (BIAS_STD if name in ("bq", "bk", "bv")
               else SCALE_STD if name == "scale" else 0.0)
        if not std:
            return node
        arr = np.asarray(node)
        return (rng.standard_normal(arr.shape) * std).astype(arr.dtype)
    return walk(tree, "")


def bridged(arch: str):
    """(JAX smoke config, JAX params, the port's model) on the same
    redrawn weights."""
    jcfg = jax_smoke(arch)
    tree = redrawn(jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(0), jcfg)), seed=len(arch))
    return (jcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, get_smoke_config(arch), "cpu"))


def _jax_batch(batch):
    return {k: (jnp.asarray(np.asarray(v.float()), jnp.bfloat16)
                if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy(),
                                                              jnp.int32))
            for k, v in batch.items()}


def run_jax(jcfg, jp, prefill_batch, decode_batches, train_batch):
    """JAX's prefill logits, its decode steps' logits (one jitted step)
    and its train loss (forward only), as numpy."""
    lg, cache = JM.prefill(jp, jcfg, _jax_batch(prefill_batch),
                           cache_len=CACHE)
    out = {"prefill": np.asarray(lg), "cache": cache, "decode": []}
    step = jax.jit(JM.decode_step, static_argnums=1)
    for db in decode_batches:
        lg, cache = step(jp, jcfg, cache, _jax_batch(db))
        out["decode"].append(np.asarray(lg))
    out["loss"] = float(JM.train_loss(jp, jcfg, _jax_batch(train_batch),
                                      remat=False))
    return out


@torch.no_grad()
def run_port(model, prefill_batch, decode_batches, train_batch):
    """The port's prefill logits, decode steps' logits and train loss."""
    lg, cache = TM.prefill(model, prefill_batch, CACHE)
    out = {"prefill": lg.numpy(), "cache": cache, "decode": []}
    for db in decode_batches:
        lg, cache = TM.decode_step(model, cache, db)
        out["decode"].append(lg.numpy())
    out["loss"] = float(TM.train_loss(model, train_batch, remat=False))
    return out


def assert_runs_close(port, ref):
    np.testing.assert_allclose(port["prefill"], ref["prefill"],
                               atol=LOGIT_TOL, rtol=0)
    assert len(port["decode"]) == len(ref["decode"]) == STEPS
    for i, (a, b) in enumerate(zip(port["decode"], ref["decode"])):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"decode step {i}")
    assert abs(port["loss"] - ref["loss"]) <= LOGIT_TOL


@torch.no_grad()
def full_forward_logits(model, batch):
    """The full-sequence forward's logits (B, S, V) fp32 (train mode)."""
    return TM._logits(model, TM.forward_hidden(model, batch))


def within_arch_smoke_bound(got, want) -> bool:
    """The JAX package's prefill/decode vs full-forward bound."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) < 0.05 * scale + 0.05
