"""Training step factory and a minimal host-side training loop: the JAX
package's ``training/loop.py`` over the port's ``Model``.

``make_train_step(cfg)`` returns ``train_step(model, opt_state, batch)
-> (model, opt_state, metrics)``: the loss and its gradients
(``model.train_loss``, whose attention's gradient on the card is
``flash_prefill``'s backward kernel), then ``adamw_update``, which
updates the model's parameters and the state's moments in place. The
batch (numpy or tensors: packed tokens and labels, or a
``models/inputs.py:make_batch`` batch with a vlm's ``patch_embeds`` and
``mrope_pos`` or an audio stack's ``frames``, the JAX package's way to
train those families) moves to the model's device inside the step.
Metrics stay 0-d tensors on the device; reading one waits for the step.
A model distributed over a mesh (``distributed/parallel.py``) trains the
same way: every batch key is laid out by ``sharding.batch_sharding``
inside the step, its parameters and gradients are DTensors, and the
metrics are the replicated scalars' local values.
``init_params`` and the weight bridge build frozen (serving) models: a
model to train has ``requires_grad_(True)`` first.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.model import Model, init_params, train_loss
from repro_torch.training.optimizer import AdamWState, adamw_init, \
    adamw_update


def make_train_step(cfg: ModelConfig, *, lr=3e-4,
                    weight_decay: float = 0.01, remat: bool = True,
                    grad_clip: float = 1.0) -> Callable:
    def train_step(model: Model, opt_state: AdamWState, batch):
        params = dict(model.named_parameters())
        if getattr(model, "mesh_ctx", None) is not None:
            from repro_torch.distributed.parallel import distribute_batch
            batch = distribute_batch(batch, model, "train")
        loss = train_loss(model, batch, remat=remat)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        model, opt_state, gnorm = adamw_update(
            model, grads, opt_state, lr=lr, weight_decay=weight_decay,
            grad_clip=grad_clip)
        metrics = {"loss": _local(loss.detach()), "grad_norm": _local(gnorm),
                   "step": opt_state.step}
        return model, opt_state, metrics
    return train_step


def _local(t):
    """A DTensor scalar's value on this rank (a tensor as it is)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def train(cfg: ModelConfig, data_iter, n_steps: int, *, seed: int = 0,
          lr=3e-4, remat: bool = False, log_every: int = 10,
          callback: Optional[Callable] = None,
          clock: Optional[Callable[[], float]] = None, device=None):
    """Single-device training loop (the examples' and tests'): a fresh
    ``init_params(cfg, seed)`` model on ``device`` (cuda unless given).

    ``clock`` follows the serving engine's injected-clock convention:
    callers that want real ``wall_s`` in the history pass ``time.time``;
    the default zero clock keeps the history deterministic. Returns
    (model, opt_state, history), history holding the metrics of every
    ``log_every``-th step and of the last as floats."""
    clock = clock or (lambda: 0.0)
    model = init_params(cfg, seed=seed, device=device).requires_grad_(True)
    opt_state = adamw_init(model)
    step_fn = make_train_step(cfg, lr=lr, remat=remat)
    history = []
    t0 = clock()
    for step in range(n_steps):
        model, opt_state, metrics = step_fn(model, opt_state,
                                            next(data_iter))
        if step % log_every == 0 or step == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["wall_s"] = clock() - t0
            history.append(m)
            if callback:
                callback(step, m)
    return model, opt_state, history
