"""The port's neural intent gate (``serving/neural_planner.py``) and the
forward-only train mode it runs, against the JAX package's on the same
weights (JAX ``init_params`` through the weight bridge), at the planner's
SMOKE config.

Tolerances, with their reasons:
  * per-row label losses: |diff| <= 0.1 (LOSS_TOL). The loss is an fp32
    logsumexp over the head of a bf16 residual stream; both frameworks
    round bf16 products and elementwise ops at other places, which moves
    the logits by ~1e-2 over two layers (tests/test_torch_model.py's
    logit tolerance is 0.05); the largest difference measured here is
    0.0046 (12 queries x 8 intents);
  * decisions: equal to JAX's wherever JAX's top-2 loss margin exceeds
    twice LOSS_TOL (no loss within the tolerance can flip them), and
    wherever it exceeds twice the largest difference this run measured;
  * the final-normed hidden states of the forward-only train mode (bf16,
    |x| up to ~4): |diff| <= 2**-5 + 2**-6 |x|, the cache leaves' bound
    in tests/test_torch_model.py (measured: 0.047);
  * within the port, batched and single decisions are equal exactly, and
    a row's hidden state and loss have the same bits at every batch size.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving import neural_planner as JN
from repro_torch.configs import get_smoke_config
from repro_torch.core.intents import INTENTS
from repro_torch.env.tasks import make_benchmark
from repro_torch.env.world import build_world
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import neural_planner as TN

LOSS_TOL = 0.1
LEAF_ATOL, LEAF_RTOL = 2.0 ** -5, 2.0 ** -6


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke("planner-proxy-100m")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jp),
                              get_smoke_config("planner-proxy-100m"), "cpu")
    return jcfg, jp, model


@pytest.fixture(scope="module")
def queries():
    return [t.query for t in make_benchmark(build_world(0, n_images=200),
                                            12)]


def test_encode_pair_is_the_reference(queries):
    for q in queries[:3]:
        for intent in INTENTS:
            for a, b in zip(TN.encode_pair(q, intent, 64),
                            JN.encode_pair(q, intent, 64)):
                np.testing.assert_array_equal(a, b)


def test_per_example_loss_matches_the_reference(pair, queries):
    jcfg, jp, model = pair
    toks, labs = TN.BatchedNeuralIntentClassifier(
        model.cfg, model)._encode_rows(queries[:2])
    got = TN.per_example_loss(model, {"tokens": toks, "labels": labs})
    want = JN.per_example_loss(jp, jcfg, {"tokens": toks, "labels": labs})
    assert got.dtype == torch.float32 and got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOSS_TOL,
                               rtol=0)


def test_gate_decisions_match_the_reference_outside_near_ties(pair,
                                                              queries):
    jcfg, jp, model = pair
    jl = JN.BatchedNeuralIntentClassifier(jcfg, jp).losses(queries)
    tl = TN.BatchedNeuralIntentClassifier(model.cfg, model).losses(queries)
    assert tl.shape == jl.shape == (len(queries), len(INTENTS))
    assert np.isfinite(tl).all()
    diff = float(np.abs(tl - jl).max())
    assert diff <= LOSS_TOL
    top2 = np.sort(jl, axis=1)
    margin = top2[:, 1] - top2[:, 0]
    same = np.argmin(tl, axis=1) == np.argmin(jl, axis=1)
    assert same[margin > 2 * LOSS_TOL].all()
    assert same[margin > 2 * diff].all()


def test_batched_gate_equals_single_gate_exactly(pair, queries):
    _, _, model = pair
    seq = TN.NeuralIntentClassifier(model.cfg, model)
    bat = TN.BatchedNeuralIntentClassifier(model.cfg, model)
    a = [seq.classify(q) for q in queries[:6]]
    assert bat.classify_batch(queries[:6]) == a
    # odd wave sizes go through the pad path; decisions must not change
    assert bat.classify_batch(queries[:3]) == a[:3]
    assert bat.classify(queries[0]) == a[0]
    # and the losses themselves keep their bits across batch sizes
    one = bat.losses(queries[:1])
    np.testing.assert_array_equal(bat.losses(queries[:5])[:1], one)


def test_forward_rows_do_not_depend_on_the_batch(pair):
    _, _, model = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab_size, (5, 64))
    full = TM.forward_hidden(model, {"tokens": toks})
    for b in (0, 3):
        torch.testing.assert_close(
            TM.forward_hidden(model, {"tokens": toks[b:b + 1]}),
            full[b:b + 1], rtol=0, atol=0)


def test_forward_matches_the_reference_stack(pair):
    jcfg, jp, model = pair
    from repro.models import layers as JL
    rng = np.random.default_rng(1)
    toks = rng.integers(0, model.cfg.vocab_size, (2, 32)).astype(np.int32)
    x, positions = JM._embed_inputs(jp, jcfg, {"tokens": toks})
    x, _, _ = JM._apply_stack(jp, jcfg, x, mode="train",
                              positions=positions, remat=False)
    want = np.asarray(JL.rmsnorm(jp["final_norm"], x, jcfg.norm_eps),
                      np.float32)
    got = TM.forward_hidden(model, {"tokens": toks}).float().numpy()
    np.testing.assert_allclose(got, want, atol=LEAF_ATOL, rtol=LEAF_RTOL)


def test_train_mode_stays_forward_only_and_dense():
    """Train mode covers every kind (an xlstm-smoke stack's hidden states
    come out, with no graph); under grad it is differentiable (the
    training slices, ``model.train_loss``), and the gate's
    ``forward_hidden`` stays forward-only (no graph)."""
    cfg = get_smoke_config("xlstm-125m")
    model = TM.init_params(cfg, seed=0, device="cpu")
    hid = TM.forward_hidden(model, {"tokens": [[1, 2, 3, 4]]})
    assert hid.shape == (1, 4, cfg.d_model) and hid.grad_fn is None
    planner = TM.init_params(get_smoke_config("planner-proxy-100m"), seed=0,
                             device="cpu")
    from repro_torch.models.blocks import block_apply
    x = torch.zeros(1, 4, planner.cfg.d_model, dtype=torch.bfloat16,
                    requires_grad=True)
    y, _ = block_apply(planner.layers[0], x, planner.cfg, mode="train",
                       cache=None, pos=0, positions=torch.arange(4)[None])
    assert y.requires_grad and y.shape == x.shape
    assert TM.forward_hidden(planner, {"tokens": [[1, 2, 3, 4]]}).grad_fn \
        is None
