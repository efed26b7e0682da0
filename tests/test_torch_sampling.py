"""The port's threefry PRNG and sampler (``serving/prng.py``,
``serving/sampling.py``) and the engine's key schedule against JAX's.

Keys, ``fold_in``, ``split`` and random bits are equal to jax's bit for
bit; Gumbel values within GUMBEL_TOL (the two ``log``s round
differently); ``sample`` gives JAX's tokens row by row, except where the
JAX draw's top-2 margin of ``gumbel + logits / T`` is under TIE_MARGIN
(such rows are counted, and must be few).

The engines at T = 0.8 (planner smoke config, the JAX weights through
the bridge): the frameworks' logits differ within LOGIT_TOL
(tests/test_torch_engine.py), so a draw may rightly part at a near tie.
Teacher-forced along the JAX engine's tokens, the first token where a
request's streams part must be a near tie of JAX's draw: a top-2 margin
of ``gumbel + logits / T`` of at most 2 * LOGIT_TOL / T, or, under
top-k, JAX's token or the port's within 2 * LOGIT_TOL of JAX's k-th
largest logit (there the frameworks may keep different sets of k: the
random-init planner's logits are nearly flat, so its top 40 crowd the
cut). The engine's final key equals JAX's engine's: one split per
sampled token, greedy and seeded ones included.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving import sampling as JSMP
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import prng
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampling import SamplerConfig, sample

GUMBEL_TOL = 1e-6
TIE_MARGIN = 1e-5
LOGIT_TOL = 0.05
SEEDS = (0, 1, 2 ** 31 - 2)
ROWS, VOCAB = 256, 8192
PROMPTS = [f"Plot xview1 images around Tampa Bay with cloud cover below "
           f"{10 + i}%" for i in range(4)]


def jkey(key) -> tuple:
    return tuple(np.asarray(key).tolist())


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    key = prng.prng_key(seed)
    assert jkey(jk) == key
    for d in (0, 1, 5, 2 ** 31 - 1):
        assert jkey(jax.random.fold_in(jk, d)) == prng.fold_in(key, d)
    a, b = jax.random.split(jk)
    assert (jkey(a), jkey(b)) == prng.split(key)
    bits = np.asarray(jax.random.bits(jk, (3, 77))).astype(np.int64)
    assert np.array_equal(
        prng.random_bits([key], 3 * 77, "cpu").numpy().reshape(3, 77), bits)
    # several keys in one pass: each row over its own counters
    keys = [prng.fold_in(key, d) for d in range(3)]
    rows = prng.random_bits(keys, 77, "cpu").numpy()
    for k, row in zip(keys, rows):
        assert np.array_equal(row, np.asarray(jax.random.bits(
            jnp.asarray(k, jnp.uint32), (1, 77)))[0].astype(np.int64))


def test_gumbel_within_tolerance_of_jax():
    keys = [prng.fold_in(prng.prng_key(s), i) for s in SEEDS
            for i in range(3)]
    ours = prng.gumbel(keys, VOCAB, "cpu").numpy()
    for k, row in zip(keys, ours):
        ref = np.asarray(jax.random.gumbel(jnp.asarray(k, jnp.uint32),
                                           (1, VOCAB)))[0]
        np.testing.assert_allclose(row, ref, atol=GUMBEL_TOL, rtol=0)


@pytest.fixture(scope="module")
def draws():
    """256 rows of logits and one key per row."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((ROWS, VOCAB)) * 3).astype(np.float32)
    key = prng.prng_key(123)
    keys = []
    for _ in range(ROWS):
        key, k = prng.split(key)
        keys.append(k)
    return logits, keys


@pytest.mark.parametrize("temperature", [0.5, 0.8, 1.0])
@pytest.mark.parametrize("top_k", [0, 40])
def test_sample_gives_jax_tokens(draws, temperature, top_k):
    logits, keys = draws
    jcfg = JSMP.SamplerConfig(temperature=temperature, top_k=top_k)
    jkeys = jnp.asarray(keys, jnp.uint32)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda lg, k: JSMP.sample(lg[None], k, jcfg)[0]))(
            jnp.asarray(logits), jkeys))
    ours = sample(torch.from_numpy(logits), keys,
                  SamplerConfig(temperature=temperature, top_k=top_k))
    # JAX's perturbed logits, for the margin of each row's draw
    scaled = logits / np.float32(temperature)
    if top_k:
        kth = np.sort(scaled, axis=-1)[:, -top_k][:, None]
        scaled = np.where(scaled < kth, np.float32(-1e30), scaled)
    pert = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (VOCAB,)))(jkeys)) + scaled
    top2 = np.sort(pert, axis=-1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] < TIE_MARGIN
    differ = ours.numpy() != ref
    assert not (differ & ~tie).any(), np.flatnonzero(differ & ~tie)
    assert tie.sum() <= 2, tie.sum()


def test_sample_is_greedy_at_zero_temperature(draws):
    logits, _ = draws
    ours = sample(torch.from_numpy(logits), None, SamplerConfig())
    assert np.array_equal(ours.numpy(), logits.argmax(-1))
    with pytest.raises(ValueError, match="keys"):
        sample(torch.from_numpy(logits[:3]), draws[1][:2],
               SamplerConfig(temperature=0.8))


# ------------------------------------------------------------- engines ----

@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke("planner-proxy-100m")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("planner-proxy-100m")
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, "cpu")


def _sampler(cls, i, seeded):
    return cls(temperature=0.8, top_k=40 if i % 2 else 0,
               seed=11 + i if seeded else None)


def _jax_run(jcfg, jp, seeded, max_new, monkeypatch):
    """The JAX engine's outputs and the key each token was drawn with."""
    keys = {}
    orig = JE.InferenceEngine._request_key

    def recording(self, req, engine_key):
        key = orig(self, req, engine_key)
        keys[(req.request_id, len(req.output))] = jkey(key)
        return key

    monkeypatch.setattr(JE.InferenceEngine, "_request_key", recording)
    eng = JE.InferenceEngine(jcfg, jp, max_batch=2, cache_len=128, seed=3,
                             backend="reference")
    rids = [eng.add_request(p, max_new_tokens=max_new,
                            sampler=_sampler(JSMP.SamplerConfig, i, seeded))
            for i, p in enumerate(PROMPTS)]
    done = {r.request_id: r for r in eng.run_until_done()}
    return eng, [done[r] for r in rids], keys


def _near_tie(jcfg, jp, req, i, key, top_k, ours) -> dict:
    """Teacher-forced JAX logits after the prompt and the first ``i``
    tokens: the top-2 margin of JAX's draw ``gumbel(key) + logits / T``
    and, under top-k, the distance of JAX's token and ``ours`` from the
    k-th largest logit."""
    ids = list(req.prompt) + list(req.output[:i])
    logits, _ = JM.prefill(jp, jcfg, {"tokens": jnp.asarray([ids])},
                           cache_len=128)
    logits = np.asarray(logits[0], np.float32)
    scaled = logits / np.float32(0.8)
    cut = np.inf
    if top_k:
        kth = np.sort(logits)[-top_k]
        cut = min(abs(logits[req.output[i]] - kth), abs(logits[ours] - kth))
        scaled = np.where(scaled < np.sort(scaled)[-top_k],
                          np.float32(-1e30), scaled)
    pert = np.asarray(jax.random.gumbel(jnp.asarray(key, jnp.uint32),
                                        (1, scaled.size)))[0] + scaled
    top2 = np.sort(pert)[-2:]
    return {"margin": float(top2[1] - top2[0]), "cut": float(cut)}


@pytest.mark.parametrize("seeded", [True, False],
                         ids=["seeded", "engine_stream"])
def test_engine_tokens_at_t08_match_jax(pair, seeded, monkeypatch):
    """4 requests (top_k 0 and 40) through 2 slots, 8 new tokens each."""
    jcfg, jp, cfg, model = pair
    jeng, jreqs, jkeys = _jax_run(jcfg, jp, seeded, 8, monkeypatch)
    eng = InferenceEngine(cfg, model, max_batch=2, cache_len=128, seed=3)
    rids = [eng.add_request(p, max_new_tokens=8,
                            sampler=_sampler(SamplerConfig, i, seeded))
            for i, p in enumerate(PROMPTS)]
    done = {r.request_id: r.output for r in eng.run_until_done()}
    assert jkey(jeng.rng) == eng.rng
    equal = 0
    for i, (jr, rid) in enumerate(zip(jreqs, rids)):
        ours = done[rid]
        assert len(ours) == len(jr.output)
        for t, (a, b) in enumerate(zip(ours, jr.output)):
            if a != b:
                tie = _near_tie(jcfg, jp, jr, t, jkeys[(jr.request_id, t)],
                                40 if i % 2 else 0, a)
                assert (tie["margin"] <= 2 * LOGIT_TOL / 0.8
                        or tie["cut"] <= 2 * LOGIT_TOL), (i, t, tie)
                break                      # a near tie: streams part here
            equal += 1
    assert equal >= 24


def test_engine_key_equals_jax_after_greedy_and_spec_runs(pair, monkeypatch):
    """Greedy tokens split the engine key too; so does a speculative
    round, once per emitted token."""
    jcfg, jp, cfg, model = pair
    from repro.serving.specdec import SpecConfig as JSpec
    from repro_torch.serving.specdec import SpecConfig
    for spec in (False, True):
        jeng = JE.InferenceEngine(
            jcfg, jp, max_batch=2, cache_len=128, seed=9,
            backend="reference",
            spec_decode=JSpec(jcfg, jp, k=3) if spec else None)
        eng = InferenceEngine(
            cfg, model, max_batch=2, cache_len=128, seed=9,
            spec_decode=SpecConfig(cfg, model, k=3) if spec else None)
        for e, S in ((jeng, JSMP.SamplerConfig), (eng, SamplerConfig)):
            for i, p in enumerate(PROMPTS[:3]):
                e.add_request(p, max_new_tokens=6,
                              sampler=S(temperature=0.0 if i != 1 else 0.8,
                                        seed=5 if i == 1 else None))
            out = {r.request_id: len(r.output) for r in e.run_until_done()}
            assert sum(out.values()) == 18
        assert jkey(jeng.rng) == eng.rng, spec
        assert eng.rng != prng.prng_key(9)
