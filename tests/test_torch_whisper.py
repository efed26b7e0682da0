"""The port's whisper (an encoder of ``"enc"`` layers over frame
embeddings plus sinusoidal positions; ``"encdec"`` decoder layers with
causal self-attention and a cross-attention over the encoder's output;
GELU MLPs, no rope, a tied head) vs the JAX package's reference backend
at whisper-smoke (2 + 2 layers, d 128, 4/4 heads of 32, 512 ids), on
the CPU.

The decoder prompt is S ids beside 48 encoder frames; its cache is
capped at ``WHISPER_DEC_CACHE`` (448) rows, and a decode past it
raises. Helpers and tolerances: ``torch_multimodal_common.py``; the
encoder's output (bf16, RMS-normed) within LOGIT_TOL too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_multimodal_common as MM
from repro.common.config import ShapeConfig
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import inputs as JI
from repro.models import model as JM
from repro_torch.configs import ALL_IDS, get_config, get_smoke_config
from repro_torch.launch import serve as SV
from repro_torch.launch import train as TR
from repro_torch.models import model as TM
from repro_torch.models.convert import _walk, params_to_numpy
from repro_torch.models.inputs import _whisper_dec_len, make_batch
from repro_torch.serving.engine import InferenceEngine

ARCH = "whisper-large-v3"
ENC_LEN = 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: its pool, under the suite's workers, slows
    these small ops ~10x (``test_torch_training.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg):
    """tests/test_arch_smoke.py's inputs: S + STEPS decoder ids and
    ENC_LEN frames; (prefill batch, decode batches, train batch)."""
    rng = np.random.default_rng(3)
    n = MM.S + MM.STEPS
    toks = torch.from_numpy(rng.integers(5, cfg.vocab_size, (MM.B, n)))
    frames = torch.from_numpy(rng.standard_normal(
        (MM.B, ENC_LEN, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    pre = {"tokens": toks[:, :MM.S], "frames": frames}
    dec = [{"tokens": toks[:, i:i + 1]} for i in range(MM.S, n)]
    train = dict(pre, labels=toks[:, 1:MM.S + 1])
    return pre, dec, train


@pytest.fixture(scope="module")
def runs():
    """One module-scope JAX run: the encoder, prefill, 8 decode steps
    and the train loss through JAX and the port on the same bridged
    weights."""
    jcfg, jp, model = MM.bridged(ARCH)
    pre, dec, train = _inputs(model.cfg)
    frames = pre["frames"]
    enc = (TM._encode(model, frames).float().numpy(),
           np.asarray(JM._encode(jp, jcfg, jnp.asarray(
               np.asarray(frames.float()), jnp.bfloat16)), np.float32))
    return (jcfg, jp, model, enc, MM.run_port(model, pre, dec, train),
            MM.run_jax(jcfg, jp, pre, dec, train))


def test_configs_are_the_jax_packages():
    assert ARCH in ALL_IDS
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_smoke(ARCH))
    assert TM.WHISPER_DEC_CACHE == JM.WHISPER_DEC_CACHE


def test_encoder_matches_jax(runs):
    port, ref = runs[3]
    assert port.shape == (MM.B, ENC_LEN, get_smoke_config(ARCH).d_model)
    np.testing.assert_allclose(port, ref, atol=MM.LOGIT_TOL, rtol=0)


def test_prefill_decode_and_train_loss_match_jax(runs):
    """Prefill logits, 8 decode steps (the cross-attention over the
    cached ck/cv, one row a step) and the train loss, within
    LOGIT_TOL."""
    MM.assert_runs_close(runs[4], runs[5])


@pytest.mark.parametrize("leaf", ["k", "v", "ck", "cv"])
def test_cache_matches_jax(runs, leaf):
    """Self-attention K/V rows and the cross-attention's ck/cv against
    JAX's prefill cache."""
    port, ref = runs[4]["cache"], runs[5]["cache"]
    want = np.asarray(ref["segments"][0][0][leaf], np.float32)
    rows = MM.S if leaf in ("k", "v") else ENC_LEN
    for li, c in enumerate(port["layers"]):
        assert c[leaf].shape[2] == want.shape[3]
        np.testing.assert_allclose(c[leaf][:, :, :rows].float().numpy(),
                                   want[li][:, :, :rows], atol=MM.LOGIT_TOL,
                                   rtol=0, err_msg=f"layer {li}")


def test_prefill_then_decode_matches_the_full_forward(runs):
    """Within the port: the prefill's last logits and each decode
    step's against the full-sequence forward over the same inputs."""
    model = runs[2]
    pre, dec, _ = _inputs(model.cfg)
    full = {"tokens": torch.cat([pre["tokens"]]
                                + [d["tokens"] for d in dec], dim=1),
            "frames": pre["frames"]}
    want = MM.full_forward_logits(model, full)
    port = runs[4]
    assert MM.within_arch_smoke_bound(torch.from_numpy(port["prefill"]),
                                      want[:, MM.S - 1])
    for i, lg in enumerate(port["decode"]):
        assert MM.within_arch_smoke_bound(torch.from_numpy(lg),
                                          want[:, MM.S + i]), i


def test_params_round_trip_exactly(runs):
    """The encoder subtree and the encdec layers' norm_x / xattn leaves
    through the bridge and back, bit for bit."""
    _, jp, model = runs[:3]
    want = dict(_walk(jax.tree.map(np.asarray, jp), ""))
    got = dict(_walk(params_to_numpy(model), ""))
    assert set(got) == set(want)
    assert any(k.startswith("encoder/layers/") for k in want)
    assert any("/xattn/" in k for k in want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(leaf, np.float32),
                                      err_msg=key)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_make_batch_is_the_jax_packages(mode):
    shape = ShapeConfig("t", 2048, 2, mode)
    want = JI.make_batch(jax_smoke(ARCH), shape, seed=7)
    got = make_batch(get_smoke_config(ARCH), mode, 2, 2048, seed=7)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)
    for s in (16, 1500, 2048, 70_000, 524_288):
        assert _whisper_dec_len(s) == JI._whisper_dec_len(s)


@pytest.fixture(scope="module")
def smoke_model():
    return TM.init_params(get_smoke_config(ARCH), seed=0, device="cpu")


def test_decoder_cache_is_capped_and_decode_past_it_raises(smoke_model):
    """A prefill asked for 1,000 rows keeps 448; a decode at position
    448 raises ValueError and writes nothing."""
    pre, _, _ = _inputs(smoke_model.cfg)
    _, cache = TM.prefill(smoke_model, pre, 1000)
    assert all(c["k"].shape[2] == TM.WHISPER_DEC_CACHE
               for c in cache["layers"])
    assert all(c["ck"].shape[2] == ENC_LEN for c in cache["layers"])
    cache["pos"] = torch.full((MM.B,), TM.WHISPER_DEC_CACHE - 1)
    _, cache = TM.decode_step(smoke_model, cache,
                              {"tokens": pre["tokens"][:, :1]})
    before = [{k: v.clone() for k, v in c.items()} for c in cache["layers"]]
    with pytest.raises(ValueError, match="past the 448-row decoder cache"):
        TM.decode_step(smoke_model, cache, {"tokens": pre["tokens"][:, :1]})
    for c, b in zip(cache["layers"], before):
        assert all(torch.equal(c[k], b[k]) for k in b)


def test_missing_frames_extend_and_verify_raise(smoke_model):
    pre, _, _ = _inputs(smoke_model.cfg)
    with pytest.raises(ValueError, match="frames"):
        TM.prefill(smoke_model, {"tokens": pre["tokens"]}, 64)
    _, cache = TM.prefill(smoke_model, pre, 64)
    with pytest.raises(NotImplementedError, match="prefill_extend"):
        TM.prefill_extend(smoke_model, cache, {"tokens": pre["tokens"]})
    with pytest.raises(NotImplementedError, match="verify_extend"):
        TM.verify_extend(smoke_model, cache, {"tokens": pre["tokens"]})


def test_engine_and_launchers_refuse_the_family(smoke_model):
    with pytest.raises(NotImplementedError, match="prefill only tokens"):
        InferenceEngine(smoke_model.cfg, smoke_model)
    argv = ["--device", "cpu", "--smoke", "--arch", ARCH]
    with pytest.raises(NotImplementedError, match="'audio' family"):
        SV.main(argv)
    with pytest.raises(NotImplementedError,
                       match="feeds only PackedLMDataset"):
        TR.main(argv)
