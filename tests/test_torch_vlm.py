"""The port's qwen2-vl (``"full"`` layers under M-RoPE, patch embeddings
spliced over the first rows, q/k/v biases, untied head) vs the JAX
package's reference backend at qwen2-vl-smoke (2 layers, d 128, 4/2
heads of 32, M-RoPE sections (4, 6, 6), 16 vision rows, 512 ids), on
the CPU.

Two position layouts: ``make_batch``'s (t = h = w = the index, where
M-RoPE is RoPE) and an image grid (``inputs.grid_mrope_pos``: the 16
patches at t 0, h i // 4, w i % 4, the text after them), whose three
rows differ, so a wrong section split shows. Helpers and tolerances:
``torch_multimodal_common.py``. Within the port, bitwise: M-RoPE with
three equal rows is RoPE.
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
from repro.models import layers as JL
from repro.models import inputs as JI
from repro_torch.configs import ALL_IDS, get_config, get_smoke_config
from repro_torch.launch import serve as SV
from repro_torch.launch import serve_pipeline as SP
from repro_torch.launch import train as TR
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import _walk, params_to_numpy
from repro_torch.models.inputs import grid_mrope_pos, make_batch
from repro_torch.serving.engine import InferenceEngine

ARCH = "qwen2-vl-72b"
LAYOUTS = ("text", "grid")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: its pool, under the suite's workers, slows
    these small ops ~10x (``test_torch_training.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, layout):
    """tests/test_arch_smoke.py's inputs: S + STEPS ids, the patches,
    and the layout's positions over all of them; (prefill batch, decode
    batches, train batch)."""
    rng = np.random.default_rng(3)
    n = MM.S + MM.STEPS
    toks = torch.from_numpy(rng.integers(5, cfg.vocab_size, (MM.B, n)))
    patches = torch.from_numpy(rng.standard_normal(
        (MM.B, cfg.n_vision_tokens, cfg.d_model),
        dtype=np.float32)).to(torch.bfloat16)
    pos = (torch.arange(n).expand(3, MM.B, n) if layout == "text"
           else grid_mrope_pos(MM.B, n, cfg.n_vision_tokens, 4))
    pre = {"tokens": toks[:, :MM.S], "patch_embeds": patches,
           "mrope_pos": pos[..., :MM.S]}
    dec = [{"tokens": toks[:, i:i + 1], "mrope_pos": pos[..., i:i + 1]}
           for i in range(MM.S, n)]
    train = dict(pre, labels=toks[:, 1:MM.S + 1])
    return pre, dec, train


@pytest.fixture(scope="module")
def runs():
    """One module-scope JAX run: both layouts through JAX and the port
    on the same bridged weights."""
    jcfg, jp, model = MM.bridged(ARCH)
    out = {}
    for layout in LAYOUTS:
        pre, dec, train = _inputs(model.cfg, layout)
        out[layout] = (MM.run_port(model, pre, dec, train),
                       MM.run_jax(jcfg, jp, pre, dec, train))
    return jcfg, jp, model, out


def test_configs_are_the_jax_packages():
    assert ARCH in ALL_IDS
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_smoke(ARCH))


def test_apply_mrope_matches_jax():
    """Random (3, B, S) positions with three distinct rows, broadcast
    over the heads, at the smoke config's sections and at the full
    config's (16, 24, 24) over heads of 128."""
    rng = np.random.default_rng(0)
    for hd, sections in ((32, (4, 6, 6)), (128, (16, 24, 24))):
        x = rng.standard_normal((2, 4, 9, hd)).astype(np.float32)
        pos = rng.integers(0, 4096, (3, 2, 1, 9))
        assert len({tuple(r.ravel()) for r in pos}) == 3
        want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              sections)
        got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6, sections)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_with_equal_rows_is_rope_bitwise(dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 11, 32, generator=gen).to(dtype)
    pos = torch.randint(0, 100_000, (2, 11), generator=gen)
    rope = TL.apply_rope(x, pos[:, None], 1e6)
    mrope = TL.apply_mrope(x, pos.expand(3, 2, 11)[:, :, None], 1e6,
                           (4, 6, 6))
    assert torch.equal(rope, mrope)


def test_mrope_sections_must_cover_the_head():
    x = torch.zeros(1, 1, 2, 32)
    with pytest.raises(ValueError, match="sum to d_head / 2 = 16"):
        TL.apply_mrope(x, torch.zeros(3, 1, 1, 2), 1e6, (4, 6, 4))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_decode_and_train_loss_match_jax(runs, layout):
    """Prefill logits, 8 decode steps (mrope_pos (3, B, 1)) and the
    train loss, within LOGIT_TOL."""
    MM.assert_runs_close(*runs[3][layout])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_kv_cache_matches_jax(runs, layout):
    """The prefill's K/V rows (rotated by M-RoPE) against JAX's cache."""
    port, ref = runs[3][layout]
    jk = np.asarray(ref["cache"]["segments"][0][0]["k"], np.float32)
    for li, c in enumerate(port["cache"]["layers"]):
        np.testing.assert_allclose(c["k"][:, :, :MM.S].float().numpy(),
                                   jk[li][:, :, :MM.S], atol=MM.LOGIT_TOL,
                                   rtol=0, err_msg=f"layer {li}")


def test_layouts_differ():
    """The grid layout moves the logits: its rows differ, and M-RoPE
    reads them through its sections."""
    cfg = get_smoke_config(ARCH)
    model = TM.init_params(cfg, seed=0, device="cpu")
    lg = {}
    for layout in LAYOUTS:
        pre, _, _ = _inputs(cfg, layout)
        lg[layout], _ = TM.prefill(model, pre, MM.CACHE)
    assert float((lg["text"] - lg["grid"]).abs().max()) > 1e-3


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_then_decode_matches_the_full_forward(runs, layout):
    """Within the port: the prefill's last logits and each decode
    step's against the full-sequence forward over the same inputs."""
    model = runs[2]
    pre, dec, _ = _inputs(model.cfg, layout)
    full = {"tokens": torch.cat([pre["tokens"]]
                                + [d["tokens"] for d in dec], dim=1),
            "patch_embeds": pre["patch_embeds"],
            "mrope_pos": torch.cat([pre["mrope_pos"]]
                                   + [d["mrope_pos"] for d in dec], dim=2)}
    want = MM.full_forward_logits(model, full)
    port = runs[3][layout][0]
    assert MM.within_arch_smoke_bound(torch.from_numpy(port["prefill"]),
                                      want[:, MM.S - 1])
    for i, lg in enumerate(port["decode"]):
        assert MM.within_arch_smoke_bound(torch.from_numpy(lg),
                                          want[:, MM.S + i]), i


def test_params_round_trip_exactly(runs):
    _, jp, model, _ = runs
    want = dict(_walk(jax.tree.map(np.asarray, jp), ""))
    got = dict(_walk(params_to_numpy(model), ""))
    assert set(got) == set(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(leaf, np.float32),
                                      err_msg=key)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_make_batch_is_the_jax_packages(mode):
    cfg = get_smoke_config(ARCH)
    shape = ShapeConfig("t", 40, 2, mode)
    want = JI.make_batch(jax_smoke(ARCH), shape, seed=7)
    got = make_batch(cfg, mode, 2, 40, seed=7)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)


def test_missing_or_short_inputs_raise():
    cfg = get_smoke_config(ARCH)
    model = TM.init_params(cfg, seed=0, device="cpu")
    pre, _, _ = _inputs(cfg, "text")
    with pytest.raises(ValueError, match="mrope_pos"):
        TM.prefill(model, {"tokens": pre["tokens"]}, MM.CACHE)
    short = {"tokens": pre["tokens"][:, :8],
             "patch_embeds": pre["patch_embeds"],
             "mrope_pos": pre["mrope_pos"][..., :8]}
    with pytest.raises(ValueError, match="patch_embeds"):
        TM.prefill(model, short, MM.CACHE)
    with pytest.raises(ValueError,
                       match=r"mrope_pos \(2, 2, 24\) != \(3, 2, 24\)"):
        TM.prefill(model, dict(pre, mrope_pos=pre["mrope_pos"][:2]),
                   MM.CACHE)


def test_engine_and_launchers_refuse_the_family():
    cfg = get_smoke_config(ARCH)
    model = TM.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="prefill only tokens"):
        InferenceEngine(cfg, model)
    argv = ["--device", "cpu", "--smoke", "--arch", ARCH]
    with pytest.raises(NotImplementedError, match="'vlm' family"):
        SV.main(argv)
    with pytest.raises(NotImplementedError, match="'vlm' family"):
        SP.main(argv)
    with pytest.raises(NotImplementedError,
                       match="feeds only PackedLMDataset"):
        TR.main(argv)
