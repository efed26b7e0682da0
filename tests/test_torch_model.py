"""The port's layers, blocks and model vs the JAX package's reference
backend, on the same weights (JAX ``init_params`` through the weight
bridge) and the same numpy inputs, at the planner's SMOKE config.

Tolerances, with their reasons:
  * logits (fp32 head over bf16 activations): |diff| <= 0.05. Both
    frameworks round every bf16 matmul and elementwise op, but not at
    the same places; over two layers this moves logits of magnitude ~1
    by ~1e-2;
  * cache leaves (bf16 K/V of magnitude ~1-4): |diff| <= 2**-5 + 2**-6
    |x|. Layer 0's leaves differ by one bf16 rounding step; deeper
    layers project a residual stream that already carries the other
    framework's roundings, which moves small entries by a few steps of
    the leaf's O(1) scale, not of their own;
  * single ops in fp32 (rmsnorm, rope): 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.training.checkpoint import save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models.convert import load_jax_checkpoint, \
    params_from_numpy

LOGIT_TOL = 0.05
LEAF_ATOL, LEAF_RTOL = 2.0 ** -5, 2.0 ** -6
CACHE_LEN = 96


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke("planner-proxy-100m")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jp),
                              get_smoke_config("planner-proxy-100m"), "cpu")
    return jcfg, jp, model


def _logits_close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=LOGIT_TOL, rtol=0)


def _caches_close(tcache, jcache, rows):
    """Every K/V leaf of every layer, over the first ``rows`` rows."""
    jk = [np.asarray(jcache["segments"][0][0][n], np.float32)
          for n in ("k", "v")]
    for li, layer in enumerate(tcache["layers"]):
        for n, j in zip(("k", "v"), jk):
            t = layer[n][:, :, :rows].float().numpy()
            jl = j[li][:, :, :rows]
            np.testing.assert_allclose(t, jl, atol=LEAF_ATOL,
                                       rtol=LEAF_RTOL, err_msg=f"{li}/{n}")


def test_rmsnorm_uses_one_plus_scale():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16), dtype=np.float32)
    s = rng.standard_normal(16, dtype=np.float32) * 0.1
    got = L.rmsnorm(torch.from_numpy(s), torch.from_numpy(x))
    want = JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_apply_rope_matches(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 7, 64), dtype=np.float32)
    pos = np.arange(7)[None, None] + np.array([0, 40])[:, None, None]
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    got = L.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    want = JL.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    assert got.dtype == tx.dtype
    # bf16: one rounding of an fp32 result that agrees to ~1e-6
    tol = 1e-5 if dtype == np.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_prefill_logits_and_cache(pair):
    jcfg, jp, model = pair
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 37))
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                        cache_len=CACHE_LEN)
    tl, tc = TM.prefill(model, {"tokens": toks}, CACHE_LEN)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 8192)
    assert tc["pos"] == int(jc["pos"]) == 37
    _logits_close(tl, jl)
    _caches_close(tc, jc, CACHE_LEN)


def test_extend_logits_and_cache(pair):
    jcfg, jp, model = pair
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (1, 30))
    ext = rng.integers(0, jcfg.vocab_size, (1, 16))
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                       cache_len=CACHE_LEN)
    _, tc = TM.prefill(model, {"tokens": toks}, CACHE_LEN)
    # bucket-padded: 11 valid tokens of 16
    jl, jc = JM.prefill_extend(jp, jcfg, jc,
                               {"tokens": jnp.asarray(ext, jnp.int32)},
                               n_valid=11)
    tl, tc = TM.prefill_extend(model, tc, {"tokens": ext}, n_valid=11)
    assert tc["pos"] == int(jc["pos"]) == 41
    _logits_close(tl, jl)
    _caches_close(tc, jc, CACHE_LEN)


def test_decode_per_slot_positions(pair):
    """Continuous-batching decode: a (B,) pos, slots at other fill
    levels, one of them at the cache end (write clamps to Sc-1)."""
    jcfg, jp, model = pair
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (3, 24))
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                       cache_len=CACHE_LEN)
    _, tc = TM.prefill(model, {"tokens": toks}, CACHE_LEN)
    pos = np.array([24, 10, CACHE_LEN + 3], np.int32)
    jc["pos"] = jnp.asarray(pos)
    tc["pos"] = torch.from_numpy(pos)
    for step in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (3, 1))
        jl, jc = JM.decode_step(jp, jcfg, jc,
                                {"tokens": jnp.asarray(nxt, jnp.int32)})
        tl, tc = TM.decode_step(model, tc, {"tokens": nxt})
        _logits_close(tl, jl)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
    _caches_close(tc, jc, CACHE_LEN)


def test_decode_scalar_pos(pair):
    jcfg, jp, model = pair
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 12))
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                        cache_len=CACHE_LEN)
    tl, tc = TM.prefill(model, {"tokens": toks}, CACHE_LEN)
    nxt = np.array([[7], [9]])
    jl, jc = JM.decode_step(jp, jcfg, jc,
                            {"tokens": jnp.asarray(nxt, jnp.int32)})
    tl, tc = TM.decode_step(model, tc, {"tokens": nxt})
    assert tc["pos"] == int(jc["pos"]) == 13
    _logits_close(tl, jl)
    _caches_close(tc, jc, 13)


def test_bridge_copies_every_leaf_exactly(pair):
    jcfg, jp, model = pair
    tree = jax.tree.map(np.asarray, jp)
    np.testing.assert_array_equal(model.embed.float().numpy(),
                                  tree["embed"].astype(np.float32))
    wq = tree["segments"][0][0]["attn"]["wq"]
    for li in range(jcfg.n_layers):
        np.testing.assert_array_equal(
            model.layers[li].attn.wq.float().numpy(),
            wq[li].astype(np.float32))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    assert TM.count_params(model) == n_jax


def test_checkpoint_round_trip(pair, tmp_path):
    """A JAX-package npz checkpoint loads with numpy alone into the same
    weights the live-tree bridge gives."""
    jcfg, jp, model = pair
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, jp)
    tree = load_jax_checkpoint(path)
    assert isinstance(tree["segments"], list)
    loaded = params_from_numpy(tree, get_smoke_config("planner-proxy-100m"),
                               "cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              loaded.named_parameters()):
        assert torch.equal(a, b), n


def test_bridge_refuses_wrong_shapes(pair):
    jcfg, jp, _ = pair
    tree = jax.tree.map(np.asarray, jp)
    tree["embed"] = tree["embed"][:, :8]
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(tree, get_smoke_config("planner-proxy-100m"),
                          "cpu")


def test_init_params_is_seeded_with_jax_shapes():
    cfg = get_smoke_config("planner-proxy-100m")
    a = TM.init_params(cfg, seed=3, device="cpu")
    b = TM.init_params(cfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    assert float(a.layers[0].norm1.scale.abs().max()) == 0.0
    std = float(a.layers[0].attn.wq.float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    jshapes = JM.param_shapes(jax_smoke("planner-proxy-100m"))
    assert TM.count_params(a) == sum(int(np.prod(s.shape))
                                     for s in jax.tree.leaves(jshapes))


def test_no_card_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.resolve_device()


@pytest.mark.parametrize("mode", ["train", "verify"])
def test_unported_modes_raise(pair, mode):
    """Both are ported: verify (a 2-row window against a dense B=1
    cache) and train (differentiable over a ``"full"`` layer); train
    over another kind raises naming its queue item."""
    _, _, model = pair
    from repro_torch.models.blocks import block_apply, block_cache_init
    x = torch.zeros(1, 2, 256, dtype=torch.bfloat16)
    positions = torch.tensor([[5, 6]])
    if mode == "verify":
        cache = block_cache_init(model.cfg, 1, 16, "cpu")
        y, cache = block_apply(model.layers[0], x, model.cfg, mode=mode,
                               cache=cache, pos=torch.tensor([5]),
                               positions=positions)
        assert y.shape == x.shape and bool(torch.isfinite(y.float()).all())
        return
    y, _ = block_apply(model.layers[0], x.requires_grad_(True), model.cfg,
                       mode=mode, cache=None, pos=0, positions=positions)
    assert y.shape == x.shape and y.requires_grad
    xl = TM.init_params(get_smoke_config("xlstm-125m"), seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        block_apply(xl.layers[0], x, xl.cfg, mode=mode, cache=None,
                    pos=0, positions=positions)
