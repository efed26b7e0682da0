"""The port's MoE router and MoE FFN vs the JAX package's reference, on
the same numpy inputs and weights, on the CPU; and the head-dim and
router limits of the kernel wrappers.

Tolerances, with their reasons:
  * router weights (fp32 softmax and renormalisation, ~10 ops a value):
    |diff| <= 1e-6; ids exactly equal (both order ties to the lowest id);
  * MoE FFN output (bf16 expert products with fp32 sums, rounded to bf16
    at the same places but not in the same order in the two frameworks):
    |diff| <= 2**-5 + 2**-6 |y|. y is a sum of bf16 terms of magnitude up
    to ~4 (the routed experts' combine, the dense residual or shared
    expert), each rounded once on each side, so a small y can carry one
    or two bf16 steps of its terms' scale (2**-6 each at [2, 4));
  * load-balance loss (fp32 means of the same probabilities): 1e-6
    relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.common import perf as jperf
from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.ref import router_topk_ref as jax_router_ref
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.common import perf
from repro_torch.common.config import MoEConfig
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import backend as KB
from repro_torch.kernels import ref as TR
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_decode_paged import flash_decode_paged
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.flash_verify import flash_verify, \
    flash_verify_paged
from repro_torch.kernels.moe_router import moe_router_topk
from repro_torch.models import moe as M
from repro_torch.models.convert import params_from_numpy

W_TOL = 1e-6
Y_ATOL, Y_RTOL = 2.0 ** -5, 2.0 ** -6
ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")


def _logits(seed, T, E):
    """randn * 3, as the JAX package's kernel sweep draws them."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((T, E), dtype=np.float32) * 3.0


# ---------------------------------------------------------------- router ----

@pytest.mark.parametrize("T,E,k", [(512, 64, 2), (256, 128, 8),
                                   (256, 16, 1), (1024, 384, 8)])
def test_router_topk_ref_matches_jax(T, E, k):
    x = _logits(T + E + k, T, E)
    w, idx, probs = TR.router_topk_ref(torch.from_numpy(x), k)
    jw, jidx, jprobs = jax_router_ref(jnp.asarray(x), k)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (T, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=W_TOL,
                               rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                               atol=W_TOL, rtol=0)


def test_router_ties_go_to_the_lowest_id():
    x = np.zeros((3, 8), np.float32)
    x[1, [2, 5, 6]] = 1.0                  # a three-way tie at the top
    x[2, ::-1] = np.arange(8)              # a strict order, reversed
    w, idx, _ = TR.router_topk_ref(torch.from_numpy(x), 3)
    jw, jidx, _ = jax_router_ref(jnp.asarray(x), 3)
    assert idx.tolist() == [[0, 1, 2], [2, 5, 6], [0, 1, 2]]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=W_TOL)
    # the op surface's CPU path is the same plain version
    kw, kidx = KB.router_topk(torch.from_numpy(x), 3)
    assert torch.equal(kidx, idx) and torch.equal(kw, w)


def test_router_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        moe_router_topk(torch.zeros(4, 64, device="meta"), 2)


# -------------------------------------------------------------- capacity ----

@pytest.mark.parametrize("E,k", [(4, 2), (128, 2), (384, 8), (16, 1)])
@pytest.mark.parametrize("S", [1, 5, 37, 1024])
@pytest.mark.parametrize("factor,override", [(1.25, 0.0), (0.5, 0.0),
                                             (1.25, 100.0)])
def test_capacity_matches_jax(E, k, S, factor, override):
    mcfg = MoEConfig(n_experts=E, top_k=k, d_expert=8,
                     capacity_factor=factor)
    jmcfg = jax_smoke("arctic-480b").moe.__class__(
        n_experts=E, top_k=k, d_expert=8, capacity_factor=factor)
    jold, old = jperf.get_flags(), perf.get_flags()
    try:
        jperf.set_flags(dataclasses.replace(jold,
                                            moe_capacity_factor=override))
        perf.set_flags(dataclasses.replace(old, moe_capacity_factor=override))
        assert M.capacity(mcfg, S) == JMoE.capacity(jmcfg, S)
    finally:
        jperf.set_flags(jold)
        perf.set_flags(old)


# --------------------------------------------------------------- MoE FFN ----

def _layer(arch):
    """The first MoE layer of the smoke model: JAX params (numpy) and the
    port's ``MoE`` module holding the same weights."""
    jcfg = jax_smoke(arch)
    cfg = get_smoke_config(arch)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(3),
                                                 jcfg))
    li = cfg.layer_kinds().index("moe")
    si = 0 if li == 0 else 1                     # kimi: dense, then moe
    model = params_from_numpy(jp, cfg, "cpu")
    jmoe = jax.tree.map(lambda a: a[0], jp["segments"][si][0]["moe"])
    return jcfg, cfg, jmoe, model.layers[li].moe


@pytest.fixture
def dispatch_flag():
    """Set the JAX package's ``moe_dispatch`` flag; restored after."""
    old = jperf.get_flags()

    def put(mode):
        jperf.set_flags(dataclasses.replace(old, moe_dispatch=mode))
    yield put
    jperf.set_flags(old)


def _drops(idx, mcfg, C):
    """Choices past capacity per batch row, by the (s, j) running count."""
    B = idx.shape[0]
    flat = idx.reshape(B, -1)
    n = 0
    for b in range(B):
        seen = {}
        for e in flat[b].tolist():
            seen[e] = seen.get(e, 0) + 1
            n += seen[e] > C
    return n


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["einsum", "gather"])
@pytest.mark.parametrize("S,factor,n_pad", [(24, 0.5, 0), (13, 1.25, 3),
                                            (37, 0.75, 3)])
def test_moe_ffn_matches_jax(arch, mode, S, factor, n_pad, dispatch_flag):
    """Both JAX dispatch modes, at sizes where choices are dropped
    (factors below 1: fewer slots than choices, 80 choices for 4 experts
    of capacity 16 at S+pad = 40) and with bucket-padded inputs (n_pad
    copies of one pad row at the end, which take capacity like any
    row)."""
    dispatch_flag(mode)
    jcfg, cfg, jmoe, moe = _layer(arch)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=factor))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                              capacity_factor=factor))
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S + n_pad, cfg.d_model), dtype=np.float32)
    if n_pad:
        x[:, S:] = x[:, S - 1:S]
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x, jnp.bfloat16)
    y, aux = M.moe_ffn(moe, tx, cfg, with_aux=True)
    jy, jaux = JMoE.moe_ffn(jmoe, jx, jcfg)
    w, idx, _ = M.router_topk(moe, tx, cfg.moe)
    _, jidx, _ = JMoE.router_topk(jmoe["router"], jx, jcfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if factor < 1:
        C = M.capacity(cfg.moe, S + n_pad)
        assert _drops(idx.numpy(), cfg.moe, C) > 0
    assert y.dtype == torch.bfloat16 and y.shape == tx.shape
    jyf = np.asarray(jy, np.float32)
    np.testing.assert_allclose(y.float().numpy(), jyf, atol=Y_ATOL,
                               rtol=Y_RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_moe_ffn_without_aux_skips_the_loss():
    _, cfg, _, moe = _layer("arctic-480b")
    x = torch.randn(1, 5, cfg.d_model).to(torch.bfloat16)
    y, aux = M.moe_ffn(moe, x, cfg)
    assert aux is None and y.shape == x.shape


def test_decode_row_never_drops():
    """A decode row is a group of one token: capacity 8 >= k (k <= 8)."""
    for E, k in ((128, 2), (384, 8), (4, 2)):
        assert M.capacity(MoEConfig(n_experts=E, top_k=k, d_expert=8), 1) \
            >= k


def test_router_logits_are_full_fp32():
    _, cfg, _, moe = _layer("kimi-k2-1t-a32b")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.randn(1, 3, cfg.d_model).to(torch.bfloat16)
        _, _, logits = M.router_topk(moe, x, cfg.moe)
        assert logits.dtype == torch.float32
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# ------------------------------------------- head dims of the kernels ----

def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _checks(hd, G=2, W=5):
    """Each attention kernel's launch checks, on CPU tensors (the checks
    a CUDA tensor meets before its launch, with q's device standing in for
    the card's)."""
    from repro_torch.kernels.flash_decode import check_cache
    from repro_torch.kernels.flash_decode_paged import check_pages
    from repro_torch.kernels.flash_prefill import check_shapes
    tab = torch.zeros(1, 4, dtype=torch.int32)
    return {
        "flash_prefill": lambda: check_shapes(
            _bf(1, 2 * G, 8, hd), _bf(1, 2, 8, hd), _bf(1, 2, 8, hd)),
        "flash_decode": lambda: check_cache(
            "flash_decode", _bf(1, 2 * G, hd), _bf(1, 2, 8, hd),
            _bf(1, 2, 8, hd)),
        "flash_decode_paged": lambda: check_pages(
            "flash_decode_paged", _bf(1, 2 * G, hd), _bf(4, 2, 16, hd),
            _bf(4, 2, 16, hd), tab, G),
        "flash_verify": lambda: check_cache(
            "flash_verify", _bf(1, 2 * G, W, hd), _bf(1, 2, 8, hd),
            _bf(1, 2, 8, hd), W),
        "flash_verify_paged": lambda: check_pages(
            "flash_verify_paged", _bf(1, 2 * G, W, hd), _bf(4, 2, 16, hd),
            _bf(4, 2, 16, hd), tab, G * W)}


@pytest.mark.parametrize("hd", [16, 96, 256])
def test_attention_wrappers_raise_on_other_head_dims(hd):
    for name, check in _checks(hd).items():
        with pytest.raises(ValueError, match=r"head dim in \(32, 64, 128\)"):
            check()


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("G", [7, 8])
def test_attention_wrappers_take_the_moe_head_dims(hd, G):
    """arctic's G = 7 (56/8) and kimi's G = 8 (64/8) at W = 5: 35 and 40
    rows a block, inside MAX_ROWS."""
    for check in _checks(hd, G=G).values():
        check()


# ------------------------------------------------- on the card only ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("T,E,k", [(8, 384, 8), (37, 128, 2),
                                   (1024, 384, 8)])
def test_router_kernel_on_card(T, E, k):
    dev = _card()
    logits = torch.from_numpy(_logits(T, T, E)).to(dev)
    before = moe_router_topk.launches
    w, idx = moe_router_topk(logits, k)
    rw, ridx, _ = TR.router_topk_ref(logits, k)
    torch.cuda.synchronize()
    assert moe_router_topk.launches == before + 1
    assert torch.equal(idx, ridx)
    assert float((w - rw).abs().max()) <= 1e-5


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("G", [7, 8])
def test_decode_family_bitwise_at_moe_head_dims_on_card(hd, G):
    """Verify rows == decode rows and paged == dense at the MoE families'
    head dims and group sizes."""
    dev = _card()
    rng = np.random.default_rng(hd + G)
    B, Hkv, W, Sk, bs = 3, 2, 5, 256, 16
    to = lambda *s: torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)).to(dev, torch.bfloat16)
    q, kc, vc = to(B, G * Hkv, W, hd), to(B, Hkv, Sk, hd), to(B, Hkv, Sk, hd)
    kvl = torch.tensor([5, 256, 77], dtype=torch.int32, device=dev)
    out = flash_verify(q, kc, vc, kvl)
    for w in range(W):
        row = flash_decode(q[:, :, w].contiguous(), kc, vc, kvl - W + w + 1)
        assert torch.equal(out[:, :, w], row), w
    torch.testing.assert_close(
        out.float(), TR.verify_attention_ref(q, kc, vc, kvl).float(),
        atol=1e-2, rtol=1e-2)
    # the same rows as a paged pool, blocks in reverse order
    nb = B * Sk // bs
    tab = torch.arange(nb - 1, -1, -1, dtype=torch.int32,
                       device=dev).view(B, Sk // bs)
    kp = torch.empty(nb, Hkv, bs, hd, dtype=torch.bfloat16, device=dev)
    vp = torch.empty_like(kp)
    for b in range(B):
        for j in range(Sk // bs):
            kp[tab[b, j]] = kc[b, :, j * bs:(j + 1) * bs]
            vp[tab[b, j]] = vc[b, :, j * bs:(j + 1) * bs]
    assert torch.equal(flash_verify_paged(q, kp, vp, tab, kvl), out)
    assert torch.equal(flash_decode_paged(q[:, :, 0].contiguous(), kp, vp,
                                          tab, kvl),
                       flash_decode(q[:, :, 0].contiguous(), kc, vc, kvl))


@pytest.mark.parametrize("hd", [32, 128])
def test_prefill_kernel_at_moe_head_dims_on_card(hd):
    dev = _card()
    rng = np.random.default_rng(hd)
    to = lambda *s: torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)).to(dev, torch.bfloat16)
    q, k, v = to(1, 14, 130, hd), to(1, 2, 300, hd), to(1, 2, 300, hd)
    out = flash_prefill(q, k, v, causal=True, q_offset=170)
    ref = TR.attention_ref(q, k, v, causal=True, q_offset=170)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    # a row at the same position gives the same bits in an extend
    tail = flash_prefill(q[:, :, 60:].contiguous(), k, v, causal=True,
                         q_offset=230)
    assert torch.equal(tail, out[:, :, 60:])


def test_row_block_bounds_the_padding_of_a_call():
    """Each product's fixed call size: a power of two in [128, 1024] with
    at most ROW_CALL_MACS multiply-adds unless it is 128."""
    from repro_torch.models import layers as L
    assert L.row_block(768, 2048) == 1024           # the planner: few calls
    assert L.row_block(7168, 1024) == 256
    assert L.row_block(7168, 8192) == 128
    for K, N in ((768, 256), (7168, 384), (7168, 2048), (64, 48)):
        rb = L.row_block(K, N)
        assert 128 <= rb <= 1024 and rb & (rb - 1) == 0
        assert rb == 128 or rb * K * N <= L.ROW_CALL_MACS
        assert rb == 1024 or 2 * rb * K * N > L.ROW_CALL_MACS


def test_fixed_row_blocks_give_each_row_the_same_result():
    """Prefill and extend run products in fixed-size calls: a row's
    result is the same whether it comes with 1,299 other rows or 19."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1300, 64), dtype=np.float32)
                         ).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((64, 48), dtype=np.float32)
                         ).to(torch.bfloat16)
    full = L.matmul_rows(x, w, fixed=True)                # 2 calls
    assert full.shape == (1300, 48)
    assert torch.equal(L.matmul_rows(x[1024 + 256:], w, fixed=True),
                       full[1280:])
    torch.testing.assert_close(full.float(), (x @ w).float(), atol=0.05,
                               rtol=0.01)
    # the MoE FFN with fixed calls: the rows of a group keep their bits
    _, cfg, _, moe = _layer("kimi-k2-1t-a32b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                              capacity_factor=100.0))
    xs = torch.from_numpy(rng.standard_normal((1, 150, cfg.d_model),
                                              dtype=np.float32)
                          ).to(torch.bfloat16)
    y, _ = M.moe_ffn(moe, xs, cfg, fixed=True)
    y_tail, _ = M.moe_ffn(moe, xs[:, 140:], cfg, fixed=True)
    assert torch.equal(y_tail, y[:, 140:])
