"""The port's attention ops vs the JAX package's oracles.

On the CPU the kernel wrappers run their plain PyTorch versions; these
tests hold those against ``repro.kernels.ref`` on the same numpy inputs,
in fp32 (the point is the algorithm, not bf16 rounding): |diff| <= 1e-5,
a few fp32 ulps of O(1) outputs summed in another order. Within the
port, the decode family's contracts are bitwise (``torch.equal``): a
verify row is the decode row at its position, paged is dense on the
gathered view, and sentinel table entries change nothing. The kernels
themselves are held against the plain versions on the card by
``chip_smoke.py`` and by the card-only tests at the end, which skip here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import backend as JKB
from repro.kernels import ref as JR
from repro_torch.kernels import backend as KB
from repro_torch.kernels import ref as TR
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_decode_paged import flash_decode_paged
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.flash_verify import flash_verify, \
    flash_verify_paged

ATOL = 1e-5


def _inputs(seed, B, Hq, Hkv, Sq, Sk, hd=64):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return mk(B, Hq, Sq, hd), mk(B, Hkv, Sk, hd), mk(B, Hkv, Sk, hd)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("Sq,Sk,q_offset", [
    (37, 37, 0),        # ragged prompt prefill
    (130, 130, 0),      # above one 64-row tile, not a multiple of it
    (16, 96, 70),       # chunked-prefill extend at an offset
    (5, 64, 59),        # extend ending exactly at the cache end
])
def test_attention_matches_oracle(G, Sq, Sk, q_offset):
    q, k, v = _inputs(G * 100 + Sq, 2, 2 * G, 2, Sq, Sk)
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, q_offset=q_offset)
    want = JR.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("cap,window,causal", [(0.0, 0, False),
                                               (5.0, 0, True),
                                               (0.0, 24, True)])
def test_attention_variants_match_oracle(cap, window, causal):
    q, k, v = _inputs(3, 1, 6, 2, 48, 48)
    got = TR.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal,
                           window=window, cap=cap, scale=0.2)
    want = JR.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, cap=cap,
                            scale=0.2)
    _close(got, want)


@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("kv_len", [17, [96, 40, 1], np.int32(96)])
def test_decode_matches_oracle(G, kv_len):
    q, k, v = _inputs(G, 3, 2 * G, 2, 1, 96)
    kvl = np.asarray(kv_len, np.int32)
    got = flash_decode(torch.from_numpy(q[:, :, 0]), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(kvl))
    want = JR.decode_attention_ref(jnp.asarray(q[:, :, 0]), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(kvl))
    _close(got, want)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_decode_softcap_and_int_kv_len(cap):
    q, k, v = _inputs(9, 2, 4, 2, 1, 64)
    got = TR.decode_attention_ref(torch.from_numpy(q[:, :, 0]),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  33, cap=cap)
    want = JR.decode_attention_ref(jnp.asarray(q[:, :, 0]), jnp.asarray(k),
                                   jnp.asarray(v), 33, cap=cap)
    _close(got, want)


def test_prefill_and_extend_rows_agree():
    """The property the engine's chunk seams rest on: a row at absolute
    position p sees the same keys in prefill (Sk = S) and in extend
    against a longer cache (Sk = Sc, q_offset)."""
    q, k, v = _inputs(5, 1, 4, 2, 40, 40)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    full = TR.attention_ref(tq, tk, tv, causal=True)
    pad = lambda t: torch.cat([t, torch.randn(1, 2, 24, 64)], dim=2)
    ext = TR.attention_ref(tq[:, :, 25:], pad(tk), pad(tv), causal=True,
                           q_offset=25)
    np.testing.assert_allclose(ext.numpy(), full[:, :, 25:].numpy(),
                               atol=ATOL, rtol=0)


def test_op_surface_matches_jax_package():
    assert KB.OP_SURFACE == JKB.OP_SURFACE
    for op in KB.OPS:
        assert JKB.check_op_signature(op, getattr(KB, op)) is None, op


def _small_paged():
    """One slot, 4 q heads over 2 kv heads, a 3-block pool of 16 rows, a
    table with one sentinel entry, 20 valid rows."""
    q, _, _ = map(torch.from_numpy, _inputs(7, 1, 4, 2, 3, 1))
    pages = torch.from_numpy(_inputs(8, 3, 1, 2, 1, 16)[1])
    return q, pages, torch.tensor([[2, 0, 3]], dtype=torch.int32)


@pytest.mark.parametrize("op,args", [
    ("paged_decode_attention", None),       # ported: runs on the CPU
    ("verify_attention", None),             # ported
    ("paged_verify_attention", None),       # ported
    ("router_topk", (None, 2)),             # ported: runs on the CPU
    ("selective_scan", (None,) * 5),
    ("mlstm_scan", (None,) * 5),
])
def test_unported_ops_raise_naming_their_queue_item(op, args):
    if op == "router_topk":
        w, idx = KB.router_topk(torch.randn(6, 16) * 3, args[1])
        assert tuple(w.shape) == tuple(idx.shape) == (6, 2)
        assert idx.dtype == torch.int32
        torch.testing.assert_close(w.sum(-1), torch.ones(6))
        return
    if args is None:
        q, pages, tab = _small_paged()
        if op == "paged_decode_attention":
            out = KB.paged_decode_attention(q[:, :, 0], pages, pages, tab,
                                            torch.tensor([20]))
        elif op == "verify_attention":
            out = KB.verify_attention(q, pages[:1], pages[:1], 16)
        else:
            out = KB.paged_verify_attention(q, pages, pages, tab, 20)
        assert out.shape == (q[:, :, 0] if op.startswith("paged_d")
                             else q).shape
        assert bool(torch.isfinite(out).all())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue B"):
        getattr(KB, op)(*args)


def test_cpu_wrappers_do_not_count_launches():
    KB.reset_launches()
    q, k, v = map(torch.from_numpy, _inputs(1, 1, 4, 2, 8, 8))
    KB.attention(q, k, v)
    KB.decode_attention(q[:, :, 0], k, v, 8)
    qp, pages, tab = _small_paged()
    KB.paged_decode_attention(qp[:, :, 0], pages, pages, tab, 20)
    KB.verify_attention(q, k, v, 8)
    KB.paged_verify_attention(qp, pages, pages, tab, 20)
    KB.router_topk(torch.randn(4, 8), 2)
    assert KB.launch_counts() == {
        "flash_prefill": 0, "flash_decode": 0, "flash_decode_paged": 0,
        "flash_verify": 0, "flash_verify_paged": 0, "moe_router_topk": 0}


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 4, 8, 64, device="meta")
    tab = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_prefill(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_decode(q[:, :, 0], q[:, :2], q[:, :2], 8)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_decode_paged(q[:, :, 0], q[:, :2], q[:, :2], tab, 8)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_verify(q, q[:, :2], q[:, :2], 8)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_verify_paged(q, q[:, :2], q[:, :2], tab, 8)


# ------------------------------------------- paged and verify oracles ----

NB, BS, MB = 12, 16, 4


def _pool(seed, Hkv=2, hd=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((NB, Hkv, BS, hd), dtype=np.float32),
            rng.standard_normal((NB, Hkv, BS, hd), dtype=np.float32))


# shuffled ids with sentinel (== NB) and out-of-range (> NB) tails
TABS = np.array([[7, 2, 11, NB], [0, 5, NB, NB + 3], [9, 4, 1, 6]],
                np.int32)


def test_paged_gather_matches_oracle():
    kp, _ = _pool(0)
    got = TR.paged_gather_kv(torch.from_numpy(kp), torch.from_numpy(TABS))
    want = JR.paged_gather_kv(jnp.asarray(kp), jnp.asarray(TABS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_len,cap", [([40, 20, 64], 0.0),
                                        ([1, 32, 17], 30.0)])
def test_paged_decode_matches_oracle(kv_len, cap):
    kp, vp = _pool(1)
    q = np.random.default_rng(2).standard_normal((3, 6, 64),
                                                 dtype=np.float32)
    kvl = np.asarray(kv_len, np.int32)
    got = flash_decode_paged(*map(torch.from_numpy, (q, kp, vp, TABS, kvl)),
                             cap=cap)
    want = JR.paged_decode_attention_ref(
        *map(jnp.asarray, (q, kp, vp, TABS, kvl)), cap=cap)
    _close(got, want)


def test_sentinel_table_entries_are_harmless():
    """Entries past kv_len (sentinels or live blocks) change nothing."""
    kp, vp = map(torch.from_numpy, _pool(3))
    q = torch.from_numpy(_inputs(4, 1, 4, 2, 1, 1)[0][:, :, 0])
    kvl = torch.tensor([20])
    a = flash_decode_paged(q, kp, vp, torch.tensor([[2, 4, NB, NB]],
                                                   dtype=torch.int32), kvl)
    b = flash_decode_paged(q, kp, vp, torch.tensor([[2, 4, 0, 1]],
                                                   dtype=torch.int32), kvl)
    assert torch.equal(a, b)


def test_paged_decode_is_dense_decode_on_the_gathered_view():
    kp, vp = map(torch.from_numpy, _pool(5))
    tab = torch.from_numpy(TABS)
    q = torch.from_numpy(_inputs(6, 3, 6, 2, 1, 1)[0][:, :, 0])
    kvl = torch.tensor([40, 20, 64])
    dense = flash_decode(q, TR.paged_gather_kv(kp, tab),
                         TR.paged_gather_kv(vp, tab), kvl)
    assert torch.equal(flash_decode_paged(q, kp, vp, tab, kvl), dense)


@pytest.mark.parametrize("G", [2, 3])
def test_verify_matches_oracle(G):
    """Fused oracle and the CPU path's row-wise version vs the JAX
    oracle; every row has keys (kv_len >= W, as in the engine)."""
    W = 5
    q, k, v = _inputs(10 + G, 3, 2 * G, 2, W, 64)
    kvl = np.array([7, 40, 64], np.int32)
    want = JR.verify_attention_ref(*map(jnp.asarray, (q, k, v, kvl)))
    args = tuple(map(torch.from_numpy, (q, k, v, kvl)))
    _close(TR.verify_attention_ref(*args), want)
    _close(flash_verify(*args), want)


def test_verify_rows_are_decode_rows_bitwise():
    W = 4
    q, k, v = map(torch.from_numpy, _inputs(12, 2, 6, 2, W, 96))
    kvl = torch.tensor([9, 96])
    out = flash_verify(q, k, v, kvl)
    for w in range(W):
        row = flash_decode(q[:, :, w].contiguous(), k, v, kvl - W + w + 1)
        assert torch.equal(out[:, :, w], row), w


def test_paged_verify_matches_oracle_and_dense_view():
    W = 4
    kp, vp = _pool(13)
    q = np.random.default_rng(14).standard_normal((3, 4, W, 64),
                                                  dtype=np.float32)
    kvl = np.array([37, 19, 64], np.int32)
    args = tuple(map(torch.from_numpy, (q, kp, vp, TABS, kvl)))
    want = JR.paged_verify_attention_ref(
        *map(jnp.asarray, (q, kp, vp, TABS, kvl)))
    _close(TR.paged_verify_attention_ref(*args), want)
    got = flash_verify_paged(*args)
    _close(got, want)
    tab = args[3]
    dense = flash_verify(args[0], TR.paged_gather_kv(args[1], tab),
                         TR.paged_gather_kv(args[2], tab), args[4])
    assert torch.equal(got, dense)


# ------------------------------------------------- on the card only ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("Sq,Sk,q_offset,cap,window", [
    (37, 37, 0, 0.0, 0), (16, 2048, 700, 0.0, 0), (130, 300, 170, 0.0, 0),
    (100, 100, 0, 20.0, 0), (100, 200, 90, 0.0, 33)])
def test_flash_prefill_kernel_on_card(Sq, Sk, q_offset, cap, window):
    dev = _card()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _inputs(Sq, 1, 12, 4, Sq, Sk))
    before = flash_prefill.launches
    out = flash_prefill(q, k, v, causal=True, q_offset=q_offset, cap=cap,
                        window=window)
    ref = TR.attention_ref(q, k, v, causal=True, q_offset=q_offset,
                           cap=cap, window=window)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


def test_flash_decode_kernel_on_card():
    dev = _card()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _inputs(4, 4, 12, 4, 1, 512))
    kvl = torch.tensor([0, 1, 300, 512], dtype=torch.int32, device=dev)
    out = flash_decode(q[:, :, 0].contiguous(), k, v, kvl)
    ref = TR.decode_attention_ref(q[:, :, 0], k, v, kvl)
    torch.cuda.synchronize()
    assert float(out[0].float().abs().max()) == 0.0      # kv_len 0 -> 0
    torch.testing.assert_close(out[1:].float(), ref[1:].float(), atol=1e-2,
                               rtol=1e-2)


def _card_paged(dev, kv_len, W=None):
    """Full-width heads over a shuffled 64-block pool of 16 rows."""
    rng = np.random.default_rng(len(kv_len))
    B, nb, bs, mb = len(kv_len), 64, 16, 32
    shape = (B, 12, 64) if W is None else (B, 12, W, 64)
    q = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((nb, 4, bs, 64),
                                                   dtype=np.float32))
              for _ in range(2))
    tab = np.full((B, mb), nb, np.int32)
    perm = rng.permutation(nb)
    used = 0
    for b, n in enumerate(kv_len):
        need = -(-n // bs)
        tab[b, :need] = perm[used:used + need]
        used += need
    to = lambda t: t.to(dev, torch.bfloat16)
    return (to(q), to(kp), to(vp), torch.from_numpy(tab).to(dev),
            torch.tensor(kv_len, dtype=torch.int32, device=dev))


def test_flash_decode_paged_kernel_on_card():
    dev = _card()
    q, kp, vp, tab, kvl = _card_paged(dev, [1, 512, 300, 17])
    before = flash_decode_paged.launches
    out = flash_decode_paged(q, kp, vp, tab, kvl)
    ref = TR.paged_decode_attention_ref(q, kp, vp, tab, kvl)
    dense = flash_decode(q, TR.paged_gather_kv(kp, tab),
                         TR.paged_gather_kv(vp, tab), kvl)
    torch.cuda.synchronize()
    assert flash_decode_paged.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    assert torch.equal(out, dense)


def test_flash_verify_kernels_on_card():
    dev = _card()
    W = 5
    q, kp, vp, tab, kvl = _card_paged(dev, [5, 512, 300, 17], W=W)
    kc, vc = TR.paged_gather_kv(kp, tab), TR.paged_gather_kv(vp, tab)
    out = flash_verify(q, kc, vc, kvl)
    torch.testing.assert_close(
        out.float(), TR.verify_attention_ref(q, kc, vc, kvl).float(),
        atol=1e-2, rtol=1e-2)
    for w in range(W):
        row = flash_decode(q[:, :, w].contiguous(), kc, vc, kvl - W + w + 1)
        assert torch.equal(out[:, :, w], row), w
    assert torch.equal(flash_verify_paged(q, kp, vp, tab, kvl), out)
    torch.cuda.synchronize()
