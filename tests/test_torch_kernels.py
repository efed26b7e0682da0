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
from repro_torch.launch.decode_bench import shuffled_pools

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
    ("selective_scan", None),               # ported: runs on the CPU
    ("mlstm_scan", None),                   # ported: runs on the CPU
])
def test_unported_ops_raise_naming_their_queue_item(op, args):
    if op == "selective_scan":
        g = torch.Generator().manual_seed(0)
        dt = torch.rand(1, 5, 16, generator=g) * 0.1
        y, h = KB.selective_scan(dt, torch.randn(1, 5, 16, generator=g),
                                 torch.randn(1, 5, 8, generator=g),
                                 torch.randn(1, 5, 8, generator=g),
                                 -torch.rand(16, 8, generator=g), None)
        assert tuple(y.shape) == (1, 5, 16) and tuple(h.shape) == (1, 16, 8)
        assert y.dtype == h.dtype == torch.float32
        assert bool(torch.isfinite(y).all())
        return
    if op == "mlstm_scan":
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(1, 2, 5, 32, generator=g) for _ in range(3))
        h, (C, n, m) = KB.mlstm_scan(q, k, v,
                                     torch.randn(1, 2, 5, generator=g),
                                     torch.randn(1, 2, 5, generator=g) + 3,
                                     None)
        assert tuple(h.shape) == (1, 2, 5, 32)
        assert tuple(C.shape) == (1, 2, 32, 32) and tuple(m.shape) == (1, 2)
        assert h.dtype == C.dtype == n.dtype == torch.float32
        assert bool(torch.isfinite(h).all())
        return
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
    KB.selective_scan(torch.rand(1, 3, 8), torch.randn(1, 3, 8),
                      torch.randn(1, 3, 8), torch.randn(1, 3, 8),
                      -torch.rand(8, 8), None)
    KB.mlstm_scan(torch.randn(1, 1, 3, 32), torch.randn(1, 1, 3, 32),
                  torch.randn(1, 1, 3, 32), torch.randn(1, 1, 3),
                  torch.randn(1, 1, 3), None)
    qg = q.clone().requires_grad_(True)
    KB.attention(qg, k, v).sum().backward()      # the backward's plain version
    assert KB.launch_counts() == {
        "flash_prefill": 0, "flash_decode": 0, "flash_decode_paged": 0,
        "flash_verify": 0, "flash_verify_paged": 0, "moe_router_topk": 0,
        "ssm_scan": 0, "mlstm_scan": 0, "flash_prefill_bwd": 0}


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


# (G, W, hd): --draft-k 4 at G = 2, 3; and more than 64 rows per (kv
# head, slot): kimi-k2's G = 8 at --draft-k 8 (72 rows), the planner's
# G = 3 at --draft-k 21 (66 rows), at a narrow head dim
OVER_64_ROWS = [pytest.param(8, 9, 32, id="8-9-32"),
                pytest.param(3, 22, 32, id="3-22-32")]
VERIFY_SHAPES = [pytest.param(2, 5, 64, id="2"),
                 pytest.param(3, 5, 64, id="3"), *OVER_64_ROWS]


@pytest.mark.parametrize("G,W,hd", VERIFY_SHAPES)
def test_verify_matches_oracle(G, W, hd):
    """Fused oracle and the CPU path's row-wise version vs the JAX
    oracle; every row has keys (kv_len >= W, as in the engine)."""
    q, k, v = _inputs(10 + G, 3, 2 * G, 2, W, 64, hd)
    kvl = np.array([max(7, W), 40, 64], np.int32)
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
    _paged_verify_case(2, 4, 64)


@pytest.mark.parametrize("G,W,hd", OVER_64_ROWS)
def test_paged_verify_matches_oracle_and_dense_view_over_64_rows(G, W, hd):
    _paged_verify_case(G, W, hd)


def _paged_verify_case(G, W, hd):
    """Paged verify (fused oracle and the CPU path) vs the JAX oracle,
    and bitwise dense verify on the gathered view."""
    kp, vp = _pool(13, hd=hd)
    q = np.random.default_rng(14).standard_normal((3, 2 * G, W, hd),
                                                  dtype=np.float32)
    kvl = np.array([37, max(19, W), 64], np.int32)
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


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_identity_pool_is_the_cache(hd):
    """ref.identity_pool (the card checks' identity-table oracle):
    the pool gathered through its table is the cache, and the paged
    decode and verify paths over it are the dense ones, bitwise."""
    rng = np.random.default_rng(hd)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    kc, vc, q, qv = mk(3, 2, 64, hd), mk(3, 2, 64, hd), mk(3, 6, hd), \
        mk(3, 6, 5, hd)
    (kp, tab), (vp, _) = TR.identity_pool(kc, 16), TR.identity_pool(vc, 16)
    assert kp.shape == (12, 2, 16, hd) and tab.dtype == torch.int32
    assert torch.equal(TR.paged_gather_kv(kp, tab), kc)
    kvl = torch.tensor([0, 37, 64])
    assert torch.equal(flash_decode_paged(q, kp, vp, tab, kvl),
                       flash_decode(q, kc, vc, kvl))
    assert torch.equal(flash_verify_paged(qv, kp, vp, tab, kvl),
                       flash_verify(qv, kc, vc, kvl))


# block sizes the paged kernels take: one row, 12 (no multiple of 8: the
# card's paged source copies K with the block's threads there), the
# engine's 16, 24 (a multiple of 8 that does not divide a 128-key tile)
# and 256 (past a tile)
PAGED_BS = [1, 12, 16, 24, 256]


def _shuffled(rng, kv_len, bs, Hkv, hd, S):
    """Seeded (B, Hkv, S, hd) K/V caches and their slots' rows as pools of
    ``bs``-row blocks through a shuffled table with sentinel tails
    (``decode_bench.shuffled_pools``, which the card's checks use too)."""
    mk = lambda: torch.from_numpy(rng.standard_normal(
        (len(kv_len), Hkv, S, hd), dtype=np.float32))
    return shuffled_pools(mk(), mk(), kv_len, bs)


@pytest.mark.parametrize("W", [0, 5])
@pytest.mark.parametrize("bs", PAGED_BS)
def test_paged_decode_family_at_block_sizes(bs, W):
    """Paged decode (W = 0) and verify over a shuffled table with
    sentinel tails equal dense decode and verify on the gathered view,
    bitwise, and the JAX oracle, at every block size of PAGED_BS."""
    rng = np.random.default_rng(100 + bs + W)
    kvl = torch.tensor([5, 300, 257, 40])
    kp, vp, tab = _shuffled(rng, kvl.tolist(), bs, 2, 32, 300)
    qs = (4, 6, W, 32) if W else (4, 6, 32)
    q = torch.from_numpy(rng.standard_normal(qs, dtype=np.float32))
    kg, vg = TR.paged_gather_kv(kp, tab), TR.paged_gather_kv(vp, tab)
    if W:
        got = flash_verify_paged(q, kp, vp, tab, kvl)
        dense = flash_verify(q, kg, vg, kvl)
        want = JR.paged_verify_attention_ref(
            *map(jnp.asarray, (q.numpy(), kp.numpy(), vp.numpy(),
                               tab.numpy(), kvl.numpy())))
    else:
        got = flash_decode_paged(q, kp, vp, tab, kvl)
        dense = flash_decode(q, kg, vg, kvl)
        want = JR.paged_decode_attention_ref(
            *map(jnp.asarray, (q.numpy(), kp.numpy(), vp.numpy(),
                               tab.numpy(), kvl.numpy())))
    assert torch.equal(got, dense)
    _close(got, want)


def test_decode_bench_refuses_without_a_card(capsys):
    """The timing script measures the card only: without one it exits
    non-zero and prints no result."""
    from repro_torch.launch import decode_bench
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert decode_bench.main([]) == 1
    assert capsys.readouterr().out == ""


# ------------------------------------------------- on the card only ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("hd", [64, 128, 32])
@pytest.mark.parametrize("Sq,Sk,q_offset,cap,window", [
    (37, 37, 0, 0.0, 0), (16, 2048, 700, 0.0, 0), (130, 300, 170, 0.0, 0),
    (100, 100, 0, 20.0, 0), (100, 200, 90, 0.0, 33)])
def test_flash_prefill_kernel_on_card(Sq, Sk, q_offset, cap, window, hd):
    dev = _card()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _inputs(Sq, 1, 12, 4, Sq, Sk, hd))
    before = flash_prefill.launches
    out = flash_prefill(q, k, v, causal=True, q_offset=q_offset, cap=cap,
                        window=window)
    ref = TR.attention_ref(q, k, v, causal=True, q_offset=q_offset,
                           cap=cap, window=window)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("hd", [64, 128, 32])
@pytest.mark.parametrize("cap,window", [(0.0, 0), (30.0, 0), (0.0, 100)])
def test_flash_prefill_extend_rows_are_prefill_rows_on_card(hd, cap, window):
    """The kernel's row contract: a row has the same bits in one 300-row
    prefill and in extends that hold it (any q_offset, any Sq, any place
    in its 64-row tile) against a 512-row cache whose rows past the
    extend are stale."""
    dev = _card()
    rng = np.random.default_rng(hd)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)).to(dev, torch.bfloat16)
    q, kc, vc = mk(1, 12, 300, hd), mk(1, 4, 512, hd), mk(1, 4, 512, hd)
    kw = dict(causal=True, cap=cap, window=window)
    full = flash_prefill(q, kc[:, :, :300].contiguous(),
                         vc[:, :, :300].contiguous(), **kw)
    for off, sq in ((1, 100), (63, 1), (64, 64), (200, 100), (292, 8)):
        kx, vx = kc.clone(), vc.clone()
        kx[:, :, off + sq:] = mk(1, 4, 512 - off - sq, hd)
        vx[:, :, off + sq:] = mk(1, 4, 512 - off - sq, hd)
        ext = flash_prefill(q[:, :, off:off + sq].contiguous(), kx, vx,
                            q_offset=off, **kw)
        assert torch.equal(ext, full[:, :, off:off + sq]), (off, sq)
    torch.cuda.synchronize()


# the dense decode kernels against their paged twins (one routine,
# decode_warp.cuh, with a dense and a paged source): every group size the
# served configs have, verify windows of --draft-k 0, 4, 8 and 21, every
# head dim the kernels are built for, block sizes 8, 12 (K copied by the
# block's threads), the engine's 16, 24 (not dividing a tile) and 256
CARD_G, CARD_W, CARD_HD = [3, 5, 7, 8], [1, 5, 9, 22], [32, 64, 128]
CARD_BS = [8, 12, 16, 24, 256]


@pytest.mark.parametrize("hd", CARD_HD)
@pytest.mark.parametrize("G", CARD_G)
def test_flash_decode_kernel_on_card(G, hd):
    dev = _card()
    q, kp, vp, tab, kvl = _card_paged(dev, [0, 1, 300, 512], G=G, hd=hd)
    kc, vc = TR.paged_gather_kv(kp, tab), TR.paged_gather_kv(vp, tab)
    out = flash_decode(q, kc, vc, kvl)
    ref = TR.decode_attention_ref(q, kc, vc, kvl)
    torch.cuda.synchronize()
    assert float(out[0].float().abs().max()) == 0.0      # kv_len 0 -> 0
    torch.testing.assert_close(out[1:].float(), ref[1:].float(), atol=1e-2,
                               rtol=1e-2)
    assert torch.equal(out, flash_decode_paged(q, kp, vp, tab, kvl))


def _card_paged(dev, kv_len, W=None, G=3, hd=64, bs=16):
    """Heads 4G/4 of hd over a shuffled pool of bs-row blocks with
    sentinel tails, 512 rows a slot."""
    rng = np.random.default_rng(len(kv_len) + 10 * G + hd + bs)
    B = len(kv_len)
    shape = (B, 4 * G, hd) if W is None else (B, 4 * G, W, hd)
    q = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    kp, vp, tab = _shuffled(rng, kv_len, bs, 4, hd, 512)
    to = lambda t: t.to(dev, torch.bfloat16)
    return (to(q), to(kp), to(vp), tab.to(dev),
            torch.tensor(kv_len, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("bs", CARD_BS)
def test_flash_decode_paged_kernel_on_card(bs):
    dev = _card()
    q, kp, vp, tab, kvl = _card_paged(dev, [1, 512, 300, 17], bs=bs)
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


@pytest.mark.parametrize("bs", CARD_BS)
@pytest.mark.parametrize("hd", CARD_HD)
@pytest.mark.parametrize("W", CARD_W)
@pytest.mark.parametrize("G", CARD_G)
def test_flash_verify_kernels_on_card(G, W, hd, bs):
    dev = _card()
    q, kp, vp, tab, kvl = _card_paged(dev, [5, 512, 300, 17], W=W, G=G,
                                      hd=hd, bs=bs)
    kc, vc = TR.paged_gather_kv(kp, tab), TR.paged_gather_kv(vp, tab)
    out = flash_verify(q, kc, vc, kvl)
    # rows with keys against the oracle; a row before the slot's first
    # key (W > kv_len) has none and writes 0, as decode at kv_len 0 does
    lim = kvl[:, None] - W + torch.arange(W, device=dev)[None, :] + 1
    live = (lim > 0)[:, None, :, None].expand_as(out)
    torch.testing.assert_close(
        out.float()[live],
        TR.verify_attention_ref(q, kc, vc, kvl).float()[live],
        atol=1e-2, rtol=1e-2)
    assert bool((out.float()[~live] == 0).all())
    for w in range(W):
        row = flash_decode(q[:, :, w].contiguous(), kc, vc, kvl - W + w + 1)
        assert torch.equal(out[:, :, w], row), w
    assert torch.equal(flash_verify_paged(q, kp, vp, tab, kvl), out)
    torch.cuda.synchronize()
