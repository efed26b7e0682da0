"""The port's mLSTM scan and xLSTM blocks vs the JAX package's, on the CPU,
and the scan's within-port contract.

Tolerances, with their reasons:
  * scan oracle vs the JAX oracle (fp32 on both sides, the same
    sequential recurrence and step order; the reductions over d are
    einsums that each framework orders its own way): the state C, n, m
    within STATE_TOL = 1e-6 + 1e-6 |x| (read: 2.4e-7, a few ulps), the
    output h within H_RTOL (1 + |h|) with H_RTOL = 1e-4 (read: 1.3-4.9e-6
    at |h| up to 76): h divides by max(|n.q|, exp(-m)), a cancelled dot,
    so ulps of the numerator and of n.q are amplified by |n||q| / |n.q|,
    which seeded normal inputs take to ~10-100;
  * ``mlstm_block`` vs JAX ``mlstm_block`` on the reference backend: the
    JAX reference runs the chunkwise form (its numerator summed in
    another order) and both frameworks round the bf16 projections at
    other places; the bf16 output within Y_ATOL + Y_RTOL |y| = 2**-5 +
    2**-6 |y| (a bf16 step or two of the down-projection's output; read
    0.016 at |y| up to ~4), the fp32 state C and n within 2e-3 + 2e-3
    |x| (their inputs k and v are bf16 products, one bf16 step ~4e-3
    relative, mostly equal here; read 1e-6), m within 1e-5 (it sees
    only the fp32 gate product; read 4e-8);
  * ``slstm_block`` vs JAX ``slstm_block``: h within Y_ATOL + Y_RTOL |h|;
    m, the log-domain stabiliser, within M_TOL = 0.05 (the recurrent
    product ``R h`` is bf16, so each step's preactivations differ by a
    bf16 step, ~1e-2 at |pre| ~ 3, and m carries the largest of them);
    c and n within (e^M_TOL - 1) + 1e-2 relative, plus 1e-2: both are
    scaled by exp(-m), so a shift of m by up to M_TOL rescales them by
    up to e^M_TOL while h = o c / n does not move (read: m 0.010, c
    0.023 of 5.0, n 0.062 of 12.4, h 0.0014).

The JAX blocks run jitted (one compile per shape instead of one per op)
and the port's CPU ops on one thread: the recurrences are loops of small
ops, which a thread pool only slows.

Within the port the scan is bitwise: a scan split at any seam (the state
of the first part fed to the second) equals one scan, and S one-step
scans equal one S-step scan, on the CPU here and on the card in the
card-only tests at the end (which skip without one) and in
``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ref as JR
from repro.models import model as JM
from repro.models import xlstm as JX
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import backend as KB
from repro_torch.kernels import ref as TR
from repro_torch.kernels.mlstm_scan import HEAD_DIMS, mlstm_scan, \
    mlstm_scan_tile_states
from repro_torch.models import xlstm as X
from repro_torch.models.convert import params_from_numpy

STATE_ATOL = STATE_RTOL = 1e-6
H_RTOL = 1e-4
Y_ATOL, Y_RTOL = 2.0 ** -5, 2.0 ** -6
C_TOL = 2e-3
M_TOL = 0.05
SL_RTOL = math.exp(M_TOL) - 1 + 1e-2

j_mlstm_block = jax.jit(JX.mlstm_block, static_argnums=2,
                        static_argnames=("backend",))
j_slstm_block = jax.jit(JX.slstm_block, static_argnums=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(seed, B, H, S, hd, state=True):
    """q, k, v, i ~ N(0,1), f ~ N(3,1) (the forget-gate bias of +3), and
    a random state C, n, m ~ N(0,1) (or None)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    args = [mk(B, H, S, hd), mk(B, H, S, hd), mk(B, H, S, hd), mk(B, H, S),
            mk(B, H, S) + 3.0]
    st = (mk(B, H, hd, hd), mk(B, H, hd), mk(B, H)) if state else None
    return args, st


def _torch(args, st):
    return ([torch.from_numpy(a) for a in args],
            None if st is None else tuple(torch.from_numpy(a) for a in st))


@pytest.mark.parametrize("hd,S", [(32, 96), (192, 48)])
def test_scan_oracle_matches_jax_oracle(hd, S):
    args, st = _scan_inputs(hd + S, 2, 4, S, hd)
    th, ts = TR.mlstm_scan_ref(*_torch(args, st)[0], _torch(args, st)[1])
    jh, js = JR.mlstm_scan_ref(*map(jnp.asarray, args),
                               tuple(map(jnp.asarray, st)))
    jh = np.asarray(jh)
    assert th.dtype == torch.float32 and tuple(th.shape) == jh.shape
    np.testing.assert_array_less(np.abs(th.numpy() - jh),
                                 H_RTOL * (1 + np.abs(jh)))
    for t, j in zip(ts, js):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   atol=STATE_ATOL, rtol=STATE_RTOL)


def test_scan_without_state_starts_fresh_and_mlstm_ref_is_its_h():
    args, _ = _scan_inputs(1, 1, 2, 12, 32, state=False)
    t = _torch(args, None)[0]
    h, st = KB.mlstm_scan(*t, None)
    fresh = TR.mlstm_zero_state(1, 2, 32, "cpu")
    h0, st0 = KB.mlstm_scan(*t, fresh)
    assert torch.equal(h, h0) and all(map(torch.equal, st, st0))
    assert torch.equal(TR.mlstm_ref(*t), h)
    assert bool((fresh[2] == -1e30).all()) and not fresh[0].any()


def test_explicit_scale_is_the_prescaled_k():
    """``scale`` multiplies k before the recurrence, as the Pallas wrapper
    does: the default is 1/sqrt(hd), and scale s equals k * s at scale
    1."""
    args, st = _scan_inputs(2, 1, 2, 10, 64)
    (q, k, v, i, f), st = _torch(args, st)
    h, s = KB.mlstm_scan(q, k, v, i, f, st)
    h1, s1 = KB.mlstm_scan(q, k, v, i, f, st, scale=1.0 / math.sqrt(64))
    assert torch.equal(h, h1) and all(map(torch.equal, s, s1))
    h2, s2 = KB.mlstm_scan(q, k, v, i, f, st, scale=0.5)
    h3, s3 = KB.mlstm_scan(q, k * 0.5, v, i, f, st, scale=1.0)
    assert torch.equal(h2, h3) and all(map(torch.equal, s2, s3))


def test_extreme_gates_stay_finite():
    """logsigmoid is taken in its stable form: gate preactivations of
    +-1e3 give finite outputs and states."""
    args, st = _scan_inputs(3, 1, 2, 8, 32)
    args[3] = np.float32(1e3) * np.sign(args[3])
    args[4] = np.float32(1e3) * np.sign(args[4] - 3.0)
    h, (C, n, m) = KB.mlstm_scan(*_torch(args, st)[0], _torch(args, st)[1])
    assert all(bool(torch.isfinite(t).all()) for t in (h, C, n, m))


@pytest.mark.parametrize("seam", [1, 17, 39])
def test_split_scan_is_the_whole_scan_bitwise(seam):
    args, st = _scan_inputs(seam, 2, 2, 40, 32)
    t, st = _torch(args, st)
    h, s = KB.mlstm_scan(*t, st)
    cut = lambda a, lo, hi: a[:, :, lo:hi].contiguous()
    h1, s1 = KB.mlstm_scan(*(cut(a, 0, seam) for a in t), st)
    h2, s2 = KB.mlstm_scan(*(cut(a, seam, 40) for a in t), s1)
    assert torch.equal(torch.cat([h1, h2], dim=2), h)
    assert all(map(torch.equal, s2, s))


def test_one_step_scans_are_one_long_scan_bitwise():
    args, st = _scan_inputs(5, 3, 4, 16, 32)
    t, st = _torch(args, st)
    h, s = KB.mlstm_scan(*t, st)
    hs, cur = [], st
    for i in range(16):
        ht, cur = KB.mlstm_scan(*(a[:, :, i:i + 1].contiguous() for a in t),
                                cur)
        hs.append(ht)
    assert torch.equal(torch.cat(hs, dim=2), h)
    assert all(map(torch.equal, cur, s))


def test_wrapper_refuses_what_the_kernel_cannot_take():
    args, st = _scan_inputs(6, 1, 2, 4, 16)
    t, st = _torch(args, st)
    with pytest.raises(ValueError, match=r"head dim in \(32, 64, 128, 192\)"):
        mlstm_scan(*t, st)
    assert HEAD_DIMS == (32, 64, 128, 192)
    args, st = _scan_inputs(6, 1, 2, 4, 32)
    (q, k, v, i, f), st = _torch(args, st)
    with pytest.raises(ValueError, match="torch.float32"):
        mlstm_scan(q.to(torch.bfloat16), k, v, i, f, st)
    with pytest.raises(ValueError, match="torch.float32"):
        mlstm_scan(q, k, v, i, f, (st[0], st[1].double(), st[2]))
    with pytest.raises(ValueError, match="contiguous"):
        mlstm_scan(q.transpose(2, 3), k, v, i, f, st)
    with pytest.raises(ValueError, match="unsupported shapes"):
        mlstm_scan(q, k, v, i, f, (st[0], st[1], st[2][:, :1]))
    with pytest.raises(ValueError, match="no kernel for device"):
        mlstm_scan(q.to("meta"), k, v, i, f, st)
    with pytest.raises(ValueError, match="only in the CUDA kernel"):
        mlstm_scan_tile_states(q, k, v, i, f, st)


def test_cpu_scan_counts_no_launch():
    KB.reset_launches()
    args, st = _scan_inputs(7, 1, 2, 3, 32)
    KB.mlstm_scan(*_torch(args, st)[0], _torch(args, st)[1])
    assert KB.launch_counts()["mlstm_scan"] == 0


# ---------------------------------------------------- the xLSTM blocks ----

@pytest.fixture(scope="module")
def layers():
    """xlstm-smoke's mLSTM (d 128, dh 128, 4 heads of 32) and sLSTM (4
    heads of 32, d_ff 170) with JAX-drawn weights in both frameworks."""
    jcfg = jax_smoke("xlstm-125m")
    cfg = get_smoke_config("xlstm-125m")
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    pick = lambda ui, name: jax.tree.map(lambda a: a[0],
                                         jp["segments"][0][ui][name])
    return (jcfg, cfg, pick(0, "mlstm"), model.layers[0].mlstm,
            pick(1, "slstm"), model.layers[1].slstm)


def _x(seed, B, T, d):
    x = np.random.default_rng(seed).standard_normal((B, T, d),
                                                    dtype=np.float32)
    return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(
        x, jnp.bfloat16)


def _y_close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=Y_ATOL, rtol=Y_RTOL)


def _mlstm_state_close(t, j):
    (tC, tn, tm), (jC, jn, jm) = t, j
    assert tC.dtype == tn.dtype == tm.dtype == torch.float32
    for a, b in ((tC, jC), (tn, jn)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=C_TOL,
                                   rtol=C_TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5,
                               rtol=0)


def _slstm_state_close(t, j):
    assert sorted(t) == ["c", "h", "m", "n"]
    np.testing.assert_allclose(t["m"].numpy(), np.asarray(j["m"]),
                               atol=M_TOL, rtol=0)
    for key in ("c", "n"):
        np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]),
                                   atol=1e-2, rtol=SL_RTOL, err_msg=key)
    np.testing.assert_allclose(t["h"].numpy(), np.asarray(j["h"]),
                               atol=Y_ATOL, rtol=Y_RTOL)


def test_mlstm_block_fresh_and_stateful_match_jax(layers):
    jcfg, cfg, jm, tm, _, _ = layers
    assert tm.w_if.dtype == tm.b_f.dtype == torch.float32
    assert tm.wq.dtype == torch.bfloat16 and float(tm.b_f[0]) == 3.0
    tx, jx = _x(0, 2, 37, cfg.d_model)
    ty, ts = X.mlstm_block(tm, tx, cfg, X.mlstm_state_init(cfg, 2, "cpu"),
                           fixed=True)
    jy, js = j_mlstm_block(jm, jx, jcfg, JX.mlstm_state_init(jcfg, 2),
                           backend="reference")
    assert ty.dtype == torch.bfloat16 and tuple(ts[0].shape) == (2, 4, 32,
                                                                 32)
    _y_close(ty, jy)
    _mlstm_state_close(ts, js)
    for step in range(3):
        tx, jx = _x(10 + step, 2, 1, cfg.d_model)
        ty, ts = X.mlstm_block(tm, tx, cfg, ts)
        jy, js = j_mlstm_block(jm, jx, jcfg, js, backend="reference")
        _y_close(ty, jy)
        _mlstm_state_close(ts, js)


def test_slstm_block_fresh_and_stateful_match_jax(layers):
    jcfg, cfg, _, _, jsl, tsl = layers
    assert tsl.b_gates.dtype == torch.float32
    assert tsl.r_gates.dtype == torch.bfloat16
    assert tuple(tsl.w_up.shape) == (128, 2 * 170)
    tx, jx = _x(1, 2, 37, cfg.d_model)
    ty, ts = X.slstm_block(tsl, tx, cfg, X.slstm_state_init(cfg, 2, "cpu"),
                           fixed=True)
    jy, js = j_slstm_block(jsl, jx, jcfg, JX.slstm_state_init(jcfg, 2))
    _y_close(ty, jy)
    _slstm_state_close(ts, js)
    for step in range(3):
        tx, jx = _x(20 + step, 2, 1, cfg.d_model)
        ty, ts = X.slstm_block(tsl, tx, cfg, ts)
        jy, js = j_slstm_block(jsl, jx, jcfg, js)
        _y_close(ty, jy)
        _slstm_state_close(ts, js)


def test_blocks_leave_their_input_state_alone(layers):
    _, cfg, _, tm, _, tsl = layers
    tx, _ = _x(5, 2, 6, cfg.d_model)
    _, ms = X.mlstm_block(tm, tx, cfg, X.mlstm_state_init(cfg, 2, "cpu"))
    _, ss = X.slstm_block(tsl, tx, cfg, X.slstm_state_init(cfg, 2, "cpu"))
    mb = tuple(t.clone() for t in ms)
    sb = {k: v.clone() for k, v in ss.items()}
    X.mlstm_block(tm, tx[:, :1], cfg, ms)
    X.slstm_block(tsl, tx[:, :1], cfg, ss)
    assert all(map(torch.equal, ms, mb))
    assert all(torch.equal(ss[k], sb[k]) for k in ss)


def test_fixed_row_products_make_a_chunked_block_bitwise(layers):
    """With fixed-size row products, a block over 37 rows equals the
    same block over 20 and then 17 rows with the state carried, on both
    kinds (the seam contract of chunked prefill)."""
    _, cfg, _, tm, _, tsl = layers
    tx, _ = _x(6, 1, 37, cfg.d_model)
    for blk, p, init in ((X.mlstm_block, tm, X.mlstm_state_init),
                         (X.slstm_block, tsl, X.slstm_state_init)):
        y, s = blk(p, tx, cfg, init(cfg, 1, "cpu"), fixed=True)
        y1, s1 = blk(p, tx[:, :20], cfg, init(cfg, 1, "cpu"), fixed=True)
        y2, s2 = blk(p, tx[:, 20:], cfg, s1, fixed=True)
        assert torch.equal(torch.cat([y1, y2], dim=1), y)
        leaves = (zip(s2, s) if isinstance(s, tuple)
                  else ((s2[k], s[k]) for k in s))
        assert all(torch.equal(a, b) for a, b in leaves)


# ------------------------------------------------- on the card only ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,H,S,hd", [(1, 4, 300, 192), (8, 4, 1, 192),
                                      (1, 4, 40, 32), (2, 2, 33, 64),
                                      (1, 2, 17, 128), (1, 4, 14, 192)])
def test_mlstm_scan_kernel_on_card(B, H, S, hd):
    dev = _card()
    args, st = _scan_inputs(S + hd, B, H, S, hd)
    t = [torch.from_numpy(a).to(dev) for a in args]
    st = tuple(torch.from_numpy(a).to(dev) for a in st)
    before = mlstm_scan.launches
    h, s = mlstm_scan(*t, st)
    rh, rs = TR.mlstm_scan_ref(*t, st)
    torch.cuda.synchronize()
    assert mlstm_scan.launches == before + 1
    assert bool(((h - rh).abs() <= H_RTOL * (1 + rh.abs())).all())
    for a, b in zip(s, rs):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    (h2, s2), (nt, mt) = mlstm_scan_tile_states(*t, st)
    assert torch.equal(h2, h) and all(map(torch.equal, s2, s))
    assert all(torch.equal(nt[:, :, j], s[1]) for j in range(nt.shape[2]))
    assert all(torch.equal(mt[:, :, j], s[2]) for j in range(mt.shape[2]))
    if S > 1:
        cut = S // 3
        part = lambda a, lo, hi: a[:, :, lo:hi].contiguous()
        h1, s1 = mlstm_scan(*(part(a, 0, cut) for a in t), st)
        h2, s2 = mlstm_scan(*(part(a, cut, S) for a in t), s1)
        assert torch.equal(torch.cat([h1, h2], 2), h)
        assert all(map(torch.equal, s2, s))
