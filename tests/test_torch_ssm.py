"""The port's selective scan and mamba layer vs the JAX package's, on the
CPU, and the scan's within-port contract.

Tolerances, with their reasons:
  * scan oracle vs the JAX oracle (fp32 on both sides, the same
    sequential recurrence; the sum over n is a product-and-sum in the
    port and an einsum in JAX): |diff| <= SCAN_TOL = 1e-4, a few fp32
    ulps of states and outputs of magnitude ~1-30 accumulated over up
    to 512 contracting steps;
  * ``ssm_forward`` vs JAX ``ssm_forward`` on the reference backend: the
    JAX reference runs a chunked associative scan (another order of the
    fp32 state sums) and both frameworks round the bf16 projections,
    conv and activations at other places. The fp32 state ``h`` is held
    within H_TOL = 1e-2 (its values are O(0.1-1); a bf16 step of an
    input is ~4e-3 relative); the bf16 output ``y`` within Y_ATOL +
    Y_RTOL |y| = 2**-6 + 2**-6 |y| (one or two bf16 steps of the
    out_proj output); the bf16 conv state within one bf16 step (it is
    the in_proj output, rounded once on each side).

Within the port the scan is bitwise: a scan split at any seam (h_last of
the first part fed as h0 of the second) equals one scan, and S one-step
scans equal one S-step scan, on the CPU here and on the card in the
card-only test at the end (which skips without one) and in
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ref as JR
from repro.models import ssm as JS
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import backend as KB
from repro_torch.kernels import ref as TR
from repro_torch.kernels.ssm_scan import STATE_SIZES, ssm_scan
from repro_torch.models import ssm as S

SCAN_TOL = 1e-4
H_TOL = 1e-2
Y_ATOL = Y_RTOL = 2.0 ** -6


def _scan_inputs(seed, B, T, di, n, h0=True):
    """The JAX sweep's input distributions (``tests/test_kernels.py``):
    dt = |N(0,1)| * 0.1, x, B_, C_ ~ N(0,1), A = -exp(N(0,1)); h0 ~
    N(0,1)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    out = [np.abs(mk(B, T, di)) * 0.1, mk(B, T, di), mk(B, T, n),
           mk(B, T, n), -np.exp(mk(di, n))]
    return out + [mk(B, di, n) if h0 else None]


@pytest.mark.parametrize("B,T,di,n", [(2, 256, 128, 16), (1, 512, 256, 8),
                                      (2, 128, 512, 16)])
def test_scan_oracle_matches_jax_oracle(B, T, di, n):
    args = _scan_inputs(B * T + n, B, T, di, n)
    y, h = TR.selective_scan_ref(*map(torch.from_numpy, args))
    jy, jh = JR.selective_scan_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SCAN_TOL,
                               rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=SCAN_TOL,
                               rtol=0)


def test_scan_without_h0_starts_from_zeros():
    args = _scan_inputs(3, 2, 20, 32, 8, h0=False)
    t = [torch.from_numpy(a) for a in args[:5]]
    y, h = KB.selective_scan(*t, None)
    y0, h0 = KB.selective_scan(*t, torch.zeros(2, 32, 8))
    assert torch.equal(y, y0) and torch.equal(h, h0)


@pytest.mark.parametrize("seam", [1, 17, 39])
def test_split_scan_is_the_whole_scan_bitwise(seam):
    dt, x, B_, C_, A, h0 = map(torch.from_numpy,
                               _scan_inputs(seam, 2, 40, 64, 16))
    y, h = KB.selective_scan(dt, x, B_, C_, A, h0)
    cut = lambda t, a, b: t[:, a:b].contiguous()
    y1, h1 = KB.selective_scan(cut(dt, 0, seam), cut(x, 0, seam),
                               cut(B_, 0, seam), cut(C_, 0, seam), A, h0)
    y2, h2 = KB.selective_scan(cut(dt, seam, 40), cut(x, seam, 40),
                               cut(B_, seam, 40), cut(C_, seam, 40), A, h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(h2, h)


def test_one_step_scans_are_one_long_scan_bitwise():
    dt, x, B_, C_, A, h0 = map(torch.from_numpy,
                               _scan_inputs(5, 3, 16, 48, 8))
    y, h = KB.selective_scan(dt, x, B_, C_, A, h0)
    hs, ys = h0, []
    for t in range(16):
        step = lambda a: a[:, t:t + 1].contiguous()
        yt, hs = KB.selective_scan(step(dt), step(x), step(B_), step(C_),
                                   A, hs)
        ys.append(yt)
    assert torch.equal(torch.cat(ys, dim=1), y) and torch.equal(hs, h)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    dt, x, B_, C_, A, h0 = map(torch.from_numpy,
                               _scan_inputs(6, 1, 4, 32, 4))
    with pytest.raises(ValueError, match=r"state size n in \(8, 16\)"):
        ssm_scan(dt, x, B_, C_, A, h0)
    assert STATE_SIZES == (8, 16)
    dt, x, B_, C_, A, h0 = map(torch.from_numpy,
                               _scan_inputs(6, 1, 4, 32, 8))
    with pytest.raises(ValueError, match="torch.float32"):
        ssm_scan(dt.to(torch.bfloat16), x, B_, C_, A, h0)
    with pytest.raises(ValueError, match="torch.float32"):
        ssm_scan(dt, x, B_, C_, A, h0.double())
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan(dt, x, torch.cat([B_, C_], -1)[..., :8], C_, A, h0)
    with pytest.raises(ValueError, match="no kernel for device"):
        ssm_scan(dt.to("meta"), x, B_, C_, A, h0)


def test_cpu_scan_counts_no_launch():
    KB.reset_launches()
    KB.selective_scan(*map(torch.from_numpy, _scan_inputs(7, 1, 3, 32, 8)))
    assert KB.launch_counts()["ssm_scan"] == 0


# ------------------------------------------------- the mamba layer ----

@pytest.fixture(scope="module")
def layer():
    """hymba-smoke's SSM (d 128, d_inner 128, n 8, K 4) with JAX-drawn
    weights in both frameworks."""
    jcfg = jax_smoke("hymba-1.5b")
    cfg = get_smoke_config("hymba-1.5b")
    jp = JS.ssm_init(jax.random.PRNGKey(1), jcfg)
    tp = S.SSM(cfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    for name, leaf in jp.items():
        dst = getattr(tp, name)
        dst.data.copy_(torch.from_numpy(np.asarray(leaf, np.float32)))
        assert dst.dtype == {"bfloat16": torch.bfloat16,
                             "float32": torch.float32}[str(leaf.dtype)]
    return jcfg, jp, cfg, tp


def _x(seed, B, T, d):
    x = np.random.default_rng(seed).standard_normal((B, T, d),
                                                    dtype=np.float32)
    return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(
        x, jnp.bfloat16)


def _close(t_out, t_state, j_out, j_state):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=Y_ATOL, rtol=Y_RTOL)
    np.testing.assert_allclose(t_state["h"].numpy(),
                               np.asarray(j_state["h"]), atol=H_TOL, rtol=0)
    assert t_state["h"].dtype == torch.float32
    assert t_state["conv"].dtype == torch.bfloat16
    a = t_state["conv"].float().numpy()
    b = np.asarray(j_state["conv"], np.float32)
    np.testing.assert_allclose(a, b, atol=0, rtol=2.0 ** -7)


def test_ssm_forward_fresh_and_stateful_match_jax(layer):
    jcfg, jp, cfg, tp = layer
    tx, jx = _x(0, 2, 37, cfg.d_model)
    ty, ts = S.ssm_forward(tp, tx, cfg)
    jy, js = JS.ssm_forward(jp, jx, jcfg, None, backend="reference")
    assert ts["h"].shape == (2, 128, 8) and ts["conv"].shape == (2, 3, 128)
    _close(ty, ts, jy, js)
    for step in range(3):
        tx, jx = _x(10 + step, 2, 1, cfg.d_model)
        ty, ts = S.ssm_forward(tp, tx, cfg, ts)
        jy, js = JS.ssm_forward(jp, jx, jcfg, js, backend="reference")
        _close(ty, ts, jy, js)


def test_ssm_forward_decode_is_the_prefill_continued(layer):
    """A prompt's state advanced one token at a time (decode) equals the
    state of one pass over the longer prompt, up to the row products'
    shapes (bf16 rows of a (1, d) and a (T, d) product may round
    differently), held to the JAX tolerances."""
    _, _, cfg, tp = layer
    tx, _ = _x(4, 1, 30, cfg.d_model)
    y_all, s_all = S.ssm_forward(tp, tx, cfg)
    y, s = S.ssm_forward(tp, tx[:, :26], cfg)
    ys = [y]
    for t in range(26, 30):
        y, s = S.ssm_forward(tp, tx[:, t:t + 1], cfg, s)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).float().numpy(),
                               y_all.float().numpy(), atol=Y_ATOL,
                               rtol=Y_RTOL)
    np.testing.assert_allclose(s["h"].numpy(), s_all["h"].numpy(),
                               atol=H_TOL, rtol=0)
    assert torch.equal(s["conv"], s_all["conv"])


def test_ssm_forward_leaves_its_input_state_alone(layer):
    _, _, cfg, tp = layer
    tx, _ = _x(5, 2, 6, cfg.d_model)
    _, s = S.ssm_forward(tp, tx, cfg)
    before = {k: v.clone() for k, v in s.items()}
    S.ssm_forward(tp, tx[:, :1], cfg, s)
    assert all(torch.equal(s[k], before[k]) for k in s)


# ------------------------------------------------- on the card only ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,T,di,n", [(1, 300, 1600, 16), (8, 1, 1600, 16),
                                      (1, 40, 128, 8), (1, 14, 1600, 16)])
def test_ssm_scan_kernel_on_card(B, T, di, n):
    dev = _card()
    dt, x, B_, C_, A, h0 = (torch.from_numpy(a).to(dev) for a in
                            _scan_inputs(T + n, B, T, di, n))
    before = ssm_scan.launches
    y, h = ssm_scan(dt, x, B_, C_, A, h0)
    ry, rh = TR.selective_scan_ref(dt, x, B_, C_, A, h0)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, rh, atol=1e-4, rtol=1e-4)
    if T > 1:
        cut = T // 3
        part = lambda t, a, b: t[:, a:b].contiguous()
        y1, h1 = ssm_scan(*(part(t, 0, cut) for t in (dt, x, B_, C_)), A,
                          h0)
        y2, h2 = ssm_scan(*(part(t, cut, T) for t in (dt, x, B_, C_)), A,
                          h1)
        assert torch.equal(torch.cat([y1, y2], 1), y)
        assert torch.equal(h2, h)
