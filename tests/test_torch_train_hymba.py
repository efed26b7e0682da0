"""Training of the port's hymba stack (hymba-1.5b at its SMOKE config: a
global and a sliding-window layer, attention beside the mamba SSM)
against the JAX package's reference backend on the same weights (JAX
``init_params`` through the weight bridge) and JAX's own seeded data,
B 2 x S 64 (past the smoke window of 32), and the selective scan's
backward.

Tolerances are those of ``torch_train_common.py`` (loss 2e-2, each
gradient leaf 3e-2 relative norm), plus ``selective_scan_bwd_ref``
against ``jax.grad`` of the JAX oracle in fp32: |diff| <= SCAN_TOL =
1e-4 (1 + |JAX|) (the reverse recurrences of two autograds, and sums of
up to 2 x 40 terms for dA and 24 channels for dB_ and dC_, in other
orders).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_train_common as TT
from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ref as JR
from repro.models import model as JM
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import backend as KB
from repro_torch.kernels.ref import selective_scan_bwd_ref
from repro_torch.kernels.ssm_scan import SsmScanFn, ssm_scan_bwd, \
    ssm_scan_with_states, states_shape
from repro_torch.launch import train as LT
from repro_torch.models.convert import _walk, params_from_numpy, \
    params_to_numpy

ARCH = "hymba-1.5b"
SCAN_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread (``test_torch_training.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    jcfg, cfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    batch = TT.batch_of(jcfg)
    jloss, jgrads = TT.jax_value_and_grad(jcfg, jp, batch)
    model = TT.bridged(jp, cfg)
    return dict(cfg=cfg, jp=jp, batch=batch, model=model, jloss=jloss,
                jgrads=jgrads, pg=TT.port_grads(model, batch))


def test_the_batch_passes_the_window(run):
    assert TT.S > run["cfg"].window
    assert set(run["cfg"].layer_kinds()) == {"hymba_g", "hymba_w"}


@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_matches_the_reference(run, remat):
    assert abs(run["pg"][remat][0] - run["jloss"]) <= TT.LOSS_TOL


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_the_reference(run, remat):
    rel = TT.grad_rel_errors(run["pg"][remat][1], run["jgrads"], run["cfg"])
    assert len(rel) == len(dict(run["model"].named_parameters()))
    assert any(".ssm.A_log" in n for n in rel)
    bad = {n: e for n, e in rel.items() if e > TT.GRAD_REL}
    assert not bad, bad


def test_remat_gradients_are_bitwise_equal(run):
    TT.assert_remat_bitwise(run["pg"])


def test_params_to_numpy_round_trips(run):
    tree = params_to_numpy(run["model"])
    want = TT.flat(run["jp"])
    got = dict(_walk(tree, ""))
    assert set(got) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    again = params_from_numpy(tree, run["cfg"], "cpu")
    for (n, a), (_, b) in zip(run["model"].named_parameters(),
                              again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def _scan_inputs(rng, B, S, di, n, given_h0):
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    dt = np.log1p(np.exp(mk(B, S, di) - 3)).astype(np.float32)  # softplus
    A = -np.exp(mk(di, n) * 0.5).astype(np.float32)
    h0 = mk(B, di, n) if given_h0 else np.zeros((B, di, n), np.float32)
    return (dt, mk(B, S, di), mk(B, S, n), mk(B, S, n), A, h0,
            mk(B, S, di), mk(B, di, n))


@pytest.mark.parametrize("B,S,di,n,given_h0", [
    (2, 40, 24, 8, False), (1, 33, 16, 16, True), (2, 7, 8, 8, True)])
def test_scan_bwd_ref_is_jax_grad_of_the_oracle(B, S, di, n, given_h0):
    rng = np.random.default_rng(S * di + n)
    dt, x, Bm, Cm, A, h0, dy, dh = _scan_inputs(rng, B, S, di, n, given_h0)

    def f(*a):
        y, h = JR.selective_scan_ref(*a)
        return jnp.sum(y * dy) + jnp.sum(h * dh)
    want = jax.jit(jax.grad(f, argnums=tuple(range(6))))(dt, x, Bm, Cm, A,
                                                          h0)
    got = selective_scan_bwd_ref(*map(torch.from_numpy,
                                      (dt, x, Bm, Cm, A, h0, dy, dh)))
    for name, t, j in zip(("ddt", "dx", "dB", "dC", "dA", "dh0"), got,
                          want):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=SCAN_TOL * (1 + np.abs(j).max()),
                                   err_msg=name)


def test_scan_function_routes_to_the_plain_backward_on_cpu():
    rng = np.random.default_rng(3)
    ins = [torch.from_numpy(a) for a in _scan_inputs(rng, 2, 9, 8, 8, True)]
    dt, x, Bm, Cm, A, h0, dy, dh = ins
    KB.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (dt, x, Bm, Cm, A)]
    y, h_last = KB.selective_scan(*leaves, h0)
    assert "SsmScanFnBackward" in TT.autograd_nodes(y)
    got = torch.autograd.grad((y, h_last), leaves, (dy, dh))
    want = selective_scan_bwd_ref(dt, x, Bm, Cm, A, h0, dy, dh)
    for a, b in zip(got, want[:5]):
        assert torch.equal(a, b)
    direct = ssm_scan_bwd(dt, x, Bm, Cm, A, h0, dy, dh)
    assert all(torch.equal(a, b) for a, b in zip(direct, want))
    assert set(KB.launch_counts().values()) == {0}
    # the saved states exist only on the card
    with pytest.raises(ValueError, match="only in the CUDA kernel"):
        ssm_scan_with_states(dt, x, Bm, Cm, A, h0)
    with pytest.raises(ValueError, match="only on the card"):
        ssm_scan_bwd(dt, x, Bm, Cm, A, h0, dy, dh,
                     saved_states=torch.zeros(states_shape(2, 9, 8, 8)))
    y2, _ = SsmScanFn.apply(*leaves, h0)
    assert torch.equal(y2, y)
    # the forward's saved states exist only on the card: none on the CPU
    assert y2.grad_fn.saved_tensors[6] is None
    with torch.no_grad():
        assert KB.selective_scan(*leaves, h0)[0].grad_fn is None


def test_train_launcher_runs_the_family(capsys):
    res = LT.main(["--device", "cpu", "--smoke", "--arch", ARCH, "--steps",
                   "3", "--batch", "2", "--seq", "64", "--log-every", "1",
                   "--remat"])
    assert "step     2 loss" in capsys.readouterr().out
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
