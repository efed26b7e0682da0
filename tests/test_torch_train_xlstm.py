"""Training of the port's xlstm stack (xlstm-125m at its SMOKE config: an
mLSTM and an sLSTM layer) against the JAX package's reference backend on
the same weights (JAX ``init_params`` through the weight bridge) and
JAX's own seeded data, B 2 x S 64, and the mLSTM scan's backward.

Tolerances are those of ``torch_train_common.py`` (loss 2e-2, each
gradient leaf 3e-2 relative norm), plus ``mlstm_scan_bwd_ref`` against
``jax.grad`` of the JAX oracle in fp32: |diff| <= SCAN_TOL = 1e-4 (1 +
|JAX|) (the reverse recurrences of two autograds in other orders; the
output divides by a cancelled dot, so the inputs are drawn with the
denominator's floor exp(-m) on some early steps and |n . q| on the
rest, as a fresh state gives).
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
from repro_torch.kernels.mlstm_scan import MlstmScanFn, mlstm_scan_bwd
from repro_torch.kernels.ref import mlstm_scan_bwd_ref
from repro_torch.launch import train as LT
from repro_torch.models.convert import _walk, params_from_numpy, \
    params_to_numpy

ARCH = "xlstm-125m"
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


@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_matches_the_reference(run, remat):
    assert abs(run["pg"][remat][0] - run["jloss"]) <= TT.LOSS_TOL


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_the_reference(run, remat):
    rel = TT.grad_rel_errors(run["pg"][remat][1], run["jgrads"], run["cfg"])
    assert len(rel) == len(dict(run["model"].named_parameters()))
    assert any(".mlstm.w_if" in n for n in rel)
    assert any(".slstm.r_gates" in n for n in rel)
    bad = {n: e for n, e in rel.items() if e > TT.GRAD_REL}
    assert not bad, bad


def test_remat_gradients_are_bitwise_equal(run):
    TT.assert_remat_bitwise(run["pg"])


def test_params_to_numpy_round_trips(run):
    """Every leaf, the fp32 ones (``w_if``, ``b_i``, ``b_f``,
    ``b_gates``) bit for bit."""
    tree = params_to_numpy(run["model"])
    want = TT.flat(run["jp"])
    got = dict(_walk(tree, ""))
    assert set(got) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    again = params_from_numpy(tree, run["cfg"], "cpu")
    f32 = 0
    for (n, a), (_, b) in zip(run["model"].named_parameters(),
                              again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
        f32 += a.dtype == torch.float32
    assert f32 == 4


def _scan_inputs(rng, B, H, S, hd, given_state):
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    q, k, v = mk(B, H, S, hd), mk(B, H, S, hd), mk(B, H, S, hd)
    i_pre, f_pre = mk(B, H, S), mk(B, H, S) + 3.0
    i_pre[:, :, 0] = 4.0                  # the exp(-m) floor at step 0
    if given_state:
        state = (mk(B, H, hd, hd) * 0.1, np.abs(mk(B, H, hd)),
                 mk(B, H) * 0.5)
    else:
        state = (np.zeros((B, H, hd, hd), np.float32),
                 np.zeros((B, H, hd), np.float32),
                 np.full((B, H), -1e30, np.float32))
    dstate = (mk(B, H, hd, hd), mk(B, H, hd), mk(B, H))
    return (q, k, v, i_pre, f_pre), state, mk(B, H, S, hd), dstate


@pytest.mark.parametrize("B,H,S,hd,given_state", [
    (2, 2, 20, 32, False), (1, 2, 17, 32, True), (1, 1, 9, 64, True)])
def test_mlstm_bwd_ref_is_jax_grad_of_the_oracle(B, H, S, hd, given_state):
    rng = np.random.default_rng(S * hd + given_state)
    ins, state, dh, dstate = _scan_inputs(rng, B, H, S, hd, given_state)

    def f(*a):
        h, st = JR.mlstm_scan_ref(*a[:5], tuple(a[5:]))
        return jnp.sum(h * dh) + sum(jnp.sum(s * d)
                                     for s, d in zip(st, dstate))
    want = jax.jit(jax.grad(f, argnums=tuple(range(8))))(*ins, *state)
    tin = [torch.from_numpy(a) for a in ins]
    got = mlstm_scan_bwd_ref(*tin, tuple(map(torch.from_numpy, state)),
                             torch.from_numpy(dh),
                             tuple(map(torch.from_numpy, dstate)))
    got = (*got[:5], *got[5])
    names = ("dq", "dk", "dv", "di", "df", "dC0", "dn0", "dm0")
    for name, t, j in zip(names, got, want):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=SCAN_TOL * (1 + np.abs(j).max()),
                                   err_msg=name)


def test_mlstm_function_routes_to_the_plain_backward_on_cpu():
    rng = np.random.default_rng(4)
    ins, state, dh, dstate = _scan_inputs(rng, 1, 2, 11, 32, True)
    tin = [torch.from_numpy(a) for a in ins]
    tst = tuple(map(torch.from_numpy, state))
    tdh, tds = torch.from_numpy(dh), tuple(map(torch.from_numpy, dstate))
    KB.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in tin]
    h, st = KB.mlstm_scan(*leaves, tst, scale=0.2)
    assert "MlstmScanFnBackward" in TT.autograd_nodes(h)
    got = torch.autograd.grad((h, *st), leaves, (tdh, *tds))
    want = mlstm_scan_bwd_ref(*tin, tst, tdh, tds, scale=0.2)
    for a, b in zip(got, want[:5]):
        assert torch.equal(a, b)
    direct = mlstm_scan_bwd(*tin, tst, tdh, tds, scale=0.2)
    assert all(torch.equal(a, b) for a, b in zip(direct[:5], want[:5]))
    assert all(torch.equal(a, b) for a, b in zip(direct[5], want[5]))
    assert set(KB.launch_counts().values()) == {0}
    h2, *_ = MlstmScanFn.apply(*leaves, *tst, 0.2)
    assert torch.equal(h2, h)
    # the forward saves its inputs alone: the backward rebuilds C itself
    assert len(h2.grad_fn.saved_tensors) == 8
    with torch.no_grad():
        assert KB.mlstm_scan(*leaves, tst, scale=0.2)[0].grad_fn is None


def test_train_launcher_runs_the_family(capsys):
    res = LT.main(["--device", "cpu", "--smoke", "--arch", ARCH, "--steps",
                   "3", "--batch", "2", "--seq", "32", "--log-every", "1",
                   "--remat"])
    assert "step     2 loss" in capsys.readouterr().out
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
