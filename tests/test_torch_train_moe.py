"""Training of the port's MoE stacks (kimi-k2-1t-a32b and arctic-480b at
their SMOKE configs) against the JAX package's reference backend on the
same weights (JAX ``init_params`` through the weight bridge) and JAX's
own seeded data, B 2 x S 64, and the router's backward.

Tolerances are those of ``torch_train_common.py`` (loss 2e-2, each
gradient leaf 3e-2 relative norm), plus:
  * routing near-ties: where a token's k-th and (k+1)-th router
    probabilities are within NEAR_TIE = 1e-3 (the port's), the two
    frameworks' bf16 roundings of the router input may pick different
    experts, and a flipped route changes that token's output, and so a
    gradient, by O(1). Such tokens get label -1 in both frameworks'
    batch (``xent_chunked`` skips them), gradients are compared only on
    stacks whose one MoE layer is the last (kimi-smoke as it is,
    arctic-smoke cut to one layer), and the capacity factor is 100 in
    both packages, so a flip cannot drop another token's choice: a
    masked token's route then reaches no other token's loss. At most
    MAX_TIE_SHARE = 20% of the tokens may be masked. Two-layer
    arctic-smoke is held by its loss and by its routes outside
    near-ties;
  * ``router_topk_bwd_ref`` against ``jax.grad`` of the JAX oracle:
    |diff| <= 1e-6 (fp32; the exact gradient of a chosen logit is
    w (dw - sum w dw), of the others 0, and both frameworks leave
    ~1e-9 of rounding on the others through the full softmax).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_train_common as TT
from repro.common import perf as jperf
from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ref as JR
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.common import perf
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import backend as KB
from repro_torch.kernels.moe_router import MoeRouterFn, moe_router_bwd
from repro_torch.kernels.ref import router_topk_bwd_ref
from repro_torch.launch import train as LT
from repro_torch.models import model as TM
from repro_torch.models.convert import _walk, params_from_numpy, \
    params_to_numpy

NEAR_TIE = 1e-3
MAX_TIE_SHARE = 0.2
ROUTER_TOL = 1e-6
# (name, arch, MoE layers kept): gradients on the stacks whose one MoE
# layer is the last; two-layer arctic by its loss and routes
STACKS = [("kimi", "kimi-k2-1t-a32b", None), ("arctic1", "arctic-480b", 1),
          ("arctic2", "arctic-480b", None)]
GRAD_STACKS = ("kimi", "arctic1")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread (``test_torch_training.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def factor_100():
    """Capacity factor 100 in both packages (nothing drops), restored
    after the module."""
    old, jold = perf.get_flags(), jperf.get_flags()
    perf.set_flags(dataclasses.replace(old, moe_capacity_factor=100.0))
    jperf.set_flags(dataclasses.replace(jold, moe_capacity_factor=100.0))
    yield
    perf.set_flags(old)
    jperf.set_flags(jold)


def _cut(cfg, layers):
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers,
                               segments=(((cfg.segments[0][0]), layers),))


def _port_routes(model, batch):
    """The port's routes by MoE layer in layer order ((B,S,k) ids) and
    the (b, s) of every near-tie token in any layer."""
    routes, ties, orig = [], set(), KB.router_topk

    def record(logits, k):
        top = torch.sort(torch.softmax(logits.detach().float(), -1), -1,
                         descending=True).values
        for i in torch.nonzero(top[:, k - 1] - top[:, k] < NEAR_TIE
                               ).flatten().tolist():
            ties.add(divmod(i, TT.S))
        w, idx = orig(logits, k)
        routes.append(idx.reshape(TT.B, TT.S, k).numpy().copy())
        return w, idx
    KB.router_topk = record
    try:
        with torch.no_grad():
            TM.train_loss(model, batch, remat=False)
    finally:
        KB.router_topk = orig
    return routes, ties


def _jax_routes(jcfg, jp, batch):
    """JAX's routes by MoE layer in layer order, recorded by a debug
    callback from inside its jitted train_loss."""
    routes, orig = [], JMOE.router_topk

    def record(router_w, x, mcfg, backend=None):
        w, idx, probs = orig(router_w, x, mcfg, backend=backend)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)), idx,
                           ordered=True)
        return w, idx, probs
    JMOE.router_topk = record
    try:
        jax.block_until_ready(jax.jit(
            lambda p: JM.train_loss(p, jcfg, batch, remat=False))(jp))
        jax.effects_barrier()
    finally:
        JMOE.router_topk = orig
    return routes


_RUNS = {}


def _run(name):
    """One stack's near-ties masked in the batch, JAX's loss, gradients
    and routes, and the port's loss (and, on GRAD_STACKS, its gradients
    with and without remat), computed once a module."""
    if name in _RUNS:
        return _RUNS[name]
    _, arch, layers = next(s for s in STACKS if s[0] == name)
    jcfg = _cut(jax_smoke(arch), layers)
    cfg = _cut(get_smoke_config(arch), layers)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    batch = TT.batch_of(jcfg)
    model = TT.bridged(jp, cfg)
    routes, ties = _port_routes(model, batch)
    for b, s in ties:
        batch["labels"][b, s] = -1
    jroutes = _jax_routes(jcfg, jp, batch)
    jloss, jgrads = TT.jax_value_and_grad(jcfg, jp, batch)
    pg = TT.port_grads(model, batch) if name in GRAD_STACKS else None
    loss = float(TM.train_loss(model, batch, remat=False).detach()) \
        if pg is None else pg[False][0]
    _RUNS[name] = dict(name=name, cfg=cfg, jcfg=jcfg, jp=jp, model=model,
                       batch=batch, ties=ties, routes=routes,
                       jroutes=jroutes, jloss=jloss, jgrads=jgrads,
                       loss=loss, pg=pg)
    return _RUNS[name]


@pytest.fixture(scope="module", params=[s[0] for s in STACKS])
def run(request, factor_100):
    return _run(request.param)


@pytest.fixture(scope="module", params=GRAD_STACKS)
def grad_run(request, factor_100):
    return _run(request.param)


def test_near_ties_are_few(run):
    assert len(run["ties"]) <= MAX_TIE_SHARE * TT.B * TT.S, \
        f"{len(run['ties'])} of {TT.B * TT.S} tokens are near-ties"


def test_train_loss_matches_the_reference(run):
    assert abs(run["loss"] - run["jloss"]) <= TT.LOSS_TOL, \
        (run["loss"], run["jloss"])


def test_routes_agree_outside_near_ties(run):
    assert len(run["routes"]) == len(run["jroutes"]) == \
        run["cfg"].layer_kinds().count("moe")
    keep = np.ones((TT.B, TT.S), bool)
    for b, s in run["ties"]:
        keep[b, s] = False
    for t, j in zip(run["routes"], run["jroutes"]):
        # the same set of experts a token (their order within a near-tie
        # of the 1st and 2nd choice is not held)
        np.testing.assert_array_equal(np.sort(t, -1)[keep],
                                      np.sort(j, -1)[keep])


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_the_reference(grad_run, remat):
    rel = TT.grad_rel_errors(grad_run["pg"][remat][1], grad_run["jgrads"],
                             grad_run["cfg"])
    assert len(rel) == len(dict(grad_run["model"].named_parameters()))
    bad = {n: e for n, e in rel.items() if e > TT.GRAD_REL}
    assert not bad, bad


def test_remat_gradients_are_bitwise_equal(grad_run):
    TT.assert_remat_bitwise(grad_run["pg"])


def test_aux_term_is_in_the_loss(run):
    """train_loss is the LM loss plus the MoE layers' load-balance
    terms, each positive."""
    from repro_torch.models import moe as M
    model, batch = run["model"], run["batch"]
    auxes, orig = [], M.moe_ffn

    def record(*a, **kw):
        y, aux = orig(*a, **kw)
        auxes.append(aux)
        return y, aux * 0
    M.moe_ffn = record
    try:
        with torch.no_grad():
            lm = float(TM.train_loss(model, batch, remat=False))
    finally:
        M.moe_ffn = orig
    assert len(auxes) == model.cfg.layer_kinds().count("moe")
    assert all(float(a) > 0 for a in auxes)
    total = lm + sum(float(a) for a in auxes)
    assert abs(run["loss"] - total) <= 1e-5 * abs(total)


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


@pytest.mark.parametrize("T,E,k", [(7, 4, 2), (5, 16, 3), (3, 40, 8)])
def test_router_bwd_ref_is_jax_grad_of_the_oracle(T, E, k):
    rng = np.random.default_rng(T * E + k)
    logits = rng.standard_normal((T, E), dtype=np.float32)
    logits[0, :] = np.round(logits[0, :])          # a row with ties
    dw = rng.standard_normal((T, k), dtype=np.float32)
    f = lambda lg: jnp.sum(JR.router_topk_ref(lg, k)[0] * dw)
    want = np.asarray(jax.jit(jax.grad(f))(logits))
    got = router_topk_bwd_ref(torch.from_numpy(logits), k,
                              torch.from_numpy(dw)).numpy()
    np.testing.assert_allclose(got, want, atol=ROUTER_TOL, rtol=0)
    # the chosen logits' closed form, which the kernel computes
    w, idx, _ = JR.router_topk_ref(logits, k)
    w, idx = np.asarray(w), np.asarray(idx)
    closed = np.zeros_like(logits)
    for t in range(T):
        closed[t, idx[t]] = w[t] * (dw[t] - np.sum(w[t] * dw[t]))
    np.testing.assert_allclose(got, closed, atol=ROUTER_TOL, rtol=0)


def test_router_function_routes_to_the_plain_backward_on_cpu():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((9, 8), dtype=np.float32))
    dw = torch.from_numpy(rng.standard_normal((9, 2), dtype=np.float32))
    KB.reset_launches()
    lg = logits.clone().requires_grad_(True)
    w, idx = KB.router_topk(lg, 2)
    assert "MoeRouterFnBackward" in TT.autograd_nodes(w)
    assert not idx.requires_grad
    (got,) = torch.autograd.grad(w, lg, dw)
    assert torch.equal(got, router_topk_bwd_ref(logits, 2, dw))
    assert torch.equal(moe_router_bwd(logits, w.detach(), idx, dw), got)
    assert set(KB.launch_counts().values()) == {0}
    w2, _ = MoeRouterFn.apply(lg, 2)
    assert torch.equal(w2, w)
    with torch.no_grad():
        assert KB.router_topk(lg, 2)[0].grad_fn is None


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b"])
def test_train_launcher_runs_the_family(arch, capsys):
    res = LT.main(["--device", "cpu", "--smoke", "--arch", arch, "--steps",
                   "3", "--batch", "2", "--seq", "32", "--log-every", "1"])
    assert "step     2 loss" in capsys.readouterr().out
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
