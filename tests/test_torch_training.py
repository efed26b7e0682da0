"""The port's training path (``models.model.train_loss``, ``training/*``,
``make_intent_dataset``, the launchers) against the JAX package's, at
the planner's SMOKE config, on the same weights (JAX ``init_params``
through the weight bridge) and JAX's own seeded data.

Tolerances, with their reasons:
  * the loss: |diff| <= 2e-2 (an fp32 logsumexp over the head of a bf16
    residual stream that both frameworks round at other places;
    measured 4.6e-5);
  * gradients: each leaf's relative norm ||port - JAX|| / ||JAX|| <=
    GRAD_REL = 3e-2. Both are bf16 (JAX's in the parameters' dtype; the
    port's cast from fp32 sums at the same places), and every bf16
    rounding of an activation or a partial gradient (relative 2**-9) on
    the way back through two layers, the tied head and the embedding's
    two sources lands elsewhere in the two frameworks; measured 0.0095
    to 0.0168 over the 20 leaves. The port's gradients with and without
    remat are bitwise equal (the same operations on the same inputs);
  * one AdamW step on the same gradients: m and v within 1e-6 relative
    when the norm does not clip; when it clips, plus twice the two
    global norms' relative difference (JAX's fp32 sum is ~9e-7 from the
    exact norm); the bf16 parameters within one bf16 step (JAX's
    function run eagerly); ``cosine_lr`` within 1e-7 relative;
  * ``attention_bwd_ref`` against ``jax.grad`` of the JAX oracle, in
    fp32: |diff| <= 1e-4 (fp32 sums of 64-128 terms in other orders);
  * data and checkpoints: exactly equal.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ref as JR
from repro.models import model as JM
from repro.serving import neural_planner as JN
from repro.training import checkpoint as JC
from repro.training import data as JD
from repro.training import optimizer as JO
from repro_torch.configs import get_smoke_config
from repro_torch.env.tasks import make_benchmark
from repro_torch.env.world import build_world
from repro_torch.kernels import backend as KB
from repro_torch.kernels.flash_prefill import flash_prefill_bwd
from repro_torch.kernels import ref as TR
from repro_torch.kernels.ref import attention_bwd_ref
from repro_torch.launch import train as LT
from repro_torch.launch import train_planner as LTP
from repro_torch.models import model as TM
from repro_torch.models.convert import _walk, params_from_numpy, \
    params_to_numpy
from repro_torch.serving import neural_planner as TN
from repro_torch.training import checkpoint as TC
from repro_torch.training import data as TD
from repro_torch.training import optimizer as TO
from repro_torch.training.loop import train

ARCH = "planner-proxy-100m"
LOSS_TOL = 2e-2
GRAD_REL = 3e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: under the suite's parallel workers a thread
    pool a worker oversubscribes the cores, and the port's small CPU
    steps then take seconds each (the JAX side keeps its own threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's weights, a batch of its packed synthetic data, and its loss
    and gradients (one jitted value_and_grad, remat off)."""
    jcfg = jax_smoke(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    batch = next(JD.PackedLMDataset(JD.synthetic_docs(jcfg.vocab_size, 0),
                                    4, 64, jcfg.vocab_size))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JM.train_loss(p, jcfg, batch, remat=False)))(jp)
    return jcfg, jp, batch, float(loss), grads


def _bridged(jp):
    model = params_from_numpy(jax.tree.map(np.asarray, jp),
                              get_smoke_config(ARCH), "cpu")
    return model.requires_grad_(True)


def _jax_leaf(flat, name):
    """The JAX tree's leaf (stacked layers sliced) of a port name."""
    if name.startswith("layers."):
        parts = name.split(".")
        return flat["segments/0/0/" + "/".join(parts[2:])][int(parts[1])]
    return flat[name.replace(".", "/")]


def _flat(tree):
    return dict(_walk(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   tree), ""))


@pytest.fixture(scope="module")
def port_grads(jax_run):
    """The port's loss and bf16 gradients by name, without and with
    remat, on the bridged weights and JAX's batch."""
    _, jp, batch, _, _ = jax_run
    model = _bridged(jp)
    params = dict(model.named_parameters())
    out = {}
    for remat in (False, True):
        loss = TM.train_loss(model, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(params.values()))
        out[remat] = (float(loss.detach()), dict(zip(params, grads)))
    return out


def test_train_loss_matches_the_reference(jax_run, port_grads):
    jloss = jax_run[3]
    for remat in (False, True):
        assert abs(port_grads[remat][0] - jloss) <= LOSS_TOL


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_the_reference(jax_run, port_grads, remat):
    flat = _flat(jax_run[4])
    grads = port_grads[remat][1]
    assert len(grads) == 20 and len(flat) == 11     # 2 layers stacked
    for name, g in grads.items():
        assert g.dtype == torch.bfloat16
        j = _jax_leaf(flat, name)
        rel = np.linalg.norm(g.float().numpy() - j) / np.linalg.norm(j)
        assert rel <= GRAD_REL, (name, rel)


def test_remat_gradients_are_bitwise_equal(port_grads):
    assert port_grads[False][0] == port_grads[True][0]
    for name, g in port_grads[False][1].items():
        assert torch.equal(g, port_grads[True][1][name]), name


def test_train_path_runs_the_autograd_function_on_cpu(jax_run):
    """With grad the attention goes through FlashPrefillFn (its backward
    the plain version on the CPU: no launch counted); without grad it is
    the direct call, as serving's."""
    _, jp, batch, _, _ = jax_run
    model = _bridged(jp)
    KB.reset_launches()
    loss = TM.train_loss(model, batch, remat=False)
    fn = loss.grad_fn
    seen, stack = set(), [fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        stack += [g for g, _ in f.next_functions]
    assert any("FlashPrefillFn" in type(f).__name__ for f in seen)
    loss.backward()
    assert set(KB.launch_counts().values()) == {0}
    with torch.no_grad():
        assert TM.train_loss(model, batch, remat=False).grad_fn is None


def _bf16_steps(a, b):
    """|a - b| in bf16 steps of two fp32 arrays holding bf16 values."""
    def ordered(x):
        bits = x.astype(np.float32).view(np.int32) >> 16
        return np.where(bits < 0, -(bits & 0x7FFF), bits).astype(np.int64)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("grad_clip", [10.0, 1.0])
def test_adamw_step_matches_the_reference(jax_run, grad_clip):
    """At grad_clip 10 the norm (2.73) does not clip: m and v within 1e-6
    relative. At 1.0 every gradient is scaled by 1 / norm, and JAX's
    fp32 norm sums 2M squares in an order that leaves it ~9e-7 from the
    exact value (the port's torch.sum: ~1e-9), so m, scaled once, and v,
    twice, may differ by that much more: 1e-6 + 2 |norm ratio - 1|.
    JAX's function runs eagerly, op by op as written: under jit, XLA's
    CPU fusion moves parameters near 0 (where p - lr u cancels) by up to
    29 bf16 steps from its own eager result."""
    _, jp, _, _, jgrads = jax_run
    jnew, jstate, jnorm = JO.adamw_update(jp, jgrads, JO.adamw_init(jp),
                                          lr=1e-3, grad_clip=grad_clip)
    model = _bridged(jp)
    gflat = _flat(jgrads)
    grads = {n: torch.from_numpy(_jax_leaf(gflat, n)).to(torch.bfloat16)
             for n, _ in model.named_parameters()}
    _, state, gnorm = TO.adamw_update(model, grads, TO.adamw_init(model),
                                      lr=1e-3, grad_clip=grad_clip)
    assert state.step == int(jstate.step) == 1
    ratio = float(gnorm) / float(jnorm)
    assert abs(ratio - 1) <= 1e-6
    rtol = 1e-6 if float(jnorm) < grad_clip else 1e-6 + 2 * abs(ratio - 1)
    for tree, got in ((jstate.m, state.m), (jstate.v, state.v)):
        flat = _flat(tree)
        for n, t in got.items():
            np.testing.assert_allclose(t.numpy(), _jax_leaf(flat, n),
                                       rtol=rtol, atol=0, err_msg=n)
    pflat = _flat(jnew)
    for n, p in model.named_parameters():
        steps = _bf16_steps(p.detach().float().numpy(), _jax_leaf(pflat, n))
        assert steps.max() <= 1, n


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 99, 100, 150])
def test_cosine_lr_matches_the_reference(step):
    kw = dict(base_lr=3e-4, warmup=10, total=100)
    want = float(JO.cosine_lr(jnp.asarray(step, jnp.int32), **kw))
    got = float(TO.cosine_lr(step, **kw))
    assert abs(got - want) <= 1e-7 * abs(want)


def test_adamw_updates_all_leaves():
    """The JAX package's test_serving.py case on the port."""
    model = TM.init_params(get_smoke_config(ARCH), seed=0, device="cpu")
    before = {n: p.clone() for n, p in model.named_parameters()}
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    _, state2, gnorm = TO.adamw_update(model, grads, TO.adamw_init(model),
                                       lr=1e-2)
    assert all(bool(torch.any(p != before[n]))
               for n, p in model.named_parameters())
    assert float(gnorm) > 0
    assert state2.step == 1


def test_training_reduces_loss():
    """The JAX package's test_serving.py case on the port."""
    cfg = get_smoke_config(ARCH)
    data = TD.PackedLMDataset(TD.synthetic_docs(cfg.vocab_size, seed=0), 4,
                              64, cfg.vocab_size)
    _, _, hist = train(cfg, iter(data), n_steps=30, lr=1e-3, log_every=29,
                       device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.1, hist


def test_packed_data_is_the_reference():
    for seed, mask in ((0, False), (3, True)):
        t = TD.PackedLMDataset(TD.synthetic_docs(8192, seed), 3, 40, 8192,
                               mask_boundaries=mask)
        j = JD.PackedLMDataset(JD.synthetic_docs(8192, seed), 3, 40, 8192,
                               mask_boundaries=mask)
        for _ in range(4):
            a, b = next(t), next(j)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])


def test_intent_dataset_is_the_reference():
    tasks = make_benchmark(build_world(0, n_images=200), 40, seed=1)
    t = TN.make_intent_dataset(tasks, seq_len=64, batch=16)
    j = JN.make_intent_dataset(tasks, seq_len=64, batch=16)
    for _ in range(3):
        a, b = next(t), next(j)
        for k in ("tokens", "labels"):
            assert isinstance(a[k], np.ndarray) and a[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_port_checkpoint_is_read_by_the_reference(jax_run, tmp_path):
    _, jp, _, _, _ = jax_run
    model = TM.init_params(get_smoke_config(ARCH), seed=3, device="cpu")
    path = str(tmp_path / "port.npz")
    TC.save_checkpoint(path, model)
    assert not os.path.exists(path + ".tmp")
    loaded = JC.load_checkpoint(path, jp)
    want = dict(_walk(params_to_numpy(model), ""))
    got = _flat(loaded)
    assert set(got) == set(want)
    for k, a in want.items():
        assert a.dtype == np.float32
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    assert jax.tree.leaves(loaded)[0].dtype == jnp.bfloat16


def test_reference_checkpoint_is_read_by_the_port(jax_run, tmp_path):
    _, jp, _, _, _ = jax_run
    path = str(tmp_path / "jax.npz")
    JC.save_checkpoint(path, jp)
    model = TC.load_checkpoint(path, get_smoke_config(ARCH), "cpu")
    got = dict(_walk(params_to_numpy(model), ""))
    want = _flat(jp)
    assert set(got) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)


@pytest.mark.parametrize("G,window,cap,hd", [
    (1, 0, 0.0, 64), (3, 0, 0.0, 64), (2, 5, 0.0, 32), (2, 0, 20.0, 128),
    (4, 7, 30.0, 64)])
def test_attention_bwd_ref_is_jax_grad_of_the_oracle(G, window, cap, hd):
    rng = np.random.default_rng(G * 100 + hd)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    B, Hkv, S = 2, 2, 19
    q, k, v = mk(B, Hkv * G, S, hd), mk(B, Hkv, S, hd), mk(B, Hkv, S, hd)
    do = mk(B, Hkv * G, S, hd)
    kw = dict(causal=True, window=window, cap=cap)
    f = lambda a, b, c: jnp.sum(JR.attention_ref(a, b, c, **kw) * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    got = attention_bwd_ref(*map(torch.from_numpy, (q, k, v, do)), **kw)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=0)
    # the wrapper on a CPU tensor is this plain version
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    wrapped = flash_prefill_bwd(tq, tk, tv, TR.attention_ref(tq, tk, tv,
                                                             **kw), tdo,
                                **kw)
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)


def test_backward_refuses_a_q_offset():
    q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError, match="q_offset"):
        flash_prefill_bwd(q, q, q, q, q, q_offset=3)
    with pytest.raises(ValueError, match="no kernel for device"):
        m = torch.zeros(1, 2, 4, 32, device="meta")
        flash_prefill_bwd(m, m, m, m, m)


def test_params_to_numpy_inverts_the_bridge(jax_run):
    _, jp, _, _, _ = jax_run
    tree = params_to_numpy(_bridged(jp))
    want = _flat(jp)
    got = dict(_walk(tree, ""))
    assert set(got) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)


def test_train_launcher_cli_and_serve_of_its_checkpoint(tmp_path, capsys):
    from repro_torch.launch import serve as LS
    ck = str(tmp_path / "lm.npz")
    res = LT.main(["--device", "cpu", "--smoke", "--local", "--steps", "3",
                   "--batch", "2", "--seq", "32", "--log-every", "2",
                   "--remat", "--checkpoint", ck])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     2 loss" in out
    assert "tok/s" in out and os.path.exists(ck)
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    served = LS.main(["--device", "cpu", "--smoke", "--checkpoint", ck,
                      "--requests", "2", "--max-new", "3"])
    assert served["requests"] == 2


def test_train_launcher_refuses_multi_pod():
    with pytest.raises(NotImplementedError, match="A13"):
        LT.main(["--device", "cpu", "--smoke", "--multi-pod"])


def test_train_refuses_other_families():
    model = TM.init_params(get_smoke_config("xlstm-125m"), seed=0,
                           device="cpu").requires_grad_(True)
    batch = {"tokens": np.ones((1, 8), np.int32),
             "labels": np.ones((1, 8), np.int32)}
    with pytest.raises(NotImplementedError, match="A11.2"):
        TM.train_loss(model, batch, remat=False)


def test_train_planner_cli(tmp_path, capsys):
    ck = str(tmp_path / "gate.npz")
    res = LTP.main(["--device", "cpu", "--steps", "2", "--eval-tasks", "4",
                    "--checkpoint", ck])
    out = capsys.readouterr().out
    assert "neural gate intent accuracy" in out and "tokens/task" in out
    assert 0.0 <= res["accuracy"] <= 1.0 and res["eval_tasks"] == 4
    assert len(res["losses"]) == 2
    model = TC.load_checkpoint(ck, get_smoke_config(ARCH), "cpu")
    assert TM.count_params(model) > 0
