"""Training of the port's dense A12 stacks against the JAX package's
reference backend: qwen1.5-32b-smoke (q/k/v biases, untied head),
qwen1.5-110b-smoke (the same with heads of 16), starcoder2-smoke
(``"local"`` layers over a 32-row window, the GELU MLP, biases) and
gemma2-smoke (``("local", "full")``, attention and final softcaps 50
and 30, GELU-GLU, the embedding scaled by sqrt(d)), B 2 x S 64 (past
the smoke window), on the same weights: JAX ``init_params`` with its
biases and norm scales redrawn non-zero
(``torch_multimodal_common.redrawn``), given to the port through the
weight bridge; JAX's own seeded packed data.

Tolerances are those of ``torch_train_common.py`` (the loss 2e-2, each
gradient leaf 3e-2 relative norm); remat and no remat bitwise equal in
the port. ``launch.train --device cpu --smoke`` trains each family: the
loss falls over 8 steps on its packed data.
"""
import numpy as np
import pytest
import torch

import torch_multimodal_common as MC
import torch_train_common as TT
from repro_torch.launch import train as LT

ARCHS = ("qwen1.5-32b", "qwen1.5-110b", "starcoder2-3b", "gemma2-2b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread (``test_torch_training.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """Each arch's JAX loss and gradients (one jitted value_and_grad)
    and the port's with and without remat, on the redrawn weights."""
    out = {}
    for arch in ARCHS:
        jcfg, jp, model = MC.bridged(arch)
        batch = TT.batch_of(jcfg)
        jloss, jgrads = TT.jax_value_and_grad(jcfg, jp, batch)
        model.requires_grad_(True)
        out[arch] = dict(cfg=model.cfg, model=model, jloss=jloss,
                         jgrads=jgrads, pg=TT.port_grads(model, batch))
    return out


def test_the_configs_reach_what_they_hold(runs):
    """Heads of 16, the window crossed, both caps, biases."""
    cfgs = {a: r["cfg"] for a, r in runs.items()}
    assert cfgs["qwen1.5-110b"].d_head == 16
    for arch in ("starcoder2-3b", "gemma2-2b"):
        assert "local" in cfgs[arch].layer_kinds()
        assert TT.S > cfgs[arch].window
    g = cfgs["gemma2-2b"]
    assert (g.attn_softcap, g.final_softcap) == (50.0, 30.0)
    assert g.emb_scale_by_sqrt_d and g.mlp_act == "gelu_glu"
    assert all(cfgs[a].qkv_bias for a in ARCHS[:3])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_the_reference(runs, arch, remat):
    r = runs[arch]
    assert abs(r["pg"][remat][0] - r["jloss"]) <= TT.LOSS_TOL


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_reference(runs, arch, remat):
    r = runs[arch]
    rel = TT.grad_rel_errors(r["pg"][remat][1], r["jgrads"], r["cfg"])
    assert len(rel) == len(dict(r["model"].named_parameters()))
    if r["cfg"].qkv_bias:
        assert any(n.endswith(".attn.bq") for n in rel)
    bad = {n: e for n, e in rel.items() if e > TT.GRAD_REL}
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bitwise_equal(runs, arch):
    TT.assert_remat_bitwise(runs[arch]["pg"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains_the_family(arch, capsys):
    res = LT.main(["--device", "cpu", "--smoke", "--arch", arch, "--steps",
                   "8", "--batch", "2", "--seq", "64", "--lr", "3e-3",
                   "--log-every", "4"])
    assert "step     7 loss" in capsys.readouterr().out
    losses = res["losses"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
