"""Training of the port's qwen2-vl and whisper stacks against the JAX
package's reference backend, at the model level as the JAX package
trains them (``tests/test_arch_smoke.py``; its launcher feeds only
tokens and labels, so the port's refuses both families): qwen2-vl-smoke
(16 patch embeddings spliced over the first rows, M-RoPE ids of the
text layout and of a 4 x 4 patch grid, whose three rows differ) and
whisper-smoke (its encoder over 64 frames, 16 decoder ids
cross-attending to it), on ``models/inputs.py:make_batch`` batches (the
JAX package's draws) and the same weights: JAX ``init_params`` with its
biases and norm scales redrawn non-zero
(``torch_multimodal_common.redrawn``), given to the port through the
weight bridge.

Tolerances are those of ``torch_train_common.py`` (the loss 2e-2, each
gradient leaf 3e-2 relative norm); remat and no remat bitwise equal in
the port. The patch rows send no gradient to the embedding, the
encoder's weights get theirs through the cross-attention, and
``training/loop.py``'s ``make_train_step`` lowers the loss of a fixed
``make_batch`` batch over 8 steps; ``launch.train.train_run`` steps
through the batches it is given as ``make_train_step`` does.
"""
import numpy as np
import pytest
import torch

import jax

import torch_multimodal_common as MC
import torch_train_common as TT
from repro.models import model as JM
from repro_torch.models import model as TM
from repro_torch.models.inputs import grid_mrope_pos, make_batch
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import adamw_init

VLM, WHISPER = "qwen2-vl-72b", "whisper-large-v3"
# (case, arch): qwen2-vl under the text and the grid layout, whisper
CASES = {"vlm_text": VLM, "vlm_grid": VLM, "whisper": WHISPER}
B, S, GRID = 2, 64, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread (``test_torch_training.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, case):
    """``make_batch``'s train batch (seed 1); the grid case's M-RoPE ids
    on a GRID-wide patch grid."""
    batch = make_batch(cfg, "train", B, S, seed=1)
    if case == "vlm_grid":
        batch["mrope_pos"] = grid_mrope_pos(B, S, cfg.n_vision_tokens, GRID)
    return batch


@pytest.fixture(scope="module")
def runs():
    """Each case's JAX loss and gradients (one jitted value_and_grad)
    and the port's with and without remat, on the redrawn weights."""
    out, bridged = {}, {}
    for case, arch in CASES.items():
        if arch not in bridged:
            bridged[arch] = MC.bridged(arch)
        jcfg, jp, model = bridged[arch]
        batch = _batch(model.cfg, case)
        jb = MC._jax_batch(batch)
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: JM.train_loss(p, jcfg, jb, remat=False)))(jp)
        model.requires_grad_(True)
        out[case] = dict(cfg=model.cfg, model=model, batch=batch,
                         jloss=float(jloss), jgrads=jgrads,
                         pg=TT.port_grads(model, batch))
    return out


def test_the_batches_hold_the_family_inputs(runs):
    vlm, grid = runs["vlm_text"]["batch"], runs["vlm_grid"]["batch"]
    nv = runs["vlm_text"]["cfg"].n_vision_tokens
    assert tuple(vlm["patch_embeds"].shape) == (B, nv, 128)
    assert not torch.equal(grid["mrope_pos"][1], grid["mrope_pos"][2])
    assert grid["mrope_pos"].dtype == torch.long
    wb = runs["whisper"]["batch"]
    assert tuple(wb["frames"].shape) == (B, S, 128)
    assert tuple(wb["tokens"].shape) == tuple(wb["labels"].shape) == (B, 16)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_train_loss_matches_the_reference(runs, case, remat):
    r = runs[case]
    assert abs(r["pg"][remat][0] - r["jloss"]) <= TT.LOSS_TOL


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_the_reference(runs, case, remat):
    r = runs[case]
    rel = TT.grad_rel_errors(r["pg"][remat][1], r["jgrads"], r["cfg"])
    assert len(rel) == len(dict(r["model"].named_parameters()))
    bad = {n: e for n, e in rel.items() if e > TT.GRAD_REL}
    assert not bad, bad


@pytest.mark.parametrize("case", CASES)
def test_remat_gradients_are_bitwise_equal(runs, case):
    TT.assert_remat_bitwise(runs[case]["pg"])


def test_patch_rows_send_no_gradient_to_the_embedding(runs):
    """An id found only under the patches gets an exactly-zero embedding
    gradient (qwen2-vl's head is untied): the splice replaces those
    rows, as JAX's concatenate does."""
    r = runs["vlm_text"]
    nv = r["cfg"].n_vision_tokens
    tokens = r["batch"]["tokens"].clone()
    tokens[tokens == 7] = 8
    tokens[:, :nv] = 7
    batch = dict(r["batch"], tokens=tokens)
    model = r["model"]
    (g,) = torch.autograd.grad(TM.train_loss(model, batch, remat=False),
                               [model.embed])
    assert torch.count_nonzero(g[7]) == 0
    assert torch.count_nonzero(g[int(tokens[0, nv])]) > 0


def test_encoder_gradients_come_through_the_cross_attention(runs):
    """Every encoder leaf gets a non-zero gradient, and none does when
    the cross-attention's output projections are zero: the decoder
    reads the encoder only there."""
    r = runs["whisper"]
    grads = r["pg"][False][1]
    enc = [n for n in grads if n.startswith("encoder.")]
    assert enc and all(torch.count_nonzero(grads[n]) for n in enc)
    model = r["model"]
    saved = {n: p.detach().clone() for n, p in model.named_parameters()
             if n.endswith(".xattn.wo")}
    assert len(saved) == r["cfg"].n_layers
    params = dict(model.named_parameters())
    try:
        with torch.no_grad():
            for n in saved:
                params[n].zero_()
        gs = torch.autograd.grad(TM.train_loss(model, r["batch"],
                                               remat=False),
                                 [params[n] for n in enc],
                                 allow_unused=True)
    finally:
        with torch.no_grad():
            for n, t in saved.items():
                params[n].copy_(t)
    assert all(g is None or torch.count_nonzero(g) == 0 for g in gs)


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_make_train_step_lowers_the_loss(arch):
    """``make_train_step`` on a fixed ``make_batch`` batch (every key
    moved to the model's device inside the step), 8 AdamW steps from
    seed 0's weights: finite, falling."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    model = TM.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    step = make_train_step(cfg, lr=3e-3, remat=True)
    opt = adamw_init(model)
    batch = make_batch(cfg, "train", B, S, seed=2)
    losses = []
    for _ in range(8):
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert opt.step == 8


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_train_run_steps_through_the_batches_it_is_given(arch):
    """``launch.train.train_run`` with ``batches`` (a new ``make_batch``
    batch a step) draws one batch a step and gives the losses of
    ``make_train_step`` stepped by hand on the same batches from the
    same weights, bitwise."""
    import itertools
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import parse_args, train_run
    cfg = get_smoke_config(arch)
    drawn = []

    def batches():
        for i in itertools.count():
            drawn.append(i)
            yield make_batch(cfg, "train", B, S, seed=i)
    model = TM.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    res = train_run(cfg, model, parse_args(
        ["--steps", "3", "--batch", str(B), "--seq", str(S)]), batches())
    assert drawn == [0, 1, 2]
    ref = TM.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    step = make_train_step(cfg, lr=3e-4, remat=False)
    opt, losses = adamw_init(ref), []
    for i in range(3):
        ref, opt, metrics = step(ref, opt, make_batch(cfg, "train", B, S,
                                                      seed=i))
        losses.append(float(metrics["loss"]))
    assert res["losses"] == losses
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 ref.parameters()))
