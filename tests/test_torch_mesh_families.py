"""The port's mesh path on a 4-rank CPU mesh (gloo), (2, 2), the other
families: arctic-480b (cut to its one MoE layer) and kimi-k2-1t-a32b
under the MoE near-tie rule, hymba-1.5b (attention over heads, the SSM
batch-parallel), xlstm-125m (batch-parallel recurrences), qwen2-vl-72b
(M-RoPE, patch embeddings) and whisper-large-v3 (the encoder,
cross-attention). Each run is held against the unsharded port and
against the JAX package on the same weights and batches
(``torch_mesh_common.py`` has the harness, the bounds and their
reasons)."""
import pytest

import torch_mesh_common as C

CASES = ("arctic-480b", "kimi-k2-1t-a32b", "hymba-1.5b", "xlstm-125m",
         "qwen2-vl-72b", "whisper-large-v3")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return C.run_mesh(CASES, tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("case", CASES)
def test_train_loss_matches_unsharded(runs, case):
    assert runs[case]["loss"] <= C.BOUNDS["loss"], runs[case]


@pytest.mark.parametrize("case", CASES)
def test_every_gradient_leaf_matches_unsharded(runs, case):
    r = runs[case]
    bad = {n: e for n, e in r["grad_by_leaf"].items()
           if not e <= C.BOUNDS["grad"]}
    assert not bad and len(r["grad_by_leaf"]) > 10, bad


@pytest.mark.parametrize("case", CASES)
def test_adamw_step_matches_unsharded(runs, case):
    """One AdamW step on the DTensor gradients: the global gradient norm
    (over the whole sharded leaves) within the gradients' bound, every
    parameter within 2 lr (a flipped gradient sign) and one bf16 step,
    the parameters still laid out by the rules."""
    r = runs[case]
    assert r["grad_norm"] <= C.BOUNDS["grad"], r["grad_norm"]
    assert r["step_param_diff"] <= 2 * C.LR + 2 ** -7, r["step_param_diff"]
    assert r["params_stay_sharded"]


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_logits_match_unsharded(runs, case):
    r = runs[case]
    assert len(r["logits_by_step"]) == 1 + C.DECODE_STEPS
    assert r["logits"] <= C.BOUNDS["logits"], r["logits_by_step"]


@pytest.mark.parametrize("case", CASES)
def test_train_loss_matches_jax(runs, case):
    """The mesh run's loss against the JAX package's ``train_loss`` on
    the same weights and batch."""
    r = runs[case]["jax"]
    assert r["loss"] <= C.BOUNDS["loss"], r["loss"]


@pytest.mark.parametrize("case", CASES)
def test_every_gradient_leaf_matches_jax(runs, case):
    """Each DTensor gradient, gathered, against ``jax.value_and_grad``'s
    leaf (relative norm)."""
    r = runs[case]["jax"]
    bad = {n: e for n, e in r["grad_by_leaf"].items()
           if not e <= C.BOUNDS["grad"]}
    assert not bad and r["n_leaves"] > 10, bad


@pytest.mark.parametrize("case", CASES)
def test_adamw_step_matches_jax(runs, case):
    """The mesh run's AdamW step against JAX's ``adamw_update`` on JAX's
    gradients: the global norm within the gradients' bound, every
    parameter within 2 lr (a flipped gradient sign) and one bf16 step."""
    r = runs[case]["jax"]
    assert r["grad_norm"] <= C.BOUNDS["grad"], r["grad_norm"]
    assert r["step_param_diff"] <= 2 * C.LR + 2 ** -7, r["step_param_diff"]


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_logits_match_jax(runs, case):
    """The mesh prefill's and decode steps' logits against JAX's
    ``prefill`` and ``decode_step`` fed the same tokens."""
    r = runs[case]["jax"]
    assert len(r["logits_by_step"]) == 1 + C.DECODE_STEPS
    assert r["logits"] <= C.BOUNDS["logits"], r["logits_by_step"]


@pytest.mark.parametrize("case", CASES)
def test_sequence_parallel_prefill_is_the_mesh_prefill(runs, case):
    """prefill(..., seq_axis="model"): the residual stream pinned seq
    over model between layers gives the mesh prefill's logits, bitwise."""
    assert runs[case]["seq_parallel"] == 0.0


@pytest.mark.parametrize("case", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_near_ties_are_few(runs, case):
    r = runs[case]
    assert r["ties"] <= C.MAX_TIE_SHARE * r["rows"], r
    assert r["train_ties"] <= C.MAX_TIE_SHARE * r["train_tokens"], r


@pytest.mark.parametrize("case", [c for c in CASES if c != "xlstm-125m"])
def test_decode_cache_is_seq_sharded_over_model(runs, case):
    assert runs[case]["cache_placements"] == (
        "(Shard(dim=0), Shard(dim=2))")


def test_whisper_mesh_decode_refuses_past_its_decoder_cache(runs):
    """A mesh decode at a position past the 448-row decoder cache raises
    ValueError and writes nothing, as the plain ``decode_step`` does,
    whether ``pos`` is a per-row tensor (one row at 448), a replicated
    DTensor of it or an int."""
    r = runs["whisper-large-v3"]["decoder_cap"]
    assert r["rows"] == 448
    assert all("past the 448-row decoder cache" in e for e in r["errors"]), r
    assert len(r["errors"]) == 3 and r["untouched"], r
