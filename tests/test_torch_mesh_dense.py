"""The port's mesh path on a 4-rank CPU mesh (gloo), the dense stacks:
the planner, qwen1.5-32b, qwen1.5-110b, starcoder2-3b and gemma2-2b on a
(2, 2) mesh (q and K/V heads over ``model``), and the planner on a
(1, 4) mesh in the three other attention layouts (q heads over
``model`` with K/V replicated; 6 heads: the batch spread over
``model``, or pinned alone); and the expert-parallel MoE dispatch
against the one dispatch and against the JAX package's shard_map
dispatch where capacity drops choices. Each run is held against the
unsharded port and against the JAX package on the same weights and
batches (``torch_mesh_common.py`` has the harness, the bounds and their
reasons)."""
import pytest

import torch_mesh_common as C

CASES = ("planner-proxy-100m", "qwen1.5-32b", "qwen1.5-110b",
         "starcoder2-3b", "gemma2-2b", "planner_kv_replicated",
         "planner_heads6_spread", "planner_heads6_batch")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return C.run_mesh(CASES, tmp_path_factory.mktemp("mesh"), ep=True)


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
    """prefill(..., seq_axis="model") pins the residual stream's seq dim
    over model between layers; each piece gathers what it needs, so the
    logits are the mesh prefill's, bitwise."""
    assert runs[case]["seq_parallel"] == 0.0


@pytest.mark.parametrize("case", CASES)
def test_decode_cache_is_seq_sharded_over_model(runs, case):
    """The cache keeps its rule's layout (batch over data, seq over
    model) through the decode steps."""
    mesh = runs[case]["mesh"]
    assert runs[case]["cache_placements"] == (
        "(Shard(dim=0), Shard(dim=2))")
    assert mesh == list(C.CASES[case][1])


@pytest.mark.parametrize("dispatch", ["shard_map", "gather"])
def test_expert_parallel_dispatch_matches_the_one_dispatch(runs, dispatch):
    """fp32, capacity factor 8: outputs within 2e-4, the expert stacks'
    gradients within 5e-4, the load-balance term within 1e-5 relative
    (JAX's tests/test_moe_shard_map.py bounds); "gather" under the mesh
    is the one dispatch with every expert on each rank."""
    r = runs["ep"][dispatch]
    assert r["y"] <= 2e-4 and r["grad"] <= 5e-4, r
    assert r["aux"] <= 1e-5, r


def test_expert_parallel_dispatch_matches_jax_under_drops(runs):
    """fp32, capacity factor 1 on the (2, 2) mesh: each ``model`` rank
    counts capacity over its data shard's 32 tokens, as JAX's
    ``_dispatch_shard_map`` on a (2, 2) host mesh does, and drops the
    same choices: outputs within 2e-4, the expert stacks' gradients
    within 5e-4, the load-balance term within 1e-5 relative. JAX's run
    drops (it is off its capacity-8 output by far more than the bound),
    and the one dispatch, whose capacity is counted per row, lands
    elsewhere, so the check sees the capacity rule."""
    r = runs["ep_jax"]
    assert r["y"] <= 2e-4 and r["grad"] <= 5e-4, r
    assert r["aux"] <= 1e-5, r
    assert r["jax_dropped"] > 1e-2, r
    assert r["one_dispatch"] > 1e-2, r
