"""The port's sharding rules (``repro_torch/distributed/sharding.py``)
against the JAX package's, at full width, with no process group.

For every config of ``ARCH_IDS`` and the planner, on the production
meshes ((16, 16) and (2, 16, 16): ``AbstractMesh`` on the JAX side,
``MeshShape`` on the port's), each port tensor's spec is JAX's spec of
its bridged leaf without the stack axis: the parameters (default
strategy, ``fsdp=False``, ``shard_vocab=False``), the ZeRO-1 optimizer
state, every ``INPUT_SHAPES`` batch, every decode cache under each
``decode_cache_seq`` and the logits. Per-rank parameter bytes equal
those JAX's specs give, exactly. JAX's own rule cases
(``tests/test_sharding.py``) are carried over, as are
``batch_struct``/``cache_struct`` against JAX's, ``profiles.resolve``
and ``parse_strategy``.
"""
import functools

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh

from repro.common.config import INPUT_SHAPES as JAX_SHAPES
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.distributed import sharding as jshd
from repro.launch import profiles as jprof
from repro.models import inputs as jinp
from repro.models.model import param_shapes as jax_param_shapes
from repro.training.optimizer import adamw_init as jax_adamw_init

from repro_torch.common.config import INPUT_SHAPES
from repro_torch.common.perf import PerfFlags, split_overrides
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import profiles as prof
from repro_torch.models import inputs as inp
from repro_torch.models.convert import jax_leaf, layer_slot
from repro_torch.models.model import param_shapes

CONFIGS = ARCH_IDS + ("planner-proxy-100m",)
JMESH = {"single": AbstractMesh((16, 16), ("data", "model")),
         "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
MESH = {"single": shd.MeshShape(("data", "model"), (16, 16)),
        "multi": shd.MeshShape(("pod", "data", "model"), (2, 16, 16))}
STRATEGIES = {"default": shd.ShardingStrategy(),
              "no_fsdp": shd.ShardingStrategy(fsdp=False),
              "no_vocab": shd.ShardingStrategy(shard_vocab=False)}
GIB = 2 ** 30


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax_param_shapes(jax_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return param_shapes(get_config(arch))


def _jax_at(tree, keys):
    for k in keys:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _jspec(sharding_or_spec):
    spec = getattr(sharding_or_spec, "spec", sharding_or_spec)
    return tuple(spec)


def _port_vs_jax_param_specs(arch, mesh_name, strategy, opt=False):
    cfg, jcfg = get_config(arch), jax_config(arch)
    model, jtree = _port_params(arch), _jax_params(arch)
    mesh, jmesh = MESH[mesh_name], JMESH[mesh_name]
    if opt:
        specs = shd.opt_state_sharding(model, cfg, mesh, strategy)["m"]
        jopt = jax.eval_shape(jax_adamw_init, jtree)
        jsh = jshd.opt_state_sharding(jopt, jtree, jcfg, jmesh, strategy_j(
            strategy))
        jspecs = jsh.m
    else:
        specs = shd.params_sharding(model, cfg, mesh, strategy)
        jspecs = None
    n = 0
    for name, t in model.named_parameters():
        keys, r = jax_leaf(cfg, name)
        leaf = _jax_at(jtree, keys)
        if jspecs is None:
            js = jshd.param_spec(keys, leaf, jcfg, jmesh, strategy_j(strategy))
        else:
            js = _jax_at(jspecs, keys).spec
        js = _jspec(js)
        if r is not None:
            assert js[0] is None and leaf.shape[1:] == tuple(t.shape), name
            js = js[1:]
        else:
            assert leaf.shape == tuple(t.shape), name
        assert specs[name] == js, (name, specs[name], js)
        n += 1
    return n


def strategy_j(s: shd.ShardingStrategy) -> jshd.ShardingStrategy:
    return jshd.ShardingStrategy(**s.__dict__)


def test_arch_ids_are_jax_arch_ids():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert {k: v.__dict__ for k, v in INPUT_SHAPES.items()} == {
        k: v.__dict__ for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("mesh", list(MESH))
@pytest.mark.parametrize("arch", CONFIGS)
def test_param_specs_equal_jax(arch, mesh, strategy):
    n = _port_vs_jax_param_specs(arch, mesh, STRATEGIES[strategy])
    assert n == len(list(_port_params(arch).parameters()))


@pytest.mark.parametrize("strategy", ["default", "no_fsdp"])
@pytest.mark.parametrize("mesh", list(MESH))
@pytest.mark.parametrize("arch", CONFIGS)
def test_opt_state_specs_equal_jax(arch, mesh, strategy):
    """ZeRO-1: m and v take the fsdp specs even without fsdp."""
    _port_vs_jax_param_specs(arch, mesh, STRATEGIES[strategy], opt=True)


def _param_bytes(arch, mesh_name, strategy):
    cfg, model = get_config(arch), _port_params(arch)
    specs = shd.params_sharding(model, cfg, MESH[mesh_name], strategy)
    return sum(shd.local_bytes(t, specs[n], MESH[mesh_name])
               for n, t in model.named_parameters())


def _jax_param_bytes(arch, mesh_name, strategy):
    jtree, jmesh = _jax_params(arch), JMESH[mesh_name]
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    total = 0
    for path, leaf in flat:
        keys = tuple(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", k))))
                     for k in path)
        spec = jshd.param_spec(keys, leaf, jax_config(arch), jmesh,
                               strategy_j(strategy))
        n = 1
        for ax in spec:
            n *= jshd._axis_size(jmesh, ax)
        total += leaf.size * leaf.dtype.itemsize // n
    return total


@pytest.mark.parametrize("mesh", list(MESH))
@pytest.mark.parametrize("arch", CONFIGS)
def test_param_bytes_per_rank_equal_jax(arch, mesh):
    st_ = shd.ShardingStrategy()
    assert _param_bytes(arch, mesh, st_) == _jax_param_bytes(arch, mesh, st_)


@pytest.mark.parametrize("arch,mesh,gib", [
    ("kimi-k2-1t-a32b", "single", 7.77), ("kimi-k2-1t-a32b", "multi", 7.77),
    ("arctic-480b", "single", 3.87), ("qwen1.5-110b", "single", 0.81),
    ("qwen2-vl-72b", "single", 0.53)])
def test_param_bytes_per_rank_known(arch, mesh, gib):
    assert round(_param_bytes(arch, mesh, shd.ShardingStrategy()) / GIB,
                 2) == gib


@pytest.mark.parametrize("mesh", list(MESH))
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", CONFIGS)
def test_batch_struct_and_specs_equal_jax(arch, shape, mesh):
    cfg, jcfg = get_config(arch), jax_config(arch)
    b = inp.batch_struct(cfg, INPUT_SHAPES[shape])
    jb = jinp.batch_struct(jcfg, JAX_SHAPES[shape])
    assert list(b) == list(jb)
    for k in b:
        assert tuple(b[k].shape) == jb[k].shape, k
        assert str(b[k].dtype).split(".")[-1] == str(jb[k].dtype), k
    for strategy in (shd.ShardingStrategy(),
                     shd.ShardingStrategy(prefill_seq_axis="model")):
        specs = shd.batch_sharding(b, cfg, INPUT_SHAPES[shape], MESH[mesh],
                                   strategy)
        jsp = jshd.batch_sharding(jb, jcfg, JAX_SHAPES[shape], JMESH[mesh],
                                  strategy_j(strategy))
        assert specs == {k: _jspec(v) for k, v in jsp.items()}


@functools.lru_cache(maxsize=None)
def _caches(arch, shape):
    return (inp.cache_struct(get_config(arch), INPUT_SHAPES[shape]),
            jinp.cache_struct(jax_config(arch), JAX_SHAPES[shape]))


def _leaves(tree, path=()):
    """{path: leaf} of a port tree (dicts, lists, tuples; a spec tuple of
    names or None is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (str(k),)))
        return out
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree and all(
            hasattr(e, "shape") or isinstance(e, (dict, list, tuple))
            for e in tree)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, path + (str(i),)))
        return out
    return {path: tree}


def _jleaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name",
                                                getattr(k, "idx", k))))
                  for k in p): v for p, v in flat}


@pytest.mark.parametrize("seq", ["model", "data", "both", "none"])
@pytest.mark.parametrize("mesh", list(MESH))
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", CONFIGS)
def test_cache_struct_and_specs_equal_jax(arch, shape, mesh, seq):
    cfg, jcfg = get_config(arch), jax_config(arch)
    cache, jcache = _caches(arch, shape)
    strategy = shd.ShardingStrategy(decode_cache_seq=seq)
    specs = shd.cache_sharding(cache, cfg, INPUT_SHAPES[shape], MESH[mesh],
                               strategy)
    jspecs = jshd.cache_sharding(jcache, jcfg, JAX_SHAPES[shape],
                                 JMESH[mesh], strategy_j(strategy))
    assert specs["pos"] == _jspec(jspecs["pos"]) == ()
    assert tuple(cache["pos"].shape) == jcache["pos"].shape
    n = 0
    for i, layer in enumerate(cache["layers"]):
        si, ui, _ = layer_slot(cfg, i)
        jl = _jleaves(jcache["segments"][si][ui])
        js = _jleaves(jspecs["segments"][si][ui])
        pl, sp = _leaves(layer), _leaves(specs["layers"][i])
        assert set(jl) == set(js) == set(pl) == set(sp), i
        for path, t in pl.items():
            assert jl[path].shape == (jl[path].shape[0],) + tuple(t.shape)
            assert jl[path].dtype.name == str(t.dtype).split(".")[-1]
            jsp = _jspec(js[path])
            assert jsp[0] is None and sp[path] == jsp[1:], (i, path)
            n += 1
    assert n


@pytest.mark.parametrize("mesh", list(MESH))
@pytest.mark.parametrize("arch", CONFIGS)
def test_logits_specs_equal_jax(arch, mesh):
    for shape in INPUT_SHAPES:
        for strategy in STRATEGIES.values():
            assert shd.logits_sharding(
                get_config(arch), INPUT_SHAPES[shape], MESH[mesh],
                strategy) == _jspec(jshd.logits_sharding(
                    jax_config(arch), JAX_SHAPES[shape], JMESH[mesh],
                    strategy_j(strategy)))


# ------------------------------------------- the JAX package's own cases ----

def _axis_prod(mesh, axes):
    return shd._axis_size(mesh, axes)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", list(MESH))
def test_param_specs_divisible(arch, mesh):
    """Every sharded dim divides by its mesh-axis product, and something
    is sharded."""
    cfg, m = get_config(arch), MESH[mesh]
    specs = shd.params_sharding(_port_params(arch), cfg, m,
                                shd.ShardingStrategy())
    n_sharded = 0
    for name, t in _port_params(arch).named_parameters():
        spec = specs[name]
        assert len(spec) == t.ndim
        for dim, axes in zip(t.shape, spec):
            assert dim % _axis_prod(m, axes) == 0, (name, spec)
            n_sharded += _axis_prod(m, axes) > 1
    assert n_sharded > 0


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "arctic-480b"])
def test_big_models_fully_sharded(arch):
    """>=100 B configs shard every >256 MB weight 16 ways or more."""
    cfg, model = get_config(arch), _port_params(arch)
    specs = shd.params_sharding(model, cfg, MESH["single"],
                                shd.ShardingStrategy(fsdp=True))
    for name, t in model.named_parameters():
        if t.numel() * 2 > 2 ** 28:
            assert shd.shard_factor(specs[name], MESH["single"]) >= 16, name


def test_moe_experts_sharded_over_model():
    cfg, model = get_config("kimi-k2-1t-a32b"), _port_params(
        "kimi-k2-1t-a32b")
    specs = shd.params_sharding(model, cfg, MESH["single"],
                                shd.ShardingStrategy())
    assert specs["layers.1.moe.w_gate"][0] == "model"
    assert specs["layers.1.moe.w_down"] == ("model", None, "data")


def test_kv_not_divisible_stays_replicated():
    cfg = get_config("hymba-1.5b")
    leaf = np.empty((1600, 5 * 13), np.float32)
    spec = shd.param_spec(("segments", "0", "0", "attn", "wk"), leaf, cfg,
                          MESH["single"], shd.ShardingStrategy(fsdp=False))
    assert spec == (None, None)


@given(st.integers(1, 4096))
@settings(max_examples=100, deadline=None)
def test_fit_always_divides(dim):
    axes = shd._fit(MESH["single"], dim, ("data", "model"))
    assert dim % _axis_prod(MESH["single"], axes) == 0
    assert axes == jshd._fit(JMESH["single"], dim, ("data", "model"))


def test_batch_sharding_decode_batch_one():
    cfg = get_smoke_config("gemma2-2b")
    batch = {"tokens": np.empty((1, 1), np.int32)}
    sh = shd.batch_sharding(batch, cfg, INPUT_SHAPES["long_500k"],
                            shd.MeshShape(("data", "model"), (1, 1)),
                            shd.ShardingStrategy())
    assert sh["tokens"] == (None, None)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    m = MESH["multi"]
    assert shd.placements((("pod", "data"), "model"), m) == [
        Shard(0), Shard(0), Shard(1)]
    assert shd.placements((None, None), m) == [Replicate()] * 3
    assert shd.placements(("model", "data"), MESH["single"]) == [
        Shard(1), Shard(0)]
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements((("model", "data"),), MESH["single"])


# ------------------------------------------------ profiles and strategies ----

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_profiles_resolve_equal_jax(arch):
    for shape in INPUT_SHAPES:
        perf, strategy = prof.resolve(arch, shape)
        assert (perf, strategy) == jprof.resolve(arch, shape)
        kept, dropped = split_overrides(perf)
        PerfFlags().apply_overrides(kept)            # must not raise
        assert "attn_chunk_remat" in dropped


def test_profile_tables_equal_jax():
    assert prof.BASE_PERF == jprof.BASE_PERF
    assert prof.ARCH_PERF == jprof.ARCH_PERF
    assert prof.PAIR_OVERRIDES == jprof.PAIR_OVERRIDES


def test_perf_flags_overrides():
    f = PerfFlags().apply_overrides("moe_dispatch=shard_map,attn_chunk=4096")
    assert f.moe_dispatch == "shard_map" and f.attn_chunk == 4096
    with pytest.raises(ValueError, match="unknown perf flag"):
        PerfFlags().apply_overrides("no_such_flag=1")
    with pytest.raises(ValueError, match="JAX package's only"):
        PerfFlags().apply_overrides("kernel_backend=pallas")
    with pytest.raises(ValueError, match="moe_dispatch"):
        PerfFlags().apply_overrides("moe_dispatch=alltoall")
    kept, dropped = split_overrides(jprof.resolve("kimi-k2-1t-a32b",
                                                  "train_4k")[0])
    assert kept == "moe_dispatch=shard_map"
    assert set(dropped) == {"attn_constraint", "attn_chunk_remat",
                            "moe_constraint", "attn_window_slice",
                            "ssm_scan_chunk"}


def test_parse_strategy():
    from repro_torch.launch.dryrun import parse_strategy
    s = parse_strategy("prefill_seq_axis=model,fsdp=False")
    assert s.prefill_seq_axis == "model"
    assert s.fsdp is False
    assert parse_strategy("").fsdp is True
