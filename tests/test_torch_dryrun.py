"""The port's dry-run (``launch/dryrun.py``), its meshes
(``launch/mesh.py``) and the one-rank local mesh, each in a subprocess
(a process group is per-process state):

  * ``run_one("gemma2-2b", "decode_32k", "single")`` on the fake
    (16, 16) mesh: ``ok``, the parameter bytes of the sharding rules
    (``test_torch_sharding.py`` holds those to JAX's), collectives
    counted, one rank's flops > 0 and below the step's unsharded count;
  * ``long_500k`` of a full-attention config skipped with JAX's reason;
  * ``make_production_mesh`` in one process raises, naming the ranks it
    needs; ``fake_mesh`` replaces a fake group and refuses to replace a
    real one;
  * on the (1, 1) local mesh (gloo, CPU) the planner's train steps
    through ``launch.train.train_run(mesh=...)``, its prefill and decode,
    and kimi-smoke's expert-parallel prefill (capacity factor 100) are
    bitwise the plain path's: the card's ``mesh_world1`` phase, here on
    the kernels' plain versions.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

DRYRUN = r"""
import json
from repro_torch.configs import get_config
from repro_torch.common.config import INPUT_SHAPES
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_mesh, teardown_fake
from repro_torch.models.model import param_shapes
rec = D.run_one("gemma2-2b", "decode_32k", "single", save=False,
                verbose=False)
cfg = get_config("gemma2-2b")
mesh = shd.MeshShape(("data", "model"), (16, 16))
m = param_shapes(cfg)
specs = shd.params_sharding(m, cfg, mesh, shd.ShardingStrategy())
rules = sum(shd.local_bytes(t, specs[n], mesh)
            for n, t in m.named_parameters())
glob = D.unsharded_flops(cfg, INPUT_SHAPES["decode_32k"])
skip = D.run_one("qwen1.5-32b", "long_500k", "single", save=False,
                 verbose=False)
refuse = ""
try:
    from repro_torch.launch.mesh import make_production_mesh
    make_production_mesh()
except RuntimeError as e:
    refuse = str(e)
m1 = fake_mesh((2, 2), ("data", "model"))
m2 = fake_mesh((16, 16), ("data", "model"))
replaced = m2.size() == 256
teardown_fake()
print("RESULT", json.dumps(dict(rec=rec, rules=rules, glob=glob, skip=skip,
                                refuse=refuse, replaced=replaced)))
"""

LOCAL = r"""
import json, types
import torch
from repro_torch.common.perf import PerfFlags, set_flags
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.parallel import distribute_model, full
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import fake_mesh, make_local_mesh
from repro_torch.models import model as MD
from repro_torch.models.inputs import make_batch
torch.set_num_threads(1)
mesh = make_local_mesh("cpu")
cfg = get_smoke_config("planner-proxy-100m")
args = types.SimpleNamespace(steps=3, batch=2, seq=32, lr=1e-3, remat=False,
                             log_every=10, checkpoint="")
runs = []
for m in (mesh, None):
    model = MD.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    r = LT.train_run(cfg, model, args, mesh=m)
    runs.append((r["losses"], {n: full(p).detach().clone()
                               for n, p in model.named_parameters()}))
out = {"losses": runs[0][0] == runs[1][0],
       "params": all(torch.equal(runs[0][1][n], runs[1][1][n])
                     for n in runs[1][1])}
ref = MD.init_params(cfg, seed=1, device="cpu")
dm = distribute_model(MD.init_params(cfg, seed=1, device="cpu"), cfg, mesh)
pb = make_batch(cfg, "prefill", 2, 14, seed=4)
lr, cr = MD.prefill(ref, pb, 24)
lm, cm = MD.prefill(dm, pb, 24)
eq = [torch.equal(full(lm), lr)]
for _ in range(4):
    db = {"tokens": torch.argmax(lr, -1)[:, None]}
    lr, cr = MD.decode_step(ref, cr, db)
    lm, cm = MD.decode_step(dm, cm, db)
    eq.append(torch.equal(full(lm), lr))
out["serve"] = eq
kc = get_smoke_config("kimi-k2-1t-a32b")
set_flags(PerfFlags(moe_capacity_factor=100.0))
ref = MD.init_params(kc, seed=2, device="cpu")
kb = make_batch(kc, "prefill", 2, 16, seed=5)
l1, _ = MD.prefill(ref, kb, 16)
set_flags(PerfFlags(moe_capacity_factor=100.0, moe_dispatch="shard_map"))
dm = distribute_model(MD.init_params(kc, seed=2, device="cpu"), kc, mesh)
l2, _ = MD.prefill(dm, kb, 16)
out["ep"] = torch.equal(full(l2), l1)
try:
    fake_mesh((2, 2), ("data", "model"))
except RuntimeError as e:
    out["fake_refused"] = str(e)
print("RESULT", json.dumps(out))
"""


def _run(code: str, timeout: int = 300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")]
    assert res.returncode == 0 and line, (res.stdout[-2000:],
                                         res.stderr[-4000:])
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def dry():
    return _run(DRYRUN)


@pytest.fixture(scope="module")
def local():
    return _run(LOCAL)


def test_dryrun_record_is_ok_with_rule_bytes(dry):
    rec = dry["rec"]
    assert rec["status"] == "ok" and rec["trace"] == "ok", rec
    assert rec["n_devices"] == 256
    assert rec["memory"]["argument_bytes"]["params"] == dry["rules"]
    assert rec["memory"]["temp_bytes"] is None
    assert "no compiler" in rec["memory"]["temp_reason"]


def test_dryrun_counts_collectives(dry):
    coll = dry["rec"]["collectives"]
    assert coll["collective_bytes"] > 0
    assert sum(v for k, v in coll.items() if k.startswith("count_")) >= 1


def test_dryrun_flops_are_one_ranks(dry):
    """Counted on local tensors: positive and below the step's
    unsharded count."""
    fl = dry["rec"]["flops"]
    assert 0 < fl < dry["glob"], (fl, dry["glob"])


def test_long_500k_skipped_with_jax_reason(dry):
    skip = dry["skip"]
    assert skip["status"] == "skipped"
    jax_src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    first = skip["reason"].split(":")[0]
    assert first in jax_src and "sub-quadratic attention" in jax_src
    assert skip["reason"] == (
        "full-attention architecture: long_500k requires sub-quadratic "
        "attention (DESIGN.md §Input-shape coverage)")


def test_production_mesh_needs_its_ranks(dry):
    assert "256 ranks" in dry["refuse"] and "world of 1" in dry["refuse"]


def test_fake_mesh_is_replaced(dry):
    assert dry["replaced"]


def test_fake_mesh_never_replaces_a_real_group(local):
    assert "a real process group runs" in local["fake_refused"]


def test_local_mesh_training_is_bitwise_plain(local):
    assert local["losses"] and local["params"]


def test_local_mesh_prefill_and_decode_are_bitwise_plain(local):
    assert all(local["serve"]) and len(local["serve"]) == 5


def test_local_mesh_expert_parallel_prefill_is_the_one_dispatch(local):
    assert local["ep"]


def test_only_the_long_slstm_loop_goes_untraced():
    """Which pairs are traced is a rule of the config and the shape, not
    of the host's speed: of every ``ARCH_IDS`` x ``INPUT_SHAPES`` pair,
    only xlstm's prefill_32k (its sLSTM loop over 32,768 positions)
    skips its trace; train_4k's 4,096-step loop is traced."""
    from repro_torch.common.config import INPUT_SHAPES
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.dryrun import untraced_reason
    untraced = {(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
                if untraced_reason(get_config(a), INPUT_SHAPES[s])}
    assert untraced == {("xlstm-125m", "prefill_32k")}
    why = untraced_reason(get_config("xlstm-125m"),
                          INPUT_SHAPES["prefill_32k"])
    assert "sLSTM" in why and "32768" in why


def test_sweep_records_trace_all_but_the_long_slstm_loop():
    """The committed sweep (``dryrun --all --mesh both``): 80 records,
    no error, ``trace: null`` only where ``untraced_reason`` says so."""
    from repro_torch.launch.dryrun import RESULTS_DIR
    recs = [json.loads(p.read_text()) for p in Path(RESULTS_DIR).glob(
        "*__*__*.json") if p.stem.count("__") == 2]
    assert len(recs) == 80
    assert not [r for r in recs if r["status"] == "error"]
    null = {(r["arch"], r["shape"], r["mesh"]) for r in recs
            if r["status"] == "ok" and r["trace"] is None}
    assert null == {("xlstm-125m", "prefill_32k", m)
                    for m in ("single", "multi")}
