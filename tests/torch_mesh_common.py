"""The 4-rank CPU mesh runs of the port's mesh path, shared by
``tests/test_torch_mesh_*.py``.

A test file calls ``run_mesh(cases, tmp_path)`` once (module scope): the
JAX package draws each case's smoke weights (biases and norm scales
redrawn non-zero, so their layouts matter) and saves them as its npz
checkpoint; one subprocess (``python tests/torch_mesh_common.py``)
starts four gloo ranks (``file://`` rendezvous in the temp dir, one
thread a rank) on a (2, 2) ``("data", "model")`` mesh (a (1, 4) one for
the cases that take the other attention layouts). Each rank loads the
bridged weights twice, as the unsharded port and as a model distributed
by the sharding rules, and runs on both the train step's loss and
gradients (B 4 x S 32, remat on the mesh) and one AdamW step on them, a
prefill (B 8 x S 24) and 2 decode steps fed the unsharded run's greedy
tokens. Rank 0 writes the differences as JSON, and the mesh run's loss,
gradients, stepped parameters and logits with the batches it ran as an
npz. Back in the test's process the JAX package runs the same batches
on the same weights (jitted ``value_and_grad`` of ``train_loss``, as the
port's training tests run it; one AdamW step op by op, as
``test_torch_training.py`` runs it; ``prefill`` and the
``decode_step``s), and the mesh run is held to it too. The tests hold
both differences to the port-vs-JAX bounds (loss 2e-2, each gradient
leaf and the global gradient norm 3e-2 relative norm, logits 0.05).
JAX's serving functions are compiled with XLA's
``xla_allow_excess_precision`` off, so that every bf16 rounding the
code writes is kept: with it on (the default), XLA's CPU fusion of the
layer scan skips roundings, and on kimi-smoke's prefill batch here
JAX's logits move up to 0.045 from its own op-by-op ones (0.051 from
the port's, unsharded or on the mesh, which are 0.029 from the op-by-op
ones); with it off they are the op-by-op logits bit for bit.

The MoE stacks follow the port's MoE tests' near-tie rule
(``test_torch_train_moe.py``, ``test_torch_moe_model.py``): capacity
factor 100 in both runs, the unsharded run's near-tie tokens (k-th and
(k+1)-th router probabilities within 1e-3, where the runs' bf16
roundings may pick other experts) given label -1, logits rows whose
token is a near-tie left out (at most 20% of them), and arctic-smoke cut
to its one MoE layer, so a flipped route reaches no other token.

The file also holds the expert-parallel dispatch, in fp32, to the one
dispatch at capacity factor 8 (nothing dropped), and to the JAX
package's ``_dispatch_shard_map`` on a 4-device (2, 2) host mesh (a
subprocess of its own, as ``tests/test_moe_shard_map.py`` runs it) at
capacity factor 1, where each rank's capacity over its local tokens
drops choices: JAX's 2e-4 on outputs, 5e-4 on gradients, 1e-5 relative
on the load-balance term.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
B_TRAIN, S_TRAIN = 4, 32
B_SERVE, S_SERVE = 8, 24
DECODE_STEPS = 2
BOUNDS = {"loss": 2e-2, "grad": 3e-2, "logits": 0.05}
NEAR_TIE = 1e-3
#: the AdamW step's learning rate; its first update is about lr sign(g)
#: a parameter, so a gradient whose sign the runs' roundings flip moves a
#: parameter 2 lr apart (plus a bf16 rounding of it)
LR = 1e-3
MAX_TIE_SHARE = 0.2
MOE_ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
#: a case: (name, arch, mesh shape, config variant, serve batch)
CASES = {
    "planner-proxy-100m": ("planner-proxy-100m", (2, 2), "", B_SERVE),
    "qwen1.5-32b": ("qwen1.5-32b", (2, 2), "", B_SERVE),
    "qwen1.5-110b": ("qwen1.5-110b", (2, 2), "", B_SERVE),
    "starcoder2-3b": ("starcoder2-3b", (2, 2), "", B_SERVE),
    "gemma2-2b": ("gemma2-2b", (2, 2), "", B_SERVE),
    "arctic-480b": ("arctic-480b", (2, 2), "one_layer", B_SERVE),
    "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", (2, 2), "", B_SERVE),
    "hymba-1.5b": ("hymba-1.5b", (2, 2), "", B_SERVE),
    "xlstm-125m": ("xlstm-125m", (2, 2), "", B_SERVE),
    "qwen2-vl-72b": ("qwen2-vl-72b", (2, 2), "", B_SERVE),
    "whisper-large-v3": ("whisper-large-v3", (2, 2), "", B_SERVE),
    # q heads over a 4-rank model axis, K/V heads replicated (each rank
    # reads the K/V head of its q head)
    "planner_kv_replicated": ("planner-proxy-100m", (1, 4), "", B_SERVE),
    # 6 q heads on 4 model ranks: batch spread over model (B 4, 8) ...
    "planner_heads6_spread": ("planner-proxy-100m", (1, 4), "heads6",
                              B_SERVE),
    # ... or, where 4 does not divide the batch, the batch pinned alone
    "planner_heads6_batch": ("planner-proxy-100m", (1, 4), "heads6", 2),
}


def variant(cfg, name: str):
    """A config of ``CASES`` (either package's config): ``one_layer``
    cuts a stack to its first layer kind once (arctic-smoke's one MoE
    layer, as the port's MoE training tests cut it: a flipped route then
    reaches no other token), ``heads6`` gives the planner 6 q and 2 K/V
    heads of 64."""
    import dataclasses
    if name == "one_layer":
        return dataclasses.replace(cfg, n_layers=1,
                                   segments=((cfg.segments[0][0], 1),))
    if name == "heads6":
        return dataclasses.replace(cfg, n_heads=6, n_kv_heads=2, d_head=64)
    return cfg


def save_weights(case: str, path: str):
    """JAX's smoke weights of ``case``, zero leaves redrawn N(0, 0.1),
    saved as its npz checkpoint; returns the tree (numpy leaves)."""
    import jax
    from repro.configs import get_smoke_config as jcfg
    from repro.models.model import init_params
    from repro.training.checkpoint import save_checkpoint
    arch, _, var, _ = CASES[case]
    params = init_params(jax.random.PRNGKey(0), variant(jcfg(arch), var))
    rng = np.random.default_rng(1)

    def redraw(leaf):
        a = np.asarray(leaf)
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            if not np.any(np.asarray(a, np.float32)):
                return (0.1 * rng.standard_normal(a.shape)).astype(
                    np.float32).astype(a.dtype)
        return a
    tree = jax.tree.map(redraw, params)
    save_checkpoint(path, tree)
    return tree


def run_mesh(cases, tmp_path, ep: bool = False, timeout: int = 170):
    """Rank 0's JSON results of the mesh runs of ``cases`` (and of the
    expert-parallel checks with ``ep``), each case's with its
    differences from the JAX package's run (``"jax"``)."""
    t0 = time.time()
    trees = {c: save_weights(c, str(tmp_path / f"{c}.npz")) for c in cases}
    if ep:
        jax_ep(tmp_path / "ep_jax.npz")
    out = tmp_path / "mesh.json"
    t1 = time.time()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, str(Path(__file__)), "--dir", str(tmp_path),
         "--out", str(out), "--cases", ",".join(cases)]
        + (["--ep"] if ep else []),
        env=env, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0 and out.exists(), (res.stdout[-3000:],
                                                  res.stderr[-6000:])
    runs = json.loads(out.read_text())
    t2 = time.time()
    for c in cases:
        runs[c]["jax"] = jax_diffs(c, trees[c], tmp_path)
    # where the fixture's time goes (the ranks' subprocess has ``timeout``)
    runs["seconds"] = {"jax_setup": t1 - t0, "ranks": t2 - t1,
                       "jax_diffs": time.time() - t2}
    print("mesh fixture seconds:", json.dumps(runs["seconds"]))
    return runs


# ---------------------------------------------------- the JAX reference ----

def _np_batch(z, prefix: str):
    """A batch the mesh run saved under ``prefix/`` as JAX arrays (bf16
    embeddings, int32 ids)."""
    import jax.numpy as jnp
    bf16 = set(json.loads(str(z["bf16_keys"])))
    return {k.split("/", 1)[1]: jnp.asarray(
        z[k], jnp.bfloat16 if k in bf16 else jnp.int32)
        for k in z.files if k.startswith(prefix + "/")}


def _masked_max(a, b, keep) -> float:
    return float(np.abs(a - np.asarray(b, np.float32)).max(-1)[keep].max())


def jax_diffs(case: str, tree, tmp) -> dict:
    """The mesh run of ``case`` (its npz) against the JAX package on the
    same weights and batches: the loss, each gradient leaf (relative
    norm), the global gradient norm and the parameters after one AdamW
    step, the prefill's and decode steps' logits (rows without a
    near-tie)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.common import perf as jperf
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro.training import optimizer as JO
    import torch_train_common as TT
    arch, _, var, _ = CASES[case]
    jcfg = variant(jax_smoke(arch), var)
    jp = jax.tree.map(jnp.asarray, tree)
    z = np.load(str(Path(tmp) / f"{case}_mesh.npz"))
    names = [k[len("grad/"):] for k in z.files if k.startswith("grad/")]
    old = jperf.get_flags()
    if arch in MOE_ARCHS:
        jperf.set_flags(dataclasses.replace(old, moe_capacity_factor=100.0))
    try:
        loss, jg = TT.jax_value_and_grad(jcfg, jp, _np_batch(z, "train"))
        gfl = TT.flat(jg)
        out = {"loss": abs(float(z["loss"]) - loss), "grad_by_leaf": {
            n: float(np.linalg.norm(z["grad/" + n] - TT.jax_leaf(gfl, n,
                                                                 jcfg))
                     / max(np.linalg.norm(TT.jax_leaf(gfl, n, jcfg)),
                           1e-30)) for n in names}}
        out["grad"] = max(out["grad_by_leaf"].values())
        # eager, as test_torch_training.py runs JAX's step
        jnew, _, jnorm = JO.adamw_update(jp, jg, JO.adamw_init(jp), lr=LR)
        out["grad_norm"] = abs(float(z["gnorm"]) - float(jnorm)) \
            / float(jnorm)
        pfl = TT.flat(jnew)
        out["step_param_diff"] = max(float(np.abs(
            z["param/" + n] - TT.jax_leaf(pfl, n, jcfg)).max())
            for n in names)
        # every bf16 rounding as written (see the module note)
        exact = {"xla_allow_excess_precision": False}
        pre = jax.jit(lambda p, b: JM.prefill(p, jcfg, b,
                                              cache_len=S_SERVE + 8),
                      compiler_options=exact)
        step = jax.jit(lambda p, c, b: JM.decode_step(p, jcfg, c, b),
                       compiler_options=exact)
        lg, cache = pre(jp, _np_batch(z, "prefill"))
        diffs = [_masked_max(z["logits/0"], lg, z["keep/0"])]
        for j in range(DECODE_STEPS):
            lg, cache = step(jp, cache, _np_batch(z, f"decode{j}"))
            diffs.append(_masked_max(z[f"logits/{j + 1}"], lg,
                                     z[f"keep/{j + 1}"]))
    finally:
        jperf.set_flags(old)
    out["logits_by_step"] = diffs
    out["logits"] = max(diffs)
    out["n_leaves"] = len(names)
    return out


#: the expert-parallel comparison's capacity factor: each (2, 2) rank's
#: 32 local tokens give 8 slots an expert for 64 choices over 8 experts,
#: so the busier experts drop choices
EP_DROP_FACTOR = 1.0

EP_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.common.perf import PerfFlags, set_flags
from repro.models import moe as M
sys.path.insert(0, sys.argv[2])
from repro.common.config import ModelConfig, MoEConfig
from torch_mesh_common import ep_config, EP_DROP_FACTOR
cfg = ep_config(EP_DROP_FACTOR, ModelConfig, MoEConfig)
p = M.moe_init(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32), jnp.float32)
mesh = jax.make_mesh((2, 2), ("data", "model"))
set_flags(PerfFlags())

def loss(p, x):
    return M.moe_ffn(p, x, cfg, dispatch="shard_map")[0].sum()
with mesh:
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
    ps = jax.device_put(p, NamedSharding(mesh, P()))
    y, aux = jax.jit(lambda p, x: M.moe_ffn(p, x, cfg,
                                            dispatch="shard_map"))(ps, xs)
    g = jax.jit(jax.grad(loss))(ps, xs)
big = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                       capacity_factor=8.0))
y_all, _ = M.moe_ffn(p, x, big, dispatch="einsum")
np.savez(sys.argv[1], x=np.asarray(x), y=np.asarray(y),
         aux=np.asarray(aux), dropped=np.abs(np.asarray(y - y_all)).max(),
         **{k: np.asarray(v) for k, v in p.items()},
         **{"grad_" + k: np.asarray(g[k])
            for k in ("w_gate", "w_up", "w_down")})
print("EP_JAX_OK")
"""


def ep_config(capacity_factor: float, ModelConfig, MoEConfig):
    """The expert-parallel checks' MoE layer (JAX's
    ``tests/test_moe_shard_map.py`` shapes) in either package's config
    classes."""
    return ModelConfig(
        name="t", family="moe", n_layers=2, d_model=32, n_heads=2,
        n_kv_heads=2, d_head=16, d_ff=0, vocab_size=64,
        segments=((("moe",), 2),), mlp_act="silu_glu",
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=48,
                      capacity_factor=capacity_factor))


def jax_ep(path) -> None:
    """JAX's ``_dispatch_shard_map`` on a 4-device (2, 2) host mesh at
    ``EP_DROP_FACTOR``, its inputs, outputs and expert gradients saved
    at ``path`` (a subprocess: the device count locks at JAX's first
    use)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", EP_JAX, str(path), str(Path(__file__).parent)],
        env=env, capture_output=True, text=True, timeout=300)
    assert "EP_JAX_OK" in res.stdout, (res.stdout[-2000:],
                                       res.stderr[-4000:])


# ------------------------------------------------------------- the ranks ----

def _rel(a, b) -> float:
    import torch
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)),
                                                 1e-30))


class _Ties:
    """Records, while on, which tokens of each router call are near-ties
    (k-th and (k+1)-th probabilities within NEAR_TIE): a (T,) mask a
    call."""

    def __init__(self):
        from repro_torch.kernels import backend as KB
        self.KB, self.orig, self.calls = KB, KB.router_topk, []

    def __enter__(self):
        def record(logits, k):
            top = torch_sort(logits)
            self.calls.append(top[:, k - 1] - top[:, k] < NEAR_TIE)
            return self.orig(logits, k)
        self.KB.router_topk = record
        return self

    def __exit__(self, *exc):
        self.KB.router_topk = self.orig

    def tokens(self, B):
        """(B, T/B) mask: a near-tie in any call."""
        import torch
        if not self.calls:
            return None
        return torch.stack([c.reshape(B, -1) for c in self.calls]).any(0)


def torch_sort(logits):
    import torch
    return torch.sort(torch.softmax(logits.detach().float(), -1), -1,
                      descending=True).values


def _case(case, mesh, tmp):
    import torch
    from repro_torch.common.perf import PerfFlags, set_flags
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.parallel import distribute_model, \
        distribute_opt_state, full
    from repro_torch.models import model as MD
    from repro_torch.training.optimizer import adamw_init, adamw_update
    from repro_torch.models.convert import load_jax_checkpoint, \
        params_from_numpy
    from repro_torch.models.inputs import make_batch
    arch, _, var, Bs = CASES[case]
    moe = arch in MOE_ARCHS
    set_flags(PerfFlags(moe_capacity_factor=100.0 if moe else 0.0))
    cfg = variant(get_smoke_config(arch), var)
    tree = load_jax_checkpoint(str(Path(tmp) / f"{case}.npz"))
    ref = params_from_numpy(tree, cfg, device="cpu")
    dm = distribute_model(params_from_numpy(tree, cfg, device="cpu"), cfg,
                          mesh)
    out = {"ties": 0, "rows": 0}
    arrs = {}
    batch = make_batch(cfg, "train", B_TRAIN, S_TRAIN, seed=2)
    with _Ties() as ties, torch.no_grad():
        MD.train_loss(ref, batch, remat=False)
    mask = ties.tokens(B_TRAIN)
    if mask is not None:
        batch["labels"] = torch.where(mask, -1, batch["labels"])
        out["train_ties"] = int(mask.sum())
        out["train_tokens"] = mask.numel()
    _save_batch(arrs, "train", batch)
    grads, norms = [], []
    for m in (ref, dm):
        m.requires_grad_(True)
        ps = dict(m.named_parameters())
        loss = MD.train_loss(m, batch, remat=m is dm)
        g = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
        grads.append((float(full(loss)), {n: full(t) for n, t in g.items()}))
        m.requires_grad_(False)
        # one AdamW step on the gradients: the global norm is over the
        # whole (sharded) leaves
        st = adamw_init(m)
        if m is dm:
            st = distribute_opt_state(st, m)
        norms.append(float(full(adamw_update(m, g, st, lr=LR)[2])))
    out["loss"] = abs(grads[0][0] - grads[1][0])
    out["loss_ref"] = grads[0][0]
    out["grad_by_leaf"] = {n: _rel(grads[1][1][n], grads[0][1][n])
                           for n in grads[0][1]}
    out["grad"] = max(out["grad_by_leaf"].values())
    out["grad_norm"] = abs(norms[1] - norms[0]) / norms[0]
    arrs["loss"] = np.float64(grads[1][0])
    arrs["gnorm"] = np.float64(norms[1])
    arrs.update({f"grad/{n}": g.float().numpy()
                 for n, g in grads[1][1].items()})
    arrs.update({f"param/{n}": full(p).float().numpy()
                 for n, p in dm.named_parameters()})
    rp = dict(ref.named_parameters())
    out["step_param_diff"] = max(float((full(p) - rp[n]).abs().max())
                                 for n, p in dm.named_parameters())
    out["params_stay_sharded"] = all(
        tuple(p.placements) == tuple(q.placements) for p, q in zip(
            dm.parameters(), distribute_model(
                params_from_numpy(tree, cfg, device="cpu"), cfg,
                mesh).parameters()))
    dm = distribute_model(params_from_numpy(tree, cfg, device="cpu"), cfg,
                          mesh)
    ref = params_from_numpy(tree, cfg, device="cpu")
    pb = make_batch(cfg, "prefill", Bs, S_SERVE, seed=3)
    with _Ties() as ties:
        lr, cr = MD.prefill(ref, pb, S_SERVE + 8)
    lm, cm = MD.prefill(dm, pb, S_SERVE + 8)
    _save_batch(arrs, "prefill", pb)
    diffs = [_logit_diff(full(lm), lr, ties, Bs, out, arrs, 0)]
    # sequence-parallel prefill: the residual stream pinned seq over model
    out["seq_parallel"] = float((full(MD.prefill(
        dm, pb, S_SERVE + 8, seq_axis="model")[0]) - full(lm)).abs().max())
    for j in range(DECODE_STEPS):
        db = {"tokens": torch.argmax(lr, dim=-1)[:, None]}
        if cfg.rope_kind == "mrope":
            db["mrope_pos"] = torch.full((3, Bs, 1), S_SERVE + j,
                                         dtype=torch.long)
        with _Ties() as ties:
            lr, cr = MD.decode_step(ref, cr, db)
        lm, cm = MD.decode_step(dm, cm, db)
        _save_batch(arrs, f"decode{j}", db)
        diffs.append(_logit_diff(full(lm), lr, ties, Bs, out, arrs, j + 1))
    out["logits"] = max(diffs)
    out["logits_by_step"] = diffs
    k = cm["layers"][0].get("k")
    out["cache_placements"] = str(tuple(k.placements)) if k is not None \
        else ""
    out["mesh"] = list(mesh.shape)
    if cfg.n_enc_layers:
        out["decoder_cap"] = _decoder_cap(dm, pb, db, Bs, mesh)
    arrs["bf16_keys"] = np.array(json.dumps(sorted(arrs.pop("_bf16", []))))
    return out, arrs


def _save_batch(arrs, prefix, batch):
    """``batch`` into ``arrs`` under ``prefix/`` (bf16 as fp32, named in
    ``arrs["_bf16"]``)."""
    import torch
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.dtype == torch.bfloat16:
            arrs.setdefault("_bf16", []).append(f"{prefix}/{k}")
            v = v.float()
        arrs[f"{prefix}/{k}"] = v.numpy()


def _decoder_cap(dm, pb, db, B, mesh):
    """whisper's mesh decode past its 448-row decoder cache: the
    ValueError of each ``pos`` form (a per-row tensor with one row at
    448, the same as a replicated DTensor, an int), and whether the
    cache kept its bits."""
    import torch
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed.parallel import _distribute, full
    from repro_torch.models import model as MD
    _, c = MD.prefill(dm, pb, 1000)
    rows = c["layers"][0]["k"].shape[2]
    per_row = torch.full((B,), 5, dtype=torch.long)
    per_row[-1] = rows
    before = [full(t).clone() for t in (c["layers"][0]["k"],
                                        c["layers"][-1]["v"])]
    out = {"rows": rows, "errors": []}
    for pos in (per_row, _distribute(per_row, mesh, [Replicate()] * 2),
                rows):
        c["pos"] = pos
        try:
            MD.decode_step(dm, c, db)
            out["errors"].append("")
        except ValueError as e:
            out["errors"].append(str(e))
    out["untouched"] = all(torch.equal(full(t), b) for t, b in zip(
        (c["layers"][0]["k"], c["layers"][-1]["v"]), before))
    return out


def _logit_diff(lm, lr, ties, B, out, arrs, j):
    """Largest |diff| over the rows whose last token is no near-tie;
    ``lm`` and the rows kept go into ``arrs`` (step ``j``)."""
    import torch
    mask = ties.tokens(B)
    keep = torch.ones(B, dtype=torch.bool) if mask is None else ~mask[:, -1]
    out["ties"] += int((~keep).sum())
    out["rows"] += B
    arrs[f"logits/{j}"] = lm.float().numpy()
    arrs[f"keep/{j}"] = keep.numpy()
    return float((lm - lr).abs().max(dim=-1).values[keep].max())


def _ep_run(mesh, cfg, p, x, dispatch):
    """The MoE layer ``p`` of ``cfg`` on x (fp32) through the mesh path
    under ``dispatch``: (y, aux, the expert stacks' gradients of
    y.sum()), whole tensors."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.common.perf import PerfFlags, set_flags
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.parallel import MeshCtx, _moe, full
    set_flags(PerfFlags(moe_dispatch=dispatch))
    ctx = MeshCtx(mesh, shd.ShardingStrategy())
    dps = {}
    for n, t in p.named_parameters():
        keys = ("segments", "0", "0", "moe") + tuple(n.split("."))
        spec = shd.param_spec(keys, torch.empty((2,) + t.shape,
                                                device="meta"), cfg,
                              mesh, ctx.strategy)[1:]
        dps[n] = distribute_tensor(t.detach().clone(), mesh,
                                   shd.placements(spec, mesh)
                                   ).requires_grad_(True)
    xd = distribute_tensor(x, mesh, shd.placements(("data", None, None),
                                                   mesh))
    y, aux = _moe(ctx, _with(p, dps), None, xd, cfg, False, True,
                  *x.shape[:2])
    g = torch.autograd.grad(y.sum(), [dps[k] for k in (
        "w_gate", "w_up", "w_down")])
    set_flags(PerfFlags())
    return full(y), float(full(aux)), [full(t) for t in g]


def _ep_case(mesh):
    """The expert-parallel dispatch against the one dispatch, fp32,
    capacity factor 8 (no choice dropped), on JAX's test shapes."""
    import torch
    from repro_torch.common.config import ModelConfig, MoEConfig
    from repro_torch.common.perf import PerfFlags, set_flags
    from repro_torch.models import moe as M
    cfg = ep_config(8.0, ModelConfig, MoEConfig)
    p = M.MoE(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    x = torch.randn((4, 16, 32), generator=torch.Generator().manual_seed(1))
    set_flags(PerfFlags())
    ps = {n: t.detach().clone().requires_grad_(True)
          for n, t in p.named_parameters()}
    y_ref, aux_ref = M.moe_ffn(_with(p, ps), x, cfg, with_aux=True)
    g_ref = torch.autograd.grad(y_ref.sum(), [ps[k] for k in (
        "w_gate", "w_up", "w_down")])
    res = {}
    for dispatch in ("shard_map", "gather"):
        y, aux, g = _ep_run(mesh, cfg, p, x, dispatch)
        res[dispatch] = {
            "y": float((y - y_ref).abs().max()),
            "aux": abs(aux - float(aux_ref)),
            "grad": max(float((a - b).abs().max())
                        for a, b in zip(g, g_ref))}
    return res


def _ep_jax_case(mesh, path):
    """The expert-parallel dispatch on the (2, 2) mesh against JAX's
    ``_dispatch_shard_map`` (``EP_JAX``'s npz) on the same weights and
    tokens at ``EP_DROP_FACTOR``; also how far the one dispatch (its
    capacity counted per row) lands from it there."""
    import torch
    from torch import nn
    from repro_torch.common.config import ModelConfig, MoEConfig
    from repro_torch.models import moe as M
    z = np.load(path)
    cfg = ep_config(EP_DROP_FACTOR, ModelConfig, MoEConfig)
    p = M.MoE(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    for n in ("router", "w_gate", "w_up", "w_down"):
        p._parameters[n] = nn.Parameter(torch.from_numpy(z[n]))
    x = torch.from_numpy(z["x"])
    y, aux, g = _ep_run(mesh, cfg, p, x, "shard_map")
    y_one, _, _ = _ep_run(mesh, cfg, p, x, "gather")
    want = torch.from_numpy(z["y"])
    return {"y": float((y - want).abs().max()),
            "aux": abs(aux - float(z["aux"])) / abs(float(z["aux"])),
            "grad": max(float((a - torch.from_numpy(z["grad_" + k])
                               ).abs().max())
                        for a, k in zip(g, ("w_gate", "w_up", "w_down"))),
            "jax_dropped": float(z["dropped"]),
            "one_dispatch": float((y_one - want).abs().max())}


def _with(p, tensors):
    """A copy of the MoE module ``p`` holding ``tensors`` by name."""
    import copy
    q = copy.copy(p)
    q._parameters = dict(p._parameters)
    q._modules = dict(p._modules)
    for n, t in tensors.items():
        if "." in n:
            continue
        q._parameters[n] = t
    return q


def _rank(rank, world, args):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{args.dir}/rdzv",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        res = {}
        for c in [c for c in args.cases.split(",") if c]:
            shape = CASES[c][1]
            m = mesh if shape == (2, 2) else init_device_mesh(
                "cpu", shape, mesh_dim_names=("data", "model"))
            res[c], arrs = _case(c, m, args.dir)
            if rank == 0:
                np.savez(str(Path(args.dir) / f"{c}_mesh.npz"), **arrs)
        if args.ep:
            res["ep"] = _ep_case(mesh)
            res["ep_jax"] = _ep_jax_case(mesh, str(Path(args.dir)
                                                   / "ep_jax.npz"))
        if rank == 0:
            Path(args.out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def main():
    import argparse
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", default="")
    ap.add_argument("--ep", action="store_true")
    args = ap.parse_args()
    mp.spawn(_rank, args=(4, args), nprocs=4, join=True)


if __name__ == "__main__":
    main()
