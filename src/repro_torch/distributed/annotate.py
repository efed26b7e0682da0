"""In-graph layout pins: the JAX package's ``distributed/annotate.py``
as DTensor redistributes.

There is no global mesh context: the mesh is a DTensor's own
(``x.device_mesh``), and on a plain tensor every function is a no-op,
as JAX's are outside a mesh. ``constrain`` redistributes to the
divisibility-fitted placements of its per-dim axes.

GSPMD loses head layouts at reshapes when head counts do not divide the
``model`` axis, and JAX pins them with these helpers only where asked
(``attn_constraint="auto"``). The port has no GSPMD: under a mesh every
attention call gets a definite per-rank layout from
``attn_batch_head_axes`` (a copy of JAX's pure function), so the pins
always apply. Where JAX leaves a dim ``UNCONSTRAINED`` (GSPMD's freedom
to keep a seq-sharded K/V), the port pins the batch dim only and
replicates the heads: each rank then attends over whole heads.

Where the JAX package drops its kernels under a mesh and takes its jnp
reference paths (``KB.mesh_local()``), the port keeps them: the model's
mesh path (``distributed/parallel.py``) pins q/k/v here, runs the same
``KB`` op per rank on the local shards (``parallel.local_call``, under
``local_map``) and returns a DTensor with the output's placements. The
kernels are held against those references already, so the function is
the same; on the card the hand-written kernels run per shard, on the
CPU their plain versions. The row-wise products and norms run on each
rank's local rows (``layers.fixed_rows`` never crosses a batch shard),
so a row's bits keep their independence of the row count.

Every aten op of the model under a mesh runs inside such a local
region; DTensor's own rules are used only for redistributes, the
residual adds, the optimizer's elementwise updates and its global norm.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import _fit, mesh_shape, placements

UNCONSTRAINED = "__unconstrained__"


def _dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *per_dim):
    """Redistribute the DTensor x to divisibility-guarded per-dim axes
    (one axis name / tuple / None a dim; ``UNCONSTRAINED`` is None
    here, replicated: see the module note). No-op on a plain tensor."""
    if not _dtensor(x):
        return x
    mesh = x.device_mesh
    spec = tuple(None if ax is UNCONSTRAINED else _fit(mesh, d, ax)
                 for d, ax in zip(x.shape, per_dim))
    pl = placements(spec, mesh)
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh, pl)


def attn_batch_head_axes(mesh, batch: int, n_q_heads: int, n_kv_heads: int):
    """Pick (batch_axes, q_head_axes, kv_head_axes) for attention internals.

    Preference order (the JAX package's):
      1. q heads divisible by `model` -> Megatron TP: q heads over model,
         kv heads over model too when they divide, else replicated (GQA
         kv is small); batch over data. Zero/cheap resharding.
      2. q heads NOT shardable but batch divisible by data*model ->
         batch over both axes (attention fully data-parallel; pays one
         activation reshard in/out — only wins when heads are stuck,
         e.g. hymba's 25q/5kv).
      3. otherwise: pin ONLY the batch dim and leave every other dim
         UNCONSTRAINED.
    """
    mesh = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if "model" not in mesh.axis_names:
        return dp, None, None
    m = mesh.shape["model"]
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    if n_q_heads % m == 0:
        kv_ax = ("model",) if n_kv_heads % m == 0 else None
        return dp, ("model",), kv_ax
    if batch % (n_dp * m) == 0:
        return dp + ("model",), dp + ("model",), dp + ("model",)
    return dp, UNCONSTRAINED, UNCONSTRAINED


def attn_specs(mesh, batch: int, n_q_heads: int, n_kv_heads: int):
    """(q spec, kv spec) of (B, H, S, hd) attention operands, fitted:
    what ``constrain_attn`` pins."""
    bax, qhax, kvhax = attn_batch_head_axes(mesh, batch, n_q_heads,
                                            n_kv_heads)
    if qhax is UNCONSTRAINED or (bax and "model" in bax):
        qhax = kvhax = None            # batch-only, or batch-spread
    b = _fit(mesh, batch, bax) if bax else None
    return ((b, _fit(mesh, n_q_heads, qhax), None, None),
            (b, _fit(mesh, n_kv_heads, kvhax), None, None))


def constrain_attn(q, k, v):
    """Pin (B, H, S, hd) layouts of attention inputs.

    Returns (q, k, v, pinned); pinned is False where JAX leaves GSPMD
    its freedom (case 3), which the port pins batch-only (module note).
    On plain tensors: (q, k, v, True)."""
    if not _dtensor(q):
        return q, k, v, True
    _, qhax, _ = attn_batch_head_axes(q.device_mesh, q.shape[0], q.shape[1],
                                      k.shape[1])
    qs, kvs = attn_specs(q.device_mesh, q.shape[0], q.shape[1], k.shape[1])
    return (constrain(q, *qs), constrain(k, *kvs), constrain(v, *kvs),
            qhax is not UNCONSTRAINED)


def constrain_seq(x, seq_axis: str):
    """Pin (B, S, d) activations to batch-over-data, seq-over-`seq_axis`
    (sequence-parallel prefill: the residual stream per layer)."""
    if not _dtensor(x) or not seq_axis or seq_axis == "none":
        return x
    names = mesh_shape(x.device_mesh).axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    return constrain(x, dp if x.shape[0] > 1 else None, seq_axis, None)


def constrain_attn_out(out, n_kv_heads: int):
    """Pin (B, Hq, S, hd) layout of the attention output (pre out-proj):
    the q operand's."""
    if not _dtensor(out):
        return out
    qs, _ = attn_specs(out.device_mesh, out.shape[0], out.shape[1],
                       n_kv_heads)
    return constrain(out, *qs)
