"""Stabilized mLSTM scan: the Hopper kernel's wrapper and its plain version.

Replaces the JAX package's Pallas TPU kernel ``mlstm_scan``
(``src/repro/kernels/mlstm_scan.py``). The CUDA source,
``csrc/mlstm_scan.cu``, carries the design note: a grid of (column tiles
of C, B·H) blocks, each holding its ``tile_cols(S)`` columns of one head's
C over 8 row groups and its own copy of n and m in registers for the whole
scan, the sequential s axis a loop inside the block in tiles of 8 steps
that the stepping threads run back to back while a producer warp stages
the next tile (q, ks, v by asynchronous copies, its gates computed once)
and reduces the last tile's outputs, one barrier a tile, and explicit
roundings (``__fmul_rn``, ``__fadd_rn``, a fixed order for both
reductions over d, whatever the tile width), so a scan split at any seam,
its state fed back, gives the bits of one scan. Head dims 32, 64, 128
and 192 are built.

The state keeps the JAX layout: ``(C (B,H,hd,hd), n (B,H,hd), m (B,H))``,
fp32; ``state=None`` is zeros / zeros / -1e30. ``scale`` defaults to
1/sqrt(hd), and k is scaled before the kernel, as the Pallas wrapper
does. On a CUDA tensor the wrapper launches the kernel (or raises); on a
CPU tensor it runs the plain version, ``ref.mlstm_scan_ref``. The
kernel's operand checks (``check_shapes``) apply on both devices, so a
caller that the card would refuse fails on the CPU too.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mlstm_scan_ref, mlstm_zero_state

HEAD_DIMS = (32, 64, 128, 192)  # the head dims the kernel is built for
# columns of C per block (the kernel is built for 8 and 16): 8 in a
# launch of many steps (96 blocks for a B·H = 4 prefill, each warp on its
# own scheduler), 16 in a one-step launch (384 blocks at 8 decode slots
# of xlstm-125m's 4 heads: the fastest width there on the H100)
TILE_COLS = {"scan": 8, "step": 16}
# q, ks, v, i, f, C0, n0, m0, h, C1, n1, m1, n_tiles, m_tiles; BH, S, hd,
# columns a tile; stream
_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def tile_cols(S: int) -> int:
    """Columns of C a block of the kernel holds in a launch of S steps."""
    return TILE_COLS["step"] if S == 1 else TILE_COLS["scan"]


def tile_state_shapes(B: int, H: int, S: int, hd: int):
    """Shapes of ``mlstm_scan_tile_states``' (n_tiles, m_tiles): one n and
    one m for each of the hd / tile_cols(S) column tiles."""
    T = hd // tile_cols(S)
    return (B, H, T, hd), (B, H, T)


def check_shapes(q, k, v, i_pre, f_pre, state):
    """Raise ValueError unless the kernel takes these operands: contiguous
    fp32 q, k, v (B,H,S,hd), i_pre and f_pre (B,H,S) and the state C
    (B,H,hd,hd), n (B,H,hd), m (B,H), all on q's device, hd in
    HEAD_DIMS."""
    C, n, m = state
    for name, t, nd in (("q", q, 4), ("k", k, 4), ("v", v, 4),
                        ("i_pre", i_pre, 3), ("f_pre", f_pre, 3),
                        ("C", C, 4), ("n", n, 3), ("m", m, 2)):
        _build.check_tensor("mlstm_scan", name, t, torch.float32, nd,
                            q.device)
    B, H, S, hd = q.shape
    if (hd not in HEAD_DIMS or k.shape != q.shape or v.shape != q.shape
            or i_pre.shape != (B, H, S) or f_pre.shape != i_pre.shape
            or C.shape != (B, H, hd, hd) or n.shape != (B, H, hd)
            or m.shape != (B, H)):
        raise ValueError(
            f"mlstm_scan: unsupported shapes q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} i_pre "
            f"{tuple(i_pre.shape)} f_pre {tuple(f_pre.shape)} C "
            f"{tuple(C.shape)} n {tuple(n.shape)} m {tuple(m.shape)} "
            f"(head dim in {HEAD_DIMS})")


def _prepare(q, k, v, i_pre, f_pre, state, scale):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlstm_scan: no kernel for device {q.device}")
    B, H, _, hd = q.shape
    if state is None:
        state = mlstm_zero_state(B, H, hd, q.device)
    check_shapes(q, k, v, i_pre, f_pre, state)
    return state, (scale if scale else 1.0 / math.sqrt(hd))


def _launch(q, k, v, i_pre, f_pre, state, scale, tiles: bool):
    """One kernel launch; returns (h, (C, n, m)) and, with ``tiles``,
    every column tile's own (n (B,H,T,hd), m (B,H,T))."""
    B, H, S, hd = q.shape
    C0, n0, m0 = state
    ks = (k * scale).contiguous()
    h = torch.empty_like(q)
    C1, n1, m1 = (torch.empty_like(t) for t in state)
    nt = tuple(torch.empty(shape, dtype=torch.float32, device=q.device)
               for shape in tile_state_shapes(B, H, S, hd)) \
        if tiles else None
    fn = _build.entry("mlstm_scan", "mlstm_scan_f32", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), ks.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
                f_pre.data_ptr(), C0.data_ptr(), n0.data_ptr(),
                m0.data_ptr(), h.data_ptr(), C1.data_ptr(), n1.data_ptr(),
                m1.data_ptr(), nt[0].data_ptr() if tiles else None,
                nt[1].data_ptr() if tiles else None, B * H, S, hd,
                tile_cols(S), stream)
    _build.check_rc("mlstm_scan", rc)
    mlstm_scan.launches += 1
    return (h, (C1, n1, m1)) + ((nt,) if tiles else ())


def mlstm_scan(q, k, v, i_pre, f_pre, state=None, *, scale: float = 0.0):
    """q, k, v: (B,H,S,hd); i_pre, f_pre: (B,H,S); state: (C (B,H,hd,hd),
    n (B,H,hd), m (B,H)) or None (fresh); all fp32. Returns (h (B,H,S,hd)
    fp32, the state after the last step)."""
    state, scale = _prepare(q, k, v, i_pre, f_pre, state, scale)
    if q.device.type == "cpu":
        return mlstm_scan_ref(q, k, v, i_pre, f_pre, state, scale=scale)
    return _launch(q, k, v, i_pre, f_pre, state, scale, tiles=False)


def mlstm_scan_tile_states(q, k, v, i_pre, f_pre, state=None, *,
                           scale: float = 0.0):
    """``mlstm_scan`` on the card, also returning the n and m that each
    column tile stepped for itself: ((h, state), (n_tiles (B,H,T,hd),
    m_tiles (B,H,T))). The kernel's design keeps them bitwise equal; this
    is how a check sees that they are."""
    if q.device.type != "cuda":
        raise ValueError("mlstm_scan_tile_states: the column tiles exist "
                         "only in the CUDA kernel")
    state, scale = _prepare(q, k, v, i_pre, f_pre, state, scale)
    h, st, nt = _launch(q, k, v, i_pre, f_pre, state, scale, tiles=True)
    return (h, st), nt


mlstm_scan.launches = 0
