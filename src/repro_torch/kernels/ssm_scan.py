"""Selective SSM scan: the Hopper kernel's wrapper and its plain version.

Replaces the JAX package's Pallas TPU kernel ``ssm_scan``
(``src/repro/kernels/ssm_scan.py``). The CUDA source,
``csrc/ssm_scan.cu``, carries the design note: a channel's n states over
n lanes of a warp, each lane with its h_i and A[d, i] in registers for the
whole scan and one fmaf a step as the only chain between steps, blocks of
128 lanes (128 / n channels) over the channels and the batch, the
timesteps staged 64 at a time in shared memory by asynchronous copies,
two tiles deep (as many as the launch has), and y summed over n in one
lane's fixed order from the states each lane leaves in shared memory per
sub-tile of n steps. Its roundings are
explicit (``__fmul_rn``, ``fmaf``, a fixed order over n), so a scan split
at any seam, h_last fed back as h0, gives the bits of one scan. State
sizes n of 8 and 16 are built.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.selective_scan_ref``. The
kernel's operand checks (``check_shapes``) apply on both devices, so a
caller that the card would refuse fails on the CPU too.

Its gradient is ``ssm_scan_bwd``, a kernel with no TPU counterpart
(``csrc/ssm_scan_bwd.cu``: the forward's lanes walking back over
16- or 32-step tiles staged two deep, each tile's states rebuilt from the
state the forward had at its start, the sums over the channels taken
by a block, then by its thread block cluster through distributed
shared memory, then by a fixed-order second pass over the clusters and
the batch), whose plain version is ``ref.selective_scan_bwd_ref``. The
forward kernel writes those tile-start states when asked
(``ssm_scan_with_states``); a backward called without them has the
forward kernel walk to them first, computing nothing else.
``SsmScanFn`` joins the two for training: its forward is the forward
kernel with the states saved, its backward the backward kernel on them
(on the CPU both plain versions, and no states); ``backend.selective_scan``
goes through it only when grad is enabled and an input requires it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import selective_scan_bwd_ref, \
    selective_scan_ref

STATE_SIZES = (8, 16)     # the d_state values the kernel is built for
# dt, x, B_, C_, A, h0, y, h_last, h_ck; B, S, di, n; stream
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# the backward kernel's threads a block, timesteps between two saved
# states (the forward's CKS too; a tile is one or two of them) and blocks
# a thread block cluster
BWD_THREADS, BWD_TILE, BWD_CLUSTER = 128, 16, 8
# dt, x, B_, C_, A, h0, dy, dh_last; ddt, dx, dB_, dC_, dA, dh0; h_ck
# (the saved states), pB, pC, pA; B, S, di, n; stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p]


def check_shapes(dt, x, B_, C_, A, h0):
    """Raise ValueError unless the kernel takes these operands: contiguous
    fp32 dt and x (B,S,di), B_ and C_ (B,S,n), A (di,n) and h0 (B,di,n),
    all on dt's device, n in STATE_SIZES."""
    for name, t, nd in (("dt", dt, 3), ("x", x, 3), ("B_", B_, 3),
                        ("C_", C_, 3), ("A", A, 2), ("h0", h0, 3)):
        _build.check_tensor("ssm_scan", name, t, torch.float32, nd,
                            dt.device)
    Bsz, S, di = dt.shape
    n = A.shape[1]
    if (n not in STATE_SIZES or x.shape != dt.shape
            or B_.shape != (Bsz, S, n) or C_.shape != B_.shape
            or A.shape != (di, n) or h0.shape != (Bsz, di, n)):
        raise ValueError(
            f"ssm_scan: unsupported shapes dt {tuple(dt.shape)} x "
            f"{tuple(x.shape)} B_ {tuple(B_.shape)} C_ {tuple(C_.shape)} "
            f"A {tuple(A.shape)} h0 {tuple(h0.shape)} (state size n in "
            f"{STATE_SIZES})")


def ssm_scan(dt, x, B_, C_, A, h0=None):
    """dt, x: (B,S,di); B_, C_: (B,S,n); A: (di,n); h0: initial state
    (B,di,n), zeros when None; all fp32. Returns (y (B,S,di) fp32,
    h_last (B,di,n) fp32)."""
    if dt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan: no kernel for device {dt.device}")
    Bsz, S, di = dt.shape
    if h0 is None:
        h0 = torch.zeros((Bsz, di, A.shape[-1]), dtype=torch.float32,
                         device=dt.device)
    check_shapes(dt, x, B_, C_, A, h0)
    if dt.device.type == "cpu":
        return selective_scan_ref(dt, x, B_, C_, A, h0)
    y = torch.empty((Bsz, S, di), dtype=torch.float32, device=dt.device)
    h_last = torch.empty_like(h0)
    _forward(dt, x, B_, C_, A, h0, y, h_last, None)
    ssm_scan.launches += 1
    return y, h_last


ssm_scan.launches = 0


def _forward(dt, x, B_, C_, A, h0, y, h_last, h_ck):
    """One launch of the forward kernel; any of y, h_last (both or
    neither) and h_ck may be None (not written)."""
    Bsz, S, di = dt.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.entry("ssm_scan", "ssm_scan_f32", _ARGTYPES)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(dt.data_ptr(), x.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                A.data_ptr(), h0.data_ptr(), ptr(y), ptr(h_last), ptr(h_ck),
                Bsz, S, di, A.shape[1], stream)
    _build.check_rc("ssm_scan", rc)


def states_shape(B: int, S: int, di: int, n: int):
    """Shape of the saved states: the state at the start of every
    BWD_TILE steps."""
    return (B, -(-S // BWD_TILE), di, n)


def ssm_scan_with_states(dt, x, B_, C_, A, h0=None):
    """``ssm_scan`` on the card, also returning the state at the start of
    every BWD_TILE steps, ``states_shape`` (what ``ssm_scan_bwd``
    rebuilds its tiles from): (y, h_last, states)."""
    if dt.device.type != "cuda":
        raise ValueError("ssm_scan_with_states: the saved states exist "
                         "only in the CUDA kernel")
    Bsz, S, di = dt.shape
    if h0 is None:
        h0 = torch.zeros((Bsz, di, A.shape[-1]), dtype=torch.float32,
                         device=dt.device)
    check_shapes(dt, x, B_, C_, A, h0)
    y = torch.empty((Bsz, S, di), dtype=torch.float32, device=dt.device)
    h_last = torch.empty_like(h0)
    h_ck = torch.empty(states_shape(Bsz, S, di, A.shape[1]),
                       dtype=torch.float32, device=dt.device)
    _forward(dt, x, B_, C_, A, h0, y, h_last, h_ck)
    ssm_scan.launches += 1
    return y, h_last, h_ck


def bwd_scratch_shapes(B: int, S: int, di: int, n: int):
    """Shapes of the backward kernel's fp32 scratch: the saved states
    (``states_shape``), each thread block cluster's sums of dB_ and dC_
    over its channels (B, clusters, S, n), and each batch row's dA (B,
    di, n)."""
    blocks = -(-di // (BWD_THREADS // n))
    clusters = -(-blocks // BWD_CLUSTER)
    return (states_shape(B, S, di, n), (B, clusters, S, n),
            (B, clusters, S, n), (B, di, n))


def ssm_scan_bwd(dt, x, B_, C_, A, h0, dy, dh_last, *, saved_states=None):
    """The gradient of ``ssm_scan``: (ddt, dx, dB_, dC_, dA, dh0) fp32 in
    the shapes of dt, x, B_, C_, A and h0, from the forward's inputs and
    the cotangents of y (B,S,di) and h_last (B,di,n). ``saved_states``:
    the forward's states from ``ssm_scan_with_states`` (card only), or
    None: the forward kernel walks to them first."""
    if dt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan_bwd: no kernel for device {dt.device}")
    check_shapes(dt, x, B_, C_, A, h0)
    Bsz, S, di = dt.shape
    n = A.shape[1]
    for name, t, shape in (("dy", dy, (Bsz, S, di)),
                           ("dh_last", dh_last, (Bsz, di, n))):
        _build.check_tensor("ssm_scan_bwd", name, t, torch.float32, 3,
                            dt.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan_bwd: {name} {tuple(t.shape)} != "
                             f"{shape}")
    if dt.device.type == "cpu":
        if saved_states is not None:
            raise ValueError("ssm_scan_bwd: saved states exist only on the "
                             "card")
        return selective_scan_bwd_ref(dt, x, B_, C_, A, h0, dy, dh_last)
    ck_shape, pb_shape, pc_shape, pa_shape = bwd_scratch_shapes(Bsz, S, di,
                                                                n)
    empty = lambda shape: torch.empty(shape, dtype=torch.float32,
                                      device=dt.device)
    if saved_states is None:
        h_ck = empty(ck_shape)
        _forward(dt, x, B_, C_, A, h0, None, None, h_ck)
    else:
        h_ck = saved_states
        _build.check_tensor("ssm_scan_bwd", "saved_states", h_ck,
                            torch.float32, 4, dt.device)
        if tuple(h_ck.shape) != ck_shape:
            raise ValueError(f"ssm_scan_bwd: saved_states "
                             f"{tuple(h_ck.shape)} != {ck_shape}")
    grads = tuple(torch.empty_like(t) for t in (dt, x, B_, C_, A, h0))
    scratch = (h_ck, empty(pb_shape), empty(pc_shape), empty(pa_shape))
    fn = _build.entry("ssm_scan_bwd", "ssm_scan_bwd_f32", _BWD_ARGTYPES)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in (dt, x, B_, C_, A, h0, dy, dh_last)
                  + grads + scratch), Bsz, S, di, n, stream)
    _build.check_rc("ssm_scan_bwd", rc)
    ssm_scan_bwd.launches += 1
    return grads


ssm_scan_bwd.launches = 0


class SsmScanFn(torch.autograd.Function):
    """``ssm_scan`` with the backward kernel as its gradient: (y, h_last)
    of (dt, x, B_, C_, A, h0). On the card the forward saves the states
    the backward starts its tiles from."""

    @staticmethod
    def forward(ctx, dt, x, B_, C_, A, h0):
        if dt.device.type == "cuda":
            y, h_last, states = ssm_scan_with_states(dt, x, B_, C_, A, h0)
        else:
            (y, h_last), states = ssm_scan(dt, x, B_, C_, A, h0), None
        ctx.save_for_backward(dt, x, B_, C_, A, h0, states)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        *ins, states = ctx.saved_tensors
        return ssm_scan_bwd(*ins, dy.contiguous(), dh_last.contiguous(),
                            saved_states=states)
