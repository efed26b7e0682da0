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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import selective_scan_ref

STATE_SIZES = (8, 16)     # the d_state values the kernel is built for
# dt, x, B_, C_, A, h0, y, h_last; B, S, di, n; stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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
    fn = _build.entry("ssm_scan", "ssm_scan_f32", _ARGTYPES)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(dt.data_ptr(), x.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                A.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                Bsz, S, di, A.shape[1], stream)
    _build.check_rc("ssm_scan", rc)
    ssm_scan.launches += 1
    return y, h_last


ssm_scan.launches = 0
