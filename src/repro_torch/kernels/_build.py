"""Build and load the port's CUDA kernels.

At first use, every ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc``
into its own shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), all sources in parallel, into a
git-ignored ``build/kernels/<hash>/`` directory at the root of the
checkout. The hash covers the sources, the shared headers (``*.cuh``)
and the flags, so an edited source or header builds anew. Every source
is compiled with the same flags, so the decode family's shared routine
(``decode_warp.cuh``) compiles to the same arithmetic in each.
Libraries are loaded with ``ctypes``. A failed build raises with the
compiler's output; nothing falls back.

The launch helpers at the end are the wrappers' common checks: tensor
device, type, rank, contiguity and 16-byte alignment, and a (B,) int32
``kv_len`` on the device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built at first use and need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def build_dir() -> Path:
    """Directory of this source tree's build, keyed by sources + flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source whose library is missing, all at once; return
    the build directory. Raises RuntimeError naming each failed source."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out / f"lib{src.stem}.so"
        if lib.is_file():
            continue
        tmp = out / f"lib{src.stem}.so.tmp{os.getpid()}"
        log = open(out / f"{src.stem}.log", "w")
        procs.append((src, lib, tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name} (rc {rc}):\n"
                          + (out / f"{src.stem}.log").read_text())
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of ``csrc/<name>.cu`` returning an int
    CUDA error code, with its argument types declared."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    return fn


def build_logs() -> Dict[str, str]:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    of each source built into this tree's build directory."""
    out = build_dir()
    return {p.stem: p.read_text() for p in sorted(out.glob("*.log"))}


# ------------------------------------------------------- launch helpers ----

def check_tensor(kernel: str, name: str, t: torch.Tensor, dtype, ndim: int,
                 device: torch.device) -> None:
    """Raise ValueError unless ``t`` is a contiguous, 16-byte aligned
    ``ndim``-d ``dtype`` tensor on ``device``."""
    if t.dtype != dtype or t.ndim != ndim or t.device != device:
        raise ValueError(f"{kernel}: {name} must be a {ndim}-d {dtype} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must be contiguous and "
                         f"16-byte aligned")


def kv_len_i32(kv_len, B: int, device: torch.device) -> torch.Tensor:
    """A scalar or (B,) ``kv_len`` as a contiguous (B,) int32 tensor on
    ``device``."""
    kvl = torch.as_tensor(kv_len, device=device)
    return kvl.to(torch.int32).reshape(-1).expand(B).contiguous()


def check_rc(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {rc}")
