"""Time the two scan kernels on the card at chip_smoke.py's cases.

  PYTHONPATH=<tree>/src python3 src/repro_torch/launch/scan_bench.py \
      [--label NAME] [--iters N] [--device cuda|cpu]

For each case of ``SSM_CASES`` (the selective scan's (B, S, di, n):
hymba-1.5b's 1,024- and 1,300-token prefills, its decode over 8 slots,
hymba-smoke, the serve runs' 14-token prompts) and of ``MLSTM_CASES``
(the mLSTM scan's (B, H, S, hd): xlstm-125m's prefills, decode and
14-token prompts, xlstm-smoke and head dims 64 and 128), from a zero and
from a random state where S > 1, it runs the wrapper (``ssm_scan``,
``mlstm_scan``) on inputs drawn as chip_smoke.py draws them, and prints
one JSON line with the sha256 of each output's bytes (``bits``: y and
h_last; h, C, n and m), the time per call by CUDA events over
``--iters`` back-to-back calls (``ms``) and the kernel's own device time
per call from ``torch.profiler`` (``device_ms``: decode_bench's rule, a
profile counts only if it saw every launch; null where none did).

It imports ``repro_torch`` from ``PYTHONPATH``, so one copy of this
script times the kernels of any tree that has the same wrapper
signatures: run it for the parent's tree (unpacked with ``git archive``)
and the change's in turns in one chip call, and hold every ``bits``
field to the other tree's. Inputs come from a seeded generator on the
device, the same in every process. ``--device cpu`` runs the wrappers'
plain versions at the smoke configs' cases only (``SMALL``), with no
times (``ms`` and ``device_ms`` are null). On the card it also prints
each scan kernel's registers and spills by instance (``ptxas``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys

import torch

# (B, S, di, n): the cases of chip_smoke.py's ssm_cases
SSM_CASES = [(1, 1024, 1600, 16), (1, 1300, 1600, 16), (8, 1, 1600, 16),
             (1, 40, 128, 8), (1, 14, 1600, 16)]
# (B, H, S, hd): the cases of chip_smoke.py's mlstm_cases
MLSTM_CASES = [(1, 4, 1024, 192), (1, 4, 1300, 192), (8, 4, 1, 192),
               (1, 4, 40, 32), (1, 4, 256, 64), (1, 4, 256, 128),
               (1, 4, 14, 192)]
# the CPU's cases: hymba-smoke's and xlstm-smoke's
SMALL = {(1, 40, 128, 8), (1, 4, 40, 32)}


def digest(t: torch.Tensor) -> str:
    """sha256 (first 16 hex digits) of a tensor's bytes: equal for equal
    bits, different after any one-ulp change."""
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def ssm_inputs(gen, B, S, di, n, random_h0, device):
    """dt = |N(0,1)| * 0.1; x, B_, C_ ~ N(0,1); A = -exp(N(0,1)); h0 ~
    N(0,1) or zeros (chip_smoke.py's draw)."""
    r = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    h0 = r(B, di, n) if random_h0 else torch.zeros(B, di, n, device=device)
    return (r(B, S, di).abs() * 0.1, r(B, S, di), r(B, S, n), r(B, S, n),
            -torch.exp(r(di, n)), h0)


def mlstm_inputs(gen, B, H, S, hd, random_state, device):
    """q, k, v, i ~ N(0,1), f ~ N(3,1); the state C, n, m ~ N(0,1), or
    fresh (chip_smoke.py's draw)."""
    from repro_torch.kernels.ref import mlstm_zero_state
    r = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    st = ((r(B, H, hd, hd), r(B, H, hd), r(B, H)) if random_state
          else mlstm_zero_state(B, H, hd, device))
    return [r(B, H, S, hd), r(B, H, S, hd), r(B, H, S, hd), r(B, H, S),
            r(B, H, S) + 3.0], st


def ptxas_instances(log: str, symbol: str) -> list:
    """Registers, stack frame and spill bytes nvcc reports (``-Xptxas
    -v``) in ``log`` for each instance of the kernel ``symbol``, with its
    integer template arguments (``args``, read from the mangled name;
    empty for a kernel that is no template). Self-contained, so that it
    reads any tree's build."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(symbol + r"(?:I((?:Li\d+E)+)E)?", line)
            cur = (dict(args=[int(x) for x in re.findall(
                r"Li(\d+)E", m.group(1) or "")]) if m else None)
            if cur:
                out.append(cur)
        elif cur and "spill stores" in line:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        elif cur and "Used" in line and "registers" in line:
            cur["registers"] = int(line.split("Used")[1].split(
                "registers")[0])
    return out


def timed(fn, kernel: str, iters: int, device: str) -> dict:
    if device != "cuda":
        return dict(ms=None, device_ms=None)
    from repro_torch.launch.decode_bench import cuda_ms, device_ms
    return dict(ms=cuda_ms(fn, iters), device_ms=device_ms(fn, kernel,
                                                           iters))


def run(iters: int, label: str, device: str = "cuda") -> list:
    from repro_torch.kernels.mlstm_scan import mlstm_scan
    from repro_torch.kernels.ssm_scan import ssm_scan
    gen = torch.Generator(device=device).manual_seed(0)
    small = device != "cuda"
    out = []

    def emit(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)

    for B, S, di, n in SSM_CASES:
        if small and (B, S, di, n) not in SMALL:
            continue
        for random_h0 in ((False, True) if S > 1 else (True,)):
            args = ssm_inputs(gen, B, S, di, n, random_h0, device)
            y, h = ssm_scan(*args)
            emit(dict(label=label, kernel="ssm_scan", B=B, S=S, di=di, n=n,
                      h0="random" if random_h0 else "zeros",
                      bits=dict(y=digest(y), h_last=digest(h)),
                      **timed(lambda: ssm_scan(*args), "ssm_scan_kernel",
                              iters, device)))
    for B, H, S, hd in MLSTM_CASES:
        if small and (B, H, S, hd) not in SMALL:
            continue
        for random_state in ((False, True) if S > 1 else (True,)):
            args, st = mlstm_inputs(gen, B, H, S, hd, random_state, device)
            h, (C, nn, m) = mlstm_scan(*args, st)
            emit(dict(label=label, kernel="mlstm_scan", B=B, H=H, S=S,
                      hd=hd, state="random" if random_state else "fresh",
                      bits=dict(h=digest(h), C=digest(C), n=digest(nn),
                                m=digest(m)),
                      **timed(lambda: mlstm_scan(*args, st),
                              "mlstm_scan_kernel", iters, device)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("scan_bench: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    else:
        card = None
    print(json.dumps({"label": args.label, "device": args.device,
                      "card": card}), flush=True)
    run(args.iters, args.label, args.device)
    if args.device == "cuda":
        from repro_torch.kernels import _build
        logs = _build.build_logs()
        print(json.dumps({"label": args.label, "ptxas": {
            k: ptxas_instances(logs[k], f"{k}_kernel")
            for k in ("ssm_scan", "mlstm_scan")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
