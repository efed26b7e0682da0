"""Time the MoE router kernel on the card at its cases.

  PYTHONPATH=<tree>/src python3 src/repro_torch/launch/router_bench.py \
      [--label NAME] [--iters N] [--device cuda|cpu]

The router's cases live here, and chip_smoke.py imports them:
``ROUTER_CASES`` ((T, E, k): kimi-k2's and arctic's decode over 8 slots
and 1,024-token prefill, and a ragged T) and ``ROUTER_EXTRA_CASES`` (the
smoke configs' E = 4, a ragged E = 100, logits rounded to integers so
that many probabilities are exactly equal, and E = 40, 200 and 512, so
that every template instance of the kernel, ``INSTANCES``, runs on
both draws). For
each case of ``CASES`` it runs ``moe_router_topk`` on logits drawn as
chip_smoke.py draws them (randn * 3, rounded for ``ties``) and prints
one JSON line with the sha256 of each output's bytes (``bits``: w and
idx), whether the ids equal the plain version's and the weights' largest
difference from it, the time per call by CUDA events over ``--iters``
back-to-back calls (``ms``), and, from one ``torch.profiler`` profile of
the router beside a one-element ``zero_()``, the kernel's device time
per call (``device_ms``) and the zero_'s (``floor_ms``: what any launch
costs the device; ``decode_bench.device_ms``'s rule, a profile counts
only if it saw every launch of both, null where none of three did). At
the end it prints the router kernel's registers, stack frame and spills
by instance (``ptxas``).

It imports ``repro_torch`` from ``PYTHONPATH``, so one copy of this
script times the kernel of any tree with the same wrapper: run it for the
parent's tree (unpacked with ``git archive``, with this script,
``scan_bench.py`` and ``decode_bench.py`` copied into its ``launch/``)
and the change's in turns in one chip call, and hold every ``bits`` field
to the other tree's. Inputs come from a seeded generator on the device,
the same in every process. ``--device cpu`` runs the wrapper's plain
version at the small cases only (``SMALL``), with no times (``ms``,
``device_ms`` and ``floor_ms`` are null).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from repro_torch.launch.decode_bench import cuda_ms, device_ms
from repro_torch.launch.scan_bench import digest, ptxas_instances

# (T, E, k): kimi-k2's (384 experts, top-8) and arctic's (128, top-2)
# decode over 8 slots and 1,024-token prefill, and a ragged T
ROUTER_CASES = [(8, 128, 2), (8, 384, 8), (1024, 128, 2), (1024, 384, 8),
                (37, 384, 8)]
# and (T, E, k, draw): the smoke configs' 4 experts, a ragged 100, logits
# rounded to integers ("ties": many equal probabilities, which go to the
# lowest id) at arctic's decode and kimi's prefill, and then the E that
# take the instances no served config takes (40, 200 and 512) on both
# draws and the smoke configs' E on ties: every instance on each draw
ROUTER_EXTRA_CASES = [(8, 4, 2, "randn"), (37, 100, 8, "randn"),
                      (8, 128, 2, "ties"), (1024, 384, 8, "ties"),
                      (8, 40, 8, "randn"), (8, 40, 8, "ties"),
                      (37, 200, 8, "randn"), (37, 200, 8, "ties"),
                      (1024, 512, 8, "randn"), (1024, 512, 8, "ties"),
                      (8, 4, 2, "ties")]
CASES = [(T, E, k, "randn") for T, E, k in ROUTER_CASES] + \
    ROUTER_EXTRA_CASES
# the CPU's cases: the smoke configs' E and the tie-heavy inputs
SMALL = {(8, 4, 2, "randn"), (8, 128, 2, "ties"), (1024, 384, 8, "ties"),
         (8, 40, 8, "ties"), (1024, 512, 8, "ties")}
ROUTER_WTOL = 1e-5   # weights, kernel vs plain version
# the kernel's template instances, lane slots V (csrc/moe_router.cu's
# dispatch: the smallest that covers ceil(E / 32))
INSTANCES = (1, 2, 4, 8, 12, 16)
KERNEL = "moe_router_topk_kernel"


def instance(E: int) -> int:
    """The instance V that the kernel's dispatch takes for E experts."""
    return next(v for v in INSTANCES if 32 * v >= E)


def router_logits(gen, T, E, draw, device):
    """randn * 3 (the JAX package's kernel sweep); rounded to integers for
    ``ties``, so that a row holds many equal probabilities."""
    x = torch.randn(T, E, generator=gen, device=device) * 3.0
    return torch.round(x) if draw == "ties" else x


def run(iters: int, label: str, device: str = "cuda") -> list:
    from repro_torch.kernels.moe_router import moe_router_topk
    from repro_torch.kernels.ref import router_topk_ref
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for T, E, k, draw in CASES:
        if device != "cuda" and (T, E, k, draw) not in SMALL:
            continue
        x = router_logits(gen, T, E, draw, device)
        w, idx = moe_router_topk(x, k)
        rw, ridx, _ = router_topk_ref(x, k)
        rec = dict(label=label, T=T, E=E, k=k, draw=draw,
                   bits=dict(w=digest(w), idx=digest(idx)),
                   ids_equal=bool(torch.equal(idx, ridx)),
                   max_abs_err=float((w - rw).abs().max()),
                   ms=None, device_ms=None, floor_ms=None)
        if device == "cuda":
            call = lambda: moe_router_topk(x, k)
            rec["ms"] = cuda_ms(call, iters)
            rec["device_ms"], rec["floor_ms"] = device_ms(
                call, KERNEL, iters, floor=True)
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("router_bench: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    else:
        card = None
    print(json.dumps({"label": args.label, "device": args.device,
                      "card": card}), flush=True)
    recs = run(args.iters, args.label, args.device)
    if args.device == "cuda":
        from repro_torch.kernels import _build
        print(json.dumps({"label": args.label, "ptxas": ptxas_instances(
            _build.build_logs()["moe_router"], KERNEL)}), flush=True)
    bad = [r for r in recs
           if not r["ids_equal"] or r["max_abs_err"] > ROUTER_WTOL]
    if bad:
        print(f"router_bench: kernel differs from its plain version at "
              f"{[(r['T'], r['E'], r['k'], r['draw']) for r in bad]}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
