"""Time flash_prefill's backward kernel on the card at chip_smoke.py's
cases.

  PYTHONPATH=<tree>/src python3 src/repro_torch/launch/attn_bwd_bench.py \
      [--label NAME] [--device cuda|cpu]

For each case of ``BWD_CASES`` (the home of chip_smoke.py's backward
cases: the planner's training shapes, kimi-k2's heads, head dims 16, 32
and 256, a window, softcaps, whisper's non-causal encoder and
cross-attention, and the dense families' training rows) it draws q, k,
v and dO as chip_smoke.py does (N(0, 1) rounded to bf16, from one seeded
generator on the device, in the cases' order), runs ``flash_prefill_bwd``
twice and prints one JSON line with the sha256 of dq, dk and dv
(``bits``, and whether the second call gave the same), each output's
largest difference from the plain version and whether every element is
within ``BWD_ATOL + BWD_RTOL |plain|`` (exit 1 where one is not), the
time per call by CUDA events (``ms``), each of the call's kernels'
device time per call from ``torch.profiler`` (``pass_device_ms``, by
kernel name: a profile counts only if it saw every launch; null where
none did) and their sum (``device_ms``), the device time of the
backward of one ``F.scaled_dot_product_attention`` call on the same
inputs (``library_device_ms``; none under a cap), and the bound
(``bound_ms``: the larger of the bytes over 3.35 TB/s and the ten hd
operations a visible (row, key) pair and q head over 989 TFLOP/s). It
also prints the backward kernels' registers and spills by instance and
their HGMMA (wgmma) instructions by head dim in the built library's
SASS.

It imports ``repro_torch`` from ``PYTHONPATH``, so one copy of this
script times the kernel of any tree with the same wrapper signature: run
it for the parent's tree (unpacked with ``git archive``) and the
change's, in turns, in one chip call. Kernel names come from the
profile, so trees whose passes are named otherwise compare too.
``--device cpu`` runs the plain version at the ``SMALL`` cases (bits, no
times).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

# (B, Sq, Sk, (Hq, Hkv, hd), window, cap, causal, family): the planner's
# train shapes (launch.train's 8 x 256, train_planner's 16 x 64 at its
# 12/4 heads of 64), a 1,024-token row, kimi-k2's 64/8 heads at head dim
# 128, head dim 32, a window and a softcap; then the A12 families'
# training: head dim 16 (qwen1.5-110b-smoke's 8/2), gemma2-2b's 8/4 of
# 256 with its cap 50 and window 4,096 at 4,608 rows (the window crossed)
# and without either at 1,024, and whisper's 20/20 of 64 non-causal, its
# encoder (4 x 1,500 frames) and its cross-attention (16 decoder rows
# over the 1,500); then the other heads and rows that chip_smoke.py's
# A12 training runs give it: whisper's causal decoder self-attention (16
# rows), qwen1.5-32b's 40/40 of 128 (G = 1) at 1,024 rows,
# starcoder2-3b's 24/2 of 128 with its 4,096 window at 4,608 rows,
# qwen2-vl-72b's 64/8 of 128 at 1,280
BWD_CASES = [
    (8, 256, 256, (12, 4, 64), 0, 0.0, True, "train"),
    (16, 64, 64, (12, 4, 64), 0, 0.0, True, "gate"),
    (1, 1024, 1024, (12, 4, 64), 0, 0.0, True, "long"),
    (1, 512, 512, (64, 8, 128), 0, 0.0, True, "kimi"),
    (2, 256, 256, (12, 4, 32), 0, 0.0, True, "hd32"),
    (2, 512, 512, (12, 4, 64), 100, 0.0, True, "window"),
    (2, 256, 256, (12, 4, 64), 0, 30.0, True, "cap"),
    (2, 256, 256, (8, 2, 16), 0, 0.0, True, "hd16"),
    (1, 4608, 4608, (8, 4, 256), 4096, 50.0, True, "gemma2"),
    (1, 1024, 1024, (8, 4, 256), 0, 0.0, True, "hd256"),
    (4, 1500, 1500, (20, 20, 64), 0, 0.0, False, "whisper_enc"),
    (4, 16, 1500, (20, 20, 64), 0, 0.0, False, "whisper_cross"),
    (4, 16, 16, (20, 20, 64), 0, 0.0, True, "whisper_self"),
    (1, 1024, 1024, (40, 40, 128), 0, 0.0, True, "qwen32"),
    (1, 4608, 4608, (24, 2, 128), 4096, 0.0, True, "starcoder2"),
    (1, 1280, 1280, (64, 8, 128), 0, 0.0, True, "qwen2vl")]
# the backward against its plain version (autograd through
# attention_ref): both recompute p in fp32 from bf16 q, k and v; the
# kernel rounds P and dS to bf16 before their products; sums in other
# orders, outputs rounded to bf16
BWD_ATOL = BWD_RTOL = 2e-2
# a case whose B Hq Sq Sk hd passes this is timed over 5 calls, not 20
BWD_LONG_WORK = 4e9
# the CPU's cases (the plain version)
SMALL = ("gate", "hd16")
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_S = 989e12           # H100 SXM dense bf16 tensor cores
# the backward kernels' names in this tree and in trees before the
# tensor-core redesign
PASS_SYMBOLS = ("prefill_bwd_rows", "prefill_bwd_dkdv", "prefill_bwd_dq",
                "bwd_rows_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel")


def digest(t: torch.Tensor) -> str:
    """sha256 (first 16 hex digits) of a tensor's bytes."""
    return hashlib.sha256(t.detach().contiguous().view(torch.int16).cpu()
                          .numpy().tobytes()).hexdigest()[:16]


def draw(gen, case, device):
    """q, k, v, dout of a case: N(0, 1) rounded to bf16, drawn in that
    order (chip_smoke.py's draw)."""
    B, Sq, Sk, (Hq, Hkv, hd) = case[:4]
    mk = lambda *s: torch.randn(*s, generator=gen, device=device).to(
        torch.bfloat16)
    return (mk(B, Hq, Sq, hd), mk(B, Hkv, Sk, hd), mk(B, Hkv, Sk, hd),
            mk(B, Hq, Sq, hd))


def visible_pairs(B, Sq, Sk, window, causal) -> int:
    """(row, key) pairs the mask leaves visible, over the batch."""
    rows = torch.arange(Sq)[:, None]
    keys = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= keys <= rows
    if window:
        mask &= rows - keys < window
    return B * int(mask.sum())


def bwd_bound(case):
    """(ms, what sets it) of the least time of the backward: q, dout, k, v
    read once, dq, dk, dv written once (bf16), against five hd-long
    products (10 hd operations) a visible pair and q head."""
    B, Sq, Sk, (Hq, Hkv, hd), window, cap, causal = case[:7]
    t_b = 2 * hd * B * (3 * Hq * Sq + 4 * Hkv * Sk) / HBM_BYTES_S
    t_f = 10 * hd * Hq * visible_pairs(B, Sq, Sk, window, causal) \
        / BF16_FLOP_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def short_name(key: str) -> str:
    """A kernel's name and template arguments from its profiler key
    (``void (anonymous namespace)::prefill_bwd_dkdv<64, 2>(...)`` ->
    ``prefill_bwd_dkdv<64, 2>``)."""
    m = re.search(r"(\w+<[^<>]*>)", key) or re.search(r"(\w+)\(", key)
    return m.group(1) if m else key[:60]


def kernel_times(fn, iters: int, tries: int = 3):
    """{kernel name: device ms a call of ``fn``} from ``torch.profiler``
    over ``iters`` calls; a profile counts only if every kernel it saw
    launched a whole multiple of ``iters`` times; None where none did."""
    from torch.profiler import ProfilerActivity, profile
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    for _ in range(3):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if "CUDA" in str(e.device_type) and e.count]
        if dev and all(e.count % iters == 0 for e in dev):
            out = {}
            for e in dev:
                name = short_name(e.key)
                out[name] = out.get(name, 0.0) + dev_t(e) / 1e3 / iters
            return out
    return None


def ptxas(log: str) -> dict:
    """Registers and spills of each backward kernel in nvcc's log, by
    instance: its head dim and, where the kernel has a second template
    argument, its warpgroups a block (scan_bench's reader)."""
    from repro_torch.launch.scan_bench import ptxas_instances
    out = {}
    for s in PASS_SYMBOLS:
        if s not in log:
            continue
        out[s] = []
        for i in ptxas_instances(log, s):
            args = i.pop("args")
            wgs = {"warpgroups": args[1]} if len(args) > 1 else {}
            out[s].append(dict(hd=args[0], **wgs, **i))
    return out


def sass_hgmma(lib: Path, symbols) -> dict:
    """{symbol: {"hd<N>": HGMMA instructions}} of each instance of the
    kernels ``symbols`` in the SASS of the library ``lib``
    (``cuobjdump -sass``)."""
    tool = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") \
        / "bin" / "cuobjdump"
    tool = str(tool) if tool.is_file() else shutil.which("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {s: {} for s in symbols}
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = None
            for s in symbols:
                m = re.search(s + r"ILi(\d+)E", line)
                if m:
                    cur = counts[s].setdefault(f"hd{m.group(1)}", [0])
        elif cur is not None and "HGMMA" in line:
            cur[0] += 1
    return {s: {k: v[0] for k, v in sorted(c.items(),
                                           key=lambda kv: int(kv[0][2:]))}
            for s, c in counts.items()}


def run_case(gen, case, device) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import flash_prefill_bwd
    from repro_torch.kernels.ref import attention_bwd_ref
    B, Sq, Sk, heads, window, cap, causal, family = case
    q, k, v, dout = draw(gen, case, device)
    kw = dict(causal=causal, window=window, cap=cap)
    run = lambda: flash_prefill_bwd(q, k, v, dout, **kw)
    got, again = run(), run()
    bits = [digest(t) for t in got]
    b_ms, b_by = bwd_bound(case)
    rec = dict(family=family, B=B, Sq=Sq, Sk=Sk, heads=list(heads),
               window=window, cap=cap, causal=causal, bits=bits,
               repeat_equal=bits == [digest(t) for t in again],
               bound_ms=b_ms, bound_by=b_by, ms=None, device_ms=None,
               pass_device_ms=None)
    ref = attention_bwd_ref(q, k, v, dout, **kw)
    err, ok = {}, True
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        diff = (a.float() - b.float()).abs()
        err[name] = float(diff.max())
        ok &= bool(torch.isfinite(a.float()).all()) and bool(
            (diff <= BWD_ATOL + BWD_RTOL * b.float().abs()).all())
    rec.update(max_abs_err=max(err.values()), err=err, within_tol=ok)
    if device != "cuda":
        return rec
    from repro_torch.launch.decode_bench import cuda_ms, device_ms
    n = 20 if B * heads[0] * Sq * Sk * heads[2] < BWD_LONG_WORK else 5
    rec["ms"] = cuda_ms(run, n)
    passes = kernel_times(run, n)
    rec["pass_device_ms"] = passes
    rec["device_ms"] = None if passes is None else sum(passes.values())
    if not cap:
        rows = torch.arange(Sq, device=device)[:, None]
        keys = torch.arange(Sk, device=device)[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
        if causal:
            mask &= keys <= rows
        if window:
            mask &= rows - keys < window
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=None if bool(mask.all()) else mask,
            enable_gqa=True)
        lib = lambda: torch.autograd.grad(o, (qs, ks, vs), dout,
                                          retain_graph=True)
        rec["library_device_ms"] = device_ms(lib, iters=n)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("attn_bwd_bench: no CUDA device", file=sys.stderr)
        return 1
    card = None
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
    print(json.dumps({"label": args.label, "device": args.device,
                      "card": card}), flush=True)
    gen = torch.Generator(device=args.device).manual_seed(3)
    ok = True
    for case in BWD_CASES:
        if args.device == "cpu" and case[-1] not in SMALL:
            continue
        rec = run_case(gen, case, args.device)
        ok &= rec["repeat_equal"] and rec["within_tol"]
        print(json.dumps(dict(label=args.label, **rec)), flush=True)
    if args.device == "cuda":
        from repro_torch.kernels import _build
        build = _build.build_all()
        log = _build.build_logs()["flash_prefill_bwd"]
        print(json.dumps(dict(
            label=args.label, ptxas=ptxas(log),
            hgmma=sass_hgmma(build / "libflash_prefill_bwd.so",
                             [s for s in PASS_SYMBOLS if s in log]))),
            flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
