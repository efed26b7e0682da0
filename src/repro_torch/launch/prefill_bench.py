"""Time a served model's prefill phases at full width on the card, and
check that fixed-size row products give a row the same bits at any row
count.

  PYTHONPATH=src python3 src/repro_torch/launch/prefill_bench.py \
      [--arch planner-proxy-100m|hymba-1.5b] \
      [--rows tree|one|loop|batched] [--check-rows] [--norm-ab]

The phases are those of a prefix-cached 1,312-token prompt (the prefix
phase of ``chip_smoke.py``) on planner-proxy-100m at full width, random
weights from seed 0, cache 2048: a 1,300-token monolithic prefill, the
1,024-token head prefill, the 276-token tail extend at position 1,024
and a 16-token suffix extend at position 1,300. hymba-1.5b, which cannot
extend, times the 1,024-token head prefill alone. Each is timed on the
host clock around the call and a synchronize (median of REPS after two
warm-up calls), so launch overhead counts. ``--norm-ab`` times each
phase with the RMS norms in fixed-size calls (the tree's) and in one call
of all rows (the plain norm), alternated call by call in one process: the
cost of the fixed-size norm on each phase. Without ``--norm-ab`` each
phase then runs PROFILE_REPS times under ``torch.profiler``: the
device's busy time per call (the self device time of every kernel),
flash_prefill's part of it, the kernels per call and the device's idle
share of the profiled wall time, which says whether a phase waits on the
device or on the host's launches.

The script imports ``repro_torch`` from the path, so one copy of it
times two source trees in one session (``PYTHONPATH=<tree>/src``).
``--rows`` chooses how prefill and extend issue their row products
where the tree has ``layers.matmul_rows``: ``tree`` leaves the tree's
own; ``one`` makes one call of all rows (no fixed-size calls); ``loop``
makes one call per BLOCK = 128 rows, zero-padded, then a cat;
``batched`` makes one ``torch.bmm`` of the zero-padded (n, BLOCK, K)
view against the weight expanded to n (no copy: batch stride 0).
``--check-rows`` holds ``one``, ``loop``, ``batched`` and the tree's
own fixed calls to the row contract at the planner's and the MoE families'
product widths (bf16; the routers' fp32 with TF32 off): rows 0..M-1 of
an M-row call equal the same rows of a 1,300-row call, bitwise, for M
in ROW_COUNTS; and whether ``batched`` equals ``loop``. It holds the
RMS norm to the same contract (``norm_row_contract``) at the served
widths, the last M of 1,300 rows for M in NORM_ROW_COUNTS over three
seeded draws, in fp32 (so the mean's last bit reaches the output; a bf16
output hides most of them): the row counts at which the plain norm (one
call) gives rows other bits, and whether the fixed-size norm
(``fixed=True``) gives every row its bits at every count. Prints one
JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

ROW_COUNTS = (1, 16, 32, 128, 276, 1024, 1050)
NORM_ROW_COUNTS = (1, 2, 4, 8, 12, 16, 36, 128, 276, 1024)
NORM_WIDTHS = (768, 1600, 7168)     # planner and xlstm, hymba, MoE
BLOCK = 128
REPS = 20
PROFILE_REPS = 5
# (K, N, dtype) of the products prefill and extend issue: the planner
# (q, kv, out, MLP), kimi-k2 (q, kv, out, dense and shared MLP, router),
# arctic (q and out, dense residual, router)
WIDTHS = [(768, 768, "bf16"), (768, 256, "bf16"), (768, 2048, "bf16"),
          (2048, 768, "bf16"),
          (7168, 8192, "bf16"), (7168, 1024, "bf16"), (8192, 7168, "bf16"),
          (7168, 16384, "bf16"), (16384, 7168, "bf16"), (7168, 2048, "bf16"),
          (2048, 7168, "bf16"), (7168, 384, "fp32"),
          (7168, 7168, "bf16"), (7168, 4864, "bf16"), (4864, 7168, "bf16"),
          (7168, 128, "fp32")]


def _pad(x, block):
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    n = -(-M // block)
    if n * block != M:
        x2 = torch.cat([x2, x2.new_zeros((n * block - M, K))])
    return lead, M, n, x2


def rows_one(x, w, fixed=False):
    return x @ w


def make_rows_loop(block):
    def rows_loop(x, w, fixed=False):
        if not fixed:
            return x @ w
        lead, M, n, x2 = _pad(x, block)
        out = torch.cat([x2[i * block:(i + 1) * block] @ w
                         for i in range(n)])
        return out[:M].reshape(*lead, w.shape[-1])
    return rows_loop


def make_rows_batched(block):
    def rows_batched(x, w, fixed=False):
        if not fixed:
            return x @ w
        lead, M, n, x2 = _pad(x, block)
        out = torch.bmm(x2.view(n, block, -1), w.expand(n, *w.shape))
        return out.view(n * block, -1)[:M].reshape(*lead, w.shape[-1])
    return rows_batched


def check_rows(tree_rows) -> dict:
    """The row contract of ``one``, ``loop``, ``batched`` and
    ``tree_rows`` (the tree's ``matmul_rows``, if any) at every width."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    fns = {"one": rows_one, "loop": make_rows_loop(BLOCK),
           "batched": make_rows_batched(BLOCK)}
    if tree_rows is not None:
        fns["tree"] = tree_rows
    out = {}
    for K, N, dt in WIDTHS:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn(1300, K, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(K, N, generator=gen, device="cuda")
             / K ** 0.5).to(dtype)
        full = {m: f(x, w, True) for m, f in fns.items()}
        res = {m: all(torch.equal(f(x[:M], w, True), full[m][:M])
                      for M in ROW_COUNTS) for m, f in fns.items()}
        res["batched_eq_loop"] = torch.equal(full["batched"], full["loop"])
        out[f"{K}x{N}_{dt}"] = res
    return out


def check_norm_rows() -> dict:
    """The RMS norm's row contract at NORM_WIDTHS, in fp32: per width,
    the counts M at which the plain norm's rows differ from the same rows
    of a 1,300-row call in any of three draws, and whether the
    fixed-size norm's rows are equal at every count in every draw."""
    from repro_torch.models.layers import rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for d in NORM_WIDTHS:
        scale = torch.zeros(d, device="cuda")
        plain_differs, fixed_equal = set(), True
        for _ in range(3):
            x = torch.randn(1300, d, generator=gen, device="cuda")
            full = {f: rmsnorm(scale, x, fixed=f) for f in (False, True)}
            for M in NORM_ROW_COUNTS:
                rows = x[1300 - M:].clone()
                if not torch.equal(rmsnorm(scale, rows),
                                   full[False][1300 - M:]):
                    plain_differs.add(M)
                fixed_equal &= torch.equal(rmsnorm(scale, rows, fixed=True),
                                           full[True][1300 - M:])
        out[str(d)] = dict(plain_rows_differ_at=sorted(plain_differs),
                           fixed_rows_equal=fixed_equal)
    return out


def _time_once(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _median_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    return statistics.median(_time_once(fn) for _ in range(reps))


def _median_ab_ms(fn, reps: int) -> dict:
    """fn with the tree's RMS norm (``fixed`` as the caller asks) and with
    the plain norm (one call of all rows, ``fixed`` ignored), alternated
    call by call so both see the same host: the medians of each."""
    from repro_torch.models import layers as L
    tree = L.rmsnorm
    plain = lambda scale, x, eps=1e-6, fixed=False: tree(scale, x, eps)
    ts: dict = {"fixed": [], "plain": []}
    try:
        for i in range(2 * (reps + 2)):
            name = ("fixed", "plain")[i % 2]
            L.rmsnorm = tree if name == "fixed" else plain
            t = _time_once(fn)
            if i >= 4:              # two warm-up calls of each
                ts[name].append(t)
    finally:
        L.rmsnorm = tree
    return {f"{k}_norm_ms": statistics.median(v) for k, v in ts.items()}


def _profile(fn, reps: int) -> dict:
    """fn under torch.profiler, per call: the host clock around the calls
    and a synchronize, the device's busy time and flash_prefill's part
    of it, the kernel count, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / reps
    dev = [e for e in prof.key_averages() if "CUDA" in str(e.device_type)]
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_t(e) for e in dev) / 1e3 / reps
    return dict(profiled_wall_ms=wall, device_busy_ms=busy,
                flash_prefill_ms=sum(dev_t(e) for e in dev
                                     if "flash_prefill" in e.key)
                / 1e3 / reps,
                kernels=sum(e.count for e in dev) / reps,
                device_idle_share=1 - busy / wall)


@torch.no_grad()
def time_phases(arch: str, reps: int, norm_ab: bool = False) -> dict:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, prefill, \
        prefill_extend
    cfg = get_config(arch)
    model = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    toks = rng.integers(6, cfg.vocab_size, (1, 1316))
    head = {"tokens": toks[:, :1024]}
    phases = dict(head_1024=lambda: prefill(model, head, 2048))
    if arch != "hymba-1.5b":    # hymba cannot extend: the head alone
        _, head_cache = prefill(model, head, 2048)
        _, prefix_cache = prefill_extend(
            model, dict(head_cache), {"tokens": toks[:, 1024:1300]})
        phases = dict(
            monolithic_1300=lambda: prefill(
                model, {"tokens": toks[:, :1300]}, 2048),
            **phases,
            tail_276=lambda: prefill_extend(
                model, head_cache, {"tokens": toks[:, 1024:1300]}),
            suffix_16=lambda: prefill_extend(
                model, prefix_cache, {"tokens": toks[:, 1300:1316]}))
    if norm_ab:
        return {k: _median_ab_ms(f, reps) for k, f in phases.items()}
    out = {f"{k}_ms": _median_ms(f, reps) for k, f in phases.items()}
    out["profile"] = {k: _profile(f, PROFILE_REPS) for k, f in phases.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="tree",
                    choices=("tree", "one", "loop", "batched"))
    ap.add_argument("--arch", default="planner-proxy-100m",
                    choices=("planner-proxy-100m", "hymba-1.5b"))
    ap.add_argument("--check-rows", action="store_true")
    ap.add_argument("--norm-ab", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prefill_bench: no CUDA device")
    import repro_torch
    from repro_torch.models import layers as L
    tree_rows = getattr(L, "matmul_rows", None)
    if args.rows != "tree":
        if tree_rows is None:
            raise SystemExit("prefill_bench: this tree has no matmul_rows")
        L.matmul_rows = {"one": rows_one, "loop": make_rows_loop(BLOCK),
                         "batched": make_rows_batched(BLOCK)}[args.rows]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    res = dict(card=card, tree=repro_torch.__file__, arch=args.arch,
               rows=args.rows, reps=REPS,
               **time_phases(args.arch, REPS, args.norm_ab))
    if args.check_rows:
        res["row_contract"] = check_rows(tree_rows)
        res["norm_row_contract"] = check_norm_rows()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
