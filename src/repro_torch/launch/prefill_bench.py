"""Time the served planner's prefill phases at full width on the card,
and check that fixed-size row products give a row the same bits at any
row count.

  PYTHONPATH=src python3 src/repro_torch/launch/prefill_bench.py \
      [--rows tree|one|loop|batched] [--check-rows]

The phases are those of a prefix-cached 1,312-token prompt (the prefix
phase of ``chip_smoke.py``) on planner-proxy-100m at full width, random
weights from seed 0, cache 2048: a 1,300-token monolithic prefill, the
1,024-token head prefill, the 276-token tail extend at position 1,024
and a 16-token suffix extend at position 1,300. Each is timed on the
host clock around the call and a synchronize (median of REPS after two
warm-up calls), so launch overhead counts.

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
in ROW_COUNTS; and whether ``batched`` equals ``loop``. Prints one JSON
line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

ROW_COUNTS = (1, 16, 32, 128, 276, 1024, 1050)
BLOCK = 128
REPS = 20
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


def _median_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


@torch.no_grad()
def time_phases(reps: int) -> dict:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, prefill, \
        prefill_extend
    cfg = get_config("planner-proxy-100m")
    model = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    toks = rng.integers(6, cfg.vocab_size, (1, 1316))
    head = {"tokens": toks[:, :1024]}
    _, head_cache = prefill(model, head, 2048)
    _, prefix_cache = prefill_extend(
        model, dict(head_cache), {"tokens": toks[:, 1024:1300]})
    return dict(
        monolithic_1300_ms=_median_ms(
            lambda: prefill(model, {"tokens": toks[:, :1300]}, 2048), reps),
        head_1024_ms=_median_ms(lambda: prefill(model, head, 2048), reps),
        tail_276_ms=_median_ms(lambda: prefill_extend(
            model, head_cache, {"tokens": toks[:, 1024:1300]}), reps),
        suffix_16_ms=_median_ms(lambda: prefill_extend(
            model, prefix_cache, {"tokens": toks[:, 1300:1316]}), reps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="tree",
                    choices=("tree", "one", "loop", "batched"))
    ap.add_argument("--check-rows", action="store_true")
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
    res = dict(card=card, tree=repro_torch.__file__, rows=args.rows,
               reps=REPS, **time_phases(REPS))
    if args.check_rows:
        res["row_contract"] = check_rows(tree_rows)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
