"""Time the decode family's kernels on the card at chip_smoke.py's cases.

  PYTHONPATH=<tree>/src python3 src/repro_torch/launch/decode_bench.py \
      [--label NAME] [--iters N]

For each case (8 ragged slots of a 2,048-row cache: the planner's heads
12/4 of 64, kimi-k2's 64/8 of 128, arctic's 56/8 of 32; hymba's 25/5 of
64 over full and partly filled 1,024-row rings) it times flash_decode
(and flash_verify at W = 5, 9 and 22, where chip_smoke.py has them) and
their paged twins, over an identity block table on the same cache and
over shuffled tables with sentinel tails that hold the same rows in
blocks of each of BLOCK_SIZES rows, by CUDA events over ``--iters``
back-to-back wrapper calls and by the kernel's own device time per call
from ``torch.profiler``, beside one ``F.scaled_dot_product_attention``
call on the same inputs (the dense cache: the paged rows' gathered
view). It prints one JSON line per case with the sha256 of each
kernel's output bytes (``bits``, ``paged_bits`` and ``paged_bits_bs<N>``),
so two trees timed in one call can also be held to the same bits; every
paged output of a case is also the dense output's bits, as the slots'
rows are the same.

It imports ``repro_torch`` from ``PYTHONPATH``, so one copy of this
script times the kernels of any tree that has the same wrapper
signatures: run it for two trees in one chip call, in turns, to compare
them on one card. Inputs come from a seeded generator on the card, the
same in every process.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

KV_LENS = [1, 2048, 300, 1025, 64, 777, 1300, 2]
HYMBA_RINGS = ([1024] * 8, [1, 300, 1024, 777, 64, 1000, 2, 513])
# (family, Hq, Hkv, hd, cache rows, kv lens, verify windows)
CASES = [("planner", 12, 4, 64, 2048, KV_LENS, (5, 22)),
         ("kimi", 64, 8, 128, 2048, KV_LENS, (5, 9)),
         ("arctic", 56, 8, 32, 2048, KV_LENS, (5,)),
         ("hymba_full", 25, 5, 64, 1024, HYMBA_RINGS[0], ()),
         ("hymba_ragged", 25, 5, 64, 1024, HYMBA_RINGS[1], ())]
BS = 16
# the shuffled tables' block sizes: the engine's 16, 8, 12 and 24 (not
# dividing a 128-key tile; tables then cover a few rows past the cache),
# and 256 (past a tile)
BLOCK_SIZES = (16, 8, 12, 24, 256)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call of ``fn`` by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str = "", iters: int = 20, tries: int = 3,
              floor: bool = False):
    """Device time per call of ``fn``: the self CUDA time of the kernels
    whose name contains ``kernel`` (all of them where it is empty), under
    ``torch.profiler`` over ``iters`` calls. A profile now and then misses
    some of its kernels' events, so a profile counts only if it saw
    ``iters`` launches of the named kernel (a whole multiple of ``iters``
    device events where none is named); the first such profile of
    ``tries`` gives the time, and None stands where none did.

    With ``floor`` (and a ``kernel`` named), a one-element ``zero_()``
    follows each call, and the result is (time, floor): the floor is the
    zero_'s device time per call, what any launch costs the device. Such
    a profile counts only if it also saw ``iters`` launches besides the
    named kernel's; (None, None) stands where none did."""
    from torch.profiler import ProfilerActivity, profile
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    call = fn
    if floor:
        z = torch.empty(1, device="cuda")
        call = lambda: (fn(), z.zero_())
    for _ in range(3):
        call()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if "CUDA" in str(e.device_type)]
        seen = [e for e in dev if kernel in e.key]
        n = sum(e.count for e in seen)
        per_call = lambda es: sum(dev_t(e) for e in es) / 1e3 / iters
        if floor:
            rest = [e for e in dev if kernel not in e.key]
            if kernel and n == iters == sum(e.count for e in rest):
                return per_call(seen), per_call(rest)
        elif n == iters or (not kernel and n and n % iters == 0):
            return per_call(seen)
    return (None, None) if floor else None


def digest(t) -> str:
    torch.cuda.synchronize()
    return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def timed(name, fn, kernel, iters):
    return {f"{name}_ms": cuda_ms(fn, iters),
            f"{name}_device_ms": device_ms(fn, kernel, iters)}


def shuffled_pools(kc, vc, kv, bs):
    """The slots' first kv[b] rows of the caches (B, Hkv, Sk, hd) as pools
    of ``bs``-row blocks in shuffled order (the last block of a slot
    zero-padded past Sk), and their (B, ceil(Sk / bs)) table with
    sentinel tails: the pool's block count, and past it in each slot's
    last entry."""
    B, Hkv, Sk, hd = kc.shape
    mb = -(-Sk // bs)
    need = [-(-n // bs) for n in kv]
    nb = sum(need) + 1
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(bs))
    tab = torch.full((B, mb), nb, dtype=torch.int32)
    tab[:, -1] += 5
    pools = []
    for c in (kc, vc):
        blocks = F.pad(c, (0, 0, 0, mb * bs - Sk)).reshape(
            B, Hkv, mb, bs, hd).transpose(1, 2)        # (B, mb, Hkv, bs, hd)
        pool = torch.zeros(nb, Hkv, bs, hd, dtype=c.dtype, device=c.device)
        used = 0
        for b, k in enumerate(need):
            ids = perm[used:used + k]
            pool[ids.to(c.device)] = blocks[b, :k]
            tab[b, :k] = ids.to(torch.int32)
            used += k
        pools.append(pool)
    return pools[0], pools[1], tab.to(kc.device)


def paged_runs(rec, run, kernel, pools, iters):
    """Bits and times of ``run(kp, vp, tab)`` over each block size's
    shuffled pools, into ``rec``."""
    for bs, (kp, vp, tab) in pools.items():
        fn = lambda: run(kp, vp, tab)
        rec[f"paged_bits_bs{bs}"] = digest(fn())
        rec.update(timed(f"paged_bs{bs}", fn, kernel, iters))


def run(iters: int, label: str) -> list:
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.flash_verify import flash_verify, \
        flash_verify_paged
    from repro_torch.kernels.ref import identity_pool
    gen = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *shape: torch.randn(*shape, generator=gen,
                                    device="cuda").to(torch.bfloat16)
    out = []
    for fam, Hq, Hkv, hd, Sk, kv, windows in CASES:
        B = len(kv)
        kc, vc, q = mk(B, Hkv, Sk, hd), mk(B, Hkv, Sk, hd), mk(B, Hq, hd)
        (kp, tab), (vp, _) = identity_pool(kc, BS), identity_pool(vc, BS)
        pools = {bs: shuffled_pools(kc, vc, kv, bs) for bs in BLOCK_SIZES}
        kvl = torch.tensor(kv, dtype=torch.int32, device="cuda")
        keys = torch.arange(Sk, device="cuda")
        mask = (keys[None, :] < kvl[:, None].long())[:, None, None, :]
        dense = lambda: flash_decode(q, kc, vc, kvl)
        paged = lambda: flash_decode_paged(q, kp, vp, tab, kvl)
        sdpa = lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)
        rec = dict(label=label, kernel="flash_decode", family=fam,
                   heads=[Hq, Hkv, hd], Sk=Sk, kv_len=kv,
                   bits=digest(dense()), paged_bits=digest(paged()))
        rec.update(timed("dense", dense, "flash_decode_kernel", iters))
        rec.update(timed("paged", paged, "flash_decode_paged_kernel",
                         iters))
        paged_runs(rec, lambda kp, vp, tab: flash_decode_paged(
            q, kp, vp, tab, kvl), "flash_decode_paged_kernel", pools, iters)
        rec.update(timed("sdpa", sdpa, "", iters))
        out.append(rec)
        print(json.dumps(rec), flush=True)
        for W in windows:
            qv = mk(B, Hq, W, hd)
            lim = torch.clamp(kvl.long()[:, None] - W
                              + torch.arange(W, device="cuda")[None, :] + 1,
                              min=0)
            vmask = (keys[None, None, :] < lim[:, :, None])[:, None]
            dense = lambda: flash_verify(qv, kc, vc, kvl)
            paged = lambda: flash_verify_paged(qv, kp, vp, tab, kvl)
            sdpa = lambda: F.scaled_dot_product_attention(
                qv, kc, vc, attn_mask=vmask, enable_gqa=True)
            rec = dict(label=label, kernel="flash_verify", family=fam,
                       heads=[Hq, Hkv, hd], W=W, Sk=Sk, kv_len=kv,
                       bits=digest(dense()), paged_bits=digest(paged()))
            rec.update(timed("dense", dense, "flash_verify_kernel", iters))
            rec.update(timed("paged", paged, "flash_verify_paged_kernel",
                             iters))
            paged_runs(rec, lambda kp, vp, tab: flash_verify_paged(
                qv, kp, vp, tab, kvl), "flash_verify_paged_kernel", pools,
                iters)
            rec.update(timed("sdpa", sdpa, "", iters))
            out.append(rec)
            print(json.dumps(rec), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_bench: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": card}), flush=True)
    run(args.iters, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
