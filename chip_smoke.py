"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

  python3 chip_smoke.py [--kernels-only]

Builds the port's Hopper kernels from ``src/repro_torch/csrc/``, holds
each against its plain PyTorch version on the card at the served
planner's shapes (and the decode family's bitwise contracts: paged
decode == decode on the gathered view, each verify row == the decode row
at its position, paged verify == verify on the gathered view), serves
planner-proxy-100m at full width through the port's serve entry point
(dense monolithic and chunked, prefix-cached, paged, speculative dense
and paged, and paged with a pool small enough to preempt), checks that
the paged and speculative runs emit the dense run's tokens with a
self-draft accept rate of 1.0, profiles a full-width decode step and a
speculative round, checks the card's logits against the CPU's on the
same seeded weights, and prints one JSON line per phase. It
fails (non-zero exit, no result line) when no card is present, when it
does not run from a checkout of the repository, or when any phase
fails. ``--kernels-only`` stops after the kernel cases (a quick check of
a kernel change; it prints no result line). Detail goes to
``chiprun_out/chip_smoke.json``, nvcc's register/shared-memory report to
``chip_smoke_build.log`` and a profiler trace of ten full-width decode
steps to ``decode_trace.json`` (open it in Perfetto).

Tolerances:
  * kernel vs plain version (both bf16 out, fp32 inside, different
    summation order): |kernel - plain| <= 1e-2 + 1e-2 * |plain|, i.e. at
    most one bf16 rounding step (relative spacing 2**-7) plus slack;
  * within the decode family (decode, paged decode, verify, paged
    verify): bitwise (``torch.equal``), by design of decode_tile.cuh;
  * card vs CPU logits (fp32 head over a 12-layer bf16 stack, matmuls
    rounded differently on the two devices): max |diff| <= LOGIT_TOL.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
KERNEL_ATOL = KERNEL_RTOL = 1e-2
LOGIT_TOL = 0.1
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_S = 989e12           # H100 SXM dense bf16 tensor cores
ARCH = "planner-proxy-100m"
RESULTS: dict = {}
# the decode family's cases: the full-width planner's heads, 8 ragged
# slots of a 2048-row cache, 16-row blocks of a 1,024-block pool, and
# the verify window of --draft-k 4
B_SLOTS, HQ, HKV, HD, CACHE, BS, NB, WIN = 8, 12, 4, 64, 2048, 16, 1024, 5
KV_LENS = [1, 2048, 300, 1025, 64, 777, 1300, 2]


def emit(phase: str, **kw):
    RESULTS[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def bound(bytes_moved: float, flops: float):
    t_b, t_f = bytes_moved / HBM_BYTES_S, flops / BF16_FLOP_S
    return (1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations")


def err_ok(out, ref) -> float:
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()).all())
    check(bool(torch.isfinite(out.float()).all()), "non-finite kernel out")
    check(ok, f"kernel disagrees with plain version: max err "
              f"{float(diff.max())}")
    return float(diff.max())


# ------------------------------------------------------------ phase 2 ----

def _mk(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16)


def prefill_case(Sq, Sk, q_offset, gen):
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.ref import attention_ref
    import torch.nn.functional as F
    Hq, Hkv, hd = HQ, HKV, HD
    q, k, v = _mk(gen, 1, Hq, Sq, hd), _mk(gen, 1, Hkv, Sk, hd), \
        _mk(gen, 1, Hkv, Sk, hd)
    out = flash_prefill(q, k, v, causal=True, q_offset=q_offset)
    ref = attention_ref(q, k, v, causal=True, q_offset=q_offset)
    err = err_ok(out, ref)
    kpos = torch.arange(Sk, device="cuda")
    qpos = q_offset + torch.arange(Sq, device="cuda")
    mask = kpos[None, :] <= qpos[:, None]                      # (Sq,Sk)
    ms = cuda_ms(lambda: flash_prefill(q, k, v, causal=True,
                                       q_offset=q_offset))
    plain = cuda_ms(lambda: attention_ref(q, k, v, causal=True,
                                          q_offset=q_offset), iters=5)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))
    pairs = int(mask.sum())                       # this run's (q,k) pairs
    keys = min(Sk, q_offset + Sq)
    nbytes = 2 * hd * (2 * Hq * Sq + 2 * Hkv * keys)
    b_ms, b_by = bound(nbytes, 4 * hd * Hq * pairs)
    return dict(Sq=Sq, Sk=Sk, q_offset=q_offset, max_abs_err=err, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def decode_case(kv_len_list, Sk, gen):
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ref import decode_attention_ref
    import torch.nn.functional as F
    B, Hq, Hkv, hd = len(kv_len_list), HQ, HKV, HD
    q, kc, vc = _mk(gen, B, Hq, hd), _mk(gen, B, Hkv, Sk, hd), \
        _mk(gen, B, Hkv, Sk, hd)
    kvl = torch.tensor(kv_len_list, dtype=torch.int32, device="cuda")
    out = flash_decode(q, kc, vc, kvl)
    ref = decode_attention_ref(q, kc, vc, kvl)
    err = err_ok(out, ref)
    mask = (torch.arange(Sk, device="cuda")[None, :]
            < kvl[:, None].long())[:, None, None, :]           # (B,1,1,Sk)
    ms = cuda_ms(lambda: flash_decode(q, kc, vc, kvl))
    plain = cuda_ms(lambda: decode_attention_ref(q, kc, vc, kvl), iters=5)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True))
    n = int(sum(kv_len_list))
    nbytes = 2 * hd * (2 * B * Hq + 2 * Hkv * n) + 4 * B
    b_ms, b_by = bound(nbytes, 4 * hd * Hq * n)
    return dict(B=B, Sk=Sk, kv_len=kv_len_list, max_abs_err=err, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def paged_pool(gen):
    """K/V pools of NB blocks holding the KV_LENS slots' rows through a
    table of shuffled block ids with sentinel tails."""
    mb = CACHE // BS
    kp, vp = _mk(gen, NB, HKV, BS, HD), _mk(gen, NB, HKV, BS, HD)
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(3))
    tab = torch.full((B_SLOTS, mb), NB, dtype=torch.int32)
    used = 0
    for b, n in enumerate(KV_LENS):
        need = -(-n // BS)
        tab[b, :need] = perm[used:used + need].to(torch.int32)
        used += need
    return kp, vp, tab.cuda(), used


def row_limits(kvl):
    """(B, W) key limit of each verify row, clamped at 0."""
    w = torch.arange(WIN, device=kvl.device)
    return torch.clamp(kvl.long()[:, None] - WIN + w[None, :] + 1, min=0)


def verify_err(out, ref, kvl) -> float:
    """Kernel vs plain on rows with keys; rows with none must be 0 (the
    decode kernel's kv_len 0 rule; the oracle's softmax over an all-masked
    row is not defined the same way)."""
    live = (row_limits(kvl) > 0)[:, None, :, None].expand_as(out)
    check(bool((out.float()[~live] == 0).all()), "keyless verify row "
                                                 "not 0")
    return err_ok(out.float()[live], ref.float()[live])


def paged_decode_case(gen):
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.ref import paged_decode_attention_ref, \
        paged_gather_kv
    import torch.nn.functional as F
    q = _mk(gen, B_SLOTS, HQ, HD)
    kp, vp, tab, used = paged_pool(gen)
    kvl = torch.tensor(KV_LENS, dtype=torch.int32, device="cuda")
    out = flash_decode_paged(q, kp, vp, tab, kvl)
    err = err_ok(out, paged_decode_attention_ref(q, kp, vp, tab, kvl))
    kg, vg = paged_gather_kv(kp, tab), paged_gather_kv(vp, tab)
    check(torch.equal(out, flash_decode(q, kg, vg, kvl)),
          "flash_decode_paged != flash_decode on the gathered view")
    mask = (torch.arange(CACHE, device="cuda")[None, :]
            < kvl[:, None].long())[:, None, None, :]
    ms = cuda_ms(lambda: flash_decode_paged(q, kp, vp, tab, kvl))
    plain = cuda_ms(lambda: paged_decode_attention_ref(q, kp, vp, tab, kvl),
                    iters=5)
    gathered = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True))
    n = int(sum(KV_LENS))
    nbytes = 2 * HD * (2 * B_SLOTS * HQ + 2 * HKV * n) + 4 * B_SLOTS \
        + 4 * used
    b_ms, b_by = bound(nbytes, 4 * HD * HQ * n)
    return dict(B=B_SLOTS, kv_len=KV_LENS, block_size=BS, n_blocks=NB,
                max_abs_err=err, bitwise_vs_decode=True, ms=ms,
                plain_ms=plain, library_ms=None,
                sdpa_on_pregathered_view_ms=gathered, bound_ms=b_ms,
                bound_by=b_by)


def verify_cases(gen):
    """flash_verify and flash_verify_paged at W = 5 over the same slots:
    against the fused oracle and the CPU path's row-wise plain version,
    each row bitwise the decode row at its position, paged bitwise
    dense on the gathered view."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_verify import flash_verify, \
        flash_verify_paged
    from repro_torch.kernels.ref import paged_gather_kv, \
        paged_verify_attention_ref, paged_verify_rows_ref, \
        verify_attention_ref, verify_rows_ref
    import torch.nn.functional as F
    q = _mk(gen, B_SLOTS, HQ, WIN, HD)
    kc, vc = _mk(gen, B_SLOTS, HKV, CACHE, HD), _mk(gen, B_SLOTS, HKV,
                                                    CACHE, HD)
    kp, vp, tab, used = paged_pool(gen)
    kvl = torch.tensor(KV_LENS, dtype=torch.int32, device="cuda")
    lim = row_limits(kvl)
    mask = (torch.arange(CACHE, device="cuda")[None, None, :]
            < lim[:, :, None])[:, None]                        # (B,1,W,Sk)
    nbytes = 2 * HD * (2 * B_SLOTS * HQ * WIN + 2 * HKV * sum(KV_LENS)) \
        + 4 * B_SLOTS
    flops = 4 * HD * HQ * int(lim.sum())
    cases = {}

    out = flash_verify(q, kc, vc, kvl)
    err = max(verify_err(out, verify_attention_ref(q, kc, vc, kvl), kvl),
              verify_err(out, verify_rows_ref(q, kc, vc, kvl), kvl))
    for w in range(WIN):
        row = flash_decode(q[:, :, w].contiguous(), kc, vc, lim[:, w])
        check(torch.equal(out[:, :, w], row),
              f"flash_verify row {w} != flash_decode at its position")
    b_ms, b_by = bound(nbytes, flops)
    cases["flash_verify"] = dict(
        max_abs_err=err, bitwise_rows_vs_decode=True,
        ms=cuda_ms(lambda: flash_verify(q, kc, vc, kvl)),
        plain_ms=cuda_ms(lambda: verify_rows_ref(q, kc, vc, kvl), iters=5),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by)

    pout = flash_verify_paged(q, kp, vp, tab, kvl)
    kg, vg = paged_gather_kv(kp, tab), paged_gather_kv(vp, tab)
    err = max(verify_err(pout, paged_verify_attention_ref(q, kp, vp, tab,
                                                          kvl), kvl),
              verify_err(pout, paged_verify_rows_ref(q, kp, vp, tab, kvl),
                         kvl))
    check(torch.equal(pout, flash_verify(q, kg, vg, kvl)),
          "flash_verify_paged != flash_verify on the gathered view")
    b_ms, b_by = bound(nbytes + 4 * used, flops)
    cases["flash_verify_paged"] = dict(
        max_abs_err=err, bitwise_vs_verify_gathered=True,
        ms=cuda_ms(lambda: flash_verify_paged(q, kp, vp, tab, kvl)),
        plain_ms=cuda_ms(lambda: paged_verify_rows_ref(q, kp, vp, tab,
                                                       kvl), iters=5),
        library_ms=None,
        sdpa_on_pregathered_view_ms=cuda_ms(
            lambda: F.scaled_dot_product_attention(
                q, kg, vg, attn_mask=mask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by)
    for c in cases.values():
        c.update(B=B_SLOTS, W=WIN, kv_len=KV_LENS)
    return cases


# ------------------------------------------------------------ phase 3 ----

def serve_runs():
    from repro_torch.kernels import backend as KB
    from repro_torch.launch.serve import main as serve_main
    base = ["--arch", ARCH, "--max-batch", "8", "--cache-len", "2048",
            "--requests", "16", "--max-new", "64", "--temperature", "0"]
    runs = {}
    for name, extra in (("monolithic", []),
                        ("budget_1024", ["--prefill-budget", "1024"])):
        KB.reset_launches()
        res = serve_main(base + extra)
        counts = KB.launch_counts()
        check(res["requests"] == 16, f"{name}: served {res['requests']}")
        check(all(len(o) == 64 for o in res["outputs"].values()),
              f"{name}: short outputs")
        runs[name] = dict(res, launches=counts)
    same = runs["monolithic"]["outputs"] == runs["budget_1024"]["outputs"]
    return runs, same


def paged_spec_runs(dense: dict):
    """The paged and speculative paths through the serve entry point at
    full width, each with the launch counts of its own run, held against
    the dense monolithic run's tokens (its first 61 for the spec runs: 1
    admission token + 12 windows of 5). A closing dense run brackets
    them, so their times compare with a dense run that is not the
    process's first serve."""
    from repro_torch.kernels import backend as KB
    from repro_torch.launch.serve import main as serve_main
    spec = ["--spec-decode", "--draft-k", "4"]
    paged = ["--kv-mode", "paged"]
    runs = {}
    for name, extra, max_new, kernel in (
            ("paged", paged, 64, "flash_decode_paged"),
            ("spec", spec, 61, "flash_verify"),
            ("paged_spec", paged + spec, 61, "flash_verify_paged"),
            ("paged_tight", paged + ["--kv-blocks", "24"], 64,
             "flash_decode_paged"),
            ("dense_again", [], 64, "flash_decode")):
        KB.reset_launches()
        res = serve_main(["--arch", ARCH, "--max-batch", "8", "--cache-len",
                          "2048", "--requests", "16", "--max-new",
                          str(max_new), "--temperature", "0"] + extra)
        counts = KB.launch_counts()
        check(res["requests"] == 16, f"{name}: served {res['requests']}")
        check(counts[kernel] > 0, f"{name}: no {kernel} launch")
        same = all(out == dense[rid][:max_new]
                   for rid, out in res["outputs"].items())
        check(same, f"{name}: tokens differ from the dense run's")
        st = res["stats"]
        if "--spec-decode" in extra:
            check(res["spec_accept_rate"] == 1.0,
                  f"{name}: self-draft accept rate "
                  f"{res['spec_accept_rate']} (a verify row differs from "
                  f"its decode row)")
        if name == "paged_tight":
            check(st["preemptions"] > 0, "paged_tight: no preemption")
            check(st["resumes"] == st["preemptions"],
                  "paged_tight: resumes != preemptions")
        runs[name] = dict(requests=res["requests"], seconds=res["seconds"],
                          steps=res["steps"], tok_s=res["tok_s"],
                          step_ms=res["step_ms"], launches=counts,
                          tokens_equal_dense=same,
                          spec_accept_rate=res["spec_accept_rate"],
                          tokens_per_step=st["tokens_per_step"],
                          preemptions=st["preemptions"],
                          resumes=st["resumes"],
                          kv_blocks_used_peak=st["kv_blocks_used_peak"])
    return runs


def prefix_runs():
    """Engine with a registered ~1,300-token prefix: a 1024-token head
    prefill, a tail extend at q_offset 1024, then per-hit suffix extends at
    q_offset ~1300; compared with the same prompts prefilled whole."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import backend as KB
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.sampling import SamplerConfig
    cfg = get_config(ARCH)
    model = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prefix = [2] + rng.integers(6, cfg.vocab_size, 1299).tolist()
    prompts = [prefix + rng.integers(6, cfg.vocab_size, 12 + i).tolist()
               for i in range(8)]
    out = {}
    for name, use_prefix in (("hit", True), ("miss", False)):
        eng = InferenceEngine(cfg, model, max_batch=8, cache_len=2048)
        KB.reset_launches()
        t0 = time.time()
        if use_prefix:
            eng.register_prefix("p", prefix)
        for p in prompts:
            eng.add_request(p, max_new_tokens=32,
                            sampler=SamplerConfig(temperature=0.0),
                            prefix_key="p" if use_prefix else None)
        done = eng.run_until_done()
        torch.cuda.synchronize()
        dt = time.time() - t0
        st = eng.throughput_stats()
        out[name] = dict(seconds=dt, launches=KB.launch_counts(),
                         prefix_hits=st["prefix_hits"],
                         tok_s=st["tokens_generated"] / dt,
                         outputs={r.request_id: r.output for r in done})
    check(out["hit"]["prefix_hits"] == 8, "prefix run: expected 8 hits")
    same = out["hit"]["outputs"] == out["miss"]["outputs"]
    return out, same


def profile_decode(steps: int = 10):
    """Where a full-width decode step's time goes: ``torch.profiler``
    over ``steps`` engine steps with 8 busy slots (past admission), device
    kernel time by name against the host clock around the same steps."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.sampling import SamplerConfig
    cfg = get_config(ARCH)
    eng = InferenceEngine(cfg, init_params(cfg, seed=0, device="cuda"),
                          max_batch=8, cache_len=2048)
    rng = np.random.default_rng(2)
    for n in (40, 300, 900, 20, 1500, 64, 700, 128):
        eng.add_request(rng.integers(6, cfg.vocab_size, n).tolist(),
                        max_new_tokens=steps + 8,
                        sampler=SamplerConfig(temperature=0.0))
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    check(eng.busy_slots() == 8, "profile: slots not all busy")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT_DIR / "decode_trace.json"))
    dev = [e for e in prof.key_averages()
           if "CUDA" in str(e.device_type)]
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    busy_us = sum(dev_t(e) for e in dev)
    top = sorted(dev, key=dev_t, reverse=True)[:8]
    return dict(steps=steps, step_ms=1e3 * wall / steps,
                device_busy_ms_per_step=busy_us / 1e3 / steps,
                device_idle_share=1 - busy_us / 1e6 / wall,
                kernels_per_step=sum(e.count for e in dev) / steps,
                top_kernels=[dict(name=e.key[:80], count=e.count,
                                  ms_per_step=dev_t(e) / 1e3 / steps)
                             for e in top])


def profile_spec(rounds: int = 4):
    """Where a full-width speculative round's time goes: the host clock
    around the draft's steps (``spec.draft`` + ``spec.catch_up``, each
    ending in a synchronize) against the whole round, and
    ``torch.profiler`` device time over the same rounds, with 8 busy
    slots (k=4 self-draft, dense)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.sampling import SamplerConfig
    from repro_torch.serving.specdec import SpecConfig
    cfg = get_config(ARCH)
    model = init_params(cfg, seed=0, device="cuda")
    eng = InferenceEngine(cfg, model, max_batch=8, cache_len=2048,
                          spec_decode=SpecConfig(cfg, model, k=4))
    rng = np.random.default_rng(2)
    for n in (40, 300, 900, 20, 1500, 64, 700, 128):
        eng.add_request(rng.integers(6, cfg.vocab_size, n).tolist(),
                        max_new_tokens=5 * (rounds + 4),
                        sampler=SamplerConfig(temperature=0.0))
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    check(eng.busy_slots() == 8, "spec profile: slots not all busy")
    draft_s = [0.0]

    def timed(fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            draft_s[0] += time.perf_counter() - t
            return out
        return run
    eng.spec.draft = timed(eng.spec.draft)
    eng.spec.catch_up = timed(eng.spec.catch_up)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if "CUDA" in str(e.device_type)]
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    busy_us = sum(dev_t(e) for e in dev)
    top = sorted(dev, key=dev_t, reverse=True)[:6]
    st = eng.throughput_stats()
    return dict(rounds=rounds, round_ms=1e3 * wall / rounds,
                draft_ms_per_round=1e3 * draft_s[0] / rounds,
                verify_and_accept_ms_per_round=1e3 * (wall - draft_s[0])
                / rounds,
                device_busy_ms_per_round=busy_us / 1e3 / rounds,
                device_idle_share=1 - busy_us / 1e6 / wall,
                kernels_per_round=sum(e.count for e in dev) / rounds,
                spec_accept_rate=st["spec_accept_rate"],
                top_kernels=[dict(name=e.key[:80], count=e.count,
                                  ms_per_round=dev_t(e) / 1e3 / rounds)
                             for e in top])


# ------------------------------------------------------------ phase 4 ----

def card_vs_cpu():
    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, init_params, prefill
    cfg = get_config(ARCH)
    rng = np.random.default_rng(1)
    prompt = rng.integers(6, cfg.vocab_size, (1, 300))
    forced = rng.integers(6, cfg.vocab_size, 16)
    logits = {}
    for dev in ("cuda", "cpu"):
        model = init_params(cfg, seed=0, device=dev)
        lg, cache = prefill(model, {"tokens": prompt}, 512)
        seq = [lg.float().cpu()]
        for t in forced:
            lg, cache = decode_step(model, cache, {"tokens": [[int(t)]]})
            seq.append(lg.float().cpu())
        logits[dev] = torch.cat(seq)                           # (17, V)
    a, b = logits["cuda"], logits["cpu"]
    check(bool(torch.isfinite(a).all()), "non-finite card logits")
    diff = float((a - b).abs().max())
    agree = int((a.argmax(-1) == b.argmax(-1)).sum())
    check(diff <= LOGIT_TOL, f"card vs CPU logits differ by {diff}")
    return dict(max_abs_diff=diff, tol=LOGIT_TOL, argmax_agree=agree,
                positions=int(a.shape[0]),
                logit_absmax=float(b.abs().max()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel cases; no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import backend as KB
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.flash_verify import flash_verify, \
        flash_verify_paged

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0]
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.time()
    build = _build.build_all()
    emit("build", seconds=time.time() - t0, dir=str(build.relative_to(ROOT)),
         sources=sorted(p.name for p in (ROOT / "src/repro_torch/csrc")
                        .glob("*.cu")))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in _build.build_logs().items()))

    gen = torch.Generator(device="cuda").manual_seed(0)
    pre = [prefill_case(s, s, 0, gen) for s in (37, 512, 1024)]
    pre += [prefill_case(sq, 2048, off, gen)
            for sq in (16, 1024) for off in (0, 700)]
    for c in pre:
        emit("kernel_prefill", **c)
    dec = [decode_case(KV_LENS, CACHE, gen)]
    for c in dec:
        emit("kernel_decode", **c)
    paged_dec = paged_decode_case(gen)
    emit("kernel_decode_paged", **paged_dec)
    ver = verify_cases(gen)
    for name, c in ver.items():
        emit(f"kernel_{name[6:]}", **c)
    if args.kernels_only:
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
            RESULTS, indent=1, default=str))
        return 0

    runs, same_budget = serve_runs()
    for name, r in runs.items():
        emit(f"serve_{name}", requests=r["requests"], seconds=r["seconds"],
             steps=r["steps"], tok_s=r["tok_s"], step_ms=r["step_ms"],
             launches=r["launches"])
        check(r["launches"]["flash_prefill"] > 0, f"{name}: no prefill "
                                                  f"kernel launch")
        check(r["launches"]["flash_decode"] > 0, f"{name}: no decode "
                                                 f"kernel launch")
    pref, same_prefix = prefix_runs()
    for name, r in pref.items():
        emit(f"prefix_{name}", seconds=r["seconds"], tok_s=r["tok_s"],
             launches=r["launches"], prefix_hits=r["prefix_hits"])
    emit("token_equality", budget_vs_monolithic=same_budget,
         prefix_hit_vs_miss=same_prefix)
    paths = paged_spec_runs(runs["monolithic"]["outputs"])
    for name, r in paths.items():
        emit(f"serve_{name}", **r)
    emit("decode_profile", **profile_decode())
    emit("spec_profile", **profile_spec())

    emit("card_vs_cpu", **card_vs_cpu())

    # each kernel's launches come from the run of the path it serves;
    # its times from its case at the main path's widest shape (the
    # 1024-token prefix head prefill; 8 ragged slots of a 2048 cache)
    mono = runs["monolithic"]["launches"]
    rows = []
    for fn, cases, src, rep, launches in (
            (flash_prefill, pre, "flash_prefill.cu",
             "src/repro/kernels/flash_prefill.py:84", mono),
            (flash_decode, dec, "flash_decode.cu",
             "src/repro/kernels/flash_decode.py:65", mono),
            (flash_decode_paged, [paged_dec], "flash_decode_paged.cu",
             "src/repro/kernels/flash_decode_paged.py:77",
             paths["paged"]["launches"]),
            (flash_verify, [ver["flash_verify"]], "flash_verify.cu",
             "src/repro/kernels/flash_verify.py:95",
             paths["spec"]["launches"]),
            (flash_verify_paged, [ver["flash_verify_paged"]],
             "flash_verify.cu", "src/repro/kernels/flash_verify.py:149",
             paths["paged_spec"]["launches"])):
        c = next(c for c in cases if c.get("Sq", 1024) == 1024
                 and c.get("Sk", CACHE) in (1024, 2048)
                 and c.get("q_offset", 0) == 0)
        rows.append({"name": fn.__name__, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}",
                     "replaces": rep, "launches": launches[fn.__name__],
                     "max_abs_err": max(x["max_abs_err"] for x in cases),
                     "ms": c["ms"], "plain_ms": c["plain_ms"],
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"]})
    RESULTS["kernels"] = rows
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        RESULTS, indent=1, default=str))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
