"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

  python3 chip_smoke.py [--kernels-only]

Builds the port's six Hopper kernels from ``src/repro_torch/csrc/``,
holds each against its plain PyTorch version on the card: the attention
kernels at the served planner's shapes (head dim 64) and at head dims
128 and 32 with the MoE families' heads (kimi-k2's 64/8 and arctic's
56/8), each time with the decode family's bitwise contracts (paged
decode == decode on the gathered view, each verify row == the decode row
at its position, paged verify == verify on the gathered view); the MoE
router at the MoE families' (tokens, experts, top-k). Then it serves
planner-proxy-100m at full width through the launcher's serving
function (dense monolithic and chunked, paged, speculative dense and
paged, and paged with a pool small enough to preempt), checks that every
run emits the monolithic run's tokens with a self-draft accept rate of
1.0, that chunked prefill and prefix hits of 1,312-token prompts do too,
profiles a full-width decode step and a speculative round, and checks
the card's logits against the CPU's on the same seeded weights. Then the
MoE families at their published widths with the depth cut
(kimi-k2-1t-a32b: its dense first layer and one MoE layer of 384 experts
top-8; arctic-480b: one MoE layer of 128 experts top-2), through the
same functions: dense, paged and (kimi) speculative dense and paged,
tokens equal to the dense run's and an accept rate of 1.0; budgeted ==
monolithic and prefix hit == miss, printed at the config's capacity
factor and asserted at 100; a profile of kimi's decode step; card vs
CPU on both MoE smoke configs. It prints
one JSON line per phase. It fails (non-zero exit, no result line) when
no card is present, when it does not run from a checkout of the
repository, or when any phase fails. ``--kernels-only`` stops after the
kernel cases (a quick check of a kernel change; it prints no result
line). Detail goes to ``chiprun_out/chip_smoke.json``, nvcc's
register/shared-memory report to ``chip_smoke_build.log`` and profiler
traces of full-width decode steps to ``decode_trace.json`` (planner)
and ``moe_decode_trace.json`` (kimi-k2) (open them in Perfetto).

Tolerances:
  * kernel vs plain version (both bf16 out, fp32 inside, different
    summation order): |kernel - plain| <= 1e-2 + 1e-2 * |plain|, i.e. at
    most one bf16 rounding step (relative spacing 2**-7) plus slack;
  * within the decode family (decode, paged decode, verify, paged
    verify): bitwise (``torch.equal``), by design of decode_tile.cuh;
  * card vs CPU logits (fp32 head over a 12-layer bf16 stack, matmuls
    rounded differently on the two devices): max |diff| <= LOGIT_TOL;
    for the MoE smoke configs on the tokens whose routes agree in every
    layer (a near-tie may route a token to another expert on the other
    device; the count of such tokens is printed);
  * router kernel vs plain version: ids equal, weights within 1e-5 (fp32
    softmax and renormalisation, summed in another order).
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
FP32_FLOP_S = 67e12            # H100 SXM fp32 outside the tensor cores
ARCH = "planner-proxy-100m"
RESULTS: dict = {}
T_START = time.time()
# the decode family's cases: the full-width planner's heads, 8 ragged
# slots of a 2048-row cache, 16-row blocks of a 1,024-block pool, and
# the verify window of --draft-k 4
B_SLOTS, HQ, HKV, HD, CACHE, BS, NB, WIN = 8, 12, 4, 64, 2048, 16, 1024, 5
KV_LENS = [1, 2048, 300, 1025, 64, 777, 1300, 2]


def emit(phase: str, **kw):
    """Print one phase's JSON line; chip_smoke.json keeps every entry of
    a phase that repeats (a kernel's cases) in a list."""
    RESULTS.setdefault(phase, []).append(kw)
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


def bound(bytes_moved: float, flops: float, flop_s: float = BF16_FLOP_S):
    t_b, t_f = bytes_moved / HBM_BYTES_S, flops / flop_s
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


def prefill_case(Sq, Sk, q_offset, gen, heads=(HQ, HKV, HD)):
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.ref import attention_ref
    import torch.nn.functional as F
    Hq, Hkv, hd = heads
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
    return dict(Sq=Sq, Sk=Sk, q_offset=q_offset, heads=list(heads),
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


def decode_case(kv_len_list, Sk, gen, heads=(HQ, HKV, HD)):
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ref import decode_attention_ref
    import torch.nn.functional as F
    B, (Hq, Hkv, hd) = len(kv_len_list), heads
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
    return dict(B=B, Sk=Sk, kv_len=kv_len_list, heads=list(heads),
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


def paged_pool(gen, Hkv=HKV, hd=HD):
    """K/V pools of NB blocks holding the KV_LENS slots' rows through a
    table of shuffled block ids with sentinel tails."""
    mb = CACHE // BS
    kp, vp = _mk(gen, NB, Hkv, BS, hd), _mk(gen, NB, Hkv, BS, hd)
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


def paged_decode_case(gen, heads=(HQ, HKV, HD)):
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.ref import paged_decode_attention_ref, \
        paged_gather_kv
    import torch.nn.functional as F
    Hq, Hkv, hd = heads
    q = _mk(gen, B_SLOTS, Hq, hd)
    kp, vp, tab, used = paged_pool(gen, Hkv, hd)
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
    nbytes = 2 * hd * (2 * B_SLOTS * Hq + 2 * Hkv * n) + 4 * B_SLOTS \
        + 4 * used
    b_ms, b_by = bound(nbytes, 4 * hd * Hq * n)
    return dict(B=B_SLOTS, kv_len=KV_LENS, block_size=BS, n_blocks=NB,
                heads=list(heads),
                max_abs_err=err, bitwise_vs_decode=True, ms=ms,
                plain_ms=plain, library_ms=None,
                sdpa_on_pregathered_view_ms=gathered, bound_ms=b_ms,
                bound_by=b_by)


def verify_cases(gen, heads=(HQ, HKV, HD)):
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
    Hq, Hkv, hd = heads
    q = _mk(gen, B_SLOTS, Hq, WIN, hd)
    kc, vc = _mk(gen, B_SLOTS, Hkv, CACHE, hd), _mk(gen, B_SLOTS, Hkv,
                                                    CACHE, hd)
    kp, vp, tab, used = paged_pool(gen, Hkv, hd)
    kvl = torch.tensor(KV_LENS, dtype=torch.int32, device="cuda")
    lim = row_limits(kvl)
    mask = (torch.arange(CACHE, device="cuda")[None, None, :]
            < lim[:, :, None])[:, None]                        # (B,1,W,Sk)
    nbytes = 2 * hd * (2 * B_SLOTS * Hq * WIN + 2 * Hkv * sum(KV_LENS)) \
        + 4 * B_SLOTS
    flops = 4 * hd * Hq * int(lim.sum())
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
        c.update(B=B_SLOTS, W=WIN, kv_len=KV_LENS, heads=list(heads))
    return cases


# ---------------------------------------- MoE slice: kernels at hd 32/128 ----

# the MoE families' attention heads (Hq, Hkv): kimi-k2 (G = 8) and arctic
# (G = 7, the first group size that is not a power of two)
MOE_HEADS = {"kimi": (64, 8), "arctic": (56, 8)}
# the router's (T, E, k): kimi and arctic at decode (8 slots) and at a
# 1,024-token prefill, and a ragged T
ROUTER_CASES = [(8, 128, 2), (8, 384, 8), (1024, 128, 2), (1024, 384, 8),
                (37, 384, 8)]
ROUTER_WTOL = 1e-5


def head_dim_cases(gen):
    """All five attention kernels at head dims 128 and 32 with the MoE
    families' heads: prefill at Sq=Sk=1024 and an extend at q_offset 700,
    the decode family over 8 ragged slots of a 2048 cache with its three
    bitwise equalities (each case checks them)."""
    out = []
    for hd in (128, 32):
        for fam, (hq, hkv) in MOE_HEADS.items():
            heads = (hq, hkv, hd)
            tag = dict(family=fam, hd=hd)
            for sq, sk, off in ((1024, 1024, 0), (1024, 2048, 700)):
                out.append(("kernel_prefill",
                            dict(prefill_case(sq, sk, off, gen, heads),
                                 **tag)))
            out.append(("kernel_decode",
                        dict(decode_case(KV_LENS, CACHE, gen, heads), **tag)))
            out.append(("kernel_decode_paged",
                        dict(paged_decode_case(gen, heads), **tag)))
            for name, c in verify_cases(gen, heads).items():
                out.append((f"kernel_{name[6:]}", dict(c, **tag)))
    return out


def _ptxas_registers(log: str, symbol: str) -> list:
    """The 'Used N registers' figures nvcc reports for kernels whose
    mangled name contains ``symbol``."""
    regs, current = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" \
                in line:
            current = symbol in line
        if current and "Used" in line and "registers" in line:
            regs.append(line.split("Used")[1].split("registers")[0].strip())
    return regs


def router_cases(gen, build_log: str):
    """moe_router_topk against its plain version on the card: ids equal,
    weights within ROUTER_WTOL; its time, bound and the softmax + topk +
    renormalisation yardstick (no one PyTorch call computes it)."""
    from repro_torch.kernels.moe_router import moe_router_topk
    from repro_torch.kernels.ref import router_topk_ref
    out = []
    for T, E, k in ROUTER_CASES:
        logits = torch.randn(T, E, generator=gen, device="cuda") * 3.0
        w, idx = moe_router_topk(logits, k)
        rw, ridx, _ = router_topk_ref(logits, k)
        torch.cuda.synchronize()
        check(torch.equal(idx, ridx), f"router ids differ at {(T, E, k)}: "
              f"{int((idx != ridx).any(-1).sum())} rows")
        err = float((w - rw).abs().max())
        check(err <= ROUTER_WTOL, f"router weights differ by {err}")

        def yardstick():
            p = torch.softmax(logits, -1)
            tw, ti = torch.topk(p, k, dim=-1)
            return tw / torch.clamp(tw.sum(-1, keepdim=True), min=1e-9), ti
        b_ms, b_by = bound(T * E * 4 + T * k * 8, T * E * (4 + 2 * k),
                           FP32_FLOP_S)
        out.append(dict(T=T, E=E, k=k, max_abs_err=err, ids_equal=True,
                        ms=cuda_ms(lambda: moe_router_topk(logits, k)),
                        plain_ms=cuda_ms(lambda: router_topk_ref(logits, k),
                                         iters=5),
                        library_ms=None,
                        softmax_topk_ms=cuda_ms(yardstick),
                        bound_ms=b_ms, bound_by=b_by,
                        registers=_ptxas_registers(build_log, "moe_router")))
    return out


# ------------------------------------ serving: the planner and MoE stacks ----

PAGED = ["--kv-mode", "paged"]
SPEC = ["--spec-decode", "--draft-k", "4"]
# (name, extra serve flags, new tokens, kernels the run must launch); the
# spec runs' new tokens are 1 admission token + whole windows of 5
PLANNER_MODES = [
    ("monolithic", [], 64, ("flash_prefill", "flash_decode")),
    ("budget_1024", ["--prefill-budget", "1024"], 64,
     ("flash_prefill", "flash_decode")),
    ("paged", PAGED, 64, ("flash_prefill", "flash_decode_paged")),
    ("spec", SPEC, 61, ("flash_prefill", "flash_verify")),
    ("paged_spec", PAGED + SPEC, 61, ("flash_prefill", "flash_verify_paged")),
    ("paged_tight", PAGED + ["--kv-blocks", "24"], 64,
     ("flash_prefill", "flash_decode_paged")),
    ("dense_again", [], 64, ("flash_prefill", "flash_decode"))]
_MOE = ("flash_prefill", "moe_router_topk")
MOE_MODES = {
    "kimi-k2-1t-a32b": [
        ("dense", [], 32, _MOE + ("flash_decode",)),
        ("paged", PAGED, 32, _MOE + ("flash_decode_paged",)),
        ("spec", SPEC, 31, _MOE + ("flash_verify",)),
        ("paged_spec", PAGED + SPEC, 31, _MOE + ("flash_verify_paged",))],
    "arctic-480b": [
        ("dense", [], 32, _MOE + ("flash_decode",)),
        ("paged", PAGED, 32, _MOE + ("flash_decode_paged",))]}


def serve_runs(arch, cfg, model, modes):
    """``model`` (built for ``cfg``) through the launcher's serving
    function once per mode: 8 slots, cache 2048, 16 requests, T=0. Each
    run has the launch counts of its own run and must launch the mode's
    kernels; its tokens must equal the first mode's (their first
    ``max_new``), a spec run's self-draft accept rate must be exactly 1.0
    and a pool that preempts must resume as often. The planner's closing
    dense run brackets the others, so their times compare with a dense
    run that is not the process's first serve."""
    from repro_torch.kernels import backend as KB
    from repro_torch.launch.serve import parse_args, serve
    runs, ref = {}, None
    for name, extra, max_new, kernels in modes:
        KB.reset_launches()
        res = serve(cfg, model, parse_args(
            ["--arch", arch, "--max-batch", "8", "--cache-len", "2048",
             "--requests", "16", "--max-new", str(max_new),
             "--temperature", "0"] + extra))
        counts = KB.launch_counts()
        check(res["requests"] == 16, f"{arch} {name}: served "
                                     f"{res['requests']}")
        missing = [k for k in kernels if not counts[k]]
        check(not missing, f"{arch} {name}: no launch of {missing}")
        if ref is None:
            ref = res["outputs"]
            check(all(len(o) == max_new for o in ref.values()),
                  f"{arch} {name}: short outputs")
        same = all(out == ref[rid][:max_new]
                   for rid, out in res["outputs"].items())
        check(same, f"{arch} {name}: tokens differ from the "
                    f"{modes[0][0]} run's")
        st = res["stats"]
        if "--spec-decode" in extra:
            check(res["spec_accept_rate"] == 1.0,
                  f"{arch} {name}: self-draft accept rate "
                  f"{res['spec_accept_rate']} (a verify row differs from "
                  f"its decode row)")
        if "--kv-blocks" in extra:
            check(st["preemptions"] > 0, f"{name}: no preemption")
            check(st["resumes"] == st["preemptions"],
                  f"{name}: resumes != preemptions")
        runs[name] = dict(requests=res["requests"], seconds=res["seconds"],
                          steps=res["steps"], tok_s=res["tok_s"],
                          step_ms=res["step_ms"], launches=counts,
                          tokens_equal_first=same,
                          spec_accept_rate=res["spec_accept_rate"],
                          tokens_per_step=st["tokens_per_step"],
                          preemptions=st["preemptions"],
                          resumes=st["resumes"],
                          kv_blocks_used_peak=st["kv_blocks_used_peak"])
    return runs


def equality_runs(cfg, model, prefix_len: int, n: int, max_new: int):
    """Budgeted (chunks of 1024) and prefix-hit serving against
    monolithic prefill on ``n`` prompts that share a ``prefix_len``-token
    prefix (a hit: the 1024-token head prefill, a tail extend at 1024,
    then per-hit suffix extends), T=0. Returns each run's seconds, launch
    counts and prefix hits, and the tokens in which it differs from the
    monolithic run's."""
    from repro_torch.kernels import backend as KB
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.sampling import SamplerConfig
    rng = np.random.default_rng(7)
    prefix = [2] + rng.integers(6, cfg.vocab_size, prefix_len - 1).tolist()
    prompts = [prefix + rng.integers(6, cfg.vocab_size, 8 + 4 * i).tolist()
               for i in range(n)]
    out, mono = {}, None
    for name, kw in (("monolithic", {}),
                     ("budget_1024", dict(prefill_budget=1024)),
                     ("prefix_hit", {})):
        eng = InferenceEngine(cfg, model, max_batch=n, cache_len=2048, **kw)
        KB.reset_launches()
        t0 = time.time()
        hit = name == "prefix_hit"
        if hit:
            eng.register_prefix("p", prefix)
        for p in prompts:
            eng.add_request(p, max_new_tokens=max_new,
                            sampler=SamplerConfig(temperature=0.0),
                            prefix_key="p" if hit else None)
        done = {r.request_id: r.output for r in eng.run_until_done()}
        torch.cuda.synchronize()
        toks = [done[i] for i in sorted(done)]
        mono = toks if mono is None else mono
        out[name] = dict(
            seconds=time.time() - t0, launches=KB.launch_counts(),
            prefix_hits=eng.throughput_stats()["prefix_hits"],
            tokens_differing=sum(x != y for u, v in zip(toks, mono)
                                 for x, y in zip(u, v)))
    check(out["prefix_hit"]["prefix_hits"] == n,
          f"prefix run: {out['prefix_hit']['prefix_hits']} hits of {n}")
    return out


def _profiled(eng, steps: int, trace: str):
    """``steps`` engine steps under torch.profiler; returns the host
    seconds, every event, the device events and their self device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace:
        OUT_DIR.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(OUT_DIR / trace))
    ev = prof.key_averages()
    dev = [e for e in ev if "CUDA" in str(e.device_type)]
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    return wall, ev, dev, dev_t


def _busy_engine(cfg, model, max_new: int, warm: int, **kw):
    """An engine with 8 busy slots of ragged prompts, ``warm`` steps past
    admission."""
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.sampling import SamplerConfig
    eng = InferenceEngine(cfg, model, max_batch=8, cache_len=2048, **kw)
    rng = np.random.default_rng(2)
    for n in (40, 300, 900, 20, 1500, 64, 700, 128):
        eng.add_request(rng.integers(6, cfg.vocab_size, n).tolist(),
                        max_new_tokens=max_new,
                        sampler=SamplerConfig(temperature=0.0))
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    check(eng.busy_slots() == 8, "profile: slots not all busy")
    return eng


def profile_decode(cfg, model, steps: int, trace: str):
    """Where a full-width decode step's time goes: device kernel time by
    name over ``steps`` engine steps with 8 busy slots, against the host
    clock around the same steps; for an MoE stack also the router
    kernel's time and the expert products' (``aten::bmm``, which only the
    expert FFN calls)."""
    eng = _busy_engine(cfg, model, steps + 8, 4)
    wall, ev, dev, dev_t = _profiled(eng, steps, trace)
    busy_us = sum(dev_t(e) for e in dev)
    top = sorted(dev, key=dev_t, reverse=True)[:8]
    res = dict(steps=steps, step_ms=1e3 * wall / steps,
               device_busy_ms_per_step=busy_us / 1e3 / steps,
               device_idle_share=1 - busy_us / 1e6 / wall,
               kernels_per_step=sum(e.count for e in dev) / steps,
               top_kernels=[dict(name=e.key[:80], count=e.count,
                                 ms_per_step=dev_t(e) / 1e3 / steps)
                            for e in top])
    if cfg.family == "moe":
        tot_t = lambda e: getattr(e, "device_time_total",
                                  getattr(e, "cuda_time_total", 0.0))
        res["moe_router_topk_ms_per_step"] = sum(
            dev_t(e) for e in dev if "moe_router" in e.key) / 1e3 / steps
        res["expert_bmm_ms_per_step"] = sum(
            tot_t(e) for e in ev if e.key == "aten::bmm") / 1e3 / steps
    return res


def profile_spec(cfg, model, rounds: int = 4):
    """Where a full-width speculative round's time goes: the host clock
    around the draft's steps (``spec.draft`` + ``spec.catch_up``, each
    ending in a synchronize) against the whole round, and device time
    over the same rounds, with 8 busy slots (k=4 self-draft, dense)."""
    from repro_torch.serving.specdec import SpecConfig
    eng = _busy_engine(cfg, model, 5 * (rounds + 4), 2,
                       spec_decode=SpecConfig(cfg, model, k=4))
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
    wall, _, dev, dev_t = _profiled(eng, rounds, "")
    busy_us = sum(dev_t(e) for e in dev)
    top = sorted(dev, key=dev_t, reverse=True)[:6]
    return dict(rounds=rounds, round_ms=1e3 * wall / rounds,
                draft_ms_per_round=1e3 * draft_s[0] / rounds,
                verify_and_accept_ms_per_round=1e3 * (wall - draft_s[0])
                / rounds,
                device_busy_ms_per_round=busy_us / 1e3 / rounds,
                device_idle_share=1 - busy_us / 1e6 / wall,
                kernels_per_round=sum(e.count for e in dev) / rounds,
                spec_accept_rate=eng.throughput_stats()["spec_accept_rate"],
                top_kernels=[dict(name=e.key[:80], count=e.count,
                                  ms_per_round=dev_t(e) / 1e3 / rounds)
                             for e in top])


def card_vs_cpu(cfg):
    """``cfg`` on the card and on the CPU with the same weights (built on
    the CPU, copied to the card): the logits of a 300-token prefill and
    16 decode steps within LOGIT_TOL, on the positions whose router ids
    agree in every MoE layer (all of them for a dense stack); the count
    of routed rows whose ids differ is returned."""
    import copy
    from repro_torch.kernels import backend as KB
    from repro_torch.models.model import decode_step, init_params, prefill
    cpu_model = init_params(cfg, seed=0, device="cpu")
    models = {"cuda": copy.deepcopy(cpu_model).to("cuda"),
              "cpu": cpu_model}
    rng = np.random.default_rng(1)
    prompt = rng.integers(6, cfg.vocab_size, (1, 300))
    forced = rng.integers(6, cfg.vocab_size, 16)
    logits, routes = {}, {}
    orig = KB.router_topk
    for dev, model in models.items():
        rec = []

        def record(lg, k):
            w, idx = orig(lg, k)
            rec.append(idx.cpu())
            return w, idx
        KB.router_topk = record
        try:
            lg, cache = prefill(model, {"tokens": prompt}, 512)
            seq = [lg.float().cpu()]
            for t in forced:
                lg, cache = decode_step(model, cache, {"tokens": [[int(t)]]})
                seq.append(lg.float().cpu())
        finally:
            KB.router_topk = orig
        logits[dev] = torch.cat(seq)                           # (17, V)
        routes[dev] = rec
    n_moe = max(1, cfg.layer_kinds().count("moe"))
    # token position -> do its routes agree in every MoE layer?
    agree = torch.ones(316, dtype=torch.bool)
    differing = 0
    for i, (a, b) in enumerate(zip(routes["cuda"], routes["cpu"])):
        rows = (a != b).any(-1)                 # (T,) this call's tokens
        differing += int(rows.sum())
        step = i // n_moe
        span = slice(0, 300) if step == 0 else slice(299 + step, 300 + step)
        agree[span] &= ~rows
    a, b = logits["cuda"], logits["cpu"]
    check(bool(torch.isfinite(a).all()), f"{cfg.name}: non-finite card "
                                         f"logits")
    keep = agree[torch.arange(299, 316)]
    diff = float((a[keep] - b[keep]).abs().max()) if keep.any() else 0.0
    check(diff <= LOGIT_TOL, f"{cfg.name}: card vs CPU logits differ by "
                             f"{diff} on agreeing routes")
    return dict(config=cfg.name, max_abs_diff=diff, tol=LOGIT_TOL,
                route_rows=sum(int(r.shape[0]) for r in routes["cpu"]),
                route_rows_differing=differing,
                logit_positions_compared=int(keep.sum()),
                argmax_agree=int((a.argmax(-1) == b.argmax(-1)).sum()),
                positions=int(a.shape[0]),
                logit_absmax=float(b.abs().max()))


def planner_phases():
    """planner-proxy-100m at full width (depth not cut): the serve runs,
    the long-prompt equalities (asserted), the decode and spec profiles
    and card vs CPU. Returns the serve runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config(ARCH)
    model = init_params(cfg, seed=0, device="cuda")
    runs = serve_runs(ARCH, cfg, model, PLANNER_MODES)
    for name, r in runs.items():
        emit(f"serve_{name}", **r)
    eq = equality_runs(cfg, model, 1300, 8, 32)
    for name, r in eq.items():
        emit(f"equality_{name}", **r)
    for name in ("budget_1024", "prefix_hit"):
        check(eq[name]["tokens_differing"] == 0,
              f"{name}: tokens differ from monolithic prefill")
    emit("decode_profile", **profile_decode(cfg, model, 10,
                                            "decode_trace.json"))
    emit("spec_profile", **profile_spec(cfg, model))
    emit("card_vs_cpu", **card_vs_cpu(cfg))
    return runs


def moe_config(arch: str):
    """The full config at its published widths, heads, experts, top-k,
    vocab and FFN sizes, with the depth cut: kimi-k2 to its dense first
    layer and one MoE layer (384 experts top-8 and the shared expert),
    arctic to one MoE layer (128 experts top-2 and the dense residual)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == "kimi-k2-1t-a32b":
        return cfg.replace(n_layers=2, segments=((("dense",), 1),
                                                 (("moe",), 1)))
    return cfg.replace(n_layers=1, segments=((("moe",), 1),))


def moe_equalities(cfg, model):
    """Budgeted == monolithic and prefix hit == miss on 4 prompts of a
    1,040-token prefix and 8-20-token suffixes: printed at the config's
    capacity factor, where a chunk seam or a prefix split changes which
    choices drop (capacity counts per prefill group, in the JAX package
    too), and asserted at capacity factor 100, where nothing drops."""
    import dataclasses
    from repro_torch.common import perf
    out, old = {}, perf.get_flags()
    try:
        for label, factor in (("config", 0.0), ("factor_100", 100.0)):
            perf.set_flags(dataclasses.replace(old,
                                               moe_capacity_factor=factor))
            out[label] = equality_runs(cfg, model, 1040, 4, 8)
    finally:
        perf.set_flags(old)
    for name in ("budget_1024", "prefix_hit"):
        check(out["factor_100"][name]["tokens_differing"] == 0,
              f"{cfg.name} capacity 100: {name} tokens differ from "
              f"monolithic prefill")
    return out


def moe_phases():
    """kimi-k2 (2 layers) and arctic (1 layer) at full width: init, serve
    runs, the two equalities, kimi's decode profile, each model freed
    before the next; then card vs CPU on both smoke configs. Returns the
    results by arch."""
    import gc
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import count_params, init_params
    results = {}
    for arch, modes in MOE_MODES.items():
        cfg = moe_config(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        model = init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        emit(f"moe_init_{arch}", layers=list(cfg.layer_kinds()),
             d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads,
                                         cfg.d_head],
             experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
             vocab=cfg.vocab_size, params=count_params(model),
             init_seconds=time.time() - t0,
             weights_gb=torch.cuda.memory_allocated() / 1e9)
        runs = serve_runs(arch, cfg, model, modes)
        for name, r in runs.items():
            emit(f"moe_serve_{arch}_{name}", **r)
        t0 = time.time()
        eq = moe_equalities(cfg, model)
        emit(f"moe_equalities_{arch}", seconds=time.time() - t0, **eq)
        res = dict(runs=runs, equalities=eq)
        if arch == "kimi-k2-1t-a32b":
            res["profile"] = profile_decode(cfg, model, 5,
                                            "moe_decode_trace.json")
            emit("moe_decode_profile", arch=arch, **res["profile"])
        res["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        emit(f"moe_memory_{arch}",
             max_memory_allocated_gb=res["max_memory_allocated_gb"])
        results[arch] = res
        del model
        gc.collect()
        torch.cuda.empty_cache()
    for arch in ("arctic-480b", "kimi-k2-1t-a32b"):
        emit(f"card_vs_cpu_{arch}", **card_vs_cpu(get_smoke_config(arch)))
    return results


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
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.flash_verify import flash_verify, \
        flash_verify_paged
    from repro_torch.kernels.moe_router import moe_router_topk

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
    hd_cases = head_dim_cases(gen)
    for phase, c in hd_cases:
        emit(phase, **c)
    build_log = (OUT_DIR / "chip_smoke_build.log").read_text()
    rout = router_cases(gen, build_log)
    for c in rout:
        emit("kernel_router", **c)
    if args.kernels_only:
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
            RESULTS, indent=1, default=str))
        return 0

    runs = planner_phases()
    moe = moe_phases()

    # each kernel's launches come from the run of the path it serves;
    # its times from its case at the main path's widest shape (the
    # 1024-token prefix head prefill; 8 ragged slots of a 2048 cache)
    rows = []
    for fn, cases, src, rep, run in (
            (flash_prefill, pre, "flash_prefill.cu",
             "src/repro/kernels/flash_prefill.py:84", "monolithic"),
            (flash_decode, dec, "flash_decode.cu",
             "src/repro/kernels/flash_decode.py:65", "monolithic"),
            (flash_decode_paged, [paged_dec], "flash_decode_paged.cu",
             "src/repro/kernels/flash_decode_paged.py:77", "paged"),
            (flash_verify, [ver["flash_verify"]], "flash_verify.cu",
             "src/repro/kernels/flash_verify.py:95", "spec"),
            (flash_verify_paged, [ver["flash_verify_paged"]],
             "flash_verify.cu", "src/repro/kernels/flash_verify.py:149",
             "paged_spec")):
        c = next(c for c in cases if c.get("Sq", 1024) == 1024
                 and c.get("Sk", CACHE) in (1024, 2048)
                 and c.get("q_offset", 0) == 0)
        phase = "kernel_" + fn.__name__.replace("flash_", "")
        cases = cases + [x for ph, x in hd_cases if ph == phase]
        rows.append({"name": fn.__name__, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}",
                     "replaces": rep,
                     "launches": runs[run]["launches"][fn.__name__],
                     "max_abs_err": max(x["max_abs_err"] for x in cases),
                     "ms": c["ms"], "plain_ms": c["plain_ms"],
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"]})
    # the router: launches of the kimi-k2 dense serve; times at its decode
    # shape there (8 slots, 384 experts, top-8)
    c = next(c for c in rout if (c["T"], c["E"], c["k"]) == (8, 384, 8))
    rows.append({"name": moe_router_topk.__name__, "route": "cuda",
                 "source": "src/repro_torch/csrc/moe_router.cu",
                 "replaces": "src/repro/kernels/moe_router.py:47",
                 "launches": moe["kimi-k2-1t-a32b"]["runs"]["dense"][
                     "launches"]["moe_router_topk"],
                 "max_abs_err": max(x["max_abs_err"] for x in rout),
                 "ms": c["ms"], "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                 "library_ms": None})
    emit("elapsed", seconds=time.time() - T_START)
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
