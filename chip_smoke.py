"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

  python3 chip_smoke.py [--kernels-only]

Builds the port's nine Hopper kernels from ``src/repro_torch/csrc/``
and checks that flash_prefill's SASS runs on the tensor cores (HGMMA
instructions at every head dim, ``cuobjdump -sass``), then holds each
kernel against its plain PyTorch version on the card: the attention
kernels at the served planner's shapes (head dim 64) and at head dims
128 and 32 with the MoE families' heads (kimi-k2's 64/8 and arctic's
56/8), each time with the decode family's bitwise contracts (paged
decode == decode on the gathered view, each verify row == the decode row
at its position, paged verify == verify on the gathered view, every
dense decode case == the paged twin over an identity table on its own
cache), also with more than 64 verify rows per (kv head, slot) (kimi's
G = 8 at W = 9, the planner's G = 3 at W = 22) and with 65 q heads per
kv head, the paged twins over shuffled block tables with sentinel tails
at block sizes 16, 8, 12, 24 and 256 (paged == dense on the gathered
view, bitwise), and a sweep of the dense decode and verify kernels
against their paged twins, bitwise, at G 3, 5, 7, 8, W 1, 5, 9, 22,
head dims 32, 64, 128, with and without a softcap, at each of those
block sizes (the four kernels run one routine with a dense or a paged
source: any difference is a fault of a source); the decode family's
cases give the device time per call (``torch.profiler``) of the kernel
and of SDPA beside the CUDA-event times, and the decode kernels'
registers and spills per instance (``-Xptxas -v``, no spills);
flash_prefill's row contract, bitwise:
a 1,300-token prefill's rows against extends at six offsets over a
stale 2,048-row cache, at head dims 64, 128 and 32, causal, windowed and
softcapped; the MoE router at the MoE families' (tokens, experts,
top-k), at the smoke configs' 4 experts, at a ragged 100, at 40, 200
and 512 (so that every template instance runs) and on logits rounded
to integers (ties), with its device time a call beside the
launch floor (a one-element zero_ in the same profile) and its
instances' registers (no spills, no stack frame); flash_prefill's
device time a call at the serve runs' 14-token prompts (the planner's,
kimi-k2's and hymba's heads) and at the intent gate's shapes (64, 128
and 256 rows of a causal 64-token forward at the planner's heads, with
SDPA's device time beside it); flash_prefill's backward
(``flash_prefill_bwd``, which has no TPU counterpart) against its plain
version (autograd through the plain forward) at the planner's training
shapes (8 x 256 and 16 x 64), a 1,024-token row, kimi-k2's heads, head
dim 32, a window and a softcap, with the same sha256 on a second call,
its device time a call (by pass at the training shape) beside SDPA's
backward, and its three passes' registers and spills. Then it serves
planner-proxy-100m at full width through the launcher's serving
function (dense monolithic and chunked, paged, speculative dense and
paged, ``--draft-k 21`` (66 verify rows per kv head), paged with a pool
small enough to preempt, and paged with 8-row blocks), checks that
every run emits the monolithic run's tokens with a self-draft accept
rate of 1.0, that chunked prefill and prefix hits of 1,312-token prompts
do too, profiles a full-width decode step and a speculative round, dense
and paged (each decode kernel's device time a launch), and checks the
card's logits against the CPU's on the same seeded weights. It holds the
threefry Gumbel-max sampler on the card to the CPU port (64 seeded rows
at V = 8,192, T = 0.8, top-k 0 and 40: the same tokens, the largest
Gumbel difference printed) and times its host cost for one decode step
of 8 slots. Then the replica cluster on the same card through the
launcher's ``serve_cluster`` (the JAX launcher's cluster example: 32
bursty sessions of up to 2 turns, skew 0.7, 16 new tokens at T = 0.8,
8 slots and a 2,048-row cache a replica, replicas sharing the model):
1 replica under round robin, 4 under each of the three routers, then
intent affinity with paged KV, with speculative decoding dense and
paged, and with SLA spill; every served request's tokens must equal the
1-replica run's, affinity's prefix-hit ratio must beat round robin's,
and each run must launch its attention kernels. Then the
GeckOpt path at the planner's full width, through
``launch/serve_pipeline.py``: the concurrent pipeline on 16 tasks with 8
in flight, with the gated library catalog and with a top-8 retrieved
toolset of a generated 128-tool catalog, each run with its kernel
launches and its gate, prefix, turn and host seconds; the batched
gate's decisions and the pipeline's Table-2 row must equal the
sequential harness's with the single-query gate, every engine turn must
ride a prefix prefilled once, and a prefix hit's tokens must equal a
full prefill's; the gated run again on a 4-replica intent-affinity
cluster, whose row and gate decisions must be the single engine's; then
the gate's losses on the card against the CPU's for 8 queries. Then
training at the planner's full width: ``launch.train`` for 30 steps of
8 x 256 tokens without and with remat (the loss must fall, remat must
equal no remat bitwise in every loss and parameter, flash_prefill must
launch once a layer a step (twice with remat) and its backward once),
with ms a step, tok/s, peak memory and one profiled step's busy share;
one train_loss and its gradients on the card against the CPU; and the
GeckOpt gate trained by ``launch.train_planner --full``, its accuracy on
48 held-out tasks and its Table-2 row against the ungated agent, its
checkpoint reloaded into a fresh model (the same batched decisions) and
served by ``launch.serve --checkpoint``. Then the
MoE families at their published widths with the depth cut
(kimi-k2-1t-a32b: its dense first layer and one MoE layer of 384 experts
top-8; arctic-480b: one MoE layer of 128 experts top-2), through the
same functions: dense, paged and (kimi) speculative dense and paged,
tokens equal to the dense run's and an accept rate of 1.0; budgeted ==
monolithic and prefix hit == miss, printed at the config's capacity
factor and asserted at 100; a profile of kimi's decode step; card vs
CPU on both MoE smoke configs. Then hymba-1.5b at full width and full
depth (32 hybrid attention + SSM layers, 30 of them over 1,024-row
sliding-window rings): the selective-scan kernel against its plain
version at hymba's prefill and decode shapes, with each output's sha256
(so a later tree can be held to the same bits) and its seam contract
(a scan split at any seam, or run one step per launch, gives the bits
of one scan); the window variant of the prefill kernel and the decode
kernel over a ring at hymba's heads (25/5 of 64); two serve runs that
must serve the same tokens, the recycled slots' requests against a
fresh engine (bitwise); prefix hits on a 1,300-token prefix against
misses (admission logits within HIT_MISS_TOL, tokens that agree
printed); ~1,000-token prompts whose decode crosses every ring's wrap
(decode logits against a windowed prefill within HIT_MISS_TOL); the
refusals of paged KV, chunked prefill and speculative decoding; a
profile of its decode step; card vs CPU on hymba-smoke. Then
xlstm-125m at full width and full depth (12 layers: three units of
three mLSTM layers, heads of 192, and one sLSTM layer): the mLSTM scan
kernel against its plain version at xlstm's prefill and decode shapes,
at head dims 32, 64 and 128, and on the full-width model's own scan
inputs of a 1,024-token prefill, with each output's sha256 and its
contracts (a scan split at any seam, or run one step per launch, gives
the bits of one scan; every column tile steps the same n and m, at the
tile widths of a many-step and of a one-step launch); two dense serve
runs and a ``--prefill-budget 1024`` run that must serve the same tokens, the
recycled slots' requests against a fresh engine; budgeted prefill and 8
prefix hits on a 1,300-token prefix against monolithic prefill
(admission logits and tokens bitwise); the refusals of paged KV and
speculative decoding; a profile of its decode step; card vs CPU on
xlstm-smoke. It prints one JSON line per phase. It fails (non-zero exit, no result line) when
no card is present, when it does not run from a checkout of the
repository, or when any phase fails. ``--kernels-only`` stops after the
kernel cases (a quick check of a kernel change; it prints no result
line). Detail goes to ``chiprun_out/chip_smoke.json``, nvcc's
register/shared-memory report to ``chip_smoke_build.log`` and gzipped
profiler traces of full-width decode steps to ``decode_trace.json.gz``
(planner), ``moe_decode_trace.json.gz`` (kimi-k2),
``hymba_decode_trace.json.gz`` and ``xlstm_decode_trace.json.gz`` (open
them in Perfetto).

Tolerances:
  * kernel vs plain version (both bf16 out, fp32 inside, different
    summation order): |kernel - plain| <= 1e-2 + 1e-2 * |plain|, i.e. at
    most one bf16 rounding step (relative spacing 2**-7) plus slack.
    flash_prefill rounds P to bf16 for its tensor-core P V product (the
    plain version multiplies in fp32), about one bf16 rounding of each
    p, inside the same tolerance;
  * flash_prefill's rows in prefill and in extend: bitwise;
  * flash_prefill_bwd vs its plain version (bf16 out, fp32 inside):
    |kernel - plain| <= 2e-2 + 2e-2 * |plain| (BWD_ATOL, BWD_RTOL),
    twice the forward's: the kernel recomputes p in fp32 but takes
    D = rowsum(dO O) from the forward kernel's output, whose P V rounds
    P to bf16, while the plain version differentiates its own fp32
    forward; the gradients reach |dk| ~ 8, where one bf16 step is
    0.031. Two calls: the same bits (no atomics, fixed sum orders);
  * training: remat vs no remat, bitwise (every loss and parameter);
    card vs CPU, one loss of the full-width planner within
    TRAIN_LOSS_TOL = 0.05 (the forward's bf16 roundings over 12 layers,
    then an fp32 logsumexp), each gradient leaf's relative error
    reported;
  * within the decode family (decode, paged decode, verify, paged
    verify): bitwise (``torch.equal``), by design: the four kernels run
    one routine (decode_warp.cuh), whose per-row arithmetic does not
    depend on the source that fills its ring (dense or paged, any block
    size);
  * card vs CPU logits (fp32 head over a 12-layer bf16 stack, matmuls
    rounded differently on the two devices): max |diff| <= LOGIT_TOL;
    for the MoE smoke configs on the tokens whose routes agree in every
    layer (a near-tie may route a token to another expert on the other
    device; the count of such tokens is printed);
  * the intent gate's (query, intent) losses, card vs CPU (an fp32
    logsumexp over the head of a 12-layer bf16 stack): max |diff| <=
    GATE_LOSS_TOL = 0.1, and the same decision wherever the CPU's top-2
    margin exceeds twice the tolerance or twice the largest difference
    measured; within the card, the batched gate's decisions equal the
    single-query gate's exactly;
  * router kernel vs plain version: ids equal (ties to the lowest id),
    weights within 1e-5 (fp32 softmax and renormalisation, summed in
    another order);
  * ssm_scan vs plain version (fp32 both; the kernel rounds the state
    update as one fmaf and sums over n in its own fixed order, the plain
    version with separate roundings and torch's reduction):
    |kernel - plain| <= 1e-4 + 1e-4 * |plain|; within the kernel
    (seams, one-step launches): bitwise;
  * hymba prefix hit vs miss, and ring-crossing decode vs windowed
    prefill (two computations of the same logits: token-by-token decode
    against one prefill, other kernels and product shapes; equal bits on
    the CPU at the smoke size): relative RMS |a - b| / |b| <=
    HIT_MISS_REL = 0.1 and max |diff| <= HIT_MISS_TOL = 0.25. At full
    width on an H100 the bf16 roundings of the two paths through 32
    layers leave the 32,001 logits (magnitude up to ~3.4) 2.7-3.4% RMS
    apart, and their largest difference, the tail of 32,001 entries, at
    0.09-0.12. A ring row or a conv state out of place moves the smoke
    config's logits by 19-31% and 78-106% RMS;
  * mlstm_scan vs plain version (fp32 both; C and n take the plain
    version's separate roundings, so they differ only through expf and
    log1pf of the gates; the output divides two reductions over d, each
    summed in another order, by max(|n.q|, exp(-m)), a cancelled dot):
    every output within MLSTM_TOL = 1e-4 of its conditioning scale,
    ``(sum_d |C q| + |h| sum_d |n q|) / den`` (a reordered fp32 sum of
    hd terms errs by at most ~hd 2**-24 = 1.1e-5 of its absolute terms
    at hd = 192, and the gates' rounding adds a few ulps a step to the
    carried state), every state leaf within 1e-4 (1 + |x|); within the
    kernel (seams, one-step launches, the column tiles' n and m):
    bitwise;
  * xlstm budgeted vs monolithic and prefix hit vs miss: bitwise (the
    sequential recurrence, the kernel's seams and the fixed-size row
    products give a row the same bits at any chunking).
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
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch.decode_bench import (  # noqa: E402
    HYMBA_RINGS, KV_LENS, cuda_ms, device_ms, shuffled_pools)
from repro_torch.kernels.ref import identity_pool  # noqa: E402
from repro_torch.launch import scan_bench  # noqa: E402
from repro_torch.launch.router_bench import (  # noqa: E402
    INSTANCES as ROUTER_INSTANCES, KERNEL as ROUTER_KERNEL, ROUTER_CASES,
    ROUTER_EXTRA_CASES, ROUTER_WTOL, router_logits)
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
# slots of a 2048-row cache, 16-row blocks, and the verify window of
# --draft-k 4
B_SLOTS, HQ, HKV, HD, CACHE, BS, WIN = 8, 12, 4, 64, 2048, 16, 5
# the other block sizes the paged twins are held to: 8, 12 (no multiple
# of 8: K copied by the block's threads), 24 (a multiple of 8 that does
# not divide a tile; its tables cover 2,064 rows) and 256 (past a tile)
OTHER_BS = (8, 12, 24, 256)


def emit(phase: str, **kw):
    """Print one phase's JSON line; chip_smoke.json keeps every entry of
    a phase that repeats (a kernel's cases) in a list."""
    RESULTS.setdefault(phase, []).append(kw)
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound(bytes_moved: float, flops: float, flop_s: float = BF16_FLOP_S,
          fp32_flops: float = 0.0):
    """Least time (ms) and what sets it: the bytes over HBM's rate, or
    ``flops`` at ``flop_s`` plus ``fp32_flops`` at the fp32 rate (the
    decode family's Q K^T has bf16 operands, its P V an fp32 p)."""
    t_b = bytes_moved / HBM_BYTES_S
    t_f = flops / flop_s + fp32_flops / FP32_FLOP_S
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


def prefill_case(Sq, Sk, q_offset, gen, heads=(HQ, HKV, HD), window=0,
                 device=False, batch=1):
    """flash_prefill against its plain version on ``batch`` rows, with its
    CUDA-event time beside the plain version's and SDPA's and the bound;
    ``device`` adds its device time a call (``torch.profiler``)."""
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.ref import attention_ref
    import torch.nn.functional as F
    Hq, Hkv, hd = heads
    q, k, v = _mk(gen, batch, Hq, Sq, hd), _mk(gen, batch, Hkv, Sk, hd), \
        _mk(gen, batch, Hkv, Sk, hd)
    kw = dict(causal=True, q_offset=q_offset, window=window)
    out = flash_prefill(q, k, v, **kw)
    ref = attention_ref(q, k, v, **kw)
    err = err_ok(out, ref)
    kpos = torch.arange(Sk, device="cuda")
    qpos = q_offset + torch.arange(Sq, device="cuda")
    mask = kpos[None, :] <= qpos[:, None]                      # (Sq,Sk)
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    ms = cuda_ms(lambda: flash_prefill(q, k, v, **kw))
    plain = cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=5)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))
    pairs = batch * int(mask.sum())               # this run's (q,k) pairs
    keys = min(Sk, q_offset + Sq)
    nbytes = 2 * hd * batch * (2 * Hq * Sq + 2 * Hkv * keys)
    b_ms, b_by = bound(nbytes, 4 * hd * Hq * pairs)
    out = dict(B=batch, Sq=Sq, Sk=Sk, q_offset=q_offset, window=window,
               heads=list(heads), max_abs_err=err, ms=ms, plain_ms=plain,
               library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    if device:
        out["device_ms"] = device_ms(lambda: flash_prefill(q, k, v, **kw),
                                     "flash_prefill_kernel")
        out["library_device_ms"] = device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                   enable_gqa=True))
    return out


# the serve runs' prompts: every request's prefill is 14 tokens
SERVE_PROMPT = 14


def prefill_serve_cases(gen):
    """flash_prefill at the serve runs' prompt length with the planner's,
    kimi-k2's and hymba's heads (hymba's windowed): each a case as
    above, with its device time a call."""
    return [dict(prefill_case(SERVE_PROMPT, SERVE_PROMPT, 0, gen, heads,
                              window=window, device=True), family=fam)
            for fam, heads, window in (
                ("planner", (HQ, HKV, HD), 0),
                ("kimi", MOE_HEADS["kimi"] + (128,), 0),
                ("hymba", HYMBA_HEADS, HYMBA_WINDOW))]


# the intent gate's forward: every (query, intent) row of an admission
# wave at once, Q*8 rows of 64 tokens (Q = 8, 16 and the pipeline's
# gate_batch of 32)
GATE_BATCHES = (64, 128, 256)
GATE_SEQ = 64


def gate_prefill_cases(gen):
    """flash_prefill at the gate's shapes: B = 64, 128 and 256 rows of a
    causal Sq = Sk = 64 forward with the planner's heads, each a case as
    above with its device time a call."""
    return [dict(prefill_case(GATE_SEQ, GATE_SEQ, 0, gen, batch=b,
                              device=True), family="gate")
            for b in GATE_BATCHES]


def decode_case(kv_len_list, Sk, gen, heads=(HQ, HKV, HD)):
    """flash_decode against its plain version and, bitwise, against
    flash_decode_paged over an identity table on the same cache (one
    routine, two sources: the copies land in the same places);
    its CUDA-event and device times beside SDPA's and the bound."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.ref import decode_attention_ref
    import torch.nn.functional as F
    B, (Hq, Hkv, hd) = len(kv_len_list), heads
    q, kc, vc = _mk(gen, B, Hq, hd), _mk(gen, B, Hkv, Sk, hd), \
        _mk(gen, B, Hkv, Sk, hd)
    kvl = torch.tensor(kv_len_list, dtype=torch.int32, device="cuda")
    out = flash_decode(q, kc, vc, kvl)
    ref = decode_attention_ref(q, kc, vc, kvl)
    err = err_ok(out, ref)
    (kp, tab), (vp, _) = identity_pool(kc, BS), identity_pool(vc, BS)
    check(torch.equal(out, flash_decode_paged(q, kp, vp, tab, kvl)),
          f"flash_decode != flash_decode_paged over an identity table at "
          f"heads {heads}, Sk {Sk}")
    mask = (torch.arange(Sk, device="cuda")[None, :]
            < kvl[:, None].long())[:, None, None, :]           # (B,1,1,Sk)
    run = lambda: flash_decode(q, kc, vc, kvl)
    sdpa = lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)
    ms = cuda_ms(run)
    plain = cuda_ms(lambda: decode_attention_ref(q, kc, vc, kvl), iters=5)
    lib = cuda_ms(sdpa)
    n = int(sum(kv_len_list))
    nbytes = 2 * hd * (2 * B * Hq + 2 * Hkv * n) + 4 * B
    b_ms, b_by = bound(nbytes, 2 * hd * Hq * n,
                       fp32_flops=2 * hd * Hq * n)
    return dict(B=B, Sk=Sk, kv_len=kv_len_list, heads=list(heads),
                max_abs_err=err, bitwise_vs_paged_identity=True, ms=ms,
                device_ms=device_ms(run, "flash_decode_kernel"),
                plain_ms=plain, library_ms=lib,
                library_device_ms=device_ms(sdpa),
                bound_ms=b_ms, bound_by=b_by)


def paged_pool(gen, Hkv=HKV, hd=HD, bs=BS, kv_lens=KV_LENS):
    """The slots' rows of a seeded CACHE-row K/V cache as pools of
    ``bs``-row blocks through a table of shuffled block ids with sentinel
    tails (``decode_bench.shuffled_pools``); also the live blocks'
    count."""
    kc = _mk(gen, len(kv_lens), Hkv, CACHE, hd)
    vc = _mk(gen, len(kv_lens), Hkv, CACHE, hd)
    kp, vp, tab = shuffled_pools(kc, vc, kv_lens, bs)
    return kp, vp, tab, sum(-(-n // bs) for n in kv_lens)


def row_limits(kvl, W=WIN):
    """(B, W) key limit of each verify row, clamped at 0."""
    w = torch.arange(W, device=kvl.device)
    return torch.clamp(kvl.long()[:, None] - W + w[None, :] + 1, min=0)


def verify_err(out, ref, kvl) -> float:
    """Kernel vs plain on rows with keys; rows with none must be 0 (the
    decode kernel's kv_len 0 rule; the oracle's softmax over an all-masked
    row is not defined the same way)."""
    live = (row_limits(kvl, out.shape[2]) > 0)[:, None, :, None].expand_as(
        out)
    check(bool((out.float()[~live] == 0).all()), "keyless verify row "
                                                 "not 0")
    return err_ok(out.float()[live], ref.float()[live])


def paged_decode_case(gen, heads=(HQ, HKV, HD), bs=BS, timed=True):
    """flash_decode_paged over a shuffled table of ``bs``-row blocks
    against its plain version and, bitwise, flash_decode on the gathered
    view; with ``timed``, its CUDA-event and device times beside SDPA's on
    the gathered view and the bound."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.ref import paged_decode_attention_ref, \
        paged_gather_kv
    import torch.nn.functional as F
    Hq, Hkv, hd = heads
    q = _mk(gen, B_SLOTS, Hq, hd)
    kp, vp, tab, used = paged_pool(gen, Hkv, hd, bs)
    kvl = torch.tensor(KV_LENS, dtype=torch.int32, device="cuda")
    out = flash_decode_paged(q, kp, vp, tab, kvl)
    err = err_ok(out, paged_decode_attention_ref(q, kp, vp, tab, kvl))
    kg, vg = paged_gather_kv(kp, tab), paged_gather_kv(vp, tab)
    check(torch.equal(out, flash_decode(q, kg, vg, kvl)),
          f"flash_decode_paged != flash_decode on the gathered view at "
          f"heads {heads}, block size {bs}")
    case = dict(B=B_SLOTS, kv_len=KV_LENS, block_size=bs,
                n_blocks=kp.shape[0], heads=list(heads), max_abs_err=err,
                bitwise_vs_decode=True)
    if not timed:
        return case
    mask = (torch.arange(kg.shape[2], device="cuda")[None, :]
            < kvl[:, None].long())[:, None, None, :]
    run = lambda: flash_decode_paged(q, kp, vp, tab, kvl)
    sdpa = lambda: F.scaled_dot_product_attention(
        q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True)
    ms = cuda_ms(run)
    plain = cuda_ms(lambda: paged_decode_attention_ref(q, kp, vp, tab, kvl),
                    iters=5)
    n = int(sum(KV_LENS))
    nbytes = 2 * hd * (2 * B_SLOTS * Hq + 2 * Hkv * n) + 4 * B_SLOTS \
        + 4 * used
    b_ms, b_by = bound(nbytes, 2 * hd * Hq * n,
                       fp32_flops=2 * hd * Hq * n)
    return dict(case, ms=ms,
                device_ms=device_ms(run, "flash_decode_paged_kernel"),
                plain_ms=plain, library_ms=None, library_device_ms=None,
                sdpa_on_pregathered_view_ms=cuda_ms(sdpa),
                sdpa_on_pregathered_view_device_ms=device_ms(sdpa),
                bound_ms=b_ms, bound_by=b_by)


def verify_cases(gen, heads=(HQ, HKV, HD), W=WIN):
    """flash_verify and flash_verify_paged at W (5: --draft-k 4) over the
    same slots: against the fused oracle and the CPU path's row-wise plain
    version, each row bitwise the decode row at its position, paged
    bitwise dense on the gathered view."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_verify import flash_verify
    from repro_torch.kernels.ref import verify_attention_ref, \
        verify_rows_ref
    import torch.nn.functional as F
    Hq, Hkv, hd = heads
    q = _mk(gen, B_SLOTS, Hq, W, hd)
    kc, vc = _mk(gen, B_SLOTS, Hkv, CACHE, hd), _mk(gen, B_SLOTS, Hkv,
                                                    CACHE, hd)
    kvl = torch.tensor(KV_LENS, dtype=torch.int32, device="cuda")
    lim = row_limits(kvl, W)
    mask = (torch.arange(CACHE, device="cuda")[None, None, :]
            < lim[:, :, None])[:, None]                        # (B,1,W,Sk)
    nbytes = 2 * hd * (2 * B_SLOTS * Hq * W + 2 * Hkv * sum(KV_LENS)) \
        + 4 * B_SLOTS
    flops = 2 * hd * Hq * int(lim.sum())      # each product
    cases = {}

    out = flash_verify(q, kc, vc, kvl)
    err = max(verify_err(out, verify_attention_ref(q, kc, vc, kvl), kvl),
              verify_err(out, verify_rows_ref(q, kc, vc, kvl), kvl))
    for w in range(W):
        row = flash_decode(q[:, :, w].contiguous(), kc, vc, lim[:, w])
        check(torch.equal(out[:, :, w], row),
              f"flash_verify row {w} != flash_decode at its position")
    run = lambda: flash_verify(q, kc, vc, kvl)
    sdpa = lambda: F.scaled_dot_product_attention(
        q, kc, vc, attn_mask=mask, enable_gqa=True)
    b_ms, b_by = bound(nbytes, flops, fp32_flops=flops)
    cases["flash_verify"] = dict(
        max_abs_err=err, bitwise_rows_vs_decode=True,
        ms=cuda_ms(run), device_ms=device_ms(run, "flash_verify_kernel"),
        plain_ms=cuda_ms(lambda: verify_rows_ref(q, kc, vc, kvl), iters=5),
        library_ms=cuda_ms(sdpa), library_device_ms=device_ms(sdpa),
        bound_ms=b_ms, bound_by=b_by)
    cases["flash_verify_paged"] = paged_verify_case(gen, heads, W)
    for c in cases.values():
        c.update(B=B_SLOTS, W=W, rows=Hq // Hkv * W, kv_len=KV_LENS,
                 heads=list(heads))
    return cases


def paged_verify_case(gen, heads=(HQ, HKV, HD), W=WIN, bs=BS, timed=True):
    """flash_verify_paged at W over a shuffled table of ``bs``-row blocks:
    against the fused oracle and the CPU path's row-wise plain version,
    bitwise flash_verify on the gathered view; with ``timed``, its times
    beside SDPA's on the gathered view and the bound."""
    from repro_torch.kernels.flash_verify import flash_verify, \
        flash_verify_paged
    from repro_torch.kernels.ref import paged_gather_kv, \
        paged_verify_attention_ref, paged_verify_rows_ref
    import torch.nn.functional as F
    Hq, Hkv, hd = heads
    q = _mk(gen, B_SLOTS, Hq, W, hd)
    kp, vp, tab, used = paged_pool(gen, Hkv, hd, bs)
    kvl = torch.tensor(KV_LENS, dtype=torch.int32, device="cuda")
    pout = flash_verify_paged(q, kp, vp, tab, kvl)
    kg, vg = paged_gather_kv(kp, tab), paged_gather_kv(vp, tab)
    err = max(verify_err(pout, paged_verify_attention_ref(q, kp, vp, tab,
                                                          kvl), kvl),
              verify_err(pout, paged_verify_rows_ref(q, kp, vp, tab, kvl),
                         kvl))
    check(torch.equal(pout, flash_verify(q, kg, vg, kvl)),
          f"flash_verify_paged != flash_verify on the gathered view at "
          f"heads {heads}, W {W}, block size {bs}")
    case = dict(max_abs_err=err, bitwise_vs_verify_gathered=True,
                block_size=bs, n_blocks=kp.shape[0])
    if not timed:
        return case
    lim = row_limits(kvl, W)
    mask = (torch.arange(kg.shape[2], device="cuda")[None, None, :]
            < lim[:, :, None])[:, None]                        # (B,1,W,Sk)
    nbytes = 2 * hd * (2 * B_SLOTS * Hq * W + 2 * Hkv * sum(KV_LENS)) \
        + 4 * B_SLOTS + 4 * used
    flops = 2 * hd * Hq * int(lim.sum())      # each product
    run = lambda: flash_verify_paged(q, kp, vp, tab, kvl)
    sdpa = lambda: F.scaled_dot_product_attention(
        q, kg, vg, attn_mask=mask, enable_gqa=True)
    b_ms, b_by = bound(nbytes, flops, fp32_flops=flops)
    return dict(
        case, ms=cuda_ms(run),
        device_ms=device_ms(run, "flash_verify_paged_kernel"),
        plain_ms=cuda_ms(lambda: paged_verify_rows_ref(q, kp, vp, tab,
                                                       kvl), iters=5),
        library_ms=None, library_device_ms=None,
        sdpa_on_pregathered_view_ms=cuda_ms(sdpa),
        sdpa_on_pregathered_view_device_ms=device_ms(sdpa),
        bound_ms=b_ms, bound_by=b_by)


def block_size_cases(gen):
    """The paged twins at OTHER_BS with the planner's, kimi-k2's and
    arctic's heads (head dims 64, 128, 32): paged decode and paged verify
    at W = 5, each bitwise the dense kernel on the gathered view and
    within tolerance of its plain version."""
    out = []
    for fam, heads in (("planner", (HQ, HKV, HD)),
                       ("kimi", (*MOE_HEADS["kimi"], 128)),
                       ("arctic", (*MOE_HEADS["arctic"], 32))):
        for bs in OTHER_BS:
            tag = dict(family=fam, hd=heads[2])
            out.append(("kernel_decode_paged", dict(paged_decode_case(
                gen, heads, bs, timed=False), **tag)))
            out.append(("kernel_verify_paged", dict(paged_verify_case(
                gen, heads, WIN, bs, timed=False), W=WIN, **tag)))
    return out


# more q heads per kv head than 64 (the JAX kernels take any G): 130/2
# of 64, dense and paged decode against the plain version, paged bitwise
# dense on the gathered view
WIDE_HEADS = (130, 2, 64)


def wide_group_case(gen):
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ref import decode_attention_ref
    Hq, Hkv, hd = WIDE_HEADS
    kc, vc = _mk(gen, B_SLOTS, Hkv, CACHE, hd), _mk(gen, B_SLOTS, Hkv,
                                                    CACHE, hd)
    q = _mk(gen, B_SLOTS, Hq, hd)
    kvl = torch.tensor(KV_LENS, dtype=torch.int32, device="cuda")
    err = err_ok(flash_decode(q, kc, vc, kvl),
                 decode_attention_ref(q, kc, vc, kvl))
    paged = paged_decode_case(gen, WIDE_HEADS, timed=False)
    return dict(family="wide_group", heads=list(WIDE_HEADS), G=Hq // Hkv,
                kv_len=KV_LENS,
                max_abs_err=max(err, paged["max_abs_err"]),
                paged_bitwise_vs_decode=True)


# ---------------------------------------- MoE slice: kernels at hd 32/128 ----

# the MoE families' attention heads (Hq, Hkv): kimi-k2 (G = 8) and arctic
# (G = 7, the first group size that is not a power of two)
MOE_HEADS = {"kimi": (64, 8), "arctic": (56, 8)}


# the dense decode kernels against their paged twins, bitwise, over
# shuffled tables with sentinel tails at every block size (BS and
# OTHER_BS), the dense kernels on the gathered view: every group size the
# served configs have (the planner's 3, hymba's 5, arctic's 7, kimi's 8),
# verify windows W 1, 5, 9, 22 (--draft-k 0, 4, 8, 21), head dims 32, 64,
# 128, plain and softcapped, over ragged slots that include an empty one
# and ones shorter than W
SWEEP_G, SWEEP_W, SWEEP_HD, SWEEP_CAP = (3, 5, 7, 8), (1, 5, 9, 22), \
    (32, 64, 128), (0.0, 30.0)
SWEEP_KV = [0, 1, 2048, 300, 1025, 21, 777, 1300]


def decode_family_sweep(gen):
    """flash_decode == flash_decode_paged and flash_verify ==
    flash_verify_paged (``torch.equal``) at every SWEEP_* case and block
    size: one routine with two sources, so any difference is a source's
    fault (a row staged in the wrong place, a table entry misread)."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.flash_verify import flash_verify, \
        flash_verify_paged
    from repro_torch.kernels.ref import paged_gather_kv
    kvl = torch.tensor(SWEEP_KV, dtype=torch.int32, device="cuda")
    n = 0
    for hd in SWEEP_HD:
        for bs in (BS,) + OTHER_BS:
            kp, vp, tab, _ = paged_pool(gen, 4, hd, bs, SWEEP_KV)
            kg, vg = paged_gather_kv(kp, tab), paged_gather_kv(vp, tab)
            for G in SWEEP_G:
                for cap in SWEEP_CAP:
                    q = _mk(gen, len(SWEEP_KV), 4 * G, hd)
                    check(torch.equal(
                        flash_decode(q, kg, vg, kvl, cap=cap),
                        flash_decode_paged(q, kp, vp, tab, kvl, cap=cap)),
                        f"flash_decode != flash_decode_paged at hd {hd}, "
                        f"bs {bs}, G {G}, cap {cap}")
                    for W in SWEEP_W:
                        q = _mk(gen, len(SWEEP_KV), 4 * G, W, hd)
                        check(torch.equal(
                            flash_verify(q, kg, vg, kvl, cap=cap),
                            flash_verify_paged(q, kp, vp, tab, kvl,
                                               cap=cap)),
                            f"flash_verify != flash_verify_paged at hd "
                            f"{hd}, bs {bs}, G {G}, W {W}, cap {cap}")
                    n += 1 + len(SWEEP_W)
    torch.cuda.synchronize()
    return dict(G=list(SWEEP_G), W=list(SWEEP_W), hd=list(SWEEP_HD),
                cap=list(SWEEP_CAP), block_sizes=[BS, *OTHER_BS],
                kv_len=SWEEP_KV, Hkv=4, cases=n, bitwise=True)


# verify above 64 rows per (kv head, slot): 9 and 17 blocks of warps at
# kimi-k2's heads with --draft-k 8 (G = 8, W = 9: 72 rows) and the
# planner's with --draft-k 21 (G = 3, W = 22: 66 rows)
VERIFY_OVER_64 = [(("kimi", 64, 8, 128), 9), (("planner", HQ, HKV, HD), 22)]


def verify_over_64_cases(gen):
    """flash_verify and flash_verify_paged with G*W > 64 rows: each row
    bitwise the decode row at its position, paged bitwise dense, both
    within tolerance of the plain versions (verify_cases' checks)."""
    out = []
    for (fam, hq, hkv, hd), W in VERIFY_OVER_64:
        for name, c in verify_cases(gen, (hq, hkv, hd), W).items():
            out.append((f"kernel_{name[6:]}", dict(c, family=fam, hd=hd)))
    return out


# prefill == extend, bitwise: the rows of one 1,300-token prefill against
# extends at these (q_offset, Sq) over a 2,048-row cache whose rows past
# the extend hold stale finite values; head dims 64, 128 and 32 with the
# planner's, kimi-k2's and arctic's heads; causal, window 1,024, softcap
PREFILL_S = 1300
EXTENDS = [(1, 276), (63, 1), (64, 64), (700, 276), (1024, 276), (1292, 8)]
PREFILL_VARIANTS = {"causal": {}, "window": dict(window=1024),
                    "softcap": dict(cap=30.0)}


def prefill_extend_cases(gen):
    """flash_prefill's row contract on the card: every extend's rows
    equal the prefill's rows at the same positions (``torch.equal``),
    and the prefill and every extend are within tolerance of the plain
    version."""
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.ref import attention_ref
    out = []
    for hd, (hq, hkv) in ((HD, (HQ, HKV)), (128, MOE_HEADS["kimi"]),
                          (32, MOE_HEADS["arctic"])):
        for name, kw in PREFILL_VARIANTS.items():
            q = _mk(gen, 1, hq, PREFILL_S, hd)
            kc, vc = _mk(gen, 1, hkv, CACHE, hd), _mk(gen, 1, hkv, CACHE, hd)
            k = kc[:, :, :PREFILL_S].contiguous()
            v = vc[:, :, :PREFILL_S].contiguous()
            full = flash_prefill(q, k, v, causal=True, **kw)
            err = err_ok(full, attention_ref(q, k, v, causal=True, **kw))
            for off, sq in EXTENDS:
                kx, vx = kc.clone(), vc.clone()
                stale = CACHE - off - sq
                kx[:, :, off + sq:] = _mk(gen, 1, hkv, stale, hd)
                vx[:, :, off + sq:] = _mk(gen, 1, hkv, stale, hd)
                qx = q[:, :, off:off + sq].contiguous()
                ext = flash_prefill(qx, kx, vx, causal=True, q_offset=off,
                                    **kw)
                check(torch.equal(ext, full[:, :, off:off + sq]),
                      f"flash_prefill: extend rows differ from prefill rows "
                      f"at hd {hd}, {name}, q_offset {off}, Sq {sq}")
                err = max(err, err_ok(ext, attention_ref(
                    qx, kx, vx, causal=True, q_offset=off, **kw)))
            out.append(dict(hd=hd, heads=[hq, hkv, hd], variant=name,
                            S=PREFILL_S, cache=CACHE, extends=EXTENDS,
                            bitwise=True, max_abs_err=err))
    return out


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


def ptxas_instances(log: str, symbol: str) -> list:
    """Registers and spill bytes nvcc reports (``-Xptxas -v``) for each
    instance of the kernel ``symbol``, by head dim (its template
    argument)."""
    return [dict(hd=i.pop("args")[0], **i)
            for i in scan_bench.ptxas_instances(log, symbol)]


def prefill_sass(build: Path) -> dict:
    """The HGMMA (wgmma) instructions in the SASS of each flash_prefill
    kernel instance, by head dim (``cuobjdump -sass`` of the built
    library); fails unless every instance has some."""
    import os
    import re
    import shutil
    tool = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" \
        / "cuobjdump"
    tool = str(tool) if tool.is_file() else shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump not found")
    sass = subprocess.run([tool, "-sass", str(build / "libflash_prefill.so")],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_prefill_kernelILi(\d+)E", line)
            fn = f"hd{m.group(1)}" if m else None
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    check(sorted(counts) == ["hd128", "hd32", "hd64"]
          and all(counts.values()),
          f"flash_prefill's SASS lacks HGMMA instructions: {counts}")
    return counts


def router_cases(gen, build_log: str):
    """moe_router_topk against its plain version on the card at
    ROUTER_CASES (logits from ``gen``) and ROUTER_EXTRA_CASES (from a
    generator of their own, so that later phases draw what they drew
    before): ids equal, weights within ROUTER_WTOL; its time by events,
    its device time a call beside the launch floor (a one-element zero_
    in the same profile), its bound and the softmax + topk +
    renormalisation yardstick (no one PyTorch call computes it). Also the
    registers, stack frame and spills of each template instance: every
    one of ROUTER_INSTANCES is built (and the cases run each), and none
    spills or has a stack frame."""
    from repro_torch.kernels.moe_router import moe_router_topk
    from repro_torch.kernels.ref import router_topk_ref
    inst = [dict(V=i.pop("args")[0], **i)
            for i in scan_bench.ptxas_instances(build_log, ROUTER_KERNEL)]
    check(set(ROUTER_INSTANCES) == {i["V"] for i in inst}
          and all(i.get("registers") for i in inst),
          f"ptxas report lacks the router instances: {inst}")
    check(not any(i["stack"] or i["spill_stores"] or i["spill_loads"]
                  for i in inst),
          f"a router instance spills or has a stack frame: {inst}")
    extra = torch.Generator(device="cuda").manual_seed(2)
    out = []
    for T, E, k, draw, g in (
            [(*c, "randn", gen) for c in ROUTER_CASES]
            + [(*c, extra) for c in ROUTER_EXTRA_CASES]):
        logits = router_logits(g, T, E, draw, "cuda")
        w, idx = moe_router_topk(logits, k)
        rw, ridx, _ = router_topk_ref(logits, k)
        torch.cuda.synchronize()
        check(torch.equal(idx, ridx), f"router ids differ at "
              f"{(T, E, k, draw)}: {int((idx != ridx).any(-1).sum())} rows")
        err = float((w - rw).abs().max())
        check(err <= ROUTER_WTOL, f"router weights differ by {err}")

        def yardstick():
            p = torch.softmax(logits, -1)
            tw, ti = torch.topk(p, k, dim=-1)
            return tw / torch.clamp(tw.sum(-1, keepdim=True), min=1e-9), ti
        call = lambda: moe_router_topk(logits, k)
        dev, floor = device_ms(call, ROUTER_KERNEL, floor=True)
        b_ms, b_by = bound(T * E * 4 + T * k * 8, T * E * (4 + 2 * k),
                           FP32_FLOP_S)
        out.append(dict(T=T, E=E, k=k, draw=draw, max_abs_err=err,
                        ids_equal=True,
                        bits=dict(w=scan_bench.digest(w),
                                  idx=scan_bench.digest(idx)),
                        ms=cuda_ms(call), device_ms=dev, floor_ms=floor,
                        plain_ms=cuda_ms(lambda: router_topk_ref(logits, k),
                                         iters=5),
                        library_ms=None,
                        softmax_topk_ms=cuda_ms(yardstick),
                        bound_ms=b_ms, bound_by=b_by))
    return out, inst


# ------------------------------------------- hymba slice: kernel cases ----

# hymba's attention heads (Hq, Hkv, hd): G = 5
HYMBA_HEADS = (25, 5, 64)
HYMBA_WINDOW = 1024
# the scan's (B, S, di, n): hymba-1.5b's prefill of a 1,024-token head and
# of a ragged 1,300-token prompt, its decode over 8 slots, hymba-smoke,
# and the serve runs' 14-token prompts
SSM_CASES = [(1, 1024, 1600, 16), (1, 1300, 1600, 16), (8, 1, 1600, 16),
             (1, 40, 128, 8), (1, 14, 1600, 16)]
SSM_ATOL = SSM_RTOL = 1e-4


def _ssm_inputs(gen, B, S, di, n, random_h0=True):
    """The JAX package's scan sweep distributions: dt = |N(0,1)| * 0.1;
    x, B_, C_ ~ N(0,1); A = -exp(N(0,1)); h0 ~ N(0,1) or zeros."""
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    h0 = r(B, di, n) if random_h0 else torch.zeros(B, di, n, device="cuda")
    return (r(B, S, di).abs() * 0.1, r(B, S, di), r(B, S, n), r(B, S, n),
            -torch.exp(r(di, n)), h0)


def ssm_err(out, ref) -> float:
    diff = (out - ref).abs()
    check(bool(torch.isfinite(out).all()), "non-finite ssm_scan out")
    check(bool((diff <= SSM_ATOL + SSM_RTOL * ref.abs()).all()),
          f"ssm_scan disagrees with its plain version: max err "
          f"{float(diff.max())}")
    return float(diff.max())


def ssm_cases(gen, build_log: str):
    """ssm_scan against its plain version at SSM_CASES (prefill shapes
    from zero and from random h0), with its time, bound (the bytes of
    every input read once and every output written once; ~7 fp32
    operations per (b, t, d, n)), registers and the sha256 of each output
    (``bits``: a later tree's kernel is held to them); then its seam
    contract, bitwise: the 1,300-step scan split at 1,024 and at 1, and 16
    one-step launches against one 16-step launch over 8 slots."""
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.kernels.ssm_scan import ssm_scan
    cases = []
    for B, S, di, n in SSM_CASES:
        for random_h0 in ((False, True) if S > 1 else (True,)):
            args = _ssm_inputs(gen, B, S, di, n, random_h0)
            y, h = ssm_scan(*args)
            ry, rh = selective_scan_ref(*args)
            torch.cuda.synchronize()
            err = max(ssm_err(y, ry), ssm_err(h, rh))
            nbytes = 4 * (3 * B * S * di + 2 * B * S * n + di * n
                          + 2 * B * di * n)
            b_ms, b_by = bound(nbytes, 7 * B * S * di * n, FP32_FLOP_S)
            cases.append(dict(
                B=B, S=S, di=di, n=n,
                h0="random" if random_h0 else "zeros", max_abs_err=err,
                bits=dict(y=scan_bench.digest(y),
                          h_last=scan_bench.digest(h)),
                ms=cuda_ms(lambda: ssm_scan(*args)),
                device_ms=device_ms(lambda: ssm_scan(*args),
                                    "ssm_scan_kernel"),
                plain_ms=cuda_ms(lambda: selective_scan_ref(*args),
                                 iters=2, warmup=1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                registers=_ptxas_registers(build_log, "ssm_scan")))
    dt, x, Bm, Cm, A, h0 = _ssm_inputs(gen, 1, 1300, 1600, 16)
    y, h = ssm_scan(dt, x, Bm, Cm, A, h0)
    part = lambda a, lo, hi: a[:, lo:hi].contiguous()
    for cut in (1024, 1):
        y1, h1 = ssm_scan(*(part(a, 0, cut) for a in (dt, x, Bm, Cm)), A,
                          h0)
        y2, h2 = ssm_scan(*(part(a, cut, 1300) for a in (dt, x, Bm, Cm)),
                          A, h1)
        check(torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h),
              f"ssm_scan split at {cut} differs from one scan")
    dt, x, Bm, Cm, A, h0 = _ssm_inputs(gen, 8, 16, 1600, 16)
    y, h = ssm_scan(dt, x, Bm, Cm, A, h0)
    ys, hs = [], h0
    for t in range(16):
        yt, hs = ssm_scan(*(part(a, t, t + 1) for a in (dt, x, Bm, Cm)), A,
                          hs)
        ys.append(yt)
    check(torch.equal(torch.cat(ys, 1), y) and torch.equal(hs, h),
          "16 one-step ssm_scan launches differ from one 16-step launch")
    return cases, dict(split_at=[1024, 1], one_step_launches=16,
                       bitwise=True)


def hymba_attention_cases(gen):
    """The two attention kernels where hymba is the first to use them
    this way: flash_prefill's window variant at hymba's heads (Sq = Sk =
    1,300, window 1,024) and flash_decode at G = 5 over a 1,024-row ring,
    full and partly filled."""
    tag = dict(family="hymba", hd=HYMBA_HEADS[2])
    out = [("kernel_prefill", dict(prefill_case(
        1300, 1300, 0, gen, HYMBA_HEADS, window=HYMBA_WINDOW), **tag))]
    for kvl in HYMBA_RINGS:
        out.append(("kernel_decode", dict(decode_case(
            kvl, HYMBA_WINDOW, gen, HYMBA_HEADS), ring=True, **tag)))
    return out


# ------------------------------------------- xlstm slice: kernel cases ----

XLSTM = "xlstm-125m"
# the mLSTM scan's (B, H, S, hd): xlstm-125m's prefill of a 1,024-token
# head and of a ragged 1,300-token prompt, its decode over 8 slots,
# xlstm-smoke, the two other head dims the kernel is built for, and the
# serve runs' 14-token prompts
MLSTM_CASES = [(1, 4, 1024, 192), (1, 4, 1300, 192), (8, 4, 1, 192),
               (1, 4, 40, 32), (1, 4, 256, 64), (1, 4, 256, 128),
               (1, 4, 14, 192)]
MLSTM_TOL = 1e-4


def _mlstm_inputs(gen, B, H, S, hd, random_state=True):
    """q, k, v, i ~ N(0,1) and f ~ N(3,1) (the forget-gate bias of +3);
    the state C, n, m ~ N(0,1), or fresh (zeros, zeros, -1e30)."""
    from repro_torch.kernels.ref import mlstm_zero_state
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    st = ((r(B, H, hd, hd), r(B, H, hd), r(B, H)) if random_state
          else mlstm_zero_state(B, H, hd, "cuda"))
    return [r(B, H, S, hd), r(B, H, S, hd), r(B, H, S, hd), r(B, H, S),
            r(B, H, S) + 3.0], st


@torch.no_grad()
def mlstm_conditioning(q, k, v, i_pre, f_pre, state):
    """What bounds the rounding of each output of the mLSTM scan: the
    plain recurrence stepped again (fp32, scale 1/sqrt(hd)), giving per
    (b, h, t, e) ``(sum_d |C[d,e] q_d| + |h_e| sum_d |n_d q_d|) / den``,
    the sums of absolute terms of the two reductions over d (a reordered
    fp32 sum errs by a few ulps of these) divided by the cancelled
    denominator; and the smallest ``den / (|n| |q|)`` seen (1 or more
    where exp(-m) wins over |n . q|)."""
    import torch.nn.functional as F
    B, H, S, hd = q.shape
    C, n, m = (t.clone() for t in state)
    ks = k / hd ** 0.5
    scales, ratios = [], []
    for t in range(S):
        q_t, i_t = q[:, :, t], i_pre[:, :, t]
        logf = F.logsigmoid(f_pre[:, :, t])
        m_new = torch.maximum(logf + m, i_t)
        fw = torch.exp(logf + m - m_new)[..., None]
        iw = torch.exp(i_t - m_new)[..., None]
        C = C * fw[..., None] + iw[..., None] * (ks[:, :, t, :, None]
                                                 * v[:, :, t, None, :])
        n = n * fw + iw * ks[:, :, t]
        den = torch.maximum((n * q_t).sum(-1).abs(), torch.exp(-m_new))
        num_abs = (C.abs() * q_t.abs()[..., None]).sum(-2)
        h_abs = (C * q_t[..., None]).sum(-2).abs() / den[..., None]
        nq_abs = (n.abs() * q_t.abs()).sum(-1)
        scales.append((num_abs + h_abs * nq_abs[..., None])
                      / den[..., None])
        ratios.append((den / (n.norm(dim=-1) * q_t.norm(dim=-1))).min())
        m = m_new
    return torch.stack(scales, dim=2), float(torch.stack(ratios).min())


def mlstm_err(out, ref, state, ref_state, scale):
    """Kernel vs plain: every output within MLSTM_TOL of its
    conditioning scale (``mlstm_conditioning``), every state leaf within
    MLSTM_TOL (1 + |x|). Returns (max |diff| of h, its largest ratio to
    the scale, max |diff| of the state)."""
    check(bool(torch.isfinite(out).all()), "non-finite mlstm_scan out")
    diff = (out - ref).abs()
    over = diff / scale.clamp(min=1e-30)
    check(float(over.max()) <= MLSTM_TOL,
          f"mlstm_scan disagrees with its plain version: max err "
          f"{float(diff.max())}, {float(over.max())} of its scale")
    st_err = 0.0
    for name, a, b in zip("Cnm", state, ref_state):
        d = (a - b).abs()
        check(bool((d <= MLSTM_TOL * (1 + b.abs())).all()),
              f"mlstm_scan state {name} differs by {float(d.max())}")
        st_err = max(st_err, float(d.max()))
    return float(diff.max()), float(over.max()), st_err


def mlstm_cases(gen, build_log: str):
    """mlstm_scan against its plain version at MLSTM_CASES (prefill
    shapes from a fresh and from a random state) with the
    conditioning-scaled tolerance, its time, bound (every input read
    once, every output written once; the function's 5 hd^2 + 7 hd + 10
    fp32 operations per (b, h, t): C fw + (iw ks) v^T is a multiply and a
    multiply-add per element of C, the readout C^T q a multiply-add; ks,
    iw ks, the n update, n . q and the division are O(hd)), registers
    and the sha256 of each output (``bits``); then its contracts,
    bitwise: the 1,300-step scan split at 1,024 and at 1, 16 one-step
    launches (decode's tile width) against one 16-step launch (the
    scan's), and every column tile's own n and m equal to the n and m
    written out, at both widths."""
    from repro_torch.kernels.mlstm_scan import mlstm_scan, \
        mlstm_scan_tile_states
    from repro_torch.kernels.ref import mlstm_scan_ref
    cases = []
    for B, H, S, hd in MLSTM_CASES:
        for random_state in ((False, True) if S > 1 else (True,)):
            args, st = _mlstm_inputs(gen, B, H, S, hd, random_state)
            h, s = mlstm_scan(*args, st)
            rh, rs = mlstm_scan_ref(*args, st)
            torch.cuda.synchronize()
            scale, ratio = mlstm_conditioning(*args, st)
            err, over, st_err = mlstm_err(h, rh, s, rs, scale)
            nbytes = 4 * (4 * B * H * S * hd + 2 * B * H * S
                          + 2 * B * H * (hd * hd + hd + 1))
            b_ms, b_by = bound(nbytes, B * H * S * (5 * hd * hd + 7 * hd
                                                    + 10), FP32_FLOP_S)
            cases.append(dict(
                B=B, H=H, S=S, hd=hd,
                state="random" if random_state else "fresh",
                max_abs_err=err, err_over_scale=over, state_err=st_err,
                bits=dict(zip("hCnm", map(scan_bench.digest, (h, *s)))),
                min_den_over_nq=ratio, h_absmax=float(rh.abs().max()),
                ms=cuda_ms(lambda: mlstm_scan(*args, st)),
                device_ms=device_ms(lambda: mlstm_scan(*args, st),
                                    "mlstm_scan_kernel"),
                plain_ms=cuda_ms(lambda: mlstm_scan_ref(*args, st),
                                 iters=2, warmup=1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                registers=_ptxas_registers(build_log, "mlstm_scan")))
    part = lambda a, lo, hi: a[:, :, lo:hi].contiguous()
    same = lambda x, y: all(torch.equal(a, b) for a, b in zip(x, y))
    args, st = _mlstm_inputs(gen, 1, 4, 1300, 192)
    h, s = mlstm_scan(*args, st)
    for cut in (1024, 1):
        h1, s1 = mlstm_scan(*(part(a, 0, cut) for a in args), st)
        h2, s2 = mlstm_scan(*(part(a, cut, 1300) for a in args), s1)
        check(torch.equal(torch.cat([h1, h2], 2), h) and same(s2, s),
              f"mlstm_scan split at {cut} differs from one scan")
    tiles = []
    (h2, s2), (nt, mt) = mlstm_scan_tile_states(*args, st)
    tiles.append((h2, s2, nt, mt, h, s))
    args, st = _mlstm_inputs(gen, 8, 4, 16, 192)
    h, s = mlstm_scan(*args, st)
    hs, cur = [], st
    for t in range(16):
        ht, cur = mlstm_scan(*(part(a, t, t + 1) for a in args), cur)
        hs.append(ht)
    check(torch.equal(torch.cat(hs, 2), h) and same(cur, s),
          "16 one-step mlstm_scan launches differ from one 16-step launch")
    (h2, s2), (nt, mt) = mlstm_scan_tile_states(*args, st)
    tiles.append((h2, s2, nt, mt, h, s))
    one = [part(a, 0, 1) for a in args]
    h, s = mlstm_scan(*one, st)
    (h2, s2), (nt1, mt1) = mlstm_scan_tile_states(*one, st)
    tiles.append((h2, s2, nt1, mt1, h, s))
    for h2, s2, nt, mt, h, s in tiles:
        check(torch.equal(h2, h) and same(s2, s)
              and all(torch.equal(nt[:, :, j], s[1])
                      and torch.equal(mt[:, :, j], s[2])
                      for j in range(nt.shape[2])),
              "mlstm_scan: the column tiles' n and m differ")
    return cases, dict(split_at=[1024, 1], one_step_launches=16,
                       tiles=[int(t[2].shape[2]) for t in tiles],
                       tiles_n_m_equal=True, bitwise=True)


def mlstm_model_cases():
    """mlstm_scan against its plain version on xlstm-125m's own inputs:
    the q, k, v, i and f that each of the 9 mLSTM layers of the
    full-width model (seed-0 weights) gives the scan in a 1,024-token
    prefill, with the conditioning-scaled tolerance."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import backend as KB
    from repro_torch.kernels.mlstm_scan import mlstm_scan
    from repro_torch.kernels.ref import mlstm_scan_ref
    from repro_torch.models.model import init_params, prefill
    cfg = get_config(XLSTM)
    model = init_params(cfg, seed=0, device="cuda")
    tokens = np.random.default_rng(11).integers(6, cfg.vocab_size,
                                                (1, 1024))
    rec, orig = [], KB.mlstm_scan

    def record(q, k, v, i_pre, f_pre, state=None, *, scale=0.0):
        rec.append((q, k, v, i_pre, f_pre, state))
        return orig(q, k, v, i_pre, f_pre, state, scale=scale)
    KB.mlstm_scan = record
    try:
        prefill(model, {"tokens": tokens}, 2048)
    finally:
        KB.mlstm_scan = orig
    del model
    gc.collect()
    torch.cuda.empty_cache()
    check(len(rec) == 9, f"recorded {len(rec)} mLSTM scans, not 9")
    errs, overs, st_errs, ratios, absmax = [], [], [], [], []
    for q, k, v, i_pre, f_pre, st in rec:
        h, s = mlstm_scan(q, k, v, i_pre, f_pre, st)
        rh, rs = mlstm_scan_ref(q, k, v, i_pre, f_pre, st)
        scale, ratio = mlstm_conditioning(q, k, v, i_pre, f_pre, st)
        err, over, st_err = mlstm_err(h, rh, s, rs, scale)
        errs.append(err)
        overs.append(over)
        st_errs.append(st_err)
        ratios.append(ratio)
        absmax.append(float(rh.abs().max()))
    return dict(layers=len(rec), S=1024, max_abs_err=errs,
                err_over_scale=overs, state_err=st_errs,
                min_den_over_nq=ratios, h_absmax=absmax, tol=MLSTM_TOL)


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
    # 66 verify rows per (kv head, slot): 1 + 2 windows of 22
    ("spec_k21", ["--spec-decode", "--draft-k", "21"], 45,
     ("flash_prefill", "flash_verify")),
    ("paged_tight", PAGED + ["--kv-blocks", "24"], 64,
     ("flash_prefill", "flash_decode_paged")),
    ("paged_bs8", PAGED + ["--block-size", "8"], 64,
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
    run that is not the process's first serve. Returns the runs and the
    first mode's outputs by request id."""
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
    return runs, ref


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
        # gzipped (Perfetto opens .json.gz): as plain JSON the four
        # decode traces take ~70 MB, gzipped ~5 MB
        import gzip
        import os
        OUT_DIR.mkdir(exist_ok=True)
        raw = OUT_DIR / f"{trace}.tmp"
        prof.export_chrome_trace(str(raw))
        with open(raw, "rb") as src, \
                gzip.open(OUT_DIR / f"{trace}.gz", "wb") as dst:
            dst.write(src.read())
        os.remove(raw)
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


def kernel_launch_times(dev, dev_t, names, per: int, unit: str) -> dict:
    """Each named kernel's device time, launches and time a launch over
    ``per`` steps or rounds (``unit``), from a profile's device events."""
    res = {}
    for name in names:
        hit = [e for e in dev if f"{name}_kernel" in e.key]
        t, n = sum(dev_t(e) for e in hit), sum(e.count for e in hit)
        res[f"{name}_ms_per_{unit}"] = t / 1e3 / per
        res[f"{name}_launches_per_{unit}"] = n / per
        res[f"{name}_ms_per_launch"] = t / 1e3 / n if n else None
    return res


def profile_decode(cfg, model, steps: int, trace: str, **kw):
    """Where a full-width decode step's time goes: device kernel time by
    name over ``steps`` engine steps with 8 busy slots (``kw``: the
    engine's KV mode), against the host clock around the same steps; the
    decode attention kernel's time, launches and share (the scans' for the
    hybrid and recurrent stacks); for an MoE stack also the router
    kernel's and the expert products' (``aten::bmm``, which only the
    expert FFN calls)."""
    eng = _busy_engine(cfg, model, steps + 8, 4, **kw)
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
    attn = "flash_decode_paged" if kw.get("kv_mode") == "paged" \
        else "flash_decode"
    names = {"hybrid": ("ssm_scan", attn), "ssm": ("mlstm_scan",),
             "moe": (attn, "moe_router_topk")}.get(cfg.family, (attn,))
    res.update(kernel_launch_times(dev, dev_t, names, steps, "step"))
    for name in names:
        res[f"{name}_share_of_busy"] = \
            1e3 * steps * res[f"{name}_ms_per_step"] / max(busy_us, 1e-9)
    if cfg.family == "moe":
        tot_t = lambda e: getattr(e, "device_time_total",
                                  getattr(e, "cuda_time_total", 0.0))
        res["expert_bmm_ms_per_step"] = sum(
            tot_t(e) for e in ev if e.key == "aten::bmm") / 1e3 / steps
    return res


def profile_spec(cfg, model, rounds: int = 4, **kw):
    """Where a full-width speculative round's time goes: the host clock
    around the draft's steps (``spec.draft`` + ``spec.catch_up``, each
    ending in a synchronize) against the whole round, and device time
    over the same rounds, with 8 busy slots (k=4 self-draft; ``kw``: the
    engine's KV mode); the verify kernel's time a launch."""
    from repro_torch.serving.specdec import SpecConfig
    eng = _busy_engine(cfg, model, 5 * (rounds + 4), 2,
                       spec_decode=SpecConfig(cfg, model, k=4), **kw)
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
                             for e in top],
                **kernel_launch_times(
                    dev, dev_t, ("flash_verify_paged",)
                    if kw.get("kv_mode") == "paged" else ("flash_verify",),
                    rounds, "round"))


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
    the long-prompt equalities (asserted), the decode and spec profiles,
    card vs CPU, the sampler on the card against the CPU and the replica
    cluster. Returns the serve runs and the cluster runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config(ARCH)
    model = init_params(cfg, seed=0, device="cuda")
    runs, _ = serve_runs(ARCH, cfg, model, PLANNER_MODES)
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
    emit("paged_decode_profile", **profile_decode(cfg, model, 10, "",
                                                  kv_mode="paged"))
    emit("spec_profile", **profile_spec(cfg, model))
    emit("paged_spec_profile", **profile_spec(cfg, model,
                                              kv_mode="paged"))
    emit("card_vs_cpu", **card_vs_cpu(cfg))
    emit("sampler_card_vs_cpu", **sampler_card_vs_cpu())
    return runs, cluster_phases(cfg, model)


# the GeckOpt pipeline runs: 16 tasks at 8 sessions in flight, with the
# gated library catalog, then with a top-8 retrieved toolset of a
# generated 128-tool catalog; (name, extra serve_pipeline flags)
GECKOPT_TASKS = 16
GECKOPT_RUNS = [("dense", []),
                ("retrieved", ["--retriever-k", "8", "--catalog-size", "128"])]
GATE_QUERIES = 8
GATE_LOSS_TOL = 0.1


def hit_vs_miss_turns(cfg, model, turns, cache_len: int, n: int = 4):
    """The first turn of each of ``n`` prefixes served again on a fresh
    engine with no prefix cache (a full prefill of its ~2.5k-token
    prompt): its tokens must be the hit's."""
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.sampling import SamplerConfig
    firsts = {}
    for prompt, key, out in turns:
        firsts.setdefault(key, (prompt, out))
    picked = list(firsts.values())[:n]
    eng = InferenceEngine(cfg, model, max_batch=len(picked),
                          cache_len=cache_len)
    rids = [eng.add_request(p, max_new_tokens=len(out),
                            sampler=SamplerConfig(temperature=0.0))
            for p, out in picked]
    done = {r.request_id: list(r.output) for r in eng.run_until_done()}
    same = [done[rid] == out for rid, (_, out) in zip(rids, picked)]
    return dict(turns=len(picked), prompt_tokens=[len(p) for p, _ in picked],
                tokens_equal=all(same))


def geckopt_run(cfg, model, name: str, extra):
    """One full-width pipeline run through the launcher's
    ``serve_pipeline`` with its launch counts (set to 0 just before it,
    read just after), then the sequential harness on the same tasks with
    the single-query gate (8 B=1 forwards a query): its decisions and its
    Table-2 row must be the pipeline's. Every turn must ride a prefix
    (hits == sessions), each prefix must be prefilled once, and a prefix
    hit must give a full prefill's tokens."""
    from repro_torch.env.evaluator import evaluate_results
    from repro_torch.kernels import backend as KB
    from repro_torch.launch import serve_pipeline as SP
    from repro_torch.serving.neural_planner import NeuralIntentClassifier
    args = SP.parse_args(["--requests", str(GECKOPT_TASKS),
                          "--concurrency", "8"] + extra)
    KB.reset_launches()
    res = SP.serve_pipeline(cfg, model, args)
    counts = KB.launch_counts()
    n = len(res["results"])
    check(n == GECKOPT_TASKS, f"geckopt {name}: {n} results")
    missing = [k for k in ("flash_prefill", "flash_decode") if not counts[k]]
    check(not missing, f"geckopt {name}: no launch of {missing}")
    agent = SP.build_agent(args, NeuralIntentClassifier(cfg, model),
                           res["agent"].world, model.device)
    t0 = time.time()
    seq = [agent.run_task(t, task_seed=i)
           for i, t in enumerate(res["tasks"])]
    seq_s = time.time() - t0
    same_gate = [r.intent_predicted for r in seq] == res["decisions"]
    check(same_gate, f"geckopt {name}: batched gate decisions differ from "
                     f"the single-query gate's")
    seq_row = evaluate_results(seq).row()
    check(seq_row == res["row"], f"geckopt {name}: pipeline row "
                                 f"{res['row']} != sequential {seq_row}")
    st = res["stats"]
    check(st["prefix_hits"] == res["pipeline"]["engine_turns"] == n,
          f"geckopt {name}: {st['prefix_hits']} prefix hits for {n} turns")
    check(st["prefills"] == st["prefix_registrations"]
          == len(res["prefixes"]),
          f"geckopt {name}: {st['prefills']} prefills for "
          f"{len(res['prefixes'])} prefixes")
    hm = hit_vs_miss_turns(cfg, model, res["turns"], SP.cache_len_for(args))
    check(hm["tokens_equal"], f"geckopt {name}: a prefix hit's tokens "
                              f"differ from a full prefill's")
    waves = res["gate_wave_ms"]
    return dict(sessions=n, concurrency=8, flags=extra,
                seconds=res["seconds"], tasks_s=res["tasks_s"],
                gate_waves=len(waves), gate_wave_ms=waves,
                gate_ms_per_wave=sum(waves) / max(len(waves), 1),
                launches=counts, launches_by_phase=res["launches"],
                prefixes=len(res["prefixes"]),
                engine={k: st[k] for k in (
                    "prefix_hits", "prefix_registrations", "prefills",
                    "prefix_tokens_saved", "tokens_generated",
                    "decode_steps", "kv_bytes_peak", "kv_bytes_allocated")},
                pipeline={k: res["pipeline"][k] for k in (
                    "admitted", "gate_batches", "mean_gate_batch", "ticks",
                    "peak_concurrent", "engine_turns", "retrievals",
                    "retrieval_widens")},
                row=res["row"], sequential_row_equal=True,
                decisions=res["decisions"],
                gate_decisions_equal=same_gate, sequential_seconds=seq_s,
                hit_vs_miss=hm)


def gate_card_vs_cpu(cfg, model, queries):
    """The batched gate's (Q, 8) losses on the card against the same
    forward on the CPU (the same seeded weights): within GATE_LOSS_TOL,
    and the same decisions wherever the CPU's top-2 margin exceeds twice
    the tolerance or twice the largest difference measured."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.neural_planner import \
        BatchedNeuralIntentClassifier
    cpu = init_params(cfg, seed=0, device="cpu")
    card = BatchedNeuralIntentClassifier(cfg, model).losses(queries)
    t0 = time.time()
    host = BatchedNeuralIntentClassifier(cfg, cpu).losses(queries)
    cpu_s = time.time() - t0
    check(bool(np.isfinite(card).all()), "gate: non-finite card losses")
    diff = float(np.abs(card - host).max())
    check(diff <= GATE_LOSS_TOL, f"gate: card vs CPU losses differ by "
                                 f"{diff}")
    top2 = np.sort(host, axis=1)
    margin = top2[:, 1] - top2[:, 0]
    same = np.argmin(card, axis=1) == np.argmin(host, axis=1)
    check(bool(same[margin > 2 * GATE_LOSS_TOL].all()
               and same[margin > 2 * diff].all()),
          f"gate: card decisions differ outside near-ties (margins "
          f"{margin.tolist()}, diff {diff})")
    return dict(queries=len(queries), max_abs_diff=diff, tol=GATE_LOSS_TOL,
                decisions_equal=int(same.sum()),
                margins=[float(m) for m in margin],
                loss_range=[float(host.min()), float(host.max())],
                cpu_seconds=cpu_s)


def geckopt_phases():
    """The GeckOpt path at the planner's full width: the pipeline runs
    (one engine, then a 4-replica cluster) and the gate's card-vs-CPU
    losses. Returns the runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config(ARCH)
    model = init_params(cfg, seed=0, device="cuda")
    runs = {}
    for name, extra in GECKOPT_RUNS:
        runs[name] = geckopt_run(cfg, model, name, extra)
        emit(f"geckopt_{name}", **runs[name])
    runs["cluster"] = geckopt_cluster(cfg, model, runs["dense"])
    emit("geckopt_cluster", **runs["cluster"])
    from repro_torch.env.tasks import make_benchmark
    from repro_torch.env.world import build_world
    queries = [t.query for t in make_benchmark(build_world(0), GATE_QUERIES)]
    emit("geckopt_gate_card_vs_cpu", **gate_card_vs_cpu(cfg, model, queries))
    return runs

# ------------------------------------------------------------ training ----

# flash_prefill's backward against its plain version (autograd through
# attention_ref): recomputed fp32 p, and D from the forward kernel's bf16
# output (whose P V rounds P to bf16)
BWD_ATOL = BWD_RTOL = 2e-2
# (B, S, (Hq, Hkv, hd), window, cap, family): the planner's train shapes
# (launch.train's 8 x 256, train_planner's 16 x 64), a 1,024-token row,
# kimi-k2's heads at head dim 128, head dim 32, a window and a softcap
BWD_CASES = [(8, 256, (HQ, HKV, HD), 0, 0.0, "train"),
             (16, 64, (HQ, HKV, HD), 0, 0.0, "gate"),
             (1, 1024, (HQ, HKV, HD), 0, 0.0, "long"),
             (1, 512, MOE_HEADS["kimi"] + (128,), 0, 0.0, "kimi"),
             (2, 256, (HQ, HKV, 32), 0, 0.0, "hd32"),
             (2, 512, (HQ, HKV, HD), 100, 0.0, "window"),
             (2, 256, (HQ, HKV, HD), 0, 30.0, "cap")]
BWD_PASSES = ("bwd_rows_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel")


def bwd_case(gen, B, S, heads, window, cap, family):
    """flash_prefill_bwd against attention_bwd_ref on the forward
    kernel's output: every dq, dk, dv within BWD_ATOL + BWD_RTOL |plain|,
    each output's relative norm error, the same sha256 on a second call;
    its CUDA-event and device times (the train shape also by pass) beside
    the plain version's, SDPA's backward (none under a cap) and the
    bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import flash_prefill, \
        flash_prefill_bwd
    from repro_torch.kernels.ref import attention_bwd_ref
    from repro_torch.launch.decode_bench import digest
    Hq, Hkv, hd = heads
    q, k, v = _mk(gen, B, Hq, S, hd), _mk(gen, B, Hkv, S, hd), \
        _mk(gen, B, Hkv, S, hd)
    dout = _mk(gen, B, Hq, S, hd)
    kw = dict(causal=True, window=window, cap=cap)
    out = flash_prefill(q, k, v, **kw)
    run = lambda: flash_prefill_bwd(q, k, v, out, dout, **kw)
    got, again = run(), run()
    ref = attention_bwd_ref(q, k, v, dout, **kw)
    err, rel = {}, {}
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        check(bool(torch.isfinite(a.float()).all()), f"bwd {family}: "
                                                     f"non-finite {name}")
        diff = (a.float() - b.float()).abs()
        err[name] = float(diff.max())
        rel[name] = float((a.float() - b.float()).norm()
                          / b.float().norm())
        check(bool((diff <= BWD_ATOL + BWD_RTOL * b.float().abs()).all()),
              f"bwd {family}: {name} differs from the plain version by "
              f"{err[name]}")
    bits = [digest(t) for t in got]
    check(bits == [digest(t) for t in again],
          f"bwd {family}: two calls give other bits")
    pos = torch.arange(S, device="cuda")
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    pairs = B * int(mask.sum())                   # visible (q, k) a head
    # five hd-long products a visible pair and q head; q, o, dout, k, v
    # read once, dq, dk, dv written once
    b_ms, b_by = bound(2 * hd * B * (4 * Hq * S + 4 * Hkv * S),
                       10 * hd * Hq * pairs)
    res = dict(family=family, B=B, S=S, heads=list(heads), window=window,
               cap=cap, max_abs_err=max(err.values()), err=err,
               rel_norm_err=rel, bits=bits, ms=cuda_ms(run),
               device_ms=device_ms(run),
               plain_ms=cuda_ms(lambda: attention_bwd_ref(q, k, v, dout,
                                                          **kw), iters=3),
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               library_device_ms=None)
    if family == "train":
        res["pass_device_ms"] = {p: device_ms(run, p) for p in BWD_PASSES}
    if not cap:
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                           enable_gqa=True)
        lib = lambda: torch.autograd.grad(o, (qs, ks, vs), dout,
                                          retain_graph=True)
        res["library_ms"] = cuda_ms(lib)
        res["library_device_ms"] = device_ms(lib)
    return res


def bwd_cases(gen, build_log: str):
    """The backward at BWD_CASES and its three passes' registers and
    spills by head dim (``-Xptxas -v``)."""
    ptxas = {p: ptxas_instances(build_log, p) for p in BWD_PASSES}
    return [bwd_case(gen, *c) for c in BWD_CASES], ptxas


TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARM = 30, 8, 256, 5
TRAIN_LOSS_TOL = 0.05
GATE_CKPT = ROOT / "build" / "planner_gate.npz"


def _train_args(steps: int, remat: bool, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    from repro_torch.launch.train import parse_args
    return parse_args(["--steps", str(steps), "--batch", str(batch),
                       "--seq", str(seq), "--log-every", "10"]
                      + (["--remat"] if remat else []))


def _profile_train_step(cfg, model):
    """One more train step (fresh optimizer state) under torch.profiler:
    its wall ms, device busy ms and share, and the device time of its
    heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.data import PackedLMDataset, synthetic_docs
    from repro_torch.training.loop import make_train_step
    from repro_torch.training.optimizer import adamw_init
    step = make_train_step(cfg, lr=3e-4, remat=False)
    opt = adamw_init(model)
    batch = next(PackedLMDataset(synthetic_docs(cfg.vocab_size, seed=3),
                                 TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size))
    step(model, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if "CUDA" in str(e.device_type)]
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_t(e) for e in dev) / 1e3
    top = sorted(dev, key=dev_t, reverse=True)[:8]
    return dict(wall_ms=1e3 * wall, busy_ms=busy,
                busy_share=busy / (1e3 * wall),
                kernels=sum(e.count for e in dev),
                top=[dict(name=e.key[:80], ms=dev_t(e) / 1e3, count=e.count)
                     for e in top])


def train_card(cfg):
    """``launch.train`` at full width, TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ tokens from seed 0's weights, without and with remat: the
    last loss below the first, each kernel's launches a step (flash
    prefill once a layer, twice with remat; its backward once a layer),
    ms a step past TRAIN_WARM steps, tok/s, peak memory; remat and no
    remat bitwise equal in every loss and parameter; one profiled
    step."""
    from repro_torch.kernels import backend as KB
    from repro_torch.launch.train import train_run
    from repro_torch.models.model import count_params, init_params
    runs, models = {}, {}
    for remat in (False, True):
        model = init_params(cfg, seed=0,
                            device="cuda").requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        KB.reset_launches()
        res = train_run(cfg, model, _train_args(TRAIN_STEPS, remat))
        counts = KB.launch_counts()
        per_step = {k: n / TRAIN_STEPS for k, n in counts.items() if n}
        name = "remat" if remat else "no_remat"
        layers = cfg.n_layers
        check(per_step.get("flash_prefill_bwd") == layers
              and per_step.get("flash_prefill")
              == layers * (2 if remat else 1),
              f"train {name}: launches a step {per_step}")
        losses = res["losses"]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"train {name}: loss {losses[0]} -> {losses[-1]}")
        steady = res["step_ms"][TRAIN_WARM:]
        ms = sum(steady) / len(steady)
        runs[name] = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                          seq=TRAIN_SEQ, params=count_params(model),
                          losses=losses, ms_per_step=ms,
                          step_ms=res["step_ms"],
                          tok_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                          launches=counts, launches_per_step=per_step,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          peak_over_base_gb=(torch.cuda.max_memory_allocated()
                                             - base) / 1e9,
                          seconds=res["seconds"])
        models[remat] = model
    a, b = runs["no_remat"]["losses"], runs["remat"]["losses"]
    first_loss = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      None)
    pb = dict(models[True].named_parameters())
    first_leaf = next((n for n, p in models[False].named_parameters()
                       if not torch.equal(p, pb[n])), None)
    check(first_loss is None and first_leaf is None,
          f"train: remat differs from no remat (first loss {first_loss}, "
          f"first leaf {first_leaf})")
    runs["remat_equal"] = True
    runs["profile"] = _profile_train_step(cfg, models[False])
    return runs


def train_card_vs_cpu(cfg):
    """One full-width train_loss and its gradients (B 2 x S 64, seed 0's
    weights, drawn on the CPU for both) on the card and on the CPU: the
    losses within TRAIN_LOSS_TOL; each leaf's relative gradient error
    reported."""
    from repro_torch.models.model import init_params, train_loss
    from repro_torch.training.data import PackedLMDataset, synthetic_docs
    batch = next(PackedLMDataset(synthetic_docs(cfg.vocab_size, seed=1), 2,
                                 64, cfg.vocab_size))
    out = {}
    for dev in ("cuda", "cpu"):
        model = init_params(cfg, seed=0,
                            device=dev).requires_grad_(True)
        params = dict(model.named_parameters())
        t0 = time.time()
        loss = train_loss(model, batch, remat=False)
        grads = torch.autograd.grad(loss, list(params.values()))
        out[dev] = (float(loss.detach()), {n: g.float().cpu() for n, g in
                                           zip(params, grads)},
                    time.time() - t0)
    diff = abs(out["cuda"][0] - out["cpu"][0])
    check(diff <= TRAIN_LOSS_TOL, f"train: card vs CPU loss differ by "
                                  f"{diff}")
    rel = {n: float((g - out["cpu"][1][n]).norm()
                    / out["cpu"][1][n].norm().clamp(min=1e-30))
           for n, g in out["cuda"][1].items()}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    return dict(config=cfg.name, B=2, S=64, loss_card=out["cuda"][0],
                loss_cpu=out["cpu"][0], loss_diff=diff, tol=TRAIN_LOSS_TOL,
                grad_rel_err_max=max(rel.values()),
                grad_rel_err_median=float(np.median(list(rel.values()))),
                grad_rel_err_worst=worst, grad_rel_err=rel,
                cpu_seconds=out["cpu"][2])


def gate_training(cfg):
    """``launch.train_planner --full`` on the card: the gate's accuracy on
    the 48 held-out tasks and its Table-2 row against the ungated agent;
    its checkpoint reloaded into a fresh model (``load_checkpoint``) gives
    the in-memory gate's batched decisions on those tasks; ``launch.serve
    --checkpoint`` serves 4 requests from it."""
    from repro_torch.env.tasks import make_benchmark
    from repro_torch.env.world import build_world
    from repro_torch.kernels import backend as KB
    from repro_torch.launch import train_planner as TP
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serving.neural_planner import \
        BatchedNeuralIntentClassifier
    from repro_torch.training.checkpoint import load_checkpoint
    KB.reset_launches()
    res = TP.main(["--full", "--checkpoint", str(GATE_CKPT)])
    counts = KB.launch_counts()
    check(counts["flash_prefill_bwd"] == res["steps"] * cfg.n_layers,
          f"gate training: {counts['flash_prefill_bwd']} backward launches")
    check(all(np.isfinite(res["losses"])), "gate training: loss not finite")
    tasks = make_benchmark(build_world(0), res["eval_tasks"], seed=2)
    loaded = load_checkpoint(str(GATE_CKPT), cfg, "cuda")
    again = [d[0] for d in BatchedNeuralIntentClassifier(cfg, loaded)
             .classify_batch([t.query for t in tasks])]
    check(again == res["decisions"], "gate: the reloaded checkpoint decides "
                                     "otherwise")
    served = serve_main(["--checkpoint", str(GATE_CKPT), "--requests", "4",
                         "--max-new", "8", "--temperature", "0"])
    check(served["requests"] == 4, "gate: serve --checkpoint failed")
    return dict({k: v for k, v in res.items() if k != "decisions"},
                loss_first=res["losses"][0], loss_last=res["losses"][-1],
                launches=counts, reloaded_decisions_equal=True,
                served_requests=served["requests"],
                checkpoint_mb=GATE_CKPT.stat().st_size / 2 ** 20)


def training_phases():
    """The planner's training at full width: launch.train on the card
    (remat and not), the card against the CPU, and the GeckOpt gate
    trained, reloaded and served. Returns the runs."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    t0 = time.time()
    runs = train_card(cfg)
    for name in ("no_remat", "remat", "profile"):
        emit(f"train_card_{name}", **runs[name])
    runs["vs_cpu"] = train_card_vs_cpu(cfg)
    emit("train_card_vs_cpu", **runs["vs_cpu"])
    runs["gate"] = gate_training(cfg)
    emit("gate_training", **runs["gate"])
    emit("training_elapsed", seconds=time.time() - t0)
    return runs


# ---------------------------------- the sampler and the replica cluster ----

SAMPLER_ROWS, SAMPLER_VOCAB, SAMPLER_T = 64, 8192, 0.8
SAMPLER_STEP_ROWS = 8           # one decode step's slots


def sampler_card_vs_cpu():
    """The threefry Gumbel-max sampler on the card against the CPU port:
    64 rows of seeded logits at V = 8,192, T = 0.8, top-k 0 and 40, one
    key a row (an engine key's splits): the same tokens, and the largest
    Gumbel difference (the devices' logs round differently). Then the
    sampler's host cost of one decode step of 8 slots on the card: the
    8 key splits and 8 seeded ``fold_in`` keys on the host and one
    batched draw, closed by the tokens' copy to the host."""
    from repro_torch.serving import prng
    from repro_torch.serving.sampling import SamplerConfig, sample
    rng = np.random.default_rng(5)
    logits = torch.from_numpy((rng.standard_normal(
        (SAMPLER_ROWS, SAMPLER_VOCAB)) * 3).astype(np.float32))
    key, keys = prng.prng_key(5), []
    for _ in range(SAMPLER_ROWS):
        key, k = prng.split(key)
        keys.append(k)
    card_logits = logits.cuda()
    res = {"rows": SAMPLER_ROWS, "vocab": SAMPLER_VOCAB,
           "temperature": SAMPLER_T}
    for top_k in (0, 40):
        cfg = SamplerConfig(temperature=SAMPLER_T, top_k=top_k)
        card = sample(card_logits, keys, cfg)
        host = sample(logits, keys, cfg)
        same = int((card == host).sum())
        check(same == SAMPLER_ROWS, f"sampler top_k {top_k}: {same} of "
                                    f"{SAMPLER_ROWS} card tokens equal the "
                                    f"CPU's")
        res[f"tokens_equal_top_k{top_k}"] = same
    g_card = prng.gumbel(keys, SAMPLER_VOCAB, "cuda").cpu()
    g_host = prng.gumbel(keys, SAMPLER_VOCAB, "cpu")
    check(bool(torch.isfinite(g_card).all()), "sampler: non-finite Gumbel")
    res["gumbel_max_abs_diff"] = float((g_card - g_host).abs().max())
    step_logits = card_logits[:SAMPLER_STEP_ROWS].contiguous()
    cfg = SamplerConfig(temperature=SAMPLER_T, top_k=40)

    def one_step():
        nonlocal key
        ks = []
        for i in range(SAMPLER_STEP_ROWS):
            key, _ = prng.split(key)
            ks.append(prng.fold_in(prng.prng_key(1000 + i), 7))
        return sample(step_logits, ks, cfg)

    for _ in range(5):
        one_step()
    torch.cuda.synchronize()
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        one_step()
    res["step_rows"] = SAMPLER_STEP_ROWS
    res["step_ms"] = 1e3 * (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for _ in range(n):
        key, _ = prng.split(key)
        prng.fold_in(prng.prng_key(1000), 7)
    res["keys_ms_per_row"] = 1e3 * (time.perf_counter() - t0) / n
    return res


# the cluster example of the JAX launcher (src/repro/launch/serve.py:10-11)
# at the planner's full width: 32 sessions, bursty, skew 0.7, up to 2
# turns, 16 new tokens at T = 0.8, 8 slots a replica, cache 2,048;
# (name, replicas, router, extra flags, kernels the run must launch)
CLUSTER_FLAGS = ["--requests", "32", "--profile", "bursty", "--skew", "0.7",
                 "--turns", "2", "--max-new", "16", "--temperature", "0.8",
                 "--max-batch", "8", "--cache-len", "2048"]
_DENSE = ("flash_prefill", "flash_decode")
CLUSTER_RUNS = [
    ("rr_1", 1, "round_robin", [], _DENSE),
    ("rr_4", 4, "round_robin", [], _DENSE),
    ("least_loaded_4", 4, "least_loaded", [], _DENSE),
    ("affinity_4", 4, "intent_affinity", [], _DENSE),
    ("affinity_4_paged", 4, "intent_affinity", PAGED,
     ("flash_prefill", "flash_decode_paged")),
    ("affinity_4_spec", 4, "intent_affinity", SPEC,
     ("flash_prefill", "flash_verify")),
    ("affinity_4_paged_spec", 4, "intent_affinity", PAGED + SPEC,
     ("flash_prefill", "flash_verify_paged")),
    ("affinity_4_sla_spill", 4, "intent_affinity", ["--sla-spill"], _DENSE)]


def cluster_phases(cfg, model):
    """The planner's replica cluster on one card (the replicas share the
    model) through the launcher's ``serve_cluster``, once per run of
    CLUSTER_RUNS, each with its launch counts (set to 0 just before it,
    read just after): every served request's tokens must equal the
    1-replica run's, and intent affinity's prefix-hit ratio must beat
    round robin's. Returns the runs."""
    from repro_torch.kernels import backend as KB
    from repro_torch.launch.serve import parse_args, serve_cluster
    runs, ref = {}, None
    for name, n, router, extra, kernels in CLUSTER_RUNS:
        args = parse_args(["--replicas", str(n), "--router", router]
                          + CLUSTER_FLAGS + extra)
        KB.reset_launches()
        spec = None
        if "--spec-decode" in extra:
            from repro_torch.serving.specdec import SpecConfig
            spec = SpecConfig(draft_cfg=cfg, draft_model=model,
                              k=args.draft_k)
        res = serve_cluster(cfg, model, args, spec)
        counts = KB.launch_counts()
        missing = [k for k in kernels if not counts[k]]
        check(not missing, f"cluster {name}: no launch of {missing}")
        s = res["summary"]
        out = res["outputs"]
        ref = out if ref is None else ref
        common = sorted(set(out) & set(ref))
        check(common and all(out[i] == ref[i] for i in common),
              f"cluster {name}: tokens differ from the 1-replica run's")
        check(all(len(o) for o in out.values()), f"cluster {name}: a "
                                                 f"served request is empty")
        runs[name] = dict(
            replicas=n, router=router, flags=extra, seconds=res["seconds"],
            ticks=res["ticks"], tick_ms=res["tick_ms"], tok_s=res["tok_s"],
            requests=s["requests"], served=s["finished"],
            sla_expired=s["sla_expired"], compared=len(common),
            tokens_equal_1_replica=True, tokens_out=s["tokens_out"],
            prefix_hit_ratio=s["prefix_hit_ratio"],
            sla_attainment=s["sla_attainment"],
            ttft_p50=s["ttft_p50"], e2e_p95=s["e2e_p95"],
            spec_accept_rate=s["spec_accept_rate"],
            tokens_per_step=s["tokens_per_step"],
            preemptions=s["preemptions"],
            utilization=[r["utilization"] for r in s["per_replica"]],
            replica_hit_ratio=[r["hit_ratio"] for r in s["per_replica"]],
            admissions=[r["admissions"] for r in s["per_replica"]],
            launches=counts)
        emit(f"cluster_{name}", **runs[name])
    check(runs["affinity_4"]["prefix_hit_ratio"]
          > runs["rr_4"]["prefix_hit_ratio"],
          f"cluster: affinity's prefix-hit ratio "
          f"{runs['affinity_4']['prefix_hit_ratio']} is not above round "
          f"robin's {runs['rr_4']['prefix_hit_ratio']}")
    return runs


def geckopt_cluster(cfg, model, single):
    """The pipeline on a 4-replica ``intent_affinity`` cluster (16 tasks,
    8 in flight) through ``serve_pipeline``: its Table-2 row and gate
    decisions must be the single-engine run's (``single``)."""
    from repro_torch.kernels import backend as KB
    from repro_torch.launch import serve_pipeline as SP
    args = SP.parse_args(["--requests", str(GECKOPT_TASKS), "--concurrency",
                          "8", "--replicas", "4", "--router",
                          "intent_affinity"])
    KB.reset_launches()
    res = SP.serve_pipeline(cfg, model, args)
    counts = KB.launch_counts()
    missing = [k for k in _DENSE if not counts[k]]
    check(not missing, f"geckopt cluster: no launch of {missing}")
    check(res["row"] == single["row"], f"geckopt cluster: row {res['row']}"
                                       f" != single engine {single['row']}")
    check(res["decisions"] == single["decisions"],
          "geckopt cluster: gate decisions differ from the single engine's")
    st = res["stats"]
    check(st["prefix_hits"] == res["pipeline"]["engine_turns"]
          == GECKOPT_TASKS,
          f"geckopt cluster: {st['prefix_hits']} prefix hits for "
          f"{res['pipeline']['engine_turns']} turns")
    return dict(sessions=GECKOPT_TASKS, replicas=4, router="intent_affinity",
                seconds=res["seconds"], tasks_s=res["tasks_s"],
                launches=counts, row=res["row"], row_equal_single=True,
                decisions_equal_single=True, prefixes=len(res["prefixes"]),
                turns_by_replica=[r["admissions"]
                                  for r in st["per_replica"]],
                hits_by_replica=[r["prefix_hits"]
                                 for r in st["per_replica"]])


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
        runs, _ = serve_runs(arch, cfg, model, modes)
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


# ------------------------------------------ hymba-1.5b at full width ----

HYMBA = "hymba-1.5b"
_HYMBA = ("flash_prefill", "flash_decode", "ssm_scan")
HYMBA_MODES = [("dense", [], 64, _HYMBA), ("dense_again", [], 64, _HYMBA)]
HIT_MISS_TOL = 0.25
HIT_MISS_REL = 0.1


def logit_gap(a, b):
    """(max |a - b|, |a - b| / |b|) of two logits rows, checked against
    HIT_MISS_TOL and HIT_MISS_REL by the caller."""
    d = (a - b).float()
    return float(d.abs().max()), float(d.norm() / b.float().norm())


def _t0():
    from repro_torch.serving.sampling import SamplerConfig
    return SamplerConfig(temperature=0.0)


def recycled_slots(cfg, model, outputs):
    """The 16-request serve's last wave (requests 8-15, served in slots
    that served requests 0-7 first) against a fresh engine serving those
    8 prompts alone: equal tokens (decode runs at B = max_batch either
    way, so a slot's rows depend on its neighbours only if state
    leaks)."""
    from repro_torch.launch.serve import request_prompts
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(cfg, model, max_batch=8, cache_len=2048)
    rids = [eng.add_request(p, max_new_tokens=64, sampler=_t0())
            for p in request_prompts(cfg, 16)[8:]]
    done = {r.request_id: r.output for r in eng.run_until_done()}
    same = [done[r] == outputs[8 + i] for i, r in enumerate(rids)]
    check(all(same), f"{cfg.name}: recycled slots' tokens differ from a "
                     f"fresh engine's ({same})")
    return dict(requests=len(rids), tokens_equal_fresh=True)


def _recording_engine(cfg, model, rec: dict, **kw):
    """An engine that records each request's admission logits."""
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(cfg, model, max_batch=8, cache_len=2048, **kw)
    first = eng._first_token

    def record(req, logits):
        rec[req.request_id] = logits.float().cpu()
        return first(req, logits)
    eng._first_token = record
    return eng


def hymba_hit_miss(cfg, model, prefix_len=1300, n=8, max_new=16):
    """8 prompts of a 1,300-token prefix plus 8-36 tokens, served as
    prefix hits (``register_prefix``: the 1,024-token head prefilled, the
    276-token tail decoded through the rings; each suffix decoded) and as
    misses (one windowed prefill each). Admission logits within
    HIT_MISS_TOL and HIT_MISS_REL; the count of equal tokens is printed
    (two computations, in JAX too: not asserted)."""
    from repro_torch.kernels import backend as KB
    rng = np.random.default_rng(7)
    prefix = [2] + rng.integers(6, cfg.vocab_size, prefix_len - 1).tolist()
    prompts = [prefix + rng.integers(6, cfg.vocab_size, 8 + 4 * i).tolist()
               for i in range(n)]
    res, logits, toks = {}, {}, {}
    for name in ("prefix_hit", "miss"):
        rec: dict = {}
        eng = _recording_engine(cfg, model, rec)
        KB.reset_launches()
        t0 = time.time()
        hit = name == "prefix_hit"
        if hit:
            eng.register_prefix("p", prefix)
            torch.cuda.synchronize()
            res["register_prefix_seconds"] = time.time() - t0
        rids = [eng.add_request(p, max_new_tokens=max_new, sampler=_t0(),
                                prefix_key="p" if hit else None)
                for p in prompts]
        done = {r.request_id: r.output for r in eng.run_until_done()}
        torch.cuda.synchronize()
        logits[name] = [rec[r] for r in rids]
        toks[name] = [done[r] for r in rids]
        res[name] = dict(seconds=time.time() - t0,
                         launches=KB.launch_counts(),
                         prefix_hits=eng.throughput_stats()["prefix_hits"])
    check(res["prefix_hit"]["prefix_hits"] == n,
          f"hymba: {res['prefix_hit']['prefix_hits']} prefix hits of {n}")
    gaps = [logit_gap(a, b)
            for a, b in zip(logits["prefix_hit"], logits["miss"])]
    diffs, rels = [g[0] for g in gaps], [g[1] for g in gaps]
    check(all(np.isfinite(diffs)), "hymba: non-finite admission logits")
    check(max(diffs) <= HIT_MISS_TOL and max(rels) <= HIT_MISS_REL,
          f"hymba: prefix-hit admission logits differ from a miss's by "
          f"{diffs} (relative {rels})")
    res.update(admission_logit_diff=diffs, admission_logit_rel=rels,
               tol=HIT_MISS_TOL, rel_tol=HIT_MISS_REL,
               logit_absmax=float(logits["miss"][0].abs().max()),
               tokens_equal=sum(x == y for u, v in zip(toks["prefix_hit"],
                                                      toks["miss"])
                                for x, y in zip(u, v)),
               tokens=n * max_new)
    return res


def hymba_long(cfg, model):
    """8 prompts of 980-1,022 tokens and 64 new tokens each, so every
    slot's decode crosses position 1,024 in each hymba_w ring; the
    logits of request 0's decode at position len + 62 (past the wrap)
    against one windowed prefill of its prompt and its first 63 tokens,
    within HIT_MISS_TOL and HIT_MISS_REL."""
    from repro_torch.kernels import backend as KB
    from repro_torch.models.model import prefill
    from repro_torch.serving import engine as E
    rng = np.random.default_rng(8)
    prompts = [rng.integers(6, cfg.vocab_size, 980 + 6 * i).tolist()
               for i in range(8)]
    eng = E.InferenceEngine(cfg, model, max_batch=8, cache_len=2048)
    step_logits, orig = [], E.decode_step

    def record(*a, **kw):
        lg, cache = orig(*a, **kw)
        step_logits.append(lg[0].float().cpu())       # request 0's slot
        return lg, cache
    E.decode_step = record
    KB.reset_launches()
    t0 = time.time()
    try:
        rids = [eng.add_request(p, max_new_tokens=64, sampler=_t0())
                for p in prompts]
        done = {r.request_id: r for r in eng.run_until_done()}
        torch.cuda.synchronize()
    finally:
        E.decode_step = orig
    wall = time.time() - t0
    out0 = done[rids[0]].output
    check(len(out0) == 64, f"hymba long: request 0 stopped at {len(out0)}")
    lg, _ = prefill(model, {"tokens": [prompts[0] + out0[:63]]}, 2048)
    diff, rel = logit_gap(step_logits[62], lg[0].float().cpu())
    check(diff <= HIT_MISS_TOL and rel <= HIT_MISS_REL,
          f"hymba long: ring-crossing decode logits differ from a "
          f"windowed prefill by {diff} (relative {rel})")
    st = eng.throughput_stats()
    return dict(prompt_tokens=[len(p) for p in prompts],
                last_position=len(prompts[0]) + 62, seconds=wall,
                tok_s=st["tokens_generated"] / wall,
                step_ms=1e3 * wall / eng.step_no,
                launches=KB.launch_counts(), decode_vs_prefill_diff=diff,
                decode_vs_prefill_rel=rel, tol=HIT_MISS_TOL,
                rel_tol=HIT_MISS_REL,
                finish=sorted({r.finish_reason for r in done.values()}))


def refusals(cfg, model, names=("paged", "prefill_budget", "spec")):
    """The engine modes ``names`` raise on ``cfg``'s stack: paged KV,
    chunked prefill and speculative decoding on hymba (recurrent state
    and rings), paged KV and speculative decoding on xlstm (recurrent
    state): JAX's reasons."""
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.specdec import SpecConfig
    modes = {"paged": lambda: dict(kv_mode="paged"),
             "prefill_budget": lambda: dict(prefill_budget=1024),
             "spec": lambda: dict(spec_decode=SpecConfig(cfg, model, k=4))}
    out = {}
    for name in names:
        try:
            InferenceEngine(cfg, model, max_batch=8, cache_len=2048,
                            **modes[name]())
        except ValueError as e:
            out[name] = str(e)[:100]
        else:
            check(False, f"{cfg.name}: {name} was not refused")
    return out


def hymba_phases():
    """hymba-1.5b at full width and full depth: init, two serve runs,
    recycled slots, prefix hit vs miss, ring-crossing prompts, the
    refusals, a decode profile; then card vs CPU on hymba-smoke. Returns
    the serve runs."""
    import gc
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import count_params, init_params
    cfg = get_config(HYMBA)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    emit("hymba_init", layers=len(cfg.layer_kinds()),
         windowed_layers=cfg.layer_kinds().count("hymba_w"),
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads,
                                     cfg.d_head],
         window=cfg.window, d_state=cfg.ssm.d_state,
         vocab=cfg.vocab_size, params=count_params(model),
         init_seconds=time.time() - t0,
         weights_gb=torch.cuda.memory_allocated() / 1e9)
    runs, outputs = serve_runs(HYMBA, cfg, model, HYMBA_MODES)
    for name, r in runs.items():
        emit(f"hymba_serve_{name}", **r)
    emit("hymba_recycled", **recycled_slots(cfg, model, outputs))
    emit("hymba_hit_miss", **hymba_hit_miss(cfg, model))
    emit("hymba_long", **hymba_long(cfg, model))
    emit("hymba_refusals", **refusals(cfg, model))
    emit("hymba_decode_profile", **profile_decode(
        cfg, model, 5, "hymba_decode_trace.json"))
    emit("hymba_memory",
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit(f"card_vs_cpu_{HYMBA}", **card_vs_cpu(get_smoke_config(HYMBA)))
    return runs


# ------------------------------------------ xlstm-125m at full width ----

XLSTM_MODES = [("dense", [], 64, ("mlstm_scan",)),
               ("budget_1024", ["--prefill-budget", "1024"], 64,
                ("mlstm_scan",)),
               ("dense_again", [], 64, ("mlstm_scan",))]


def xlstm_equalities(cfg, model, prefix_len=1300, n=8, max_new=16):
    """8 prompts of a 1,300-token prefix plus 8-36 tokens, served with
    monolithic prefill (one prefill each), under ``prefill_budget=1024``
    (a 1,024-token head prefill, then the unpadded 284-312-token rest
    extended) and as prefix hits (the 1,024-token head prefilled, the
    276-token tail extended once, each suffix extended from a copy):
    admission logits and tokens bitwise those of the monolithic run.
    Returns each run's seconds, launches and prefix hits, and the prefix
    registration's seconds."""
    from repro_torch.kernels import backend as KB
    rng = np.random.default_rng(7)
    prefix = [2] + rng.integers(6, cfg.vocab_size, prefix_len - 1).tolist()
    prompts = [prefix + rng.integers(6, cfg.vocab_size, 8 + 4 * i).tolist()
               for i in range(n)]
    res, logits, toks = {}, {}, {}
    for name, kw in (("monolithic", {}),
                     ("budget_1024", dict(prefill_budget=1024)),
                     ("prefix_hit", {})):
        rec: dict = {}
        eng = _recording_engine(cfg, model, rec, **kw)
        KB.reset_launches()
        t0 = time.time()
        hit = name == "prefix_hit"
        if hit:
            eng.register_prefix("p", prefix)
            torch.cuda.synchronize()
            res["register_prefix_seconds"] = time.time() - t0
        rids = [eng.add_request(p, max_new_tokens=max_new, sampler=_t0(),
                                prefix_key="p" if hit else None)
                for p in prompts]
        done = {r.request_id: r.output for r in eng.run_until_done()}
        torch.cuda.synchronize()
        logits[name] = [rec[r] for r in rids]
        toks[name] = [done[r] for r in rids]
        st = eng.throughput_stats()
        res[name] = dict(seconds=time.time() - t0,
                         launches=KB.launch_counts(),
                         prefix_hits=st["prefix_hits"],
                         prefill_chunks=st["prefill_chunks"])
    check(res["prefix_hit"]["prefix_hits"] == n,
          f"xlstm: {res['prefix_hit']['prefix_hits']} prefix hits of {n}")
    for name in ("budget_1024", "prefix_hit"):
        diffs = [float((a - b).abs().max())
                 for a, b in zip(logits[name], logits["monolithic"])]
        bitwise = all(torch.equal(a, b) for a, b in
                      zip(logits[name], logits["monolithic"]))
        res[name].update(admission_logits_bitwise=bitwise,
                         admission_logit_diff=max(diffs),
                         tokens_equal=toks[name] == toks["monolithic"])
        check(bitwise and toks[name] == toks["monolithic"],
              f"xlstm {name}: admission logits (max diff {max(diffs)}) "
              f"or tokens differ from monolithic prefill")
    res["tokens"] = n * max_new
    return res


def xlstm_phases():
    """xlstm-125m at full width and full depth: init, three serve runs
    (dense, budgeted, dense again: equal tokens), recycled slots, the
    budgeted and prefix-hit equalities on 1,300-token prompts, the
    refusals, a decode profile; then card vs CPU on xlstm-smoke. Returns
    the serve runs."""
    import gc
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import count_params, init_params
    cfg = get_config(XLSTM)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    emit("xlstm_init", layers=list(cfg.layer_kinds()), d_model=cfg.d_model,
         heads=cfg.n_heads,
         mlstm_head_dim=model.layers[0].mlstm.wq.shape[0] // cfg.n_heads,
         vocab=cfg.vocab_size, params=count_params(model),
         init_seconds=time.time() - t0,
         weights_gb=torch.cuda.memory_allocated() / 1e9)
    runs, outputs = serve_runs(XLSTM, cfg, model, XLSTM_MODES)
    for name, r in runs.items():
        emit(f"xlstm_serve_{name}", **r)
    emit("xlstm_recycled", **recycled_slots(cfg, model, outputs))
    emit("xlstm_equalities", **xlstm_equalities(cfg, model))
    emit("xlstm_refusals", **refusals(cfg, model, ("paged", "spec")))
    emit("xlstm_decode_profile", **profile_decode(
        cfg, model, 5, "xlstm_decode_trace.json"))
    emit("xlstm_memory",
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit(f"card_vs_cpu_{XLSTM}", **card_vs_cpu(get_smoke_config(XLSTM)))
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel cases; no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.flash_prefill import flash_prefill, \
        flash_prefill_bwd
    from repro_torch.kernels.flash_verify import flash_verify, \
        flash_verify_paged
    from repro_torch.kernels.moe_router import moe_router_topk
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.kernels.mlstm_scan import mlstm_scan

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
    logs = _build.build_logs()
    hgmma = prefill_sass(build)
    (OUT_DIR / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items())
        + f"\n== flash_prefill SASS: HGMMA instructions by head dim "
          f"(cuobjdump -sass)\n{json.dumps(hgmma)}\n")
    emit("build_prefill_sass", hgmma=hgmma,
         registers=_ptxas_registers(logs["flash_prefill"], "flash_prefill"),
         ptxas=[ln.strip() for ln in logs["flash_prefill"].splitlines()
                if "Used" in ln or "smem" in ln or "spill" in ln])
    decode_ptxas = {k: ptxas_instances(logs[src], f"{k}_kernel")
                    for k, src in (("flash_decode", "flash_decode"),
                                   ("flash_decode_paged",
                                    "flash_decode_paged"),
                                   ("flash_verify", "flash_verify"),
                                   ("flash_verify_paged", "flash_verify"))}
    check(all(sorted(i["hd"] for i in v) == [32, 64, 128]
              and all(i.get("registers") for i in v)
              for v in decode_ptxas.values()),
          f"ptxas report lacks the decode instances: {decode_ptxas}")
    check(not any(i.get("spill_stores") or i.get("spill_loads")
                  for v in decode_ptxas.values() for i in v),
          f"a decode kernel instance spills: {decode_ptxas}")
    emit("build_decode_ptxas", **decode_ptxas)

    gen = torch.Generator(device="cuda").manual_seed(0)
    pre = [prefill_case(s, s, 0, gen) for s in (37, 512, 1024)]
    pre += [prefill_case(sq, 2048, off, gen)
            for sq in (16, 1024) for off in (0, 700)]
    for c in pre:
        emit("kernel_prefill", **c)
    # profiled early, on their own draws: after the xlstm model's
    # prefill, torch.profiler misses a launch of these short calls
    pre_serve = prefill_serve_cases(
        torch.Generator(device="cuda").manual_seed(1))
    for c in pre_serve:
        emit("kernel_prefill_serve", **c)
    pre_gate = gate_prefill_cases(
        torch.Generator(device="cuda").manual_seed(2))
    for c in pre_gate:
        emit("kernel_prefill_gate", **c)
    # the backward's cases, profiled early too, on their own draws
    bwd, bwd_ptxas = bwd_cases(torch.Generator(device="cuda").manual_seed(3),
                               logs["flash_prefill_bwd"])
    emit("build_prefill_bwd_ptxas", **bwd_ptxas)
    for c in bwd:
        emit("kernel_prefill_bwd", **c)
    dec = [decode_case(KV_LENS, CACHE, gen)]
    for c in dec:
        emit("kernel_decode", **c)
    paged_dec = paged_decode_case(gen)
    emit("kernel_decode_paged", **paged_dec)
    ver = verify_cases(gen)
    for name, c in ver.items():
        emit(f"kernel_{name[6:]}", **c)
    hd_cases = head_dim_cases(gen)
    hd_cases += verify_over_64_cases(gen)
    hd_cases += block_size_cases(gen)
    hd_cases.append(("kernel_decode", wide_group_case(gen)))
    for phase, c in hd_cases:
        emit(phase, **c)
    emit("kernel_decode_family_sweep", **decode_family_sweep(gen))
    pre_ext = prefill_extend_cases(gen)
    for c in pre_ext:
        emit("kernel_prefill_bitwise", **c)
    hd_cases += [("kernel_prefill", c)
                 for c in pre_ext + pre_serve + pre_gate]
    build_log = (OUT_DIR / "chip_smoke_build.log").read_text()
    rout, router_ptxas = router_cases(gen, build_log)
    emit("build_router_ptxas", instances=router_ptxas)
    for c in rout:
        emit("kernel_router", **c)
    scan, seams = ssm_cases(gen, build_log)
    for c in scan:
        emit("kernel_ssm_scan", **c)
    emit("kernel_ssm_scan_seams", **seams)
    hymba_attn = hymba_attention_cases(gen)
    for phase, c in hymba_attn:
        emit(phase, **c)
    hd_cases += hymba_attn
    mlstm, mlstm_seams = mlstm_cases(gen, build_log)
    for c in mlstm:
        emit("kernel_mlstm_scan", **c)
    emit("kernel_mlstm_scan_seams", **mlstm_seams)
    mlstm_model = mlstm_model_cases()
    emit("kernel_mlstm_scan_model_inputs", **mlstm_model)
    if args.kernels_only:
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
            RESULTS, indent=1, default=str))
        return 0

    runs, cluster = planner_phases()
    geckopt = geckopt_phases()
    train = training_phases()
    moe = moe_phases()
    hymba = hymba_phases()
    xlstm = xlstm_phases()

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
        if "device_ms" in c:       # the decode family: profiler times
            rows[-1].update(device_ms=c["device_ms"],
                            library_device_ms=c["library_device_ms"])
        # the GeckOpt pipeline's dense run (gate waves, prefixes, turns)
        rows[-1]["geckopt_launches"] = \
            geckopt["dense"]["launches"][fn.__name__]
        # every run of the replica cluster together
        rows[-1]["cluster_launches"] = sum(
            r["launches"][fn.__name__] for r in cluster.values())
    # the training run (launch.train, 30 steps, no remat)
    rows[0]["train_launches"] = \
        train["no_remat"]["launches"]["flash_prefill"]
    # flash_prefill's backward: launches of that training run; times at its
    # shape (8 x 256 at the planner's heads), device times by profiler
    c = next(c for c in bwd if c["family"] == "train")
    rows.append({"name": flash_prefill_bwd.__name__, "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_prefill_bwd.cu",
                 "replaces": "none: no TPU kernel (the gradient of "
                             "src/repro/kernels/flash_prefill.py:84, which "
                             "the JAX package takes by jax.grad of its "
                             "reference attention)",
                 "launches": train["no_remat"]["launches"][
                     "flash_prefill_bwd"],
                 "max_abs_err": max(x["max_abs_err"] for x in bwd),
                 "ms": c["ms"], "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                 "library_ms": c["library_ms"], "device_ms": c["device_ms"],
                 "library_device_ms": c["library_device_ms"]})
    # the router: launches of the kimi-k2 dense serve; times at its decode
    # shape there (8 slots, 384 experts, top-8), with its device time a
    # call and the launch floor
    c = next(c for c in rout if (c["T"], c["E"], c["k"], c["draw"]) == (
        8, 384, 8, "randn"))
    rows.append({"name": moe_router_topk.__name__, "route": "cuda",
                 "source": "src/repro_torch/csrc/moe_router.cu",
                 "replaces": "src/repro/kernels/moe_router.py:47",
                 "launches": moe["kimi-k2-1t-a32b"]["runs"]["dense"][
                     "launches"]["moe_router_topk"],
                 "max_abs_err": max(x["max_abs_err"] for x in rout),
                 "ms": c["ms"], "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                 "library_ms": None, "device_ms": c["device_ms"],
                 "floor_ms": c["floor_ms"]})
    # the scan: launches of the hymba dense serve; times at its 1,024-token
    # prefill from zero state (the decode case is in chip_smoke.json)
    c = next(c for c in scan if (c["B"], c["S"], c["h0"]) == (1, 1024,
                                                             "zeros"))
    rows.append({"name": ssm_scan.__name__, "route": "cuda",
                 "source": "src/repro_torch/csrc/ssm_scan.cu",
                 "replaces": "src/repro/kernels/ssm_scan.py:52",
                 "launches": hymba["dense"]["launches"]["ssm_scan"],
                 "max_abs_err": max(x["max_abs_err"] for x in scan),
                 "ms": c["ms"], "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                 "library_ms": None})
    # the mLSTM scan: launches of the xlstm dense serve; times at its
    # 1,024-token prefill from a fresh state (the decode case is in
    # chip_smoke.json); its error over the seeded cases and the model's
    # own inputs
    c = next(c for c in mlstm if (c["B"], c["S"], c["state"]) == (
        1, 1024, "fresh"))
    rows.append({"name": mlstm_scan.__name__, "route": "cuda",
                 "source": "src/repro_torch/csrc/mlstm_scan.cu",
                 "replaces": "src/repro/kernels/mlstm_scan.py:68",
                 "launches": xlstm["dense"]["launches"]["mlstm_scan"],
                 "max_abs_err": max([x["max_abs_err"] for x in mlstm]
                                    + mlstm_model["max_abs_err"]),
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
