"""Time the two scan kernels and their backwards on the card at
chip_smoke.py's cases.

  PYTHONPATH=<tree>/src python3 src/repro_torch/launch/scan_bench.py \
      [--label NAME] [--iters N] [--device cuda|cpu] [--bwd]

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

With ``--bwd`` it runs the backwards instead, ``ssm_scan_bwd`` at
``SSM_BWD_CASES`` and ``mlstm_scan_bwd`` at ``MLSTM_BWD_CASES`` (the home
of chip_smoke.py's backward cases, on its seeded draws: 5 and 6), and
prints for each case each output's sha256 (``bits``) and whether a
second call gave the same (``repeat_equal``), each output's relative
norm ||kernel - plain|| / ||plain|| and whether all are within the
tolerance (``SSM_BWD_REL``; ``mlstm_bwd_tolerance``: exit 1 where one
is not), ms by CUDA events, each of the call's kernels' device time a
call by name (``pass_device_ms``, ``torch.profiler``) and their sum
(``device_ms``; the call's by ``decode_bench.queued_ms`` where every
profile missed launches, ``by_events``), and the bound (``bound_ms``:
every input read once and every gradient written once over 3.35 TB/s,
or 12 operations an element of the scanned state a step over the fp32
67 TFLOP/s, whichever is larger). A ``ssm_scan_bwd`` case also gives
the call on the forward's saved states where the tree has them
(``saved``: its bits equal to the direct call's, its device time). Then
the backward kernels' registers and spills by instance. ``--bwd
--device cpu`` runs the plain backwards at ``SSM_BWD_SMALL`` and
``MLSTM_BWD_SMALL`` (bits, no times).
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
# (B, S, di, n, h0): hymba-1.5b's training shape, a ragged 1,300-step
# prompt from a given state, n = 8 (hymba-smoke's state) from a given one
SSM_BWD_CASES = [(2, 2048, 1600, 16, "zeros"), (1, 1300, 1600, 16, "random"),
                 (2, 300, 256, 8, "random")]
# each output's relative norm ||kernel - plain|| / ||plain||: the
# forward's tolerance (1e-4), the two scans' fp32 reverse recurrences and
# sums over up to 4,096 terms (dA) in other orders
SSM_BWD_REL = 1e-4
# (B, H, S, hd): xlstm-125m's training shape and a 1,024-token sequence,
# each from a fresh and from a given state
MLSTM_BWD_CASES = [(8, 4, 256, 192), (1, 4, 1024, 192)]
# the CPU's backward cases: hymba-smoke's and xlstm-smoke's, from a given
# state
SSM_BWD_SMALL = [(1, 40, 128, 8, "random")]
MLSTM_BWD_SMALL = [(1, 4, 40, 32)]
# the mLSTM scan's kernel-vs-plain bound, relative to each output's
# conditioning scale (mlstm_conditioning)
MLSTM_TOL = 1e-4
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_S = 67e12            # H100 SXM fp32 outside the tensor cores
# the backwards' kernels in this tree and in trees before their redesign
BWD_SYMBOLS = ("ssm_scan_kernel", "ssm_bwd_scan", "ssm_bwd_reduce",
               "ssm_scan_bwd_kernel", "ssm_scan_bwd_reduce",
               "mlstm_bwd_gates", "mlstm_bwd_den", "mlstm_bwd_columns",
               "mlstm_bwd_sums", "mlstm_bwd_chain", "mlstm_bwd_heads")


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


def ssm_bwd_work(B, S, di, n):
    """(bytes, operations) of ``ssm_scan_bwd``: dt, x, dy, B_, C_, A, h0,
    dh_last read once and every gradient written once (5 (B,S,di), 4
    (B,S,n), 2 (di,n) and 3 (B,di,n) tensors), ~12 n operations a (b, t,
    d)."""
    return (4 * (5 * B * S * di + 4 * B * S * n + 2 * di * n
                 + 3 * B * di * n), 12 * B * S * di * n)


def mlstm_bwd_work(B, H, S, hd):
    """(bytes, operations) of ``mlstm_scan_bwd``: q, k, v, dh, i, f, the
    state and its cotangents read once and every gradient written once (7
    (B,H,S,hd), 4 (B,H,S) and 3 state-shaped tensors), ~12 hd^2
    operations a (b, h, t)."""
    return (4 * (7 * B * H * S * hd + 4 * B * H * S
                 + 3 * B * H * (hd * hd + hd + 1)),
            12 * B * H * S * hd * hd)


def bwd_bound(work) -> tuple:
    """(ms, what sets it) of the least time for (bytes, fp32 operations)."""
    t_b, t_f = work[0] / HBM_BYTES_S, work[1] / FP32_FLOP_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


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


def mlstm_bwd_tolerance(q, k, v, i_pre, f_pre, state) -> float:
    """The relative-norm tolerance of the mLSTM backward on these inputs,
    from the forward's conditioning-scaled bound: the forward holds each
    output within MLSTM_TOL of its conditioning scale
    (``mlstm_conditioning``: the sums of absolute terms of its two
    reductions over the cancelled denominator), so in norm within
    MLSTM_TOL ||scale|| / ||h|| of ||h||. The backward runs the same
    recurrence in reverse through the same denominators and is held to
    that relative bound: MLSTM_TOL times the ratio, at least MLSTM_TOL."""
    from repro_torch.kernels.ref import mlstm_scan_ref
    scale, _ = mlstm_conditioning(q, k, v, i_pre, f_pre, state)
    with torch.no_grad():
        h = mlstm_scan_ref(q, k, v, i_pre, f_pre, state)[0]
    return MLSTM_TOL * max(1.0, float(scale.norm()
                                      / h.norm().clamp(min=1e-30)))


def rel_norm(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp(min=1e-30))


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


def _bwd_record(names, got, again, ref, tol, run, work, device) -> dict:
    """The common record of a backward case (see the module's note)."""
    bits = [digest(t) for t in got]
    rel = {n: rel_norm(a, b) for n, a, b in zip(names, got, ref)}
    ok = all(bool(torch.isfinite(a).all()) for a in got) \
        and max(rel.values()) <= tol
    b_ms, b_by = bwd_bound(work)
    rec = dict(bits=dict(zip(names, bits)),
               repeat_equal=bits == [digest(t) for t in again],
               rel_norm_err=rel, tol=tol, within_tol=ok, ms=None,
               device_ms=None, pass_device_ms=None, bound_ms=b_ms,
               bound_by=b_by)
    if device == "cuda":
        from repro_torch.launch.attn_bwd_bench import kernel_times
        from repro_torch.launch.decode_bench import cuda_ms, queued_ms
        rec["ms"] = cuda_ms(run)
        passes = kernel_times(run, 20, tries=5)
        rec["pass_device_ms"] = passes
        rec["device_ms"] = (queued_ms(run) if passes is None
                            else sum(passes.values()))
        rec["by_events"] = passes is None
    return rec


def run_bwd(label: str, device: str = "cuda") -> list:
    """The backwards at SSM_BWD_CASES and MLSTM_BWD_CASES (SSM_BWD_SMALL
    and MLSTM_BWD_SMALL on the CPU); returns the records."""
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.kernels.mlstm_scan import mlstm_scan_bwd
    from repro_torch.kernels.ref import mlstm_scan_bwd_ref, \
        selective_scan_bwd_ref
    small = device != "cuda"
    ssm_cases = SSM_BWD_SMALL if small else SSM_BWD_CASES
    mlstm_cases = MLSTM_BWD_SMALL if small else MLSTM_BWD_CASES
    out = []

    def emit(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)

    gen = torch.Generator(device=device).manual_seed(5)
    names = ("ddt", "dx", "dB", "dC", "dA", "dh0")
    for B, S, di, n, h0k in ssm_cases:
        args = ssm_inputs(gen, B, S, di, n, h0k == "random", device)
        dy = torch.randn(B, S, di, generator=gen, device=device)
        dh = torch.randn(B, di, n, generator=gen, device=device)
        run = lambda: SS.ssm_scan_bwd(*args, dy, dh)
        got, again = run(), run()
        ref = selective_scan_bwd_ref(*args, dy, dh)
        rec = dict(label=label, kernel="ssm_scan_bwd", B=B, S=S, di=di, n=n,
                   h0=h0k, **_bwd_record(names, got, again, ref, SSM_BWD_REL,
                                         run, ssm_bwd_work(B, S, di, n),
                                         device))
        if device == "cuda" and hasattr(SS, "ssm_scan_with_states"):
            from repro_torch.launch.decode_bench import device_ms
            states = SS.ssm_scan_with_states(*args)[2]
            saved = lambda: SS.ssm_scan_bwd(*args, dy, dh,
                                            saved_states=states)
            rec["saved"] = dict(
                bitwise=[digest(t) for t in saved()] == list(
                    rec["bits"].values()),
                device_ms=device_ms(saved, tries=5))
            rec["within_tol"] &= rec["saved"]["bitwise"]
        emit(rec)
    gen = torch.Generator(device=device).manual_seed(6)
    names = ("dq", "dk", "dv", "di", "df", "dC0", "dn0", "dm0")
    flat = lambda g: (*g[:5], *g[5])
    for B, H, S, hd in mlstm_cases:
        for random_state in ((False, True) if not small else (True,)):
            args, st = mlstm_inputs(gen, B, H, S, hd, random_state, device)
            r = lambda *shape: torch.randn(*shape, generator=gen,
                                           device=device)
            dh = r(B, H, S, hd)
            dst = (r(B, H, hd, hd), r(B, H, hd), r(B, H))
            run = lambda: mlstm_scan_bwd(*args, st, dh, dst)
            got, again = flat(run()), flat(run())
            ref = flat(mlstm_scan_bwd_ref(*args, st, dh, dst))
            tol = mlstm_bwd_tolerance(*args, st)
            emit(dict(label=label, kernel="mlstm_scan_bwd", B=B, H=H, S=S,
                      hd=hd, state="random" if random_state else "fresh",
                      **_bwd_record(names, got, again, ref, tol, run,
                                    mlstm_bwd_work(B, H, S, hd), device)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--bwd", action="store_true",
                    help="the backwards at SSM_BWD_CASES, MLSTM_BWD_CASES")
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
    if args.bwd:
        recs = run_bwd(args.label, args.device)
        if args.device == "cuda":
            from repro_torch.kernels import _build
            logs = _build.build_logs()
            log = "\n".join(logs.get(k, "") for k in (
                "ssm_scan", "ssm_scan_bwd", "mlstm_scan_bwd"))
            print(json.dumps({"label": args.label, "ptxas": {
                k: ptxas_instances(log, k) for k in BWD_SYMBOLS
                if k in log}}), flush=True)
        return 0 if all(r["repeat_equal"] and r["within_tol"]
                        for r in recs) else 1
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
