"""``launch/router_bench.py`` and the router kernel's selection, on the CPU.

The bench times the MoE router kernel on the card and prints the sha256
of its outputs, so that two trees timed in one call can be held to the
same bits; chip_smoke.py takes its cases from it. Here: its cases
include the served shapes and reach every template instance that
``csrc/moe_router.cu`` dispatches to, its digest tells equal bits from
a one-ulp change, its plain-version run on the CPU prints the digests
of the outputs it computed (and no time), with the JAX package's ids on
the tie-heavy inputs, it refuses to run on a card that is not there,
and its ptxas reader reads template instances and plain kernels.

The CUDA kernel cannot run here (its card cases are in
``tests/test_torch_moe.py``), so its selection is modelled in numpy as
``csrc/moe_router.cu`` states it (each lane's probabilities ordered
once, descending and stable in expert id, L = min(V, 8) of them kept;
each pass a max over the heads' bits as signed ints, then the least id
among the lanes whose head has those bits) and held to the plain
version's ids on tie-heavy logits at the largest E: a design aid, not a
test of the kernel.
"""
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import router_topk_ref as jax_router_ref
from repro_torch.kernels.moe_router import moe_router_topk
from repro_torch.kernels.ref import router_topk_ref
from repro_torch.launch import router_bench as RB

ROOT = Path(__file__).resolve().parents[1]
NEG_INF = np.float32(-1e30)


def test_cases_hold_the_served_shapes_and_every_instance():
    cases = set(RB.CASES)
    assert {(T, E, k, "randn") for T, E, k in RB.ROUTER_CASES} <= cases
    assert set(RB.ROUTER_EXTRA_CASES) <= cases and RB.SMALL <= cases
    # the served E (kimi-k2 384, arctic 128), the smoke configs' 4, a
    # ragged 100, and the tie-heavy draw on the CPU too
    assert {E for _, E, _, _ in RB.CASES} >= {4, 100, 128, 384}
    assert any(c[3] == "ties" for c in RB.SMALL)
    # every instance the kernel's dispatch can take runs, on both draws
    for draw in ("randn", "ties"):
        assert {RB.instance(E) for _, E, _, d in RB.CASES if d == draw} \
            == set(RB.INSTANCES)


def test_instances_are_the_kernels_dispatch():
    """INSTANCES and instance(E) are csrc/moe_router.cu's dispatch: the
    smallest instance that covers ceil(E / 32), the last for the rest."""
    src = (ROOT / "src/repro_torch/csrc/moe_router.cu").read_text()
    entry = src[src.index('extern "C" int moe_router_topk_f32('):]
    steps = [(int(a), int(b)) for a, b in re.findall(
        r"if \(v <= (\d+)\) return launch<(\d+)>", entry)]
    last = int(re.search(r"\n  return launch<(\d+)>", entry).group(1))
    assert all(a == b for a, b in steps)
    assert tuple(b for _, b in steps) + (last,) == RB.INSTANCES
    for E in range(1, 513):
        v = -(-E // 32)
        assert RB.instance(E) == next(
            (b for a, b in steps if v <= a), last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("shape", [(8, 2), (37, 8), (1024, 8)])
def test_digest_tells_equal_bits_from_one_ulp(shape, dtype):
    t = torch.rand(*shape, generator=torch.Generator().manual_seed(3))
    t = (t * 384).to(dtype)
    assert RB.digest(t) == RB.digest(t.clone()) and len(RB.digest(t)) == 16
    for i in (0, t.numel() - 1):
        u = t.clone().reshape(-1)
        u[i] = (torch.nextafter(u[i], torch.tensor(float("inf")))
                if dtype == torch.float32 else u[i] + 1)
        assert RB.digest(u.reshape(shape)) != RB.digest(t)


def test_cpu_run_prints_the_plain_versions_bits(capsys):
    assert RB.main(["--device", "cpu", "--label", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"label": "cpu", "device": "cpu", "card": None}
    recs = lines[1:]
    assert [(r["T"], r["E"], r["k"], r["draw"]) for r in recs] == [
        c for c in RB.CASES if c in RB.SMALL]
    # the digests are those of the plain version on the same draws
    gen = torch.Generator().manual_seed(0)
    for r in recs:
        assert r["label"] == "cpu" and r["ids_equal"]
        assert r["max_abs_err"] == 0.0
        assert r["ms"] is None and r["device_ms"] is None \
            and r["floor_ms"] is None
        x = RB.router_logits(gen, r["T"], r["E"], r["draw"], "cpu")
        w, idx, _ = router_topk_ref(x, r["k"])
        assert r["bits"] == {"w": RB.digest(w), "idx": RB.digest(idx)}
        if r["draw"] == "ties":
            # many rows tie at the cut, and JAX orders them the same way
            p = torch.softmax(x, -1)
            top = torch.sort(p, -1, descending=True).values
            assert int((top[:, r["k"] - 1] == top[:, r["k"]]).sum()) \
                >= r["T"] // 8
            jw, jidx, _ = jax_router_ref(jnp.asarray(x.numpy()), r["k"])
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)


def test_bench_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert RB.main(["--label", "x"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_ptxas_reader_takes_instances_and_plain_kernels():
    def entry(name, stack, loads, regs):
        return (f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'\nptxas info    : Function properties for "
                f"{name}\n    {stack} bytes stack frame, 0 bytes spill "
                f"stores, {loads} bytes spill loads\nptxas info    : Used "
                f"{regs} registers, used 0 barriers\n")
    ns = "_ZN46_GLOBAL__N__b9ef431f_13_moe_router_cu_8f9f0b2322"
    log = (entry(ns + "moe_router_topk_kernelILi12EEEvPKfPfPiiii", 0, 0, 40)
           + entry("_Z5otherv", 8, 8, 99)
           + entry(ns + "moe_router_topk_kernelILi1EEEvPKfPfPiiii", 16, 4,
                   24))
    assert RB.ptxas_instances(log, RB.KERNEL) == [
        dict(args=[12], stack=0, spill_stores=0, spill_loads=0,
             registers=40),
        dict(args=[1], stack=16, spill_stores=0, spill_loads=4,
             registers=24)]
    plain = entry(ns + "moe_router_topk_kernelEPKfPfPiiii", 0, 0, 58)
    assert RB.ptxas_instances(plain, RB.KERNEL) == [
        dict(args=[], stack=0, spill_stores=0, spill_loads=0,
             registers=58)]


def _lane_list_select(probs: np.ndarray, k: int):
    """csrc/moe_router.cu's selection on the probabilities (T, E) fp32:
    (weights (T, k) fp32, ids (T, k) int32)."""
    T, E = probs.shape
    V = -(-E // 32)
    L = min(V, 8)
    pad = np.full((T, 32 * V), NEG_INF, np.float32)
    pad[:, :E] = probs
    vals = pad.reshape(T, V, 32).transpose(0, 2, 1)        # (T, lane, slot)
    ids = (np.arange(32)[:, None] + 32 * np.arange(V)[None, :])
    ids = np.broadcast_to(ids, vals.shape)
    order = np.argsort(-vals, axis=-1, kind="stable")[..., :L]
    hv = np.take_along_axis(vals, order, -1).copy()          # (T, 32, L)
    hi = np.take_along_axis(ids, order, -1).copy()
    hi[hv == NEG_INF] = np.iinfo(np.int32).max
    tot = np.zeros(T, np.float32)
    ws, out = [], []
    rows = np.arange(T)
    for _ in range(k):
        head = hv[..., 0].view(np.int32)                     # (T, 32)
        best = head.max(-1)
        win = np.where(head == best[:, None], hi[..., 0],
                       np.iinfo(np.int32).max).min(-1)
        lane = win % 32
        hv[rows, lane, :-1] = hv[rows, lane, 1:].copy()
        hi[rows, lane, :-1] = hi[rows, lane, 1:].copy()
        hv[rows, lane, -1] = NEG_INF
        hi[rows, lane, -1] = np.iinfo(np.int32).max
        bv = best.view(np.float32)
        tot = (tot + bv).astype(np.float32)
        ws.append(bv)
        out.append(win)
    w = np.stack(ws, 1) / np.maximum(tot, np.float32(1e-9))[:, None]
    return w.astype(np.float32), np.stack(out, 1).astype(np.int32)


def test_lane_lists_choose_the_plain_versions_experts():
    E, k = 512, 8
    gen = torch.Generator().manual_seed(E + k)
    x = RB.router_logits(gen, 64, E, "ties", "cpu")
    rw, ridx, probs = router_topk_ref(x, k)
    w, idx = _lane_list_select(probs.numpy(), k)
    np.testing.assert_array_equal(idx, ridx.numpy())
    # the same values chosen; the plain version sums them in torch's
    # reduction order, the kernel in pass order (fp32, k <= 8 terms)
    np.testing.assert_allclose(w, rw.numpy(), atol=1e-6, rtol=0)
    # the wrapper's CPU path is that plain version
    kw, kidx = moe_router_topk(x, k)
    assert torch.equal(kidx, ridx) and torch.equal(kw, rw)
