"""``launch/attn_bwd_bench.py``, the home of flash_prefill_bwd's card
cases, on the CPU.

The bench times the backward kernel on the card at chip_smoke.py's cases
(which it holds: chip_smoke.py imports ``BWD_CASES`` from it) and prints
the sha256 of dq, dk and dv, so that a parent tree and the change can be
timed in one call. Here: its cases are the heads and rows chip_smoke.py's
constants name, its tolerance is chip_smoke.py's, the passes chip_smoke.py
profiles and counts in the SASS are the kernels the CUDA source defines,
its plain-version run on the CPU prints bits and no time, and it refuses
to run on a card that is not there.
"""
import ast
import json
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.launch import attn_bwd_bench as AB

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke_values(*names) -> dict:
    """The literal values of ``names`` in chip_smoke.py (read, not
    imported); a tuple target (``A, B = 1, 2``) binds each name."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id in names:
                out[t.id] = ast.literal_eval(node.value)
            elif isinstance(t, ast.Tuple):
                vals = ast.literal_eval(node.value)
                for el, v in zip(t.elts, vals):
                    if getattr(el, "id", None) in names:
                        out[el.id] = v
    missing = set(names) - set(out)
    assert not missing, f"chip_smoke.py has no {missing}"
    return out


def test_cases_are_chip_smokes_heads_and_rows():
    """Each case's heads and rows are the ones chip_smoke.py's constants
    name (the planner's, kimi-k2's, the dense families', whisper's)."""
    c = _chip_smoke_values("HQ", "HKV", "HD", "MOE_HEADS", "DENSE_HEADS",
                           "GEMMA2_WINDOW", "GEMMA2_CAP", "WHISPER_HEADS",
                           "WHISPER_ENC", "WHISPER_PROMPT", "WHISPER_B")
    planner = (c["HQ"], c["HKV"], c["HD"])
    d = c["DENSE_HEADS"]
    wb, wenc, wp = c["WHISPER_B"], c["WHISPER_ENC"], c["WHISPER_PROMPT"]
    wh = tuple(c["WHISPER_HEADS"])
    want = [
        (8, 256, 256, planner, 0, 0.0, True, "train"),
        (16, 64, 64, planner, 0, 0.0, True, "gate"),
        (1, 1024, 1024, planner, 0, 0.0, True, "long"),
        (1, 512, 512, tuple(c["MOE_HEADS"]["kimi"]) + (128,), 0, 0.0, True,
         "kimi"),
        (2, 256, 256, planner[:2] + (32,), 0, 0.0, True, "hd32"),
        (2, 512, 512, planner, 100, 0.0, True, "window"),
        (2, 256, 256, planner, 0, 30.0, True, "cap"),
        (2, 256, 256, tuple(d["qwen110_smoke"]), 0, 0.0, True, "hd16"),
        (1, 4608, 4608, tuple(d["gemma2"]), c["GEMMA2_WINDOW"],
         c["GEMMA2_CAP"], True, "gemma2"),
        (1, 1024, 1024, tuple(d["gemma2"]), 0, 0.0, True, "hd256"),
        (wb, wenc, wenc, wh, 0, 0.0, False, "whisper_enc"),
        (wb, wp, wenc, wh, 0, 0.0, False, "whisper_cross"),
        (wb, wp, wp, wh, 0, 0.0, True, "whisper_self"),
        (1, 1024, 1024, tuple(d["qwen32"]), 0, 0.0, True, "qwen32"),
        (1, 4608, 4608, (24, 2, 128), 4096, 0.0, True, "starcoder2"),
        (1, 1280, 1280, (64, 8, 128), 0, 0.0, True, "qwen2vl")]
    assert AB.BWD_CASES == want
    assert set(AB.SMALL) <= {x[-1] for x in AB.BWD_CASES}
    src = (ROOT / "chip_smoke.py").read_text()
    assert "from repro_torch.launch.attn_bwd_bench import" in src
    assert "\nBWD_CASES = " not in src


def test_tolerance_is_chip_smokes():
    c = _chip_smoke_values("BWD_ATOL", "BWD_RTOL")
    assert (AB.BWD_ATOL, AB.BWD_RTOL) == (c["BWD_ATOL"], c["BWD_RTOL"]) \
        == (2e-2, 2e-2)


def test_passes_are_the_sources_kernels():
    """chip_smoke.py's BWD_PASSES (profiled by name, counted in the SASS)
    are the __global__ kernels of csrc/flash_prefill_bwd.cu, and the
    bench reads their registers under the same names."""
    src = (_build.CSRC / "flash_prefill_bwd.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                         r"(\w+)\(", src)
    passes = _chip_smoke_values("BWD_PASSES")["BWD_PASSES"]
    assert sorted(passes) == sorted(kernels)
    assert set(passes) <= set(AB.PASS_SYMBOLS)
    # no pass name is a part of another's (the profiler matches by part)
    assert not any(a != b and a in b for a in passes for b in passes)


def test_bound_counts_the_visible_pairs():
    """The gate case is bound by its bytes, the 1,024-row causal case by
    its operations (10 hd a visible pair and q head at 989 TFLOP/s)."""
    gate = next(c for c in AB.BWD_CASES if c[-1] == "gate")
    ms, by = AB.bwd_bound(gate)
    assert by == "bytes"
    assert ms == pytest.approx(2 * 64 * 16 * (3 * 12 * 64 + 4 * 4 * 64)
                               / 3.35e12 * 1e3)
    long = next(c for c in AB.BWD_CASES if c[-1] == "long")
    ms, by = AB.bwd_bound(long)
    assert by == "operations"
    assert ms == pytest.approx(10 * 64 * 12 * (1024 * 1025 // 2)
                               / 989e12 * 1e3)
    assert AB.visible_pairs(1, 4, 4, 2, True) == 4 + 3
    assert AB.visible_pairs(2, 3, 5, 0, False) == 30


def test_short_names_of_profiler_keys():
    assert AB.short_name("void (anonymous namespace)::prefill_bwd_dkdv<64,"
                         " 2>(CUtensorMap_st, CUtensorMap_st)") \
        == "prefill_bwd_dkdv<64, 2>"
    assert AB.short_name("void (anonymous namespace)::bwd_dq_kernel<16>"
                         "((anonymous namespace)::Params)") \
        == "bwd_dq_kernel<16>"
    assert AB.short_name("void at::native::zero_kernel(float*)") \
        == "zero_kernel"


def test_cpu_run_prints_the_plain_versions_bits(capsys):
    assert AB.main(["--device", "cpu", "--label", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"label": "cpu", "device": "cpu", "card": None}
    recs = lines[1:]
    assert [r["family"] for r in recs] == list(AB.SMALL)
    for r in recs:
        assert r["repeat_equal"] and r["within_tol"]
        assert r["max_abs_err"] == 0.0       # the wrapper is the plain one
        assert r["ms"] is None and r["device_ms"] is None
        assert len(r["bits"]) == 3 and all(len(b) == 16 for b in r["bits"])


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert AB.main([]) == 1
    assert capsys.readouterr().out == ""
