"""``launch/scan_bench.py`` and the scan wrappers' tile shapes, on the CPU.

The bench times the two scan kernels on the card and prints the sha256 of
every output, so that two trees timed in one call can be held to the
same bits. Here: its cases are chip_smoke.py's, its digest tells equal
bits from a one-ulp change, its plain-version run on the CPU prints the
digests of the outputs it computed (and no time), and it refuses to run
on a card that is not there. ``mlstm_scan_tile_states``' shapes follow
the kernel's tile widths (``TILE_COLS``), which the CUDA kernel is built
for and which divide every head dim. For the backwards (``--bwd``): the
cases' home is the bench (chip_smoke.py imports them), the CPU run prints
the plain backwards' bits, and the wrappers' scratch follows the
constants that the backward kernels are built with.
"""
import ast
import json
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import mlstm_scan as MS
from repro_torch.kernels import ssm_scan as SS
from repro_torch.kernels.mlstm_scan import HEAD_DIMS, TILE_COLS, \
    mlstm_scan, tile_cols, tile_state_shapes
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.launch import scan_bench as SB

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke_value(name: str):
    """The literal value of ``name`` in chip_smoke.py (read, not imported)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"chip_smoke.py has no {name}")


def _chip_smoke_list(name: str) -> list:
    return [tuple(x) for x in _chip_smoke_value(name)]


@pytest.mark.parametrize("name", ["SSM_CASES", "MLSTM_CASES"])
def test_bench_cases_are_chip_smokes(name):
    assert getattr(SB, name) == _chip_smoke_list(name)
    assert SB.SMALL <= set(SB.SSM_CASES + SB.MLSTM_CASES)


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 4, 6)])
def test_digest_tells_equal_bits_from_one_ulp(shape):
    t = torch.randn(*shape, generator=torch.Generator().manual_seed(3))
    assert SB.digest(t) == SB.digest(t.clone())
    assert len(SB.digest(t)) == 16
    for idx in (0, t.numel() - 1):
        u = t.clone().reshape(-1)
        u[idx] = torch.nextafter(u[idx], torch.tensor(float("inf")))
        assert SB.digest(u.reshape(shape)) != SB.digest(t)
    assert SB.digest(torch.zeros(3)) != SB.digest(-torch.zeros(3))


def test_cpu_run_prints_the_plain_versions_bits(capsys):
    assert SB.main(["--device", "cpu", "--label", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"label": "cpu", "device": "cpu", "card": None}
    recs = lines[1:]
    assert [(r["kernel"], r.get("h0", r.get("state"))) for r in recs] == [
        ("ssm_scan", "zeros"), ("ssm_scan", "random"),
        ("mlstm_scan", "fresh"), ("mlstm_scan", "random")]
    # the digests are those of the plain versions on the same draws
    gen = torch.Generator().manual_seed(0)
    for r in recs:
        assert r["label"] == "cpu"
        assert r["ms"] is None and r["device_ms"] is None
        if r["kernel"] == "ssm_scan":
            assert (r["B"], r["S"], r["di"], r["n"]) in SB.SMALL
            args = SB.ssm_inputs(gen, r["B"], r["S"], r["di"], r["n"],
                                 r["h0"] == "random", "cpu")
            y, h = ssm_scan(*args)
            assert r["bits"] == {"y": SB.digest(y), "h_last": SB.digest(h)}
        else:
            assert (r["B"], r["H"], r["S"], r["hd"]) in SB.SMALL
            args, st = SB.mlstm_inputs(gen, r["B"], r["H"], r["S"],
                                       r["hd"], r["state"] == "random",
                                       "cpu")
            h, (C, n, m) = mlstm_scan(*args, st)
            assert r["bits"] == {"h": SB.digest(h), "C": SB.digest(C),
                                 "n": SB.digest(n), "m": SB.digest(m)}


def test_bench_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert SB.main(["--label", "x"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 2, 14, 1024])
def test_tile_state_shapes_follow_tile_cols(hd, S):
    width = TILE_COLS["step"] if S == 1 else TILE_COLS["scan"]
    assert tile_cols(S) == width
    assert hd % width == 0
    assert tile_state_shapes(3, 4, S, hd) == ((3, 4, hd // width, hd),
                                              (3, 4, hd // width))


def test_tile_widths_are_the_built_ones():
    # csrc/mlstm_scan.cu instantiates 8 and 16 columns a block and
    # refuses any other width
    assert sorted(TILE_COLS.values()) == [8, 16]


# ------------------------------------------------------------ backwards ----

CSRC = ROOT / "src/repro_torch/csrc"
NAMES = {"ssm_scan_bwd": ("ddt", "dx", "dB", "dC", "dA", "dh0"),
         "mlstm_scan_bwd": ("dq", "dk", "dv", "di", "df", "dC0", "dn0",
                            "dm0")}


def _cu_const(src: str, name: str) -> int:
    """The value of ``constexpr int <name> = <int>;`` in csrc/<src>."""
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / src).read_text())
    assert m, f"{src} has no constexpr int {name}"
    return int(m.group(1))


def test_backward_constants_are_the_built_ones():
    # the wrappers size the scratch by the constants the .cu files build
    assert SS.BWD_THREADS == _cu_const("ssm_scan_bwd.cu", "NT")
    assert SS.BWD_TILE == _cu_const("ssm_scan_bwd.cu", "CKS") \
        == _cu_const("ssm_scan.cu", "CKS")
    assert SS.BWD_CLUSTER == _cu_const("ssm_scan_bwd.cu", "CL")
    assert MS.BWD_COLS == _cu_const("mlstm_scan_bwd.cu", "EC")
    assert MS.BWD_CHECKPOINT == _cu_const("mlstm_scan_bwd.cu", "CK")
    assert MS.BWD_CLUSTER == _cu_const("mlstm_scan_bwd.cu", "CL")


@pytest.mark.parametrize("B,S,di,n", [(2, 2048, 1600, 16), (1, 1300, 1600, 16),
                                      (2, 300, 256, 8), (1, 1, 100, 8),
                                      (3, 17, 1000, 16)])
def test_ssm_bwd_scratch_shapes_follow_the_constants(B, S, di, n):
    blocks = -(-di // (SS.BWD_THREADS // n))
    clusters = -(-blocks // SS.BWD_CLUSTER)
    tiles = -(-S // SS.BWD_TILE)
    assert SS.states_shape(B, S, di, n) == (B, tiles, di, n)
    assert SS.bwd_scratch_shapes(B, S, di, n) == (
        (B, tiles, di, n), (B, clusters, S, n), (B, clusters, S, n),
        (B, di, n))
    if (B, S, di, n) == (2, 2048, 1600, 16):  # hymba's training shape
        assert (tiles, clusters) == (128, 25)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 8, 9, 256])
def test_mlstm_bwd_scratch_shapes_follow_the_constants(hd, S):
    T = hd // MS.BWD_COLS
    assert T % MS.BWD_CLUSTER == 0          # whole clusters at every hd
    ncl, ck = T // MS.BWD_CLUSTER, -(-S // MS.BWD_CHECKPOINT)
    assert MS.bwd_scratch_shapes(2, 4, S, hd) == (
        (8, 7, S), (8, S, hd), (8, S, hd), (8, T, ck, hd, MS.BWD_COLS),
        (8, T + 4, S), (8, ncl, S, hd), (8, ncl, S, hd))


def test_backward_cases_live_in_the_bench():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    moved = {"SSM_BWD_CASES", "MLSTM_BWD_CASES", "SSM_BWD_REL", "MLSTM_TOL",
             "mlstm_bwd_tolerance", "mlstm_conditioning"}
    imported = {a.name for node in tree.body
                if isinstance(node, ast.ImportFrom)
                and node.module == "repro_torch.launch.scan_bench"
                for a in node.names}
    defined = {t.id for node in tree.body if isinstance(node, ast.Assign)
               for t in node.targets if isinstance(t, ast.Name)}
    defined |= {node.name for node in tree.body
                if isinstance(node, ast.FunctionDef)}
    assert moved <= imported and not moved & defined
    # hymba's and xlstm's training shapes come first
    assert SB.SSM_BWD_CASES[0] == (2, 2048, 1600, 16, "zeros")
    assert SB.MLSTM_BWD_CASES[0] == (8, 4, 256, 192)


def test_backward_passes_are_the_built_kernels():
    # chip_smoke.py times and reads the registers of each kernel a
    # backward launches; the bench reads them too
    for name, srcs in (("SSM_BWD_PASSES", ("ssm_scan.cu", "ssm_scan_bwd.cu")),
                       ("MLSTM_BWD_PASSES", ("mlstm_scan_bwd.cu",))):
        text = "".join((CSRC / s).read_text() for s in srcs)
        for kernel in _chip_smoke_value(name):
            assert re.search(rf"__global__[^;{{]*\b{kernel}\(", text), kernel
            assert kernel in SB.BWD_SYMBOLS


def test_cpu_bwd_run_prints_the_plain_versions_bits(capsys):
    from repro_torch.kernels.ref import mlstm_scan_bwd_ref, \
        selective_scan_bwd_ref
    assert SB.main(["--bwd", "--device", "cpu", "--label", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"label": "cpu", "device": "cpu", "card": None}
    recs = lines[1:]
    assert [r["kernel"] for r in recs] == ["ssm_scan_bwd", "mlstm_scan_bwd"]
    for r in recs:
        assert r["label"] == "cpu" and r["repeat_equal"] and r["within_tol"]
        assert set(r["rel_norm_err"].values()) == {0.0}
        assert r["ms"] is None and r["device_ms"] is None
        assert r["bound_ms"] > 0 and r["bound_by"] == "bytes"
    # the digests are those of the plain versions on the same draws
    gen = torch.Generator().manual_seed(5)
    B, S, di, n, h0 = SB.SSM_BWD_SMALL[0]
    assert (recs[0]["B"], recs[0]["S"], recs[0]["di"], recs[0]["n"],
            recs[0]["h0"]) == (B, S, di, n, h0)
    args = SB.ssm_inputs(gen, B, S, di, n, True, "cpu")
    dy, dh = torch.randn(B, S, di, generator=gen), \
        torch.randn(B, di, n, generator=gen)
    want = selective_scan_bwd_ref(*args, dy, dh)
    assert recs[0]["bits"] == dict(zip(NAMES["ssm_scan_bwd"],
                                       map(SB.digest, want)))
    gen = torch.Generator().manual_seed(6)
    B, H, S, hd = SB.MLSTM_BWD_SMALL[0]
    assert (recs[1]["B"], recs[1]["H"], recs[1]["S"], recs[1]["hd"],
            recs[1]["state"]) == (B, H, S, hd, "random")
    args, st = SB.mlstm_inputs(gen, B, H, S, hd, True, "cpu")
    r = lambda *shape: torch.randn(*shape, generator=gen)
    dh = r(B, H, S, hd)
    dst = (r(B, H, hd, hd), r(B, H, hd), r(B, H))
    g = mlstm_scan_bwd_ref(*args, st, dh, dst)
    assert recs[1]["bits"] == dict(zip(NAMES["mlstm_scan_bwd"],
                                       map(SB.digest, (*g[:5], *g[5]))))
    assert recs[1]["tol"] == SB.mlstm_bwd_tolerance(*args, st)
