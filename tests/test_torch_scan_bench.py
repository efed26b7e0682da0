"""``launch/scan_bench.py`` and the scan wrappers' tile shapes, on the CPU.

The bench times the two scan kernels on the card and prints the sha256 of
every output, so that two trees timed in one call can be held to the
same bits. Here: its cases are chip_smoke.py's, its digest tells equal
bits from a one-ulp change, its plain-version run on the CPU prints the
digests of the outputs it computed (and no time), and it refuses to run
on a card that is not there. ``mlstm_scan_tile_states``' shapes follow
the kernel's tile widths (``TILE_COLS``), which the CUDA kernel is built
for and which divide every head dim.
"""
import ast
import json
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.mlstm_scan import HEAD_DIMS, TILE_COLS, \
    mlstm_scan, tile_cols, tile_state_shapes
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.launch import scan_bench as SB

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke_list(name: str) -> list:
    """The literal value of ``name`` in chip_smoke.py (read, not imported)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return [tuple(x) for x in ast.literal_eval(node.value)]
    raise AssertionError(f"chip_smoke.py has no {name}")


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
