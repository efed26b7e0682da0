"""The port's serve launcher: the JAX launcher's surface plus
``--device``, unported flags refused before any model is built, and one
tiny CPU run at the smoke config."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.model import init_params as jax_init
from repro.training.checkpoint import save_checkpoint
from repro_torch.launch.serve import build_parser, main, validate_args


def parse(argv):
    ap = build_parser()
    return validate_args(ap, ap.parse_args(argv))


def test_defaults_match_jax_launcher():
    from repro.launch.serve import build_parser as jax_parser
    ours = vars(parse([]))
    theirs = vars(jax_parser().parse_args([]))
    shared = set(theirs) - {"backend", "router", "profile", "skew", "turns"}
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}
    assert ours["device"] is None and set(ours) == shared | {"device"}


@pytest.mark.parametrize("argv", [
    ["--smoke", "--device", "cpu"],
    ["--prefill-budget", "1024"],
    ["--prefill-budget", "64", "--no-interleave", "--admission", "slack"],
    ["--cache-len", "2048", "--max-batch", "8", "--temperature", "0"],
    ["--kv-mode", "paged", "--kv-blocks", "24", "--block-size", "16"],
    ["--kv-mode", "paged", "--spec-decode", "--draft-k", "4"],
])
def test_valid_combinations_parse(argv):
    parse(argv)


#: flags once refused here that a later slice ported (retrieval)
OPENED = ("--retriever-k",)


@pytest.mark.parametrize("argv,msg", [
    (["--kv-mode", "paged"], None),          # ported: parses
    (["--spec-decode"], None),               # ported: parses
    (["--replicas", "2"], "--replicas"),
    (["--retriever-k", "4"], "--retriever-k"),
    (["--catalog-size", "64", "--retriever-k", "4"], "--retriever-k"),
    (["--sla-spill"], "--sla-spill"),
])
def test_unported_flags_refused(argv, msg, capsys):
    if msg is None:
        args = parse(argv)
        assert args.kv_mode == ("paged" if "--kv-mode" in argv
                                else "dense")
        assert args.spec_decode == ("--spec-decode" in argv)
        return
    if msg in OPENED:
        # ported since: parses as the JAX launcher's flag
        args = parse(argv)
        assert args.retriever_k == 4
        assert args.catalog_size == (64 if "--catalog-size" in argv
                                     else None)
        return
    with pytest.raises(SystemExit):
        parse(argv)
    err = capsys.readouterr().err
    assert msg in err and "not ported yet" in err


@pytest.mark.parametrize("argv", [
    ["--backend", "pallas"],                 # the device decides
    ["--kv-blocks", "8"],
    ["--block-size", "16"],
    ["--spec-decode", "--draft-k", "0"],
    ["--prefill-budget", "0"],
    ["--no-interleave"],
    ["--replicas", "0"],
    ["--admission", "lifo"],
    ["--catalog-size", "64"],                # no gate: needs --retriever-k
    ["--retriever-k", "0"],
])
def test_invalid_combinations_error(argv):
    with pytest.raises(SystemExit):
        parse(argv)


def test_cpu_smoke_run(capsys, tmp_path):
    trace = tmp_path / "t.jsonl"
    res = main(["--device", "cpu", "--smoke", "--requests", "3",
                "--max-new", "3", "--max-batch", "2", "--cache-len", "64",
                "--temperature", "0", "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "on cpu" in out
    assert res["requests"] == 3
    assert all(len(o) == 3 for o in res["outputs"].values())
    assert res["stats"]["tokens_generated"] == 6     # 3 first + 3 decoded
    assert trace.read_text().strip()


def test_budgeted_run_serves_the_same_tokens():
    base = ["--device", "cpu", "--smoke", "--requests", "3", "--max-new",
            "4", "--max-batch", "2", "--cache-len", "64", "--temperature",
            "0"]
    assert (main(base)["outputs"]
            == main(base + ["--prefill-budget", "16"])["outputs"])


@pytest.mark.parametrize("extra", [
    ["--kv-mode", "paged"],
    ["--spec-decode", "--draft-k", "3"],
    ["--kv-mode", "paged", "--kv-blocks", "6", "--spec-decode"],
], ids=["paged", "spec", "paged_spec_tight"])
def test_paged_and_spec_runs_serve_the_dense_tokens(extra, capsys):
    base = ["--device", "cpu", "--smoke", "--requests", "4", "--max-new",
            "9", "--max-batch", "2", "--cache-len", "64", "--temperature",
            "0"]
    dense = main(base)
    res = main(base + extra)
    assert res["outputs"] == dense["outputs"]
    out = capsys.readouterr().out
    if "--spec-decode" in extra:
        assert "spec-decode[k=" in out and res["spec_accept_rate"] > 0
    if "paged" in extra:
        assert "kv[paged]" in out and "preemptions" in out
    assert res["preemptions"] == res["stats"]["preemptions"]


def test_checkpoint_flag_loads_jax_weights(tmp_path):
    jp = jax_init(jax.random.PRNGKey(7), jax_smoke("planner-proxy-100m"))
    path = tmp_path / "planner.npz"
    save_checkpoint(str(path), jp)
    base = ["--device", "cpu", "--smoke", "--requests", "2", "--max-new",
            "3", "--max-batch", "2", "--cache-len", "64", "--temperature",
            "0"]
    a = main(base + ["--checkpoint", str(path)])
    b = main(base + ["--checkpoint", str(path)])
    assert a["outputs"] == b["outputs"]


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["--smoke", "--requests", "1"])
