"""The port's serve launcher: the JAX launcher's surface plus
``--device``, invalid combinations refused before any model is built as
the JAX launcher refuses them, and tiny CPU runs at the smoke config,
one engine and a two-replica cluster."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.model import init_params as jax_init
from repro.training.checkpoint import save_checkpoint
from repro.launch import serve as jax_serve
from repro_torch.launch.serve import build_parser, main, validate_args


def parse(argv):
    ap = build_parser()
    return validate_args(ap, ap.parse_args(argv))


def test_defaults_match_jax_launcher():
    from repro.launch.serve import build_parser as jax_parser
    ours = vars(parse([]))
    theirs = vars(jax_parser().parse_args([]))
    shared = set(theirs) - {"backend"}
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


#: flags once refused here as not ported that later slices ported
#: (retrieval, the cluster)
OPENED = ("--retriever-k", "--replicas", "--sla-spill")


def jax_refuses(argv) -> bool:
    ap = jax_serve.build_parser()
    try:
        jax_serve.validate_args(ap, ap.parse_args(argv))
    except SystemExit:
        return True
    return False


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
    assert msg in OPENED
    # ported since: parses, or is refused, as the JAX launcher's flag
    if jax_refuses(argv):
        # --sla-spill alone: router-level spill needs two replicas
        with pytest.raises(SystemExit):
            parse(argv)
        err = capsys.readouterr().err
        assert msg in err and "not ported" not in err
        argv = argv + ["--replicas", "2"]
        assert not jax_refuses(argv)
    args = parse(argv)
    if msg == "--retriever-k":
        assert args.retriever_k == 4
        assert args.catalog_size == (64 if "--catalog-size" in argv
                                     else None)
    else:
        assert args.replicas == 2 and args.router == "intent_affinity"
        assert args.sla_spill == (msg == "--sla-spill")


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
    ["--skew", "1.5"],
    ["--router", "random"],
    ["--profile", "zipf"],
    ["--replicas", "2", "--retriever-k", "4"],   # cluster: intent workload
])
def test_invalid_combinations_error(argv):
    with pytest.raises(SystemExit):
        parse(argv)
    assert argv[0] == "--backend" or jax_refuses(argv)


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


def test_cluster_runs_serve_the_same_tokens_under_every_router(capsys):
    """``--replicas 2`` on the CPU: the seeded T = 0.8 workload gives the
    same tokens under each router and with SLA spill; affinity keeps
    every turn on its prefix's home replica."""
    base = ["--device", "cpu", "--smoke", "--requests", "6", "--max-new",
            "3", "--max-batch", "2", "--cache-len", "128", "--temperature",
            "0.8", "--replicas", "2", "--profile", "bursty", "--skew",
            "0.7", "--turns", "2"]
    runs = {r: main(base + ["--router", r]) for r in
            ("round_robin", "least_loaded", "intent_affinity")}
    runs["sla_spill"] = main(base + ["--sla-spill"])
    out = capsys.readouterr().out
    assert "cluster[2x2 slots, router=intent_affinity]" in out
    assert "replica 1:" in out and "prefix-hit ratio" in out
    ref = runs["round_robin"]["outputs"]
    assert len(ref) == runs["round_robin"]["summary"]["requests"] > 6
    assert all(r["outputs"] == ref for r in runs.values())
    assert runs["intent_affinity"]["summary"]["prefix_hit_ratio"] == 1.0
    assert runs["round_robin"]["summary"]["prefix_hit_ratio"] < 1.0
