"""The port's three example launchers held against the JAX package's
examples on the CPU.

  * ``launch/quickstart.py`` and ``launch/gating_ablation.py`` print
    the JAX examples' stdout letter for letter (each JAX example run
    once, in a subprocess);
  * ``launch/serve_copilot.py --device cpu`` prints the JAX example's
    lines but the last one's seconds and tok/s, and its engine serves
    the JAX engine's T=0 tokens (reference backend) when it carries
    JAX's ``init_params(PRNGKey(0))`` weights across by
    ``models/convert.py`` (the launcher's own weights come from a
    ``torch.Generator``), at ``--requests 6``.
"""
import argparse
import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke_config as jax_smoke
from repro.env.tasks import make_benchmark as jax_benchmark
from repro.env.world import build_world as jax_world
from repro.models import model as JM
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.sampling import SamplerConfig as JaxSampler
from repro_torch.configs import get_smoke_config
from repro_torch.launch import gating_ablation, quickstart, serve_copilot
from repro_torch.models.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
REQUESTS = 6
# the wall-clock numbers of serve_copilot's last line
_TIMED = re.compile(r"in [0-9.]+s \([0-9.]+ tok/s")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: its pool, under the suite's workers, slows
    these small ops ~10x (``test_torch_training.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_example(name: str, *args: str) -> str:
    """stdout of the JAX package's ``examples/<name>.py``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          *args], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def port_main(module, *argv: str):
    """(stdout, result) of the port launcher's ``main``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = module.main(list(argv))
    return buf.getvalue(), out


def test_quickstart_prints_the_jax_example():
    text, res = port_main(quickstart)
    assert text == jax_example("quickstart.py")
    assert res["intent"] == "load_filter_plot"
    assert 0 < res["token_reduction"] < 1


def test_gating_ablation_prints_the_jax_example():
    text, res = port_main(gating_ablation)
    assert text == jax_example("gating_ablation.py")
    assert len(res["accuracy"]) == len(gating_ablation.ACCURACIES)
    assert len(res["coverage"]) == len(gating_ablation.COVERAGES)


@pytest.fixture(scope="module")
def jax_copilot():
    """The JAX example's stdout, and its engine's T=0 tokens by request
    on its own weights (``init_params(PRNGKey(0))``)."""
    text = jax_example("serve_copilot.py", "--requests", str(REQUESTS))
    cfg = jax_smoke("planner-proxy-100m")
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    eng = JaxEngine(cfg, params, max_batch=serve_copilot.MAX_BATCH,
                    cache_len=serve_copilot.CACHE_LEN)
    rids = [eng.add_request(serve_copilot.GATE_PROMPT + t.query,
                            max_new_tokens=serve_copilot.MAX_NEW,
                            sampler=JaxSampler(temperature=0.0))
            for t in jax_benchmark(jax_world(0), REQUESTS)]
    done = {r.request_id: r for r in eng.run_until_done()}
    return dict(text=text, params=params,
                prompts=[list(done[i].prompt) for i in rids],
                outputs=[list(done[i].output) for i in rids])


def test_serve_copilot_prints_the_jax_example(jax_copilot):
    text, res = port_main(serve_copilot, "--device", "cpu", "--requests",
                          str(REQUESTS))
    ours, theirs = text.splitlines(), jax_copilot["text"].splitlines()
    assert len(ours) == len(theirs) == 5
    assert ours[:-1] == theirs[:-1]
    assert _TIMED.sub("", ours[-1]) == _TIMED.sub("", theirs[-1])
    assert f"{REQUESTS} requests in " in ours[-1]
    assert res["requests"] == REQUESTS
    assert set(res["reports"]) == {"full-catalog", "geckopt"}


def test_serve_copilot_engine_tokens_equal_jax(jax_copilot):
    cfg = get_smoke_config("planner-proxy-100m")
    model = params_from_numpy(jax.tree.map(np.asarray,
                                           jax_copilot["params"]),
                              cfg, "cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        res = serve_copilot.serve_copilot(
            cfg, model, argparse.Namespace(requests=REQUESTS))
    assert res["prompts"] == jax_copilot["prompts"]
    assert res["outputs"] == jax_copilot["outputs"]
    assert all(len(o) == serve_copilot.MAX_NEW for o in res["outputs"])
