"""The port's dense families qwen1.5 (``"full"`` layers, q/k/v biases,
untied head), starcoder2 (``"local"`` sliding-window rings, GELU MLP,
q/k/v biases) and gemma2 (``"local"`` and ``"full"``, attention and final
softcaps, GELU-GLU, the embedding scaled by sqrt(d)) vs the JAX
package's reference backend, at their smoke configs, on the CPU.

Smoke configs: qwen1.5-32b-smoke (4/4 heads of 32: MHA), qwen1.5-110b-
smoke (8/2 heads of 16), starcoder2-smoke (two ``"local"`` layers, 4/2
heads of 32, window 32), gemma2-smoke (``"local"`` then ``"full"``, 4/2
heads of 32, window 32, caps 50 and 30); d 128, 2 layers, vocab 512.

Weights: JAX ``init_params`` with its zero-initialised biases and norm
scales redrawn non-zero from a seed (zeros would hide a missing bias or
a norm scale read as 0), given to both frameworks: JAX as arrays, the
port through the weight bridge.

Tolerances, with their reasons:
  * logits (fp32 head over bf16 activations): |diff| <= LOGIT_TOL =
    0.05, as ``tests/test_torch_model.py``: both frameworks round the
    bf16 products and activations at other places;
  * engine tokens at T=0: equal to the JAX engine's up to the first
    position where the two streams differ, if any, where the two chosen
    tokens' logits must lie within 2 * LOGIT_TOL of each other (a
    near-tie of random-init weights, after which the streams may rightly
    part), as ``tests/test_torch_hymba.py`` holds them.

Token ids stay below the smoke vocabulary (512): JAX fills out-of-range
embedding rows with NaN. Within the port, bitwise: qwen1.5's paged,
speculative, budgeted and prefix-hit serving give its dense tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from torch_multimodal_common import bridged
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving.sampling import SamplerConfig as JSampler
from repro_torch.configs import ALL_IDS, get_config, get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models.convert import _walk, params_to_numpy
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampling import SamplerConfig
from repro_torch.serving.specdec import SpecConfig

ARCHS = ("qwen1.5-32b", "qwen1.5-110b", "starcoder2-3b", "gemma2-2b")
WINDOWED = ("starcoder2-3b", "gemma2-2b")
LOGIT_TOL = 0.05
CACHE = 512
PROMPT, STEPS = 300, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: its pool, under the suite's workers, slows
    these small ops ~10x (``test_torch_training.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """(arch, JAX config, JAX params, the port's model) on the same
    redrawn weights."""
    return (request.param,) + bridged(request.param)


def _logits_close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    assert arch in ALL_IDS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke(arch))


def test_redrawn_leaves_are_nonzero(fam):
    """Every bias and norm scale of the redrawn tree is non-zero, and
    the bias leaves are there exactly where the config has qkv_bias."""
    arch, jcfg, jp, model = fam
    tree = jax.tree.map(np.asarray, jp)
    names = [k for k, _ in _walk(tree, "")]
    picked = [k for k in names if k.split("/")[-1] in ("bq", "bk", "bv",
                                                       "scale")]
    # norm1, norm2 (and bq, bk, bv) of each unit kind, the final norm
    per_kind = 5 if jcfg.qkv_bias else 2
    assert len(picked) == per_kind * len(jcfg.segments[0][0]) + 1
    for key, leaf in _walk(tree, ""):
        if key in picked:
            assert np.abs(np.asarray(leaf, np.float32)).min() > 0, key
    assert jcfg.qkv_bias == any(k.endswith("attn/bq") for k in names)


def test_params_round_trip_exactly(fam):
    """params_from_numpy then params_to_numpy is the JAX tree, every leaf
    bit for bit (bf16 leaves as fp32, which holds them exactly)."""
    _, _, jp, model = fam
    want = dict(_walk(jax.tree.map(np.asarray, jp), ""))
    got = dict(_walk(params_to_numpy(model), ""))
    assert set(got) == set(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(leaf, np.float32),
                                      err_msg=key)


def test_prefill_and_decode_logits_match_jax(fam):
    """A 300-token prefill (past the 32-row rings, which wrap) and 16
    decode steps of two slots at scalar positions."""
    arch, jcfg, jp, model = fam
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, PROMPT))
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                        cache_len=CACHE)
    tl, tc = TM.prefill(model, {"tokens": toks}, CACHE)
    _logits_close(tl, jl)
    rings = [c["k"].shape[2] for c in tc["layers"]]
    assert rings == [32 if k == "local" else CACHE
                     for k in jcfg.layer_kinds()]
    # one compile of JAX's step: eager, each of its ops dispatches alone
    jdecode = jax.jit(JM.decode_step, static_argnums=1)
    for _ in range(STEPS):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1))
        jl, jc = jdecode(jp, jcfg, jc,
                         {"tokens": jnp.asarray(nxt, jnp.int32)})
        tl, tc = TM.decode_step(model, tc, {"tokens": nxt})
        _logits_close(tl, jl)
    assert int(tc["pos"]) == PROMPT + STEPS


@pytest.mark.parametrize("arch", ["gemma2-2b"])
def test_embedding_scale_and_final_softcap_match_jax(arch):
    """gemma2's two model-level steps at magnitudes that show them: the
    embedding times sqrt(d) rounded to bf16 first (11.3125 at d 128),
    bitwise; the final softcap on logits of O(30-100), within 1e-4."""
    jcfg = jax_smoke(arch)
    model = TM.init_params(get_smoke_config(arch), seed=0, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 7))
    emb = np.asarray(model.embed.float().numpy(), ml_dtypes.bfloat16)
    jx, _ = JM._embed_inputs({"embed": jnp.asarray(emb)}, jcfg,
                             {"tokens": jnp.asarray(toks)})
    tx, _ = TM._embed_inputs(model, torch.as_tensor(toks))
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx, np.float32))
    assert float(tx[0, 0, 0]) == float(model.embed[toks[0, 0], 0]
                                       * torch.tensor(11.3125,
                                                      dtype=torch.bfloat16))
    x = rng.standard_normal((3, jcfg.d_model)).astype(np.float32) * 40
    jlog = JM._logits({"embed": jnp.asarray(emb)}, jcfg, jnp.asarray(x))
    tlog = TM._logits(model, torch.from_numpy(x))
    assert 20.0 < float(np.abs(np.asarray(jlog)).max()) <= 30.0
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)


def _requests(cfg):
    rng = np.random.default_rng(5)
    return [(rng.integers(6, cfg.vocab_size, n).tolist(), m)
            for n, m in ((12, 14), (45, 10), (7, 12))]


def _serve(eng, reqs, prefix=None):
    if prefix is not None:
        eng.register_prefix("p", prefix)
    rids = [eng.add_request(p, max_new_tokens=m,
                            sampler=SamplerConfig(temperature=0.0),
                            prefix_key="p" if prefix is not None else None)
            for p, m in reqs]
    done = {r.request_id: r.output for r in eng.run_until_done()}
    return [done[r] for r in rids]


def test_engine_tokens_match_jax(fam):
    """Three requests over two slots at T=0 (the third in a recycled
    slot) against the JAX engine on the reference backend."""
    arch, jcfg, jp, model = fam
    reqs = _requests(jcfg)
    jeng = JE.InferenceEngine(jcfg, jp, max_batch=2, cache_len=128, seed=0,
                              backend="reference")
    jrids = [jeng.add_request(p, max_new_tokens=m,
                              sampler=JSampler(temperature=0.0))
             for p, m in reqs]
    jdone = {r.request_id: r.output for r in jeng.run_until_done()}
    tout = _serve(InferenceEngine(model.cfg, model, max_batch=2,
                                  cache_len=128), reqs)
    equal = 0
    for (p, _), rid, tt in zip(reqs, jrids, tout):
        jt = jdone[rid]
        n = next((i for i, (a, b) in enumerate(zip(jt, tt)) if a != b),
                 None)
        if n is None:
            assert len(jt) == len(tt)
            equal += len(jt)
            continue
        lg, c = TM.prefill(model, {"tokens": [p]}, 128)
        for t in tt[:n]:
            lg, c = TM.decode_step(model, c, {"tokens": [[t]]})
        gap = abs(float(lg[0, jt[n]]) - float(lg[0, tt[n]]))
        assert gap <= 2 * LOGIT_TOL, (arch, n, gap)
        equal += n
    assert equal >= 12, equal


@pytest.mark.parametrize("arch", WINDOWED)
@pytest.mark.parametrize("kw,match", [
    (dict(kv_mode="paged"), "kv_mode='paged' needs a pure-attention"),
    (dict(prefill_budget=64), "prefill_budget .chunked prefill. needs"),
    ("spec", "spec_decode target model needs a pure-attention"),
], ids=["paged", "budget", "spec"])
def test_window_stacks_refuse_paged_budget_and_spec(arch, kw, match):
    model = TM.init_params(get_smoke_config(arch), seed=0, device="cpu")
    if kw == "spec":
        kw = dict(spec_decode=SpecConfig(model.cfg, model, k=2))
    with pytest.raises(ValueError, match=match):
        InferenceEngine(model.cfg, model, max_batch=2, cache_len=128, **kw)


@pytest.mark.parametrize("arch", WINDOWED)
def test_window_stacks_decode_prefix_tails_through(arch):
    """A 40-token prefix (past the 32-row rings) and suffixes served as
    prefix hits, the tails decoded token by token: the hit's admission
    logits within LOGIT_TOL of one windowed prefill of the prompt."""
    model = TM.init_params(get_smoke_config(arch), seed=0, device="cpu")
    rng = np.random.default_rng(6)
    prefix = [2] + rng.integers(6, 512, 39).tolist()
    eng = InferenceEngine(model.cfg, model, max_batch=2, cache_len=128)
    eng.register_prefix("p", prefix)
    for n in (3, 11):
        p = prefix + rng.integers(6, 512, n).tolist()
        hit, hc = eng._extend_prefix(eng.prefixes["p"], p[len(prefix):])
        miss, mc = TM.prefill(model, {"tokens": [p]}, 128)
        assert hc["pos"] == mc["pos"] == len(p)
        assert float((hit - miss).abs().max()) <= LOGIT_TOL


@pytest.mark.parametrize("arch", ["qwen1.5-110b"])
def test_qwen_serves_every_path_with_the_dense_tokens(arch):
    """qwen1.5 is pure attention: paged (a pool that preempts),
    speculative (k 3, accept rate 1.0), budgeted and prefix-hit serving
    give the dense run's tokens, bitwise."""
    model = TM.init_params(get_smoke_config(arch), seed=0, device="cpu")
    cfg = model.cfg
    rng = np.random.default_rng(7)
    prefix = [2] + rng.integers(6, 512, 70).tolist()
    reqs = [(prefix + rng.integers(6, 512, n).tolist(), 12)
            for n in (5, 17, 9)]
    make = lambda **kw: InferenceEngine(cfg, model, max_batch=2,
                                        cache_len=128, **kw)
    dense = _serve(make(), reqs)
    assert _serve(make(kv_mode="paged", kv_blocks=9), reqs) == dense
    spec = make(spec_decode=SpecConfig(cfg, model, k=3))
    assert _serve(spec, reqs) == dense
    assert spec.throughput_stats()["spec_accept_rate"] == 1.0
    assert _serve(make(prefill_budget=32), reqs) == dense
    hit = make()
    assert _serve(hit, reqs, prefix) == dense
    assert hit.throughput_stats()["prefix_hits"] == 3
