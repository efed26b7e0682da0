"""The port's attention ops vs the JAX package's oracles.

On the CPU the kernel wrappers run their plain PyTorch versions; these
tests hold those against ``repro.kernels.ref`` on the same numpy inputs,
in fp32 (the point is the algorithm, not bf16 rounding): |diff| <= 1e-5,
a few fp32 ulps of O(1) outputs summed in another order. The kernels
themselves are held against the plain versions on the card by
``chip_smoke.py`` and by the card-only tests at the end, which skip here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import backend as JKB
from repro.kernels import ref as JR
from repro_torch.kernels import backend as KB
from repro_torch.kernels import ref as TR
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import flash_prefill

ATOL = 1e-5


def _inputs(seed, B, Hq, Hkv, Sq, Sk, hd=64):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return mk(B, Hq, Sq, hd), mk(B, Hkv, Sk, hd), mk(B, Hkv, Sk, hd)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("Sq,Sk,q_offset", [
    (37, 37, 0),        # ragged prompt prefill
    (130, 130, 0),      # above one 64-row tile, not a multiple of it
    (16, 96, 70),       # chunked-prefill extend at an offset
    (5, 64, 59),        # extend ending exactly at the cache end
])
def test_attention_matches_oracle(G, Sq, Sk, q_offset):
    q, k, v = _inputs(G * 100 + Sq, 2, 2 * G, 2, Sq, Sk)
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, q_offset=q_offset)
    want = JR.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("cap,window,causal", [(0.0, 0, False),
                                               (5.0, 0, True),
                                               (0.0, 24, True)])
def test_attention_variants_match_oracle(cap, window, causal):
    q, k, v = _inputs(3, 1, 6, 2, 48, 48)
    got = TR.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal,
                           window=window, cap=cap, scale=0.2)
    want = JR.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, cap=cap,
                            scale=0.2)
    _close(got, want)


@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("kv_len", [17, [96, 40, 1], np.int32(96)])
def test_decode_matches_oracle(G, kv_len):
    q, k, v = _inputs(G, 3, 2 * G, 2, 1, 96)
    kvl = np.asarray(kv_len, np.int32)
    got = flash_decode(torch.from_numpy(q[:, :, 0]), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(kvl))
    want = JR.decode_attention_ref(jnp.asarray(q[:, :, 0]), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(kvl))
    _close(got, want)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_decode_softcap_and_int_kv_len(cap):
    q, k, v = _inputs(9, 2, 4, 2, 1, 64)
    got = TR.decode_attention_ref(torch.from_numpy(q[:, :, 0]),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  33, cap=cap)
    want = JR.decode_attention_ref(jnp.asarray(q[:, :, 0]), jnp.asarray(k),
                                   jnp.asarray(v), 33, cap=cap)
    _close(got, want)


def test_prefill_and_extend_rows_agree():
    """The property the engine's chunk seams rest on: a row at absolute
    position p sees the same keys in prefill (Sk = S) and in extend
    against a longer cache (Sk = Sc, q_offset)."""
    q, k, v = _inputs(5, 1, 4, 2, 40, 40)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    full = TR.attention_ref(tq, tk, tv, causal=True)
    pad = lambda t: torch.cat([t, torch.randn(1, 2, 24, 64)], dim=2)
    ext = TR.attention_ref(tq[:, :, 25:], pad(tk), pad(tv), causal=True,
                           q_offset=25)
    np.testing.assert_allclose(ext.numpy(), full[:, :, 25:].numpy(),
                               atol=ATOL, rtol=0)


def test_op_surface_matches_jax_package():
    assert KB.OP_SURFACE == JKB.OP_SURFACE
    for op in KB.OPS:
        assert JKB.check_op_signature(op, getattr(KB, op)) is None, op


@pytest.mark.parametrize("op,args", [
    ("paged_decode_attention", (None,) * 5),
    ("verify_attention", (None,) * 4),
    ("paged_verify_attention", (None,) * 5),
    ("router_topk", (None, 2)),
    ("selective_scan", (None,) * 5),
    ("mlstm_scan", (None,) * 5),
])
def test_unported_ops_raise_naming_their_queue_item(op, args):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue B"):
        getattr(KB, op)(*args)


def test_cpu_wrappers_do_not_count_launches():
    KB.reset_launches()
    q, k, v = map(torch.from_numpy, _inputs(1, 1, 4, 2, 8, 8))
    KB.attention(q, k, v)
    KB.decode_attention(q[:, :, 0], k, v, 8)
    assert KB.launch_counts() == {"flash_prefill": 0, "flash_decode": 0}


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 4, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_prefill(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_decode(q[:, :, 0], q[:, :2], q[:, :2], 8)


# ------------------------------------------------- on the card only ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("Sq,Sk,q_offset,cap,window", [
    (37, 37, 0, 0.0, 0), (16, 2048, 700, 0.0, 0), (130, 300, 170, 0.0, 0),
    (100, 100, 0, 20.0, 0), (100, 200, 90, 0.0, 33)])
def test_flash_prefill_kernel_on_card(Sq, Sk, q_offset, cap, window):
    dev = _card()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _inputs(Sq, 1, 12, 4, Sq, Sk))
    before = flash_prefill.launches
    out = flash_prefill(q, k, v, causal=True, q_offset=q_offset, cap=cap,
                        window=window)
    ref = TR.attention_ref(q, k, v, causal=True, q_offset=q_offset,
                           cap=cap, window=window)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


def test_flash_decode_kernel_on_card():
    dev = _card()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _inputs(4, 4, 12, 4, 1, 512))
    kvl = torch.tensor([0, 1, 300, 512], dtype=torch.int32, device=dev)
    out = flash_decode(q[:, :, 0].contiguous(), k, v, kvl)
    ref = TR.decode_attention_ref(q[:, :, 0], k, v, kvl)
    torch.cuda.synchronize()
    assert float(out[0].float().abs().max()) == 0.0      # kv_len 0 -> 0
    torch.testing.assert_close(out[1:].float(), ref[1:].float(), atol=1e-2,
                               rtol=1e-2)
