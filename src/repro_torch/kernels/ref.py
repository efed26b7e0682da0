"""Plain PyTorch versions of the attention kernels (the allclose targets).

Ports of ``attention_ref`` and ``decode_attention_ref`` from the JAX
package's ``kernels/ref.py``: they materialise the full fp32 score matrix
and are correctness references, not fast paths. On a CPU tensor the
kernel wrappers run these; on the card they are what ``chip_smoke.py``
holds the kernels against. The oracles of the unported kernels (paged,
verify, router, scans) come with those kernels.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _kv_len_tensor(kv_len, device) -> torch.Tensor:
    """kv_len as a (1,) or (B,) int64 tensor on ``device``."""
    kvl = torch.as_tensor(kv_len, device=device).to(torch.int64)
    return kvl.reshape(1) if kvl.ndim == 0 else kvl


def attention_ref(q, k, v, *, causal=True, window=0, cap=0.0, kv_len=None,
                  q_offset=0, scale=0.0):
    """q: (B,Hq,Sq,hd); k,v: (B,Hkv,Sk,hd); GQA: q head h reads kv head
    h // (Hq // Hkv).

    window: sliding-window size (0 = full); cap: logit softcap;
    kv_len: number of valid kv entries — scalar or (B,) (decode against
    per-sequence fill levels); q positions end at kv_len-1 (decode) or
    start at q_offset (prefill / chunked-prefill extend).
    scale: 0 -> 1/sqrt(hd). Returns q's dtype.
    """
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale else 1.0 / math.sqrt(hd)
    dev = q.device
    qg = q.float().reshape(B, Hkv, G, Sq, hd)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if cap:
        logits = cap * torch.tanh(logits / cap)
    kpos = torch.arange(Sk, device=dev)
    if kv_len is not None:
        kvl = _kv_len_tensor(kv_len, dev)                      # (1|B,)
        qpos = kvl[:, None] - Sq + torch.arange(Sq, device=dev)[None, :]
        valid = kpos[None, None, :] < kvl[:, None, None]       # (1|B,1,Sk)
    else:
        qpos = (torch.as_tensor(q_offset, device=dev).to(torch.int64)
                + torch.arange(Sq, device=dev))[None, :]      # (1,Sq)
        valid = torch.ones((1, 1, Sk), dtype=torch.bool, device=dev)
    mask = valid.expand(valid.shape[0], Sq, Sk)
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[..., None])
    if window:
        mask = mask & (qpos[..., None] - kpos[None, None, :] < window)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), NEG_INF, device=dev))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(B, Hq, Sq, hd).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, kv_len, *, cap=0.0,
                         scale=0.0):
    """q: (B,Hq,hd); caches: (B,Hkv,S,hd); kv_len: scalar or (B,) int."""
    out = attention_ref(q[:, :, None], k_cache, v_cache, causal=False,
                        cap=cap, kv_len=kv_len, scale=scale)
    return out[:, :, 0]
