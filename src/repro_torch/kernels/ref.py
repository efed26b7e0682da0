"""Plain PyTorch versions of the kernels (the allclose targets).

Ports of the oracles of the JAX package's ``kernels/ref.py`` for the
attention kernels (dense, decode, paged decode, verify, paged verify),
the MoE router and the selective scan: they materialise the full fp32
score matrix (or probability row, or step the scan one timestep at a
time) and are correctness references, not fast paths. On a CPU tensor
the kernel wrappers run these; on the card they are what
``chip_smoke.py`` holds the kernels against. The mLSTM scan's oracle
comes with its kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def paged_gather_kv(pages, block_tab):
    """The logical per-sequence KV view of a paged pool.

    pages: (n_blocks, Hkv, bs, hd) physical block pool (one layer);
    block_tab: (B, mb) int block table. Entries >= n_blocks are
    out-of-table sentinels and clamp to the last block (their rows are
    garbage, masked away by kv_len downstream).
    Returns (B, Hkv, mb * bs, hd), contiguous.
    """
    nb, Hkv, bs, hd = pages.shape
    B, mb = block_tab.shape
    ids = torch.clamp(block_tab.to(pages.device).long(), 0, nb - 1)
    view = pages[ids]                                  # (B, mb, Hkv, bs, hd)
    return view.permute(0, 2, 1, 3, 4).reshape(B, Hkv, mb * bs, hd)


def identity_pool(cache, bs):
    """A dense cache as a paged pool of ``bs``-row blocks and its identity
    table: the inverse of ``paged_gather_kv``.

    cache: (B, Hkv, S, hd) with S a multiple of bs.
    Returns ((B * S // bs, Hkv, bs, hd) contiguous pool, (B, S // bs)
    int32 table numbering slot b's blocks b * S // bs onwards).
    """
    B, Hkv, S, hd = cache.shape
    mb = S // bs
    pool = cache.reshape(B, Hkv, mb, bs, hd).transpose(1, 2).reshape(
        B * mb, Hkv, bs, hd).contiguous()
    return pool, torch.arange(B * mb, dtype=torch.int32,
                              device=cache.device).reshape(B, mb)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tab, kv_len, *,
                               cap=0.0, scale=0.0):
    """Decode attention against scattered KV blocks (gather oracle).
    q: (B,Hq,hd); pages: (n_blocks,Hkv,bs,hd); block_tab: (B,mb);
    kv_len: (B,) valid rows per sequence. Returns (B,Hq,hd)."""
    return decode_attention_ref(q, paged_gather_kv(k_pages, block_tab),
                                paged_gather_kv(v_pages, block_tab),
                                kv_len, cap=cap, scale=scale)


def verify_attention_ref(q, k_cache, v_cache, kv_len, *, cap=0.0,
                         scale=0.0):
    """Speculative-verify attention, fused: W query rows per sequence
    against a (partially) filled cache, causal at per-sequence offsets.

    q: (B,Hq,W,hd); caches: (B,Hkv,Sc,hd); kv_len: (B,) int, the valid
    rows AFTER the verify write, so query row r sits at absolute
    position kv_len - W + r and attends kv positions <= that (the mask a
    single-token decode at that position uses). Returns (B,Hq,W,hd).
    The oracle both ``verify_rows_ref`` and the CUDA kernels are held
    against."""
    return attention_ref(q, k_cache, v_cache, causal=True, cap=cap,
                         kv_len=kv_len, scale=scale)


def verify_rows_ref(q, k_cache, v_cache, kv_len, *, cap=0.0, scale=0.0):
    """The plain verify read the CPU path takes: W decode-shaped calls of
    ``decode_attention_ref``, row r at kv_len - W + r + 1 (the JAX
    package's ``_verify_rows``). Each call has exactly the shapes of a
    single-token decode at that position, so on the CPU a verify row is
    bitwise the decode row; one fused W-row einsum would be
    mathematically equal but may reduce in another order."""
    W = q.shape[2]
    kvl = _kv_len_tensor(kv_len, q.device)
    outs = [decode_attention_ref(q[:, :, r].contiguous(), k_cache, v_cache,
                                 kvl - W + r + 1, cap=cap, scale=scale)
            for r in range(W)]
    return torch.stack(outs, dim=2)


def paged_verify_attention_ref(q, k_pages, v_pages, block_tab, kv_len, *,
                               cap=0.0, scale=0.0):
    """Speculative-verify attention over scattered KV blocks (gather
    oracle). q: (B,Hq,W,hd); pages: (n_blocks,Hkv,bs,hd); block_tab:
    (B,mb); kv_len: (B,) valid rows after the verify write."""
    return verify_attention_ref(q, paged_gather_kv(k_pages, block_tab),
                                paged_gather_kv(v_pages, block_tab),
                                kv_len, cap=cap, scale=scale)


def paged_verify_rows_ref(q, k_pages, v_pages, block_tab, kv_len, *,
                          cap=0.0, scale=0.0):
    """``verify_rows_ref`` over the gathered view of a paged pool: the
    plain version the CPU path takes for paged verify."""
    return verify_rows_ref(q, paged_gather_kv(k_pages, block_tab),
                           paged_gather_kv(v_pages, block_tab), kv_len,
                           cap=cap, scale=scale)


def router_topk_ref(logits, k: int):
    """logits: (T,E) -> (weights (T,k) fp32, idx (T,k) int32, probs (T,E)
    fp32). The row softmax in fp32, the k largest probabilities in
    descending order with ties to the lowest expert id (a stable
    descending sort, as ``lax.top_k`` orders them; ``torch.topk``
    promises no order for ties), renormalised by their sum clamped at
    1e-9."""
    probs = torch.softmax(logits.float(), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w = top[:, :k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx[:, :k].to(torch.int32), probs


def selective_scan_ref(dt, x, B_, C_, A, h0=None):
    """Sequential selective-scan oracle, in fp32.

    dt, x: (B,S,di); B_, C_: (B,S,n); A: (di,n); h0: optional initial
    state (B,di,n), zeros when None. Step t: ``a = exp(dt_t A)``, ``h =
    a h + (dt_t x_t) B_t``, ``y_t = sum_n h C_t``. Returns (y (B,S,di),
    h_last (B,di,n)), both fp32. The sum over n is an elementwise
    product and a sum (not a matmul), so no TF32 setting reaches it."""
    Bsz, S, di = x.shape
    n = A.shape[-1]
    dt, x, B_, C_, A = (t.float() for t in (dt, x, B_, C_, A))
    h = (torch.zeros((Bsz, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dt_t = dt[:, t]                                         # (B, di)
        a = torch.exp(dt_t[..., None] * A)                      # (B,di,n)
        h = a * h + (dt_t * x[:, t])[..., None] * B_[:, t, None, :]
        ys.append((h * C_[:, t, None, :]).sum(-1))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((Bsz, 0, di), dtype=torch.float32, device=x.device))
    return y, h


def mlstm_scan_ref(q, k, v, i_pre, f_pre, state=None, *, scale=0.0):
    """Sequential stabilized mLSTM oracle with state carry, in fp32.

    q, k, v: (B,H,S,hd); i_pre, f_pre: (B,H,S); state: optional (C
    (B,H,hd,hd), n (B,H,hd), m (B,H)), zeros / zeros / -1e30 when None;
    scale: 0 -> 1/sqrt(hd). Step t, in this order: ``logf = logsigmoid
    (f_t)`` (the stable form), ``m' = max(logf + m, i_t)``, ``fw =
    exp(logf + m - m')``, ``iw = exp(i_t - m')``, ``ks = k_t scale``,
    ``C = C fw + iw (ks v^T)``, ``n = n fw + iw ks``, ``h_t = C^T q_t /
    max(|n . q_t|, exp(-m'))``. Returns (h (B,H,S,hd) fp32, (C, n, m)).
    The output divides by a cancelled dot, so the step order is the
    JAX oracle's exactly."""
    B, H, S, hd = q.shape
    scale = scale if scale else 1.0 / math.sqrt(hd)
    q, k, v, i_pre, f_pre = (t.float() for t in (q, k, v, i_pre, f_pre))
    if state is None:
        state = mlstm_zero_state(B, H, hd, q.device)
    C, n, m = (t.float() for t in state)
    hs = []
    for t in range(S):
        q_t, i_t = q[:, :, t], i_pre[:, :, t]
        logf = F.logsigmoid(f_pre[:, :, t])
        m_new = torch.maximum(logf + m, i_t)
        fw = torch.exp(logf + m - m_new)[..., None]
        iw = torch.exp(i_t - m_new)[..., None]
        ks = k[:, :, t] * scale
        C = C * fw[..., None] + iw[..., None] * (ks[..., :, None]
                                                 * v[:, :, t, None, :])
        n = n * fw + iw * ks
        num = torch.einsum("bhde,bhd->bhe", C, q_t)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q_t)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    h = (torch.stack(hs, dim=2) if hs else
         torch.zeros((B, H, 0, hd), dtype=torch.float32, device=q.device))
    return h, (C, n, m)


def mlstm_zero_state(B: int, H: int, hd: int, device):
    """The mLSTM's fresh state: C and n zeros, m -1e30, all fp32."""
    return (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((B, H, hd), dtype=torch.float32, device=device),
            torch.full((B, H), -1e30, dtype=torch.float32, device=device))


def mlstm_ref(q, k, v, i_pre, f_pre):
    """Sequential stabilized mLSTM oracle (fresh state, outputs only).
    q, k, v: (B,H,S,hd); i_pre, f_pre: (B,H,S). Returns h (B,H,S,hd)."""
    return mlstm_scan_ref(q, k, v, i_pre, f_pre)[0]
