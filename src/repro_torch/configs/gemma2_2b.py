"""Gemma-2 2B — alternating local/global attention, logit softcaps
(a copy of the JAX package's config).
[arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) head_dim=256 d_ff=9216 vocab=256000.
unit=(local, global) repeated 13x; attn softcap 50, final logit softcap 30;
GeGLU MLP; embeddings scaled by sqrt(d_model). Eligible for long_500k via
the alternating-window pattern (window caches for local layers,
seq-sharded cache for global layers).
"""
import math

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab_size=256_000,
    segments=((("local", "full"), 13),),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_scale=1.0 / math.sqrt(256.0),
    mlp_act="gelu_glu",
    emb_scale_by_sqrt_d=True,
    tie_embeddings=True,
    long_context_ok=True,
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab_size=512,
    segments=((("local", "full"), 1),),
    window=32,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="gelu_glu",
    emb_scale_by_sqrt_d=True,
    long_context_ok=True,
)
