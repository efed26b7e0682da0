"""StarCoder2-3B — GQA + RoPE, 4k sliding-window attention [arXiv:2402.19173].
(a copy of the JAX package's config).

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152. Served in its
documented sliding-window mode (window=4096), which makes it eligible for
long_500k decode (window KV cache).
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_head=128,
    d_ff=12288,
    vocab_size=49_152,
    segments=((("local",), 30),),
    window=4096,
    rope_theta=100_000.0,
    qkv_bias=True,
    mlp_act="gelu",
    tie_embeddings=True,
    long_context_ok=True,   # sliding-window variant (per-brief carve-in)
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab_size=512,
    segments=((("local",), 2),),
    window=32,
    qkv_bias=True,
    mlp_act="gelu",
    long_context_ok=True,
)
