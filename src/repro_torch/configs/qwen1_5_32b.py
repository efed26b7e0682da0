"""Qwen1.5-32B — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B family].
(a copy of the JAX package's config).

64L d_model=5120 40H (kv=40, MHA) d_ff=27392 vocab=152064.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_head=128,
    d_ff=27_392,
    vocab_size=152_064,
    segments=((("full",), 64),),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    mlp_act="silu_glu",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen1.5-32b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_head=32,
    d_ff=256,
    vocab_size=512,
    segments=((("full",), 2),),
    qkv_bias=True,
    tie_embeddings=False,
)
