"""Qwen1.5-110B — dense, GQA, QKV bias [hf:Qwen/Qwen1.5-0.5B family].
(a copy of the JAX package's config).

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49_152,
    vocab_size=152_064,
    segments=((("full",), 80),),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    mlp_act="silu_glu",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_head=16,
    d_ff=256,
    vocab_size=512,
    segments=((("full",), 2),),
    qkv_bias=True,
    tie_embeddings=False,
)
