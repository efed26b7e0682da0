"""Hymba-1.5B — hybrid parallel attention + mamba heads [arXiv:2411.13676]
(a copy of the JAX package's config).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Layer pattern: the paper keeps full (global) attention only at the first,
middle and last layers, sliding-window elsewhere; the JAX package uses
the periodic approximation global@{0,16} with 15 window layers after
each, and so does the port.
"""
from repro_torch.common.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32_001,
    segments=(((("hymba_g",) + ("hymba_w",) * 15), 2),),
    window=1024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=1),
    rope_theta=10_000.0,
    mlp_act="silu_glu",
    tie_embeddings=True,
    long_context_ok=True,   # mamba state + sliding window; 2 global layers
)

SMOKE = ModelConfig(
    name="hymba-smoke",
    family="hybrid",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab_size=512,
    segments=((("hymba_g", "hymba_w"), 1),),
    window=32,
    ssm=SSMConfig(d_state=8, d_conv=4, expand=1),
    long_context_ok=True,
)
