"""Qwen2-VL-72B — M-RoPE, dynamic resolution [arXiv:2409.12191].
(a copy of the JAX package's config).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
The ViT vision encoder + projector is the allowed STUB: ``input_specs``
provides precomputed patch embeddings (B, n_vision_tokens, d_model); the
language backbone (M-RoPE over (t,h,w) position ids) is fully implemented.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29_568,
    vocab_size=152_064,
    segments=((("full",), 80),),
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    mlp_act="silu_glu",
    tie_embeddings=False,
    n_vision_tokens=1024,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab_size=512,
    segments=((("full",), 2),),
    rope_kind="mrope",
    mrope_sections=(4, 6, 6),
    qkv_bias=True,
    tie_embeddings=False,
    n_vision_tokens=16,
)
