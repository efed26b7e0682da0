"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per-expert) vocab=163840.
DeepSeek-V3-style layout: layer 0 is dense (ff = top_k * d_expert), layers
1..60 are MoE with one always-on shared expert (ff=2048).
"""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=2048,
    vocab_size=163_840,
    segments=((("dense",), 1), (("moe",), 60)),
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048,
                  shared_expert_ff=2048),
    rope_theta=1_000_000.0,
    mlp_act="silu_glu",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="kimi-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=64,
    vocab_size=512,
    segments=((("dense",), 1), (("moe",), 1)),
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, shared_expert_ff=64),
    tie_embeddings=False,
)
