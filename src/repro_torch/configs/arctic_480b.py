"""Snowflake Arctic 480B — 128-expert top-2 MoE + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 (per-expert) vocab=32000.
Arctic's "dense-MoE hybrid" runs a dense residual FFN in parallel with the
routed experts.
"""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,
    vocab_size=32_000,
    segments=((("moe",), 35),),
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864,
                  dense_residual_ff=4864),
    rope_theta=1_000_000.0,
    mlp_act="silu_glu",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="arctic-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=96,
    vocab_size=512,
    segments=((("moe",), 2),),
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=96, dense_residual_ff=96),
    tie_embeddings=False,
)
