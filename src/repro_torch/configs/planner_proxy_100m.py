"""planner-proxy-100m — the ~100M-param dense model GeckOpt serves as its
planner/intent-classifier (a copy of the JAX package's config: 12 full
layers, d=768, GQA 12 q / 4 kv heads of 64, tied head, vocab 8192).
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="planner-proxy-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_head=64,
    d_ff=2048,
    vocab_size=8192,
    segments=((("full",), 12),),
    tie_embeddings=True,
)

# An even smaller variant for tests / quick examples.
SMOKE = ModelConfig(
    name="planner-proxy-smoke",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_head=64,
    d_ff=512,
    vocab_size=8192,
    segments=((("full",), 2),),
    tie_embeddings=True,
)
