"""Whisper-large-v3 — encoder-decoder with conv frontend (stub)
[arXiv:2212.04356].
(a copy of the JAX package's config).

32 decoder layers (self-attn + cross-attn) + 32 encoder layers,
d_model=1280 20H (kv=20) d_ff=5120 vocab=51866, sinusoidal positions.
The mel-spectrogram + conv feature extractor is the allowed STUB:
``input_specs`` provides frame embeddings (B, S_frames, d_model).
The decoder context is architecturally capped (448); decode shapes put the
long axis on the *encoder* side (cross-attention to S_frames states).
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_head=64,
    d_ff=5120,
    vocab_size=51_866,
    segments=((("encdec",), 32),),
    n_enc_layers=32,
    rope_kind="none",
    mlp_act="gelu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_head=32,
    d_ff=256,
    vocab_size=512,
    segments=((("encdec",), 2),),
    n_enc_layers=2,
    rope_kind="none",
    mlp_act="gelu",
)
