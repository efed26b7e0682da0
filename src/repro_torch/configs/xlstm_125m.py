"""xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517] (a copy of the
JAX package's config).

12L d_model=768 4H (kv=4, attention-free — heads are xLSTM heads)
d_ff=0 (FFN folded into the block up/down projections) vocab=50304.
Block ratio follows the paper's mostly-mLSTM mix: unit = 3×mLSTM + 1×sLSTM.
The mLSTM's inner width is d·proj_factor/2 = 768, so its heads are 192
wide (32 in the smoke config).
"""
from repro_torch.common.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    segments=((("mlstm", "mlstm", "mlstm", "slstm"), 3),),
    xlstm=XLSTMConfig(chunk_size=64, proj_factor=2.0),
    rope_kind="none",
    tie_embeddings=True,
    long_context_ok=True,   # pure recurrent state
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    segments=((("mlstm", "slstm"), 1),),
    xlstm=XLSTMConfig(chunk_size=16, proj_factor=2.0),
    rope_kind="none",
    long_context_ok=True,
)
