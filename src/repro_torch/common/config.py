"""Configuration dataclasses of the PyTorch port (a copy of the JAX
package's ``common/config.py``, kept in step with it by hand).

Every architecture in ``repro_torch.configs`` instantiates a :class:`ModelConfig`.
The config fully determines parameter shapes, the layer stack (as *segments*
of repeated layer-kind units, so heterogeneous stacks like Gemma-2's
local/global alternation or Hymba's sparse global-attention layers can be
run as one repeated unit), and serving-time cache shapes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer kinds understood by models/blocks.py
#   "full"    - full causal self-attention + MLP
#   "local"   - sliding-window causal self-attention + MLP
#   "moe"     - full attention + mixture-of-experts FFN (optionally + dense residual)
#   "dense"   - full attention + dense FFN inside an otherwise-MoE model
#   "hymba_g" - Hymba block (parallel attn + mamba heads), global attention
#   "hymba_w" - Hymba block, sliding-window attention
#   "mlstm"   - xLSTM matrix-LSTM block (attention-free)
#   "slstm"   - xLSTM scalar-LSTM block (attention-free, sequential)
#   "encdec"  - decoder block with self-attn + cross-attn + MLP (whisper)
ATTENTION_KINDS = ("full", "local", "moe", "dense", "hymba_g", "hymba_w", "encdec")
WINDOW_KINDS = ("local", "hymba_w")
SSM_KINDS = ("hymba_g", "hymba_w", "mlstm", "slstm")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                      # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    dense_residual_ff: int = 0         # Arctic-style parallel dense FFN (0 = off)
    shared_expert_ff: int = 0          # Kimi/DeepSeek-style always-on shared expert
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 1                    # d_inner = expand * d_model
    dt_rank: int = 0                   # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    # mLSTM / sLSTM head geometry; heads share the model-level n_heads.
    chunk_size: int = 64               # chunkwise-parallel mLSTM chunk length
    proj_factor: float = 2.0           # mLSTM up-projection factor


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                    # 0 -> d_model // n_heads

    # Layer stack: ((unit_kinds, n_repeat), ...). Total layers must equal
    # n_layers (encoder layers counted separately for enc-dec models).
    segments: Tuple[Tuple[Tuple[str, ...], int], ...] = ()

    # Attention details
    rope_theta: float = 10_000.0
    rope_kind: str = "rope"            # rope | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # t/h/w split of d_head//2
    window: int = 4096                 # sliding-window size for WINDOW_KINDS
    attn_softcap: float = 0.0          # gemma2: 50.0
    final_softcap: float = 0.0         # gemma2: 30.0
    qkv_bias: bool = False             # qwen1.5 family
    attn_scale: float = 0.0            # 0 -> 1/sqrt(d_head)

    # FFN
    mlp_act: str = "silu_glu"          # silu_glu | gelu_glu | gelu
    # Mixtures / SSM / xLSTM
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # Enc-dec (whisper): n_enc_layers encoder layers of full non-causal attn.
    n_enc_layers: int = 0
    # VLM (qwen2-vl): number of prefix positions fed as patch embeddings.
    n_vision_tokens: int = 0

    # Embeddings / head
    tie_embeddings: bool = True
    emb_scale_by_sqrt_d: bool = False  # gemma-style embedding scaling

    # Numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # Serving
    long_context_ok: bool = False      # eligible for long_500k (sub-quadratic)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if not self.segments:
            kind = {"moe": "moe"}.get(self.family, "full")
            object.__setattr__(self, "segments", (((kind,), self.n_layers),))
        total = sum(len(unit) * rep for unit, rep in self.segments)
        assert total == self.n_layers, (
            f"{self.name}: segments cover {total} layers, expected {self.n_layers}")
        assert self.n_heads % self.n_kv_heads == 0 or self.n_kv_heads > self.n_heads, (
            f"{self.name}: n_heads={self.n_heads} not divisible by kv={self.n_kv_heads}")

    # ---- derived quantities -------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def layer_kinds(self) -> Tuple[str, ...]:
        out = []
        for unit, rep in self.segments:
            out.extend(list(unit) * rep)
        return tuple(out)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}
