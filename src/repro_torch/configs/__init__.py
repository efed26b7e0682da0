"""Architecture registry of the port.

``get_config(name)`` returns the full config, ``get_smoke_config(name)``
the reduced same-family variant the CPU tests use. Every config of the
JAX package is ported: the served planner, the two MoE families
(arctic, kimi-k2), the hybrid attention + SSM hymba, the recurrent
xlstm, the dense qwen1.5, starcoder2 and gemma2, the vision-language
qwen2-vl (M-RoPE, patch embeddings) and the encoder-decoder whisper.
``ARCH_IDS`` are the ten assigned architectures (every config but the
planner), in the JAX package's order: the dry-run sweeps them.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("hymba-1.5b", "arctic-480b", "xlstm-125m", "starcoder2-3b",
            "qwen2-vl-72b", "whisper-large-v3", "qwen1.5-32b", "gemma2-2b",
            "kimi-k2-1t-a32b", "qwen1.5-110b")

ALL_IDS = ("planner-proxy-100m", "arctic-480b", "kimi-k2-1t-a32b",
           "hymba-1.5b", "xlstm-125m", "qwen1.5-32b", "qwen1.5-110b",
           "starcoder2-3b", "gemma2-2b", "qwen2-vl-72b", "whisper-large-v3")


def _module(name: str):
    if name not in ALL_IDS:
        raise ValueError(f"unknown architecture {name!r}; have {ALL_IDS}")
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE
