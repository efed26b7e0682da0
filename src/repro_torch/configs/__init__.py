"""Architecture registry of the port.

``get_config(name)`` returns the full config, ``get_smoke_config(name)``
the reduced same-family variant the CPU tests use. The served planner,
the two MoE families (arctic, kimi-k2), the hybrid attention + SSM
hymba and the recurrent xlstm are ported; the other architectures come
with their model families (ROADMAP.md, queue A12).
"""
from __future__ import annotations

import importlib

ALL_IDS = ("planner-proxy-100m", "arctic-480b", "kimi-k2-1t-a32b",
           "hymba-1.5b", "xlstm-125m")


def _module(name: str):
    if name not in ALL_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ROADMAP.md queue "
            f"A12); have {ALL_IDS}")
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE
