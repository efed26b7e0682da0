"""Performance flags the port reads.

Three knobs of the JAX package's ``common/perf.py`` are carried over: the
attention q-chunk length (the engine aligns chunked prefill and prefix
registration to it, exactly as the JAX engine does, so both split a
prompt at the same seams), the MoE capacity-factor override, and the MoE
dispatch. ``moe_dispatch`` ``"einsum"`` and ``"gather"`` both select the
port's one dispatch (``models/moe.py``), which computes the function of
either; ``"shard_map"`` selects the expert-parallel dispatch under a mesh
with a ``model`` axis (``models/moe.py:_dispatch_ep``).

The other knobs of the JAX package choose between jnp or GSPMD
formulations that the port does not have; ``JAX_ONLY_FLAGS`` names each
with the reason. ``apply_overrides`` refuses them, and the dry-run
records a profile's fragments of them as not applied
(``split_overrides``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

MOE_DISPATCHES = ("einsum", "gather", "shard_map")

#: the JAX package's knobs that have no counterpart here, and why
JAX_ONLY_FLAGS: Dict[str, str] = {
    "ssm_scan_chunk": "chunk of the JAX reference's associative scan; the "
                      "port's selective scan is sequential (one kernel)",
    "ssm_scan_dtype": "dtype of the JAX reference's in-chunk scan "
                      "elements; the port's scan runs in fp32",
    "attn_probs_dtype": "dtype of the jnp attention's probabilities; the "
                        "port's attention is one kernel (fp32 softmax)",
    "attn_chunk_remat": "remat of the jnp attention's q-chunks; the "
                        "port's attention backward is a kernel that "
                        "recomputes its probabilities",
    "attn_window_slice": "K/V band slicing of the jnp attention; the "
                         "port's kernel skips the tiles outside the window",
    "moe_constraint": "GSPMD pins on the one-hot MoE einsums; the port "
                      "has no einsum dispatch and no GSPMD",
    "kernel_backend": "the JAX package's reference/pallas switch; the "
                      "port dispatches by device (kernels/backend.py)",
    "attn_constraint": "GSPMD may leave attention unpinned; under a mesh "
                       "the port always gives the kernel a definite "
                       "per-rank layout (distributed/annotate.py)",
}


@dataclass(frozen=True)
class PerfFlags:
    # chunked-prefill slab width (tokens) and prefix-head alignment
    attn_chunk: int = 1024
    # override the per-arch MoE capacity factor (0.0 = use the config's)
    moe_capacity_factor: float = 0.0
    # "einsum" | "gather" (the one dispatch) | "shard_map" (expert
    # parallel under a mesh with a model axis)
    moe_dispatch: str = "einsum"

    def apply_overrides(self, spec: str) -> "PerfFlags":
        """'attn_chunk=4096,moe_dispatch=shard_map' -> new flags. An
        unknown name raises, and so does a name of ``JAX_ONLY_FLAGS``
        (with its reason)."""
        out = self
        for k, v in _fragments(spec):
            if k in JAX_ONLY_FLAGS:
                raise ValueError(f"perf flag {k!r} is the JAX package's "
                                 f"only: {JAX_ONLY_FLAGS[k]}")
            if not hasattr(self, k):
                raise ValueError(f"unknown perf flag {k!r} (have "
                                 f"{[f.name for f in dataclasses.fields(self)]})")
            cur = getattr(self, k)
            val = (int(v) if isinstance(cur, int)
                   else float(v) if isinstance(cur, float) else v)
            if k == "moe_dispatch" and val not in MOE_DISPATCHES:
                raise ValueError(f"moe_dispatch {val!r} (have "
                                 f"{MOE_DISPATCHES})")
            out = dataclasses.replace(out, **{k: val})
        return out


def _fragments(spec: str):
    """[(name, value)] of a 'k=v,k=v' spec."""
    out = []
    for kv in (spec or "").split(","):
        if kv.strip():
            k, v = kv.split("=")
            out.append((k.strip(), v.strip()))
    return out


def split_overrides(spec: str) -> Tuple[str, Dict[str, dict]]:
    """(the spec without its ``JAX_ONLY_FLAGS`` fragments, {name:
    {"value", "reason"}} of those fragments; a later fragment of a name
    wins, as in ``apply_overrides``)."""
    kept, dropped = [], {}
    for k, v in _fragments(spec):
        if k in JAX_ONLY_FLAGS:
            dropped[k] = {"value": v, "reason": JAX_ONLY_FLAGS[k]}
        else:
            kept.append(f"{k}={v}")
    return ",".join(kept), dropped


FLAGS = PerfFlags()


def set_flags(flags: PerfFlags):
    global FLAGS
    FLAGS = flags


def get_flags() -> PerfFlags:
    return FLAGS
