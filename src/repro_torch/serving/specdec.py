"""Speculative decoding: a draft model proposes K greedy tokens per slot,
the target verifies all of them in ONE forward.

Port of the JAX package's ``serving/specdec.py``. The protocol (wired
into ``InferenceEngine.step`` when the engine is built with
``spec_decode=SpecConfig(...)``):

  1. **draft**: K greedy single-token steps of the draft model over every
     slot (the draft keeps its own dense KV cache mirroring the target's
     per-slot fill levels);
  2. **verify**: ONE target ``verify_extend`` forward scores the carried
     last token plus the K proposals (W = K+1 rows per slot) against the
     target's dense or paged cache;
  3. **accept**: per slot, walk the W rows in order, sample the target's
     token for each position with the request's own sampler stream (the
     stream non-speculative decoding uses) and accept the proposal only
     if it EQUALS that sample. The first mismatch (or terminal token)
     stops the walk.

Every emitted token is the target sampler's own draw from logits that
are bitwise the decode logits (``verify_extend``'s rows are decode rows,
on the CPU and, through the flash_verify kernels, on the card), so the
emitted stream is identical to non-speculative decoding: at T=0
unconditionally, at any temperature for seeded requests. Rejected tokens
roll back by KV-length truncation (``set_pos``).

The draft runs K+1 decode steps per round when some slot accepted its
whole window: K to propose and one that writes the last proposal's KV
row (``catch_up``), so a fully accepted window leaves no hole in the
draft cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.perf import get_flags
from repro_torch.models.blocks import PURE_ATTENTION_KINDS
from repro_torch.models.model import Model, decode_step, init_cache, prefill

_SPEC_KINDS = set(PURE_ATTENTION_KINDS)


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs for ``InferenceEngine``.

    draft_cfg/draft_model: the draft model (any pure-attention stack; the
    launcher uses the target itself as a perfect-agreement stand-in,
    since the repo ships no trained draft). k: draft tokens proposed per
    round (a round emits between 1 and k+1 tokens)."""
    draft_cfg: ModelConfig
    draft_model: Model
    k: int = 4


def check_spec_stack(cfg: ModelConfig, what: str):
    """Raise unless ``cfg`` supports multi-token verify + rollback."""
    kinds = set(cfg.layer_kinds())
    if cfg.n_enc_layers or not kinds <= _SPEC_KINDS:
        raise ValueError(
            f"spec_decode {what} needs a pure-attention stack (kinds "
            f"within {sorted(_SPEC_KINDS)} and no encoder): recurrent "
            f"state cannot be rolled back by KV-length truncation; got "
            f"kinds {sorted(kinds)}")


class SpecDecoder:
    """Draft side of speculative decoding: the draft model, its dense KV
    cache (one slot per engine slot, same ``cache_len``) and its host
    fill levels. The draft cache holds KV for exactly the tokens the
    target cache holds (context minus the carried last token) and rolls
    back the same way (``set_pos``)."""

    def __init__(self, spec: SpecConfig, *, max_batch: int, cache_len: int,
                 metrics=None):
        if spec.k < 1:
            raise ValueError(f"spec_decode needs k >= 1, got {spec.k}")
        check_spec_stack(spec.draft_cfg, "draft model")
        self._c_draft = (metrics.counter("spec_draft_forwards")
                         if metrics else None)
        self._c_catchup = (metrics.counter("spec_catch_ups")
                           if metrics else None)
        self.cfg = spec.draft_cfg
        self.model = spec.draft_model
        self.k = spec.k
        self.cache_len = cache_len
        self.cache = init_cache(self.cfg, max_batch, cache_len,
                                self.model.device)
        self._pos = np.zeros((max_batch,), np.int32)
        self._catchup_tokens: Optional[torch.Tensor] = None

    def reset(self):
        """Back to the just-constructed state (storage reused; stale rows
        are masked by the zeroed fill levels)."""
        self._pos[:] = 0
        self._catchup_tokens = None

    # ------------------------------------------------------ admission ----
    def admit(self, slot: int, ctx_ids):
        """Prefill the draft over a request's context (its prompt, or
        prompt + output[:-1] when a preempted request resumes: the
        target's swap restores its KV but the draft's was dropped) and
        install it in ``slot``. Long contexts prefill on their
        chunk-aligned head and extend over the tail."""
        from repro_torch.serving.engine import _insert_slot, \
            advance_cache_through
        ids = list(ctx_ids)
        if not 0 < len(ids) < self.cache_len:
            raise ValueError(f"draft context of {len(ids)} tokens does not "
                             f"fit cache_len {self.cache_len}")
        align = get_flags().attn_chunk
        head = (ids if len(ids) <= align
                else ids[:(len(ids) // align) * align])
        logits, cache = prefill(self.model, {"tokens": [head]},
                                self.cache_len)
        _, cache = advance_cache_through(self.model, logits, cache,
                                         ids[len(head):],
                                         cache_len=self.cache_len)
        _insert_slot(self.cache, cache, slot)
        self._pos[slot] = len(ids)

    # ------------------------------------------------------- drafting ----
    def _step(self, tokens) -> torch.Tensor:
        self.cache["pos"] = torch.from_numpy(self._pos.copy())
        logits, self.cache = decode_step(self.model, self.cache,
                                         {"tokens": tokens})
        self._pos += 1
        return logits

    def draft(self, last_tokens: np.ndarray) -> np.ndarray:
        """K greedy draft steps over every slot (idle slots ride along,
        as in the target's decode). Returns the (B, k) proposals and
        stages the catch-up token; leaves the draft fill levels advanced
        by k (the engine then sets the accepted ones)."""
        toks = torch.as_tensor(last_tokens, device=self.model.device)
        outs = []
        if self._c_draft is not None:
            self._c_draft.inc(self.k)
        for _ in range(self.k):
            toks = torch.argmax(self._step(toks), dim=-1)[:, None]
            outs.append(toks)
        self._catchup_tokens = toks
        return torch.cat(outs, dim=1).cpu().numpy()

    def catch_up(self):
        """Write the last proposal's KV row (one extra draft step, logits
        discarded). Needed only when some slot accepted its whole window;
        harmless for the others (the row lands past their truncated fill
        level and is overwritten before it becomes visible)."""
        if self._c_catchup is not None:
            self._c_catchup.inc()
        self._step(self._catchup_tokens)

    def set_pos(self, new_pos: np.ndarray):
        """Adopt the target's post-acceptance fill levels: the KV-length
        truncation that rolls back rejected draft rows."""
        self._pos = np.asarray(new_pos, np.int32).copy()
