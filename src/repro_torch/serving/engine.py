"""Inference engine: prefill + continuous-batching decode (dense KV).

Port of the JAX package's ``serving/engine.py`` for ``kv_mode="dense"``.
A fixed pool of ``max_batch`` slots shares one batched cache with
per-slot positions (the (B,) ``pos`` vector, so every slot can sit at its
own fill level). Requests are prefilled on arrival (B=1) and their caches
copied into a free slot; one ``decode_step`` advances every active slot.

  * **prompt-prefix caching** — ``register_prefix`` prefills a shared
    prompt prefix once; requests tagged with its ``prefix_key`` extend a
    copy of the cached prefill with their suffix instead of recomputing
    the prefix;
  * **sessions** — ``open_session`` multiplexes the turns of one
    conversation over the shared slots;
  * **chunked prefill** — ``prefill_budget`` splits admission prefill
    into ``attn_chunk``-aligned slabs (``prefill_extend``), at most
    ``max(1, prefill_budget // attn_chunk)`` per step, interleaved with
    decode (``interleave=False`` runs them to completion first);
    ``admission`` orders the queue: ``"fifo"`` or ``"slack"``.

The port updates caches in place where the JAX package returns new
arrays: an admission copies its B=1 cache into its slot, and a prefix hit
clones the registered prefix cache before extending it, so the prefix
stays intact for the next hit. Host-side state (per-slot positions, last
tokens) lives in numpy and goes to the device once per step.

Not ported yet: ``kv_mode="paged"`` and ``spec_decode`` (ROADMAP.md queue
A4/A5); the constructor raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.perf import get_flags
from repro_torch.models.model import Model, decode_step, init_cache, \
    prefill, prefill_extend
from repro_torch.obs import NULL_TRACER, MetricsRegistry, StatsView
from repro_torch.serving.sampling import SamplerConfig, request_generator, \
    sample
from repro_torch.serving.sched import AdmissionQueue, deadline_step
from repro_torch.serving.tokenizer import SPECIALS, TOKENIZER

KV_MODES = ("dense", "paged")

# The engine's counter surface, the JAX engine's keys (same semantics;
# the paged and speculative counters stay 0 until those modes are ported).
ENGINE_STAT_KEYS = (
    "decode_steps", "prefills", "tokens_generated", "prefix_hits",
    "prefix_tokens_saved", "admissions", "prefix_registrations",
    "preemptions", "resumes", "prefix_evictions", "prefill_chunks",
    "stall_ticks", "sla_expired", "spec_rounds", "spec_drafted",
    "spec_accepted")


@dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int = 32
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    prefix_key: Optional[str] = None
    session_id: Optional[int] = None
    # SLA deadline budget in engine steps (ticks) from enqueue; None =
    # no deadline. Drives slack admission order and queued-expiry drops.
    sla_ticks: Optional[int] = None
    # filled by the engine:
    output: List[int] = field(default_factory=list)
    done: bool = False
    # "eos" | "max_new_tokens" | "cache_len" | "sla_expired"
    finish_reason: Optional[str] = None
    enqueue_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    # tick stamps (engine step numbers)
    enqueue_step: int = 0
    admit_step: Optional[int] = None
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None


@dataclass
class CachedPrefix:
    ids: List[int]
    cache: dict            # B=1 prefilled cache (int pos); never mutated
    logits: torch.Tensor   # (1,V) logits after the prefix's last token


@dataclass
class PendingPrefill:
    """An admission whose prefill is in flight under ``prefill_budget``:
    the request owns its slot from admission; its B=1 cache advances one
    chunk at a time across steps. The first token is sampled, and the
    cache copied into the slot, when the last chunk lands."""
    req: Request
    slot: int
    toks: List[int]                  # full prompt ids
    i: int                           # ids already in the cache
    logits: Optional[torch.Tensor]   # (1,V) after toks[:i]; None pre-head
    cache: Optional[dict]            # B=1 cache; None pre-head


def _clone_cache(cache: dict) -> dict:
    return {"layers": [{k: t.clone() for k, t in c.items()}
                       for c in cache["layers"]],
            "pos": cache["pos"]}


def _insert_slot(batched: dict, single: dict, slot: int) -> None:
    """Copy a B=1 cache into slot ``slot`` of the batched cache, in place
    (the JAX package's ``_insert_slot``)."""
    for b, s in zip(batched["layers"], single["layers"]):
        for key, leaf in b.items():
            leaf[slot:slot + 1].copy_(s[key])


def advance_cache_through(model: Model, logits, cache, tokens, *,
                          cache_len: int):
    """Advance a B=1 cache through new tokens with ``prefill_extend``:
    whole ``attn_chunk`` slabs, then one bucket-padded call for the rest
    (pad width capped at the cache end). Returns (last-token logits
    (1,V), the extended cache)."""
    toks = list(tokens)
    if not toks:
        return logits, cache
    align = get_flags().attn_chunk
    i = 0
    while len(toks) - i >= align:
        logits, cache = prefill_extend(model, cache,
                                       {"tokens": [toks[i:i + align]]}, align)
        i += align
    rest = toks[i:]
    if rest:
        n = len(rest)
        room = cache_len - int(cache["pos"])
        if n < room:
            width = min(1 << (n - 1).bit_length(), room)
            rest = rest + [0] * (width - n)
        logits, cache = prefill_extend(model, cache, {"tokens": [rest]}, n)
    return logits, cache


def _kv_cache_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size()
               for c in cache["layers"] for t in c.values())


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, model: Model, *, max_batch: int = 8,
                 cache_len: int = 512, seed: int = 0, kv_mode: str = "dense",
                 kv_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 spec_decode=None,
                 prefill_budget: Optional[int] = None,
                 interleave: bool = True,
                 admission: str = "fifo",
                 clock: Optional[Callable[[], float]] = None,
                 tracer=None, metrics: Optional[MetricsRegistry] = None):
        if kv_mode not in KV_MODES:
            raise ValueError(f"kv_mode must be one of {KV_MODES}, "
                             f"got {kv_mode!r}")
        if kv_mode == "paged":
            raise NotImplementedError(
                "kv_mode='paged' is not ported yet (ROADMAP.md queue A4, "
                "kernel B3)")
        if spec_decode is not None:
            raise NotImplementedError(
                "spec_decode is not ported yet (ROADMAP.md queue A5, "
                "kernel B4)")
        if kv_blocks is not None or block_size is not None:
            raise ValueError("kv_blocks/block_size apply only to "
                             "kv_mode='paged'")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(f"prefill_budget must be >= 1 token per "
                             f"step, got {prefill_budget}")
        self.cfg = cfg
        self.model = model
        self.device = model.device
        # latency stamps come from an injected clock (zero by default)
        self._clock: Callable[[], float] = clock or (lambda: 0.0)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.tracer.bind_clock(clock)
        self.trace_group: int = 0
        self._req_spans: Dict[int, int] = {}
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.kv_mode = kv_mode
        self.seed = seed
        self.rng = torch.Generator().manual_seed(seed)
        self.cache = init_cache(cfg, max_batch, cache_len, self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.admission = admission
        self.queue = AdmissionQueue(admission, metrics=self.metrics)
        self.interleave = interleave
        self.prefill_budget = prefill_budget
        self.step_no = 0
        self._pending: Dict[int, PendingPrefill] = {}
        self._pending_rr: deque = deque()
        self.prefixes: Dict[str, CachedPrefix] = {}
        self._next_id = 0
        self._next_session = 0
        self.stats = StatsView(self.metrics, ENGINE_STAT_KEYS)
        self._kv_bytes_total = _kv_cache_bytes(self.cache)
        self._kv_peak_slots = 0
        # host mirrors of the per-slot fill levels and carried tokens
        self._pos = np.zeros((max_batch,), np.int32)
        self._last_tokens = np.zeros((max_batch, 1), np.int64)

    # ------------------------------------------------------------- API ----
    def add_request(self, prompt_text_or_ids, max_new_tokens: int = 32,
                    sampler: SamplerConfig = SamplerConfig(),
                    prefix_key: Optional[str] = None,
                    session_id: Optional[int] = None,
                    sla_ticks: Optional[int] = None) -> int:
        ids = (TOKENIZER.encode_with_specials(prompt_text_or_ids)
               if isinstance(prompt_text_or_ids, str)
               else list(prompt_text_or_ids))
        req = Request(self._next_id, ids, max_new_tokens, sampler,
                      prefix_key=prefix_key, session_id=session_id,
                      sla_ticks=sla_ticks, enqueue_t=self._clock(),
                      enqueue_step=self.step_no)
        self._next_id += 1
        if self.tracer.enabled:
            self.tracer.event("enqueue", tick=self.step_no,
                              group=self.trace_group, lane="queue",
                              request=req.request_id,
                              prompt_tokens=len(ids))
        self.queue.push(req)
        return req.request_id

    def busy_slots(self) -> int:
        return sum(s is not None for s in self.slots)

    def free_slot_count(self) -> int:
        return self.max_batch - self.busy_slots()

    def queue_depth(self) -> int:
        return len(self.queue)

    def load(self) -> int:
        return self.busy_slots() + len(self.queue)

    def is_idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

    @property
    def spec_k(self) -> int:
        return 0

    def reset(self, seed: Optional[int] = None):
        """Return the engine to its just-constructed state. Cache storage
        is reused: stale rows are masked by the zeroed positions and
        overwritten at the next admission."""
        if seed is not None:
            self.seed = seed
        self.rng = torch.Generator().manual_seed(self.seed)
        self.metrics.reset()
        self._req_spans.clear()
        self._pos[:] = 0
        self._last_tokens[:] = 0
        self.slots = [None] * self.max_batch
        self.queue.clear()
        self._pending.clear()
        self._pending_rr.clear()
        self.step_no = 0
        self.prefixes.clear()
        self._next_id = 0
        self._next_session = 0
        self._kv_peak_slots = 0

    # -------------------------------------------------- prefix caching ----
    def register_prefix(self, key: str, prefix_text_or_ids) -> int:
        """Prefill a shared prompt prefix ONCE and cache the result;
        returns its length in tokens. Text prefixes are encoded as <bos> +
        tokens (no <eos>). A prefix longer than one attention chunk is
        prefilled on its chunk-aligned head and extended over the tail,
        the JAX engine's split."""
        ids = ([SPECIALS["<bos>"]] + TOKENIZER.encode(prefix_text_or_ids)
               if isinstance(prefix_text_or_ids, str)
               else list(prefix_text_or_ids))
        if len(ids) >= self.cache_len:
            raise ValueError(f"prefix of {len(ids)} tokens does not fit "
                             f"cache_len {self.cache_len}")
        align = get_flags().attn_chunk
        head = (ids if len(ids) <= align
                else ids[:(len(ids) // align) * align])
        logits, cache = prefill(self.model, {"tokens": [head]},
                                self.cache_len)
        self.stats["prefills"] += 1
        self.stats["prefix_registrations"] += 1
        logits, cache = self._decode_through(logits, cache, ids[len(head):])
        self.prefixes[key] = CachedPrefix(ids, cache, logits)
        return len(ids)

    def _decode_through(self, logits, cache, tokens: List[int]
                        ) -> Tuple[torch.Tensor, dict]:
        return advance_cache_through(self.model, logits, cache, tokens,
                                     cache_len=self.cache_len)

    def _extend_prefix(self, pref: CachedPrefix, suffix: List[int]
                       ) -> Tuple[torch.Tensor, dict]:
        """Advance a copy of a cached prefix through the suffix tokens."""
        return self._decode_through(pref.logits, _clone_cache(pref.cache),
                                    suffix)

    def _note_kv_peak(self):
        self._kv_peak_slots = max(self._kv_peak_slots, self.busy_slots())

    # ------------------------------------------------------- sessions ----
    def open_session(self, prefix_key: Optional[str] = None,
                     session_id: Optional[int] = None) -> "EngineSession":
        if session_id is None:
            session_id = self._next_session
            self._next_session += 1
        return EngineSession(self, session_id, prefix_key)

    # ---------------------------------------------------- scheduling ----
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _request_gen(self, req: Request) -> torch.Generator:
        """Generator for the request's next token: the engine stream, or
        the request's own (seed, token index) stream when seeded."""
        if req.sampler.seed is None:
            return self.rng
        return request_generator(req.sampler.seed, len(req.output))

    def _prefix_hit(self, req: Request) -> Optional[CachedPrefix]:
        pref = (self.prefixes.get(req.prefix_key)
                if req.prefix_key else None)
        if pref is not None and len(req.prompt) > len(pref.ids) and \
                len(req.prompt) < self.cache_len and \
                req.prompt[:len(pref.ids)] == pref.ids:
            return pref
        return None

    def _prefill_request(self, req: Request):
        """Admission logits + B=1 cache, via the prefix cache on a hit."""
        pref = self._prefix_hit(req)
        if pref is not None:
            logits, cache1 = self._extend_prefix(
                pref, req.prompt[len(pref.ids):])
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_saved"] += len(pref.ids)
            return logits, cache1
        logits, cache1 = prefill(self.model, {"tokens": [req.prompt]},
                                 self.cache_len)
        self.stats["prefills"] += 1
        return logits, cache1

    def _trace_admit(self, req: Request, slot: int):
        if not self.tracer.enabled:
            return
        self.tracer.event("admit", tick=self.step_no,
                          group=self.trace_group, lane="queue",
                          request=req.request_id, slot=slot)
        self._req_spans[req.request_id] = self.tracer.begin(
            "request", tick=self.step_no, group=self.trace_group,
            lane=slot, request=req.request_id,
            prompt_tokens=len(req.prompt), resumed=False)

    def _finish_now(self, req: Request, reason: str):
        req.done = True
        req.finish_reason = reason
        req.finish_t = self._clock()
        req.finish_step = self.step_no
        if not req.first_token_t:
            req.first_token_t = req.finish_t
        if req.first_token_step is None:
            req.first_token_step = req.finish_step
        h = self._req_spans.pop(req.request_id, None)
        if h is not None:
            self.tracer.end(h, tick=self.step_no, reason=reason,
                            tokens=len(req.output))
        elif self.tracer.enabled:
            self.tracer.event(
                "sla_expired" if reason == "sla_expired" else "finish",
                tick=self.step_no, group=self.trace_group, lane="queue",
                request=req.request_id, reason=reason)

    def _first_token(self, req: Request, logits) -> bool:
        """Sample the admission token; True when it is terminal."""
        tok = int(sample(logits, self._request_gen(req), req.sampler)[0])
        req.output.append(tok)
        req.first_token_t = self._clock()
        req.first_token_step = self.step_no
        if self.tracer.enabled:
            h = self._req_spans.get(req.request_id)
            lane = self.tracer.lane_of(h) if h is not None else None
            self.tracer.event("first_token", tick=self.step_no,
                              group=self.trace_group,
                              lane="queue" if lane is None else lane,
                              request=req.request_id)
        if tok == SPECIALS["<eos>"] or \
                len(req.output) >= req.max_new_tokens:
            self._finish_now(req, "eos" if tok == SPECIALS["<eos>"]
                             else "max_new_tokens")
            return True
        return False

    def _drop_expired(self) -> List[Request]:
        """Drop fresh queue heads whose SLA deadline has passed."""
        dropped: List[Request] = []
        while self.queue:
            req = self.queue.peek()
            if req.output or self.step_no < deadline_step(req):
                break
            self.queue.pop()
            self._finish_now(req, "sla_expired")
            self.stats["sla_expired"] += 1
            dropped.append(req)
        return dropped

    def _install(self, slot: int, req: Request, cache1: dict):
        _insert_slot(self.cache, cache1, slot)
        self._pos[slot] = len(req.prompt)
        self.slots[slot] = req
        self._last_tokens[slot, 0] = req.output[-1]

    def _admit(self) -> List[Request]:
        """Prefill queued requests into free slots (or, under
        ``prefill_budget``, start their chunked prefills); returns the
        ones whose admission token was terminal plus expired drops."""
        finished: List[Request] = self._drop_expired()
        free = deque(self._free_slots())
        while free and self.queue:
            slot = free[0]
            req = self.queue.pop()
            if self.prefill_budget is not None and \
                    len(req.prompt) >= self.cache_len:
                # a chunk-by-chunk replay cannot reproduce the clamped
                # overflow write of a truncated monolithic prefill
                self._finish_now(req, "cache_len")
                finished.append(req)
                continue
            self.stats["admissions"] += 1
            req.admit_step = self.step_no
            self._trace_admit(req, slot)
            if self.prefill_budget is not None:
                free.popleft()
                self._start_pending(slot, req, self._prefix_hit(req))
                continue
            logits, cache1 = self._prefill_request(req)
            if self._first_token(req, logits):
                finished.append(req)
                continue
            free.popleft()
            self._install(slot, req, cache1)
        return finished

    def _start_pending(self, slot: int, req: Request,
                       pref: Optional[CachedPrefix]):
        i, logits, cache = 0, None, None
        if pref is not None:
            i = len(pref.ids)
            logits = pref.logits
            cache = _clone_cache(pref.cache)
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_saved"] += i
        else:
            self.stats["prefills"] += 1
        self.slots[slot] = req
        self._pending[slot] = PendingPrefill(
            req=req, slot=slot, toks=list(req.prompt), i=i,
            logits=logits, cache=cache)
        self._pending_rr.append(slot)

    def _advance_pending(self, p: PendingPrefill, chunks: int) -> int:
        """Spend up to ``chunks`` attn_chunk slabs on one pending prefill;
        the same prefill/prefill_extend sequence ``advance_cache_through``
        issues, spread across steps. Returns the slabs consumed."""
        align = get_flags().attn_chunk
        spent = 0
        while spent < chunks and p.i < len(p.toks):
            rem = len(p.toks) - p.i
            if p.cache is None:
                n = min(rem, align)
                p.logits, p.cache = prefill(
                    self.model, {"tokens": [p.toks[:n]]}, self.cache_len)
                p.i = n
            elif rem >= align:
                p.logits, p.cache = prefill_extend(
                    self.model, p.cache,
                    {"tokens": [p.toks[p.i:p.i + align]]}, align)
                p.i += align
            else:
                rest = p.toks[p.i:]
                room = self.cache_len - int(p.cache["pos"])
                if rem < room:
                    width = min(1 << (rem - 1).bit_length(), room)
                    rest = rest + [0] * (width - rem)
                p.logits, p.cache = prefill_extend(
                    self.model, p.cache, {"tokens": [rest]}, rem)
                p.i = len(p.toks)
            spent += 1
        self.stats["prefill_chunks"] += spent
        if spent and self.tracer.enabled:
            self.tracer.event("prefill_chunk", tick=self.step_no,
                              group=self.trace_group, lane=p.slot,
                              request=p.req.request_id, chunks=spent,
                              done_tokens=p.i)
        return spent

    def _complete_pending(self, slot: int) -> Optional[Request]:
        p = self._pending.pop(slot)
        req = p.req
        if self._first_token(req, p.logits):
            self.slots[slot] = None
            return req
        self._install(slot, req, p.cache)
        return None

    def _advance_pendings(self) -> List[Request]:
        """Spend this step's ``max(1, prefill_budget // attn_chunk)``
        slabs over pending prefills in deficit round-robin (one chunk per
        turn); a prefill that finishes joins this step's decode."""
        allowance = max(1, self.prefill_budget // get_flags().attn_chunk)
        finished: List[Request] = []
        while allowance > 0 and self._pending_rr:
            slot = self._pending_rr[0]
            p = self._pending[slot]
            allowance -= self._advance_pending(p, 1)
            if p.i >= len(p.toks):
                self._pending_rr.popleft()
                done = self._complete_pending(slot)
                if done is not None:
                    finished.append(done)
            else:
                self._pending_rr.rotate(-1)
        return finished

    def step(self) -> List[Request]:
        """One engine iteration: admit, advance pending chunked prefills,
        then decode one token for every active slot (skipped while any
        prefill is pending when ``interleave=False``). Returns newly
        finished requests."""
        finished = self._step_once()
        self.step_no += 1
        return finished

    def _step_once(self) -> List[Request]:
        finished = self._admit()
        self._note_kv_peak()
        if self._pending:
            finished.extend(self._advance_pendings())
        stalled = not self.interleave and bool(self._pending)
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i not in self._pending]
        if not active:
            return finished
        if stalled:
            self.stats["stall_ticks"] += 1
            if self.tracer.enabled:
                self.tracer.event("stall", tick=self.step_no,
                                  group=self.trace_group, lane="engine",
                                  pending=len(self._pending))
            return finished
        self.cache["pos"] = torch.as_tensor(self._pos, device=self.device)
        logits, self.cache = decode_step(
            self.model, self.cache,
            {"tokens": torch.as_tensor(self._last_tokens,
                                       device=self.device)})
        # every slot advances, idle ones included (the JAX pos + 1)
        self._pos += 1
        self.stats["decode_steps"] += 1
        if self.tracer.enabled:
            self.tracer.event("decode", tick=self.step_no,
                              group=self.trace_group, lane="engine",
                              active=len(active))
        greedy = torch.argmax(logits, dim=-1).tolist()
        for i in active:
            req = self.slots[i]
            if req.sampler.temperature <= 0.0:
                tok = greedy[i]
            else:
                tok = int(sample(logits[i:i + 1], self._request_gen(req),
                                 req.sampler)[0])
            req.output.append(tok)
            self.stats["tokens_generated"] += 1
            self._last_tokens[i, 0] = tok
            hit_cap = len(req.output) >= req.max_new_tokens
            hit_len = int(self._pos[i]) + 1 >= self.cache_len - 1
            if tok == SPECIALS["<eos>"] or hit_cap or hit_len:
                self._finish_now(req, "eos" if tok == SPECIALS["<eos>"]
                                 else "max_new_tokens" if hit_cap
                                 else "cache_len")
                finished.append(req)
                self.slots[i] = None
                self._pos[i] = 0
        return finished

    def run_until_done(self, max_iters: int = 10_000) -> List[Request]:
        done: List[Request] = []
        it = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and it < max_iters:
            done.extend(self.step())
            it += 1
        return done

    def throughput_stats(self) -> Dict[str, float]:
        st = {**self.stats, **self.kv_memory_stats()}
        st["tokens_per_step"] = round(
            st["tokens_generated"] / max(st["decode_steps"], 1), 4)
        st["spec_accept_rate"] = 0.0
        st["spec_k"] = self.spec_k
        return st

    def kv_memory_stats(self) -> Dict:
        """Dense KV accounting: the full (max_batch, cache_len) slab is
        allocated; live requests hold one slot each."""
        per_slot = self._kv_bytes_total // max(self.max_batch, 1)
        return {"kv_mode": "dense",
                "kv_bytes_allocated": self._kv_bytes_total,
                "kv_bytes_in_use": self.busy_slots() * per_slot,
                "kv_bytes_peak": self._kv_peak_slots * per_slot,
                "kv_blocks_total": 0, "kv_blocks_used": 0,
                "kv_blocks_free": 0, "kv_blocks_shared": 0,
                "kv_blocks_owned": 0, "kv_blocks_used_peak": 0,
                "kv_blocks_shared_peak": 0, "kv_shared_frac": 0.0}


@dataclass
class EngineSession:
    """One conversation multiplexed over the engine's slots: each turn is
    one request tagged with the session's ``prefix_key``."""
    engine: InferenceEngine
    session_id: int
    prefix_key: Optional[str] = None
    pending: List[int] = field(default_factory=list)
    turns: List[Request] = field(default_factory=list)

    def submit_turn(self, text: str, max_new_tokens: int = 16,
                    sampler: SamplerConfig = SamplerConfig()) -> int:
        rid = self.engine.add_request(text, max_new_tokens, sampler,
                                      prefix_key=self.prefix_key,
                                      session_id=self.session_id)
        self.pending.append(rid)
        return rid

    def collect(self, finished: List[Request]) -> List[Request]:
        mine = [r for r in finished if r.session_id == self.session_id
                and r.request_id in self.pending]
        for r in mine:
            self.pending.remove(r.request_id)
            self.turns.append(r)
        return mine

    @property
    def idle(self) -> bool:
        return not self.pending
