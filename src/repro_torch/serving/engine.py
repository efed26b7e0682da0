"""Inference engine: prefill + continuous-batching decode.

Port of the JAX package's ``serving/engine.py``. A fixed pool of
``max_batch`` slots shares one batched cache with per-slot positions (the
(B,) ``pos`` vector, so every slot can sit at its own fill level).
Requests are prefilled on arrival (B=1) and their caches copied into a
free slot; one ``decode_step`` advances every active slot.

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

``kv_mode`` selects the KV-cache memory manager:

  * ``"dense"`` (default): one (max_batch, cache_len) slab; admission
    copies the request's prefill (and any cached prefix) into its slot;
  * ``"paged"``: a fixed budget of ``kv_blocks`` blocks of ``block_size``
    rows (serving/kvpool.py) with per-slot block tables. A registered
    prefix's blocks are CoW-shared by every admission (refcount++, zero
    copies), admission waits for free blocks, cold prefix pins are
    LRU-evicted under pressure and the lowest-priority running request
    is preempted and requeued (a bit-exact host copy of its rows)
    instead of dropped. Dense and paged decode are bitwise identical.

``spec_decode`` (a ``serving/specdec.py`` SpecConfig) turns on
draft-verify speculative decoding: every step drafts K greedy tokens per
slot and verifies them in ONE target ``verify_extend`` forward, emitting
1..K+1 tokens per slot, bitwise the tokens of non-speculative decoding
(T=0 always; any temperature for seeded requests), in both kv modes.

A stack with sliding-window rings (hymba) cannot extend a cache by
several tokens at once (the JAX engine's ``_can_extend``): its prefix
tails and prefix-hit suffixes advance token by token through
``decode_step``, and ``prefill_budget`` is refused. A recurrent stack
without rings (xlstm) extends in whole ``attn_chunk`` slabs plus one
unpadded rest, and takes ``prefill_budget``: bucket-padded extends
(``_pad_extend``) need a pure-attention stack, since recurrent state
would step through the pads. Paged KV and speculative decoding need a
pure-attention stack.

The port updates caches in place where the JAX package returns new
arrays: an admission copies its B=1 cache into its slot (dense) or its
blocks (paged), every leaf of it, a hymba layer's SSM state and an xLSTM
layer's state tuple or dict included, so a recycled slot never sees its
last tenant's state; a prefix hit clones the registered prefix cache
(every leaf) before extending it, so the prefix stays intact for the
next hit.
Host-side state (per-slot positions, last tokens, the block table) lives
in numpy; positions and the table go to the device once per step.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import WINDOW_KINDS, ModelConfig
from repro_torch.common.perf import get_flags
from repro_torch.models.blocks import PURE_ATTENTION_KINDS
from repro_torch.models.model import Model, decode_step, init_cache, \
    init_paged_cache, prefill, prefill_extend, verify_extend
from repro_torch.obs import NULL_TRACER, MetricsRegistry, StatsView
from repro_torch.serving.kvpool import BlockTable, KVBlockPool
from repro_torch.serving.sampling import SamplerConfig, request_generator, \
    sample
from repro_torch.serving.sched import AdmissionQueue, deadline_step, \
    victim_key
from repro_torch.serving.specdec import SpecConfig, SpecDecoder, \
    check_spec_stack
from repro_torch.serving.tokenizer import SPECIALS, TOKENIZER

KV_MODES = ("dense", "paged")

# The engine's counter surface, the JAX engine's keys and semantics:
# decode_steps counts TARGET forwards (verify forwards under spec decode);
# spec_drafted/spec_accepted count draft tokens (accept rate = ratio).
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
    # "eos" | "max_new_tokens" | "cache_len" | "kv_oom" (paged: can never
    # fit the block budget) | "sla_expired"
    finish_reason: Optional[str] = None
    enqueue_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    # tick stamps (engine step numbers)
    enqueue_step: int = 0
    admit_step: Optional[int] = None
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None
    # paged preemption: host copy of the request's KV blocks
    # ({"layers": [{"k", "v"}, ...] of (n_blocks, Hkv, bs, hd), "pos": n})
    # while it sits requeued
    swap: Optional[dict] = None


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
    table: Optional[BlockTable] = None   # paged: blocks held from admission
    j0: int = 0                          # paged: shared prefix blocks


def extend_support(cfg: ModelConfig) -> Tuple[bool, bool]:
    """(can_extend, pad_extend) of a stack, the JAX engine's rule: a
    multi-token ``prefill_extend`` needs no ring buffers and no encoder;
    a bucket-padded one also needs a pure-attention stack."""
    kinds = set(cfg.layer_kinds())
    can = (not kinds & set(WINDOW_KINDS) and "encdec" not in kinds
           and not cfg.n_enc_layers)
    return can, can and kinds <= set(PURE_ATTENTION_KINDS)


def _clone_tree(tree):
    """A copy of every tensor of a cache layer's nested dicts and tuples
    (the mLSTM state is a ``(C, n, m)`` tuple, the JAX layout)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone_tree(v) for v in tree)
    return tree.clone()


def _clone_cache(cache: dict) -> dict:
    """A copy of a B=1 cache's layers (every leaf, nested SSM state
    included) with the same ``pos``."""
    return {"layers": [_clone_tree(c) for c in cache["layers"]],
            "pos": cache["pos"]}


def _insert_tree(b, s, slot: int) -> None:
    for key, leaf in (b.items() if isinstance(b, dict) else enumerate(b)):
        if isinstance(leaf, (dict, tuple)):
            _insert_tree(leaf, s[key], slot)
        else:
            leaf[slot:slot + 1].copy_(s[key])


def _insert_slot(batched: dict, single: dict, slot: int) -> None:
    """Copy a B=1 cache into slot ``slot`` of the batched cache, in place
    (the JAX package's ``_insert_slot``): every leaf, K/V rows and any
    nested state (a hymba layer's ``ssm.h`` and ``ssm.conv``, an xLSTM
    layer's ``mlstm`` tuple or ``slstm`` dict)."""
    for b, s in zip(batched["layers"], single["layers"]):
        _insert_tree(b, s, slot)


def _paged_scatter(paged: dict, layers, blocks: List[int],
                   first: int = 0) -> None:
    """Copy logical blocks [first, len(blocks)) of a B=1 dense cache's
    layers ((1, Hkv, S, hd) leaves, S >= len(blocks) * bs) into the
    paged cache's pool blocks ``blocks``, in place (the JAX package's
    ``_paged_scatter``; logical blocks below ``first`` are shared prefix
    blocks, already in the pool)."""
    n = len(blocks)
    if first >= n:
        return
    dst = torch.as_tensor(blocks[first:],
                          device=paged["layers"][0]["k"].device)
    for pool, single in zip(paged["layers"], layers):
        for key in ("k", "v"):
            bs = pool[key].shape[2]
            src = single[key][0, :, first * bs:n * bs]        # (Hkv, R, hd)
            Hkv, _, hd = src.shape
            pool[key][dst] = src.reshape(Hkv, n - first, bs, hd
                                         ).transpose(0, 1)


def advance_cache_through(model: Model, logits, cache, tokens, *,
                          cache_len: int):
    """Advance a B=1 cache through new tokens. With ``prefill_extend``
    where the stack supports it (``extend_support``): whole
    ``attn_chunk`` slabs, then one call for the rest, bucket-padded on a
    pure-attention stack (pad width capped at the cache end); otherwise
    token by token through ``decode_step``. Returns (last-token logits
    (1,V), the extended cache)."""
    toks = list(tokens)
    if not toks:
        return logits, cache
    can_extend, pad_extend = extend_support(model.cfg)
    if not can_extend:
        for t in toks:
            logits, cache = decode_step(model, cache, {"tokens": [[t]]})
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
        if pad_extend and n < room:
            width = min(1 << (n - 1).bit_length(), room)
            rest = rest + [0] * (width - n)
        logits, cache = prefill_extend(model, cache, {"tokens": [rest]}, n)
    return logits, cache


def _kv_cache_bytes(cache: dict) -> int:
    """Bytes of the K/V leaves of every layer (dense slabs, rings or
    pools; SSM state is not KV), as the JAX engine counts them."""
    return sum(c[key].numel() * c[key].element_size()
               for c in cache["layers"] for key in ("k", "v") if key in c)


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, model: Model, *, max_batch: int = 8,
                 cache_len: int = 512, seed: int = 0, kv_mode: str = "dense",
                 kv_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 spec_decode: Optional[SpecConfig] = None,
                 prefill_budget: Optional[int] = None,
                 interleave: bool = True,
                 admission: str = "fifo",
                 clock: Optional[Callable[[], float]] = None,
                 tracer=None, metrics: Optional[MetricsRegistry] = None):
        if kv_mode not in KV_MODES:
            raise ValueError(f"kv_mode must be one of {KV_MODES}, "
                             f"got {kv_mode!r}")
        if kv_mode == "dense" and (kv_blocks is not None
                                   or block_size is not None):
            raise ValueError("kv_blocks/block_size apply only to "
                             "kv_mode='paged'")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(f"prefill_budget must be >= 1 token per "
                             f"step, got {prefill_budget}")
        kinds = set(cfg.layer_kinds())
        if kv_mode == "paged" and not kinds <= set(PURE_ATTENTION_KINDS):
            raise ValueError(
                f"kv_mode='paged' needs a pure-attention stack "
                f"(full/dense/moe), got kinds {sorted(kinds)}")
        can_extend, pad_extend = extend_support(cfg)
        if prefill_budget is not None and not can_extend:
            raise ValueError(
                "prefill_budget (chunked prefill) needs a stack that "
                "supports multi-token prefill_extend — no "
                "sliding-window rings and no encoder; got kinds "
                f"{sorted(kinds)}")
        self.cfg = cfg
        self.model = model
        self.device = model.device
        # a chunked prefill's tail may be bucket-padded only where no
        # recurrent state would step through the pads
        self._pad_extend = pad_extend
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
        if kv_mode == "paged":
            self.block_size = 16 if block_size is None else block_size
            if cache_len % self.block_size:
                raise ValueError(f"cache_len {cache_len} must be a "
                                 f"multiple of block_size {self.block_size}")
            # default physical budget: exactly the dense reservation
            self.kv_blocks = (kv_blocks if kv_blocks is not None
                              else max_batch * cache_len // self.block_size)
            self.pool = KVBlockPool(self.kv_blocks, self.block_size,
                                    metrics=self.metrics)
            self.cache = init_paged_cache(cfg, max_batch, cache_len,
                                          self.kv_blocks, self.block_size,
                                          self.device)
            self.tables: List[Optional[BlockTable]] = [None] * max_batch
            self._prefix_tables: Dict[str, BlockTable] = {}
            self._prefix_lru: Dict[str, int] = {}
            self._lru_tick = 0
            # host block table, uploaded once per step
            self._tab = np.full((max_batch, cache_len // self.block_size),
                                self.kv_blocks, np.int32)
        else:
            self.block_size = 0
            self.kv_blocks = 0
            self.pool = None
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
        self._kv_peak_blocks = 0       # paged: peak pool blocks in use
        self._kv_peak_shared = 0       # paged: peak CoW-shared blocks
        self._kv_peak_slots = 0        # dense: peak busy slots
        # host mirrors of the per-slot fill levels and carried tokens
        self._pos = np.zeros((max_batch,), np.int32)
        self._last_tokens = np.zeros((max_batch, 1), np.int64)
        # speculative decoding: draft K tokens per slot, verify them in
        # ONE target forward (serving/specdec.py)
        self.spec: Optional[SpecDecoder] = None
        if spec_decode is not None:
            check_spec_stack(cfg, "target model")
            self.spec = SpecDecoder(spec_decode, max_batch=max_batch,
                                    cache_len=cache_len,
                                    metrics=self.metrics)

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
        """Draft tokens per speculative round (0 = spec decode off)."""
        return self.spec.k if self.spec is not None else 0

    def reset(self, seed: Optional[int] = None):
        """Return the engine to its just-constructed state. Cache storage
        is reused: stale rows are masked by the zeroed positions (and, in
        paged mode, the all-sentinel table) and overwritten at the next
        admission."""
        if seed is not None:
            self.seed = seed
        self.rng = torch.Generator().manual_seed(self.seed)
        self.metrics.reset()
        self._req_spans.clear()
        self._pos[:] = 0
        self._last_tokens[:] = 0
        if self.kv_mode == "paged":
            self.pool = KVBlockPool(self.kv_blocks, self.block_size,
                                    metrics=self.metrics)
            self.tables = [None] * self.max_batch
            self._prefix_tables = {}
            self._prefix_lru = {}
            self._lru_tick = 0
            self._tab[:] = self.kv_blocks
        self.slots = [None] * self.max_batch
        self.queue.clear()
        self._pending.clear()
        self._pending_rr.clear()
        self.step_no = 0
        self.prefixes.clear()
        self._next_id = 0
        self._next_session = 0
        self._kv_peak_blocks = 0
        self._kv_peak_shared = 0
        self._kv_peak_slots = 0
        if self.spec is not None:
            self.spec.reset()

    # -------------------------------------------------- prefix caching ----
    def register_prefix(self, key: str, prefix_text_or_ids) -> int:
        """Prefill a shared prompt prefix ONCE and cache the result;
        returns its length in tokens. Text prefixes are encoded as <bos> +
        tokens (no <eos>). A prefix longer than one attention chunk is
        prefilled on its chunk-aligned head and extended over the tail,
        the JAX engine's split. In paged mode the prefix's rows are also
        pinned in pool blocks that every hit shares."""
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
        if self.kv_mode == "paged":
            self._pin_prefix(key, self.prefixes[key])
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

    # ------------------------------------------------ paged KV memory ----
    # Host-side policy over serving/kvpool.py: the pool owns block ids and
    # refcounts; the engine owns what is cold (LRU prefix pins) and who is
    # lowest priority (the admission policy's preemption victim).
    def _pin_prefix(self, key: str, pref: CachedPrefix):
        """Write the prefix's KV rows into pool blocks ONCE and pin them
        (an LRU-evictable hold). Every admission that hits the prefix
        forks this table (refcount++, zero copies). If the pool cannot
        hold the prefix even after evicting colder pins, it stays
        unpinned: hits still reuse the staged prefill and scatter their
        own copy."""
        old = self._prefix_tables.pop(key, None)
        if old is not None:
            self._prefix_lru.pop(key, None)
            self.pool.free(old)
        need = self.pool.blocks_needed(len(pref.ids))
        if need > self.pool.n_blocks or not self._reserve(need):
            return
        table = self.pool.alloc(len(pref.ids))
        _paged_scatter(self.cache, pref.cache["layers"], table.blocks)
        self._prefix_tables[key] = table
        self._touch_prefix(key)
        self._note_kv_peak()

    def _touch_prefix(self, key: str):
        self._prefix_lru[key] = self._lru_tick
        self._lru_tick += 1

    def _reserve(self, need: int, keep: Optional[str] = None) -> bool:
        """True once >= ``need`` blocks are free, evicting cold prefix
        pins (LRU; never ``keep``, the pin an admission is about to fork)
        as required. Evicts only when eviction can satisfy the request:
        pins are never re-established, so destroying them for an
        unsatisfiable reservation would end sharing for nothing. Never
        touches running requests (that is _ensure_room's call)."""
        if self.pool.free_blocks() >= need:
            return True
        # blocks an eviction sweep would free: a pin's exclusively held
        # blocks (shared ones stay with their forks)
        gain = sum(1 for k, t in self._prefix_tables.items()
                   if k != keep
                   for b in t.blocks if self.pool.ref[b] == 1)
        if self.pool.free_blocks() + gain < need:
            return False
        while self.pool.free_blocks() < need \
                and self._evict_cold_prefix(keep):
            pass
        return self.pool.free_blocks() >= need

    def _evict_cold_prefix(self, keep: Optional[str] = None) -> bool:
        """Evict the LRU prefix pin among those whose eviction frees at
        least one block NOW."""
        candidates = [k for k, t in self._prefix_tables.items()
                      if k != keep
                      and any(self.pool.ref[b] == 1 for b in t.blocks)]
        if not candidates:
            return False
        key = min(candidates, key=self._prefix_lru.get)
        self.pool.free(self._prefix_tables.pop(key))
        del self._prefix_lru[key]
        self.stats["prefix_evictions"] += 1
        if self.tracer.enabled:
            self.tracer.event("kv_evict", tick=self.step_no,
                              group=self.trace_group, lane="kv",
                              prefix=key)
        return True

    def _install_paged(self, slot: int, req: Request, table: BlockTable,
                       layers, scatter_from: int):
        """Bind (request, block table) to a slot: scatter the B=1 cache
        rows of logical blocks [scatter_from, len(table)) into the
        table's blocks, then point the slot's table row and pos at
        them."""
        _paged_scatter(self.cache, layers, table.blocks, scatter_from)
        self._bind_table(slot, req, table)

    def _bind_table(self, slot: int, req: Request, table: BlockTable):
        self._tab[slot] = self.kv_blocks
        self._tab[slot, :len(table.blocks)] = table.blocks
        self._pos[slot] = table.n_tokens
        self.slots[slot] = req
        self.tables[slot] = table
        self._note_kv_peak()

    def _release_slot(self, slot: int):
        """Free a paged slot's blocks and sentinel its table row."""
        self.pool.free(self.tables[slot])
        self.tables[slot] = None
        self._tab[slot] = self.kv_blocks

    def _preempt(self, slot: int):
        """Swap the slot's KV blocks to host memory, free them and requeue
        the request at the queue head. The swap payload is a bit-exact
        host copy, so the resumed request decodes the same tokens it
        would have (seeded requests are provably unperturbed; engine-
        stream requests see another draw order, as any co-tenancy change
        gives them)."""
        req = self.slots[slot]
        table = self.tables[slot]
        ids = torch.as_tensor(table.blocks, device=self.device)
        req.swap = {"layers": [{key: pool[key][ids].cpu() for key in pool}
                               for pool in self.cache["layers"]],
                    "pos": table.n_tokens}
        self.slots[slot] = None
        self._pos[slot] = 0
        self._release_slot(slot)
        # FIFO requeues at the head (the victim resumes before new
        # arrivals); slack mode re-competes by deadline
        self.queue.push(req, front=True)
        self.stats["preemptions"] += 1
        h = self._req_spans.pop(req.request_id, None)
        if h is not None:
            self.tracer.end(h, tick=self.step_no, preempted=True,
                            tokens=len(req.output))
        if self.tracer.enabled:
            self.tracer.event("preempt", tick=self.step_no,
                              group=self.trace_group, lane="queue",
                              request=req.request_id, slot=slot)

    def _resume(self, slot: int, req: Request, table: BlockTable):
        """Restore a preempted request's swapped blocks into ``table``."""
        n = min(len(table.blocks),
                req.swap["layers"][0]["k"].shape[0])
        dst = torch.as_tensor(table.blocks[:n], device=self.device)
        for pool, saved in zip(self.cache["layers"], req.swap["layers"]):
            for key in ("k", "v"):
                pool[key][dst] = saved[key][:n].to(self.device)
        self._bind_table(slot, req, table)

    def _ensure_room(self, width: int = 1) -> List[Request]:
        """Pre-decode: every active slot must own blocks for the ``width``
        rows it is about to write (1 per decode step, K+1 per speculative
        verify; rejected rows stay in blocks the slot already owns).
        Under memory pressure, evict cold prefix pins (inside _reserve),
        then preempt and requeue the lowest-priority running request
        (sched.victim_key), never drop it. Pending chunked prefills are
        neither growers nor victims. A lone request that has outgrown the
        whole pool finishes with ``kv_oom``."""
        finished: List[Request] = []
        for i in range(self.max_batch):
            if self.slots[i] is None or i in self._pending:
                continue
            table = self.tables[i]
            needed_rows = min(table.n_tokens + width, self.cache_len)
            blocked = False
            while (not blocked
                   and len(table.blocks) * self.block_size < needed_rows):
                if self._reserve(1):
                    j = len(table.blocks)
                    self._tab[i, j] = self.pool.append_block(table)
                    continue
                active = [j for j in range(self.max_batch)
                          if self.slots[j] is not None
                          and j not in self._pending]
                victim = max(active, key=lambda j: victim_key(
                    self.slots[j], self.admission))
                if victim == i and len(active) == 1:
                    req = self.slots[i]
                    self._finish_now(req, "kv_oom")
                    finished.append(req)
                    self.slots[i] = None
                    self._pos[i] = 0
                    self._release_slot(i)
                    blocked = True
                    break
                self._preempt(victim)
                if victim == i:
                    blocked = True
        self._note_kv_peak()
        return finished

    def _note_kv_peak(self):
        if self.kv_mode == "paged":
            self._kv_peak_blocks = max(self._kv_peak_blocks,
                                       self.pool.used_blocks())
            self._kv_peak_shared = max(self._kv_peak_shared,
                                       self.pool.shared_blocks())
        else:
            self._kv_peak_slots = max(self._kv_peak_slots,
                                      self.busy_slots())

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

    def _prefill_request(self, req: Request,
                         pref: Optional[CachedPrefix]):
        """Admission logits + B=1 cache, via the prefix cache on a hit
        (``pref``, the request's ``_prefix_hit``)."""
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

    def _trace_admit(self, req: Request, slot: int, resumed: bool = False):
        if not self.tracer.enabled:
            return
        self.tracer.event("resume" if resumed else "admit",
                          tick=self.step_no, group=self.trace_group,
                          lane="queue", request=req.request_id, slot=slot)
        self._req_spans[req.request_id] = self.tracer.begin(
            "request", tick=self.step_no, group=self.trace_group,
            lane=slot, request=req.request_id,
            prompt_tokens=len(req.prompt), resumed=resumed)

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
        """Drop fresh queue heads whose SLA deadline has passed (a
        preempted request, which holds output, always resumes)."""
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

    def _seated(self, slot: int, req: Request):
        """A request now decodes from ``slot``: carry its last token and,
        with spec decode, build the draft's cache over its context."""
        self._last_tokens[slot, 0] = req.output[-1]
        if self.spec is not None:
            self.spec.admit(slot, req.prompt + req.output[:-1])

    def _admit(self) -> List[Request]:
        """Prefill queued requests into free slots (or, under
        ``prefill_budget``, start their chunked prefills); returns the
        ones whose admission token was terminal plus expired drops."""
        if self.kv_mode == "paged":
            return self._admit_paged()
        finished: List[Request] = self._drop_expired()
        free = deque(self._free_slots())
        while free and self.queue:
            slot = free[0]
            req = self.queue.pop()
            if (self.spec is not None or self.prefill_budget is not None) \
                    and len(req.prompt) >= self.cache_len:
                # plain dense truncates the prefill and emits a token or
                # two before dying with "cache_len"; that clamped overflow
                # write cannot be reproduced by one verify forward or
                # replayed chunk by chunk, so spec and budget modes refuse
                # up front (the paged semantics)
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
            logits, cache1 = self._prefill_request(req,
                                                   self._prefix_hit(req))
            if self._first_token(req, logits):
                finished.append(req)
                continue
            free.popleft()
            self._install(slot, req, cache1)
            self._seated(slot, req)
        return finished

    def _admit_paged(self) -> List[Request]:
        """Paged admission: FIFO like dense, but gated on free blocks. A
        queue head that does not fit (after LRU-evicting cold prefix
        pins) WAITS for running requests to free memory; requests that
        can never fit the pool finish with ``kv_oom``; preempted requests
        at the head are restored from their swap payload without
        recomputation. Each admission holds one block of headroom for
        the decode write of its first step."""
        finished: List[Request] = self._drop_expired()
        free = deque(self._free_slots())
        while free and self.queue:
            slot = free[0]
            req = self.queue.peek()
            if req.swap is not None:                       # resume
                total = req.swap["pos"]
                need = self.pool.blocks_needed(total + 1)
                if need > self.pool.n_blocks:
                    self.queue.pop()
                    self._finish_now(req, "kv_oom")
                    finished.append(req)
                    continue
                if not self._reserve(need):
                    break                                  # wait
                self.queue.pop()
                table = self.pool.alloc(total + 1)
                table.n_tokens = total
                self._resume(slot, req, table)
                req.swap = None
                self.stats["resumes"] += 1
                self._trace_admit(req, slot, resumed=True)
                # the swap restored the target's KV; the draft cache was
                # dropped at preemption and is rebuilt over the context
                self._seated(slot, req)
                free.popleft()
                continue
            total = len(req.prompt)
            if total >= self.cache_len:
                # no room in the logical view for even one decode write
                self.queue.pop()
                self._finish_now(req, "cache_len")
                finished.append(req)
                continue
            # zero-copy sharing needs the prefix PINNED; a hit on an
            # evicted pin reuses the staged prefill but scatters a
            # private copy (j0 = 0)
            pref = self._prefix_hit(req)
            ptab = (self._prefix_tables.get(req.prefix_key)
                    if pref is not None else None)
            j0 = len(pref.ids) // self.block_size if ptab is not None else 0
            if ptab is not None:
                self._touch_prefix(req.prefix_key)
            need = self.pool.blocks_needed(total + 1) - j0
            if need > self.pool.n_blocks:
                self.queue.pop()
                self._finish_now(req, "kv_oom")
                finished.append(req)
                continue
            if not self._reserve(need, keep=(req.prefix_key
                                             if ptab is not None else None)):
                if self.busy_slots() > 0:
                    break      # wait: running requests will free blocks
                # nothing running will free blocks; last resort, retry as
                # a private copy (may evict the pin we would have forked)
                if ptab is not None:
                    ptab, j0 = None, 0
                    need = self.pool.blocks_needed(total + 1)
                if not self._reserve(need):
                    self.queue.pop()
                    self._finish_now(req, "kv_oom")
                    finished.append(req)
                    continue
            self.queue.pop()
            self.stats["admissions"] += 1
            req.admit_step = self.step_no
            self._trace_admit(req, slot)
            if self.prefill_budget is not None:
                # chunked admission takes its blocks NOW, so co-resident
                # decodes cannot starve the in-flight prefill
                table = self._take_table(req, ptab, j0, total)
                free.popleft()
                self._start_pending(slot, req, pref, table, j0)
                self._note_kv_peak()
                continue
            logits, cache1 = self._prefill_request(req, pref)
            if self._first_token(req, logits):
                finished.append(req)
                continue
            table = self._take_table(req, ptab, j0, total)
            self._install_paged(slot, req, table, cache1["layers"], j0)
            self._seated(slot, req)
            free.popleft()
        return finished

    def _take_table(self, req: Request, ptab: Optional[BlockTable],
                    j0: int, total: int) -> BlockTable:
        """The admission's block table, with one block of headroom for
        its first decode write: a CoW fork of the prefix pin (sharing its
        ``j0`` full blocks, owning a fresh copy of the rest) or fresh
        blocks."""
        if ptab is not None:
            table = self.pool.fork(ptab, total)
            self.pool.cow_from(table, j0)
            self.pool.grow(table, total + 1)
            if self.tracer.enabled:
                self.tracer.event("cow_fork", tick=self.step_no,
                                  group=self.trace_group, lane="kv",
                                  request=req.request_id, shared_blocks=j0)
        else:
            table = self.pool.alloc(total + 1)
        table.n_tokens = total
        return table

    def _start_pending(self, slot: int, req: Request,
                       pref: Optional[CachedPrefix],
                       table: Optional[BlockTable] = None, j0: int = 0):
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
            logits=logits, cache=cache, table=table, j0=j0)
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
                # advance_cache_through's tail rule: bucket-padded (pad
                # width capped at the cache end) only on a pure-attention
                # stack, unpadded where recurrent state would step
                # through the pads
                rest = p.toks[p.i:]
                room = self.cache_len - int(p.cache["pos"])
                if self._pad_extend and rem < room:
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
        """Last chunk landed: sample the admission token and install the
        B=1 cache into the slot (dense copy or paged scatter), as the
        monolithic admission does. Returns the request when its first
        token was terminal."""
        p = self._pending.pop(slot)
        req = p.req
        if self._first_token(req, p.logits):
            self.slots[slot] = None
            if self.kv_mode == "paged":
                self.pool.free(p.table)
            return req
        if self.kv_mode == "paged":
            self._install_paged(slot, req, p.table, p.cache["layers"], p.j0)
        else:
            self._install(slot, req, p.cache)
        self._seated(slot, req)
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
        then (paged) grow the block tables for this step's writes and
        decode one token for every active slot, or, with spec decode on,
        draft K tokens per slot and verify them in one target forward
        (skipped while any prefill is pending when ``interleave=False``).
        Returns newly finished requests."""
        finished = self._step_once()
        self.step_no += 1
        return finished

    def _upload_step_state(self):
        """This step's per-slot positions and block table (host tensors;
        the model moves them to the device once per forward)."""
        self.cache["pos"] = torch.from_numpy(self._pos.copy())
        if self.kv_mode == "paged":
            self.cache["block_tab"] = torch.from_numpy(self._tab.copy())

    def _step_once(self) -> List[Request]:
        finished = self._admit()
        self._note_kv_peak()
        if self._pending:
            finished.extend(self._advance_pendings())
        stalled = not self.interleave and bool(self._pending)
        if self.kv_mode == "paged" and not stalled:
            finished.extend(self._ensure_room(self.spec_k + 1))
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
        if self.spec is not None:
            finished.extend(self._spec_step(active))
            return finished
        self._upload_step_state()
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
        if self.kv_mode == "paged":
            for i in active:          # one KV row written per sequence
                self.tables[i].n_tokens += 1
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
                if self.kv_mode == "paged":
                    self._release_slot(i)
        return finished

    def _spec_step(self, active: List[int]) -> List[Request]:
        """One speculative round: K greedy draft steps, one target verify
        forward over W = K+1 positions per slot, then per-slot
        sample-and-match acceptance (serving/specdec.py). Every emitted
        token is sampled from verify logits that are bitwise the decode
        logits, with the generator non-speculative decoding would use for
        it, and the finish checks replay step()'s decisions token by
        token, so outputs and finish reasons match the non-speculative
        engine."""
        k = self.spec.k
        pos0 = self._pos.copy()
        drafts = self.spec.draft(self._last_tokens)              # (B, k)
        toks = np.concatenate([self._last_tokens, drafts], axis=1)
        self._upload_step_state()
        vlogits, self.cache = verify_extend(
            self.model, self.cache,
            {"tokens": torch.as_tensor(toks, device=self.device)})
        self.stats["decode_steps"] += 1
        self.stats["spec_rounds"] += 1
        greedy = torch.argmax(vlogits, dim=-1).tolist()          # (B, W)
        new_pos = pos0.copy()
        finished: List[Request] = []
        full_accept = False
        round_accepted = 0
        for i in active:
            req = self.slots[i]
            emitted = accepted = 0
            reason = None
            for j in range(k + 1):
                if req.sampler.temperature <= 0.0:
                    tok = greedy[i][j]
                else:
                    tok = int(sample(vlogits[i, j][None],
                                     self._request_gen(req),
                                     req.sampler)[0])
                req.output.append(tok)
                emitted += 1
                self.stats["tokens_generated"] += 1
                matched = j < k and tok == int(drafts[i, j])
                if matched:
                    accepted += 1
                hit_cap = len(req.output) >= req.max_new_tokens
                hit_len = int(pos0[i]) + j + 2 >= self.cache_len - 1
                reason = ("eos" if tok == SPECIALS["<eos>"]
                          else "max_new_tokens" if hit_cap
                          else "cache_len" if hit_len else None)
                if reason is not None or not matched:
                    break
            self.stats["spec_drafted"] += k
            self.stats["spec_accepted"] += accepted
            round_accepted += accepted
            full_accept = full_accept or accepted == k
            new_pos[i] = int(pos0[i]) + emitted
            self._last_tokens[i, 0] = req.output[-1]
            if self.kv_mode == "paged":
                # rollback IS this truncation: rejected rows sit in blocks
                # the table already holds and are overwritten before
                # kv_len reaches them
                self.tables[i].n_tokens = int(pos0[i]) + emitted
            if reason is not None:
                self._finish_now(req, reason)
                finished.append(req)
                self.slots[i] = None
                new_pos[i] = 0
                if self.kv_mode == "paged":
                    self._release_slot(i)
        if self.tracer.enabled:
            self.tracer.event("spec_round", tick=self.step_no,
                              group=self.trace_group, lane="engine",
                              active=len(active), drafted=k * len(active),
                              accepted=round_accepted)
        self._pos = new_pos
        if full_accept:
            self.spec.catch_up()
        self.spec.set_pos(new_pos)
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
        # tokens per TARGET forward (> busy slots when drafts are
        # accepted); accept rate = accepted / drafted over every round
        st["tokens_per_step"] = round(
            st["tokens_generated"] / max(st["decode_steps"], 1), 4)
        st["spec_accept_rate"] = round(
            st["spec_accepted"] / max(st["spec_drafted"], 1), 4)
        st["spec_k"] = self.spec_k
        return st

    def kv_memory_stats(self) -> Dict:
        """KV-memory accounting, alike across modes:
        ``kv_bytes_allocated`` is the physical reservation (dense: the
        full (max_batch, cache_len) slab; paged: the block pool),
        ``kv_bytes_in_use``/``kv_bytes_peak`` what live requests hold,
        and ``kv_shared_frac`` the peak fraction of in-use blocks
        CoW-shared between holders (dense never shares)."""
        if self.kv_mode == "paged":
            ps = self.pool.stats()
            bpb = self._kv_bytes_total // max(self.kv_blocks, 1)
            return {**ps, "kv_mode": "paged",
                    "kv_bytes_allocated": self._kv_bytes_total,
                    "kv_bytes_in_use": ps["kv_blocks_used"] * bpb,
                    "kv_bytes_peak": self._kv_peak_blocks * bpb,
                    "kv_blocks_used_peak": self._kv_peak_blocks,
                    "kv_blocks_shared_peak": self._kv_peak_shared,
                    "kv_shared_frac": round(
                        self._kv_peak_shared
                        / max(self._kv_peak_blocks, 1), 4)}
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
