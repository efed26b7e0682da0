"""Paged KV-cache block allocator: refcounted fixed-size blocks with
copy-on-write forking.

A copy of the JAX package's ``serving/kvpool.py`` (pure host-side
bookkeeping, no array library), kept in step with it by hand.

The dense engine reserves ``max_batch * cache_len`` KV rows up front and
physically copies the per-intent prefix cache into every slot it admits.
This module is the vLLM-style alternative: KV memory is a fixed budget of
``n_blocks`` blocks of ``block_size`` token rows each, and every request
holds a *block table* — an ordered list of block ids covering its logical
``[0, n_tokens)`` rows. Sharing is by refcount:

  * ``fork``     — share every block of an existing table (refcount++,
                   zero copies). The engine forks a registered prefix's
                   table into each admission, so N same-intent slots hold
                   the prefix once, not N times.
  * ``cow_from`` — copy-on-write: replace the table's entries from block
                   ``j`` on with freshly-owned blocks (the physical row
                   copy is the caller's single scatter — the pool only
                   manages ownership). A forked table CoWs its partial
                   tail block before the slot writes suffix/decode rows
                   into it; fully-shared prefix blocks are never written.
  * ``grow``     — extend a table to cover more tokens (decode appends).
  * ``free``     — drop the table; blocks return to the free list when
                   their refcount hits zero.

Allocation order is deterministic (lowest-id free block first, via a min
heap), so a paged engine run is exactly reproducible — the property the
dense-vs-paged bitwise parity tests rest on. The pool is pure host-side
bookkeeping: device storage lives in the engine's paged cache
(models/model.py ``init_paged_cache``), indexed by these block ids.

The pool does not evict on its own: the engine decides *what* is cold
(LRU prefix pins) and *who* is lowest priority (preempt-and-requeue);
the pool exposes the refcount/free-count facts those policies need.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List


class KVPoolExhausted(RuntimeError):
    """No free block. The engine should have evicted or preempted first;
    reaching this means an accounting bug, so fail loudly."""


@dataclass
class BlockTable:
    """One request's (or pinned prefix's) view of the pool: ordered block
    ids covering logical token rows [0, n_tokens)."""
    blocks: List[int] = field(default_factory=list)
    n_tokens: int = 0

    def __len__(self) -> int:
        return len(self.blocks)


class KVBlockPool:
    """Deterministic refcounted allocator over ``n_blocks`` fixed-size
    blocks. All methods are O(log n) or O(table); none touch device
    memory."""

    def __init__(self, n_blocks: int, block_size: int, metrics=None):
        if n_blocks <= 0 or block_size <= 0:
            raise ValueError(f"need positive n_blocks/block_size, got "
                             f"{n_blocks}/{block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.ref = [0] * n_blocks
        self._free = list(range(n_blocks))      # min-heap: lowest id first
        heapq.heapify(self._free)
        # incremental count of blocks with ref > 1: shared/owned stats
        # are read every engine step, so no O(n_blocks) scans there
        self._n_shared = 0
        # optional obs registry gauges, refreshed after every mutator
        self._g_used = metrics.gauge("kv_blocks_used") if metrics else None
        self._g_free = metrics.gauge("kv_blocks_free") if metrics else None
        self._g_shared = (metrics.gauge("kv_blocks_shared")
                          if metrics else None)
        self._publish()

    def _publish(self):
        if self._g_used is not None:
            self._g_used.set(self.used_blocks())
            self._g_free.set(self.free_blocks())
            self._g_shared.set(self.shared_blocks())

    # ------------------------------------------------------- introspection ----
    def free_blocks(self) -> int:
        return len(self._free)

    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def shared_blocks(self) -> int:
        """Blocks referenced by more than one table (CoW-shared)."""
        return self._n_shared

    def owned_blocks(self) -> int:
        """Blocks referenced by exactly one table."""
        return self.used_blocks() - self._n_shared

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)         # ceil div

    # --------------------------------------------------------- allocation ----
    def _alloc_block(self) -> int:
        if not self._free:
            raise KVPoolExhausted(
                f"all {self.n_blocks} KV blocks in use")
        b = heapq.heappop(self._free)
        assert self.ref[b] == 0, (b, self.ref[b])
        self.ref[b] = 1
        return b

    def alloc(self, n_tokens: int) -> BlockTable:
        """Fresh table covering ``n_tokens`` rows, all blocks owned."""
        need = self.blocks_needed(n_tokens)
        if need > len(self._free):
            raise KVPoolExhausted(
                f"need {need} blocks, {len(self._free)} free")
        t = BlockTable([self._alloc_block() for _ in range(need)],
                       n_tokens)
        self._publish()
        return t

    def fork(self, table: BlockTable, n_tokens: int = -1) -> BlockTable:
        """Share every block of ``table`` (refcount++, zero copies).
        ``n_tokens`` defaults to the source's length."""
        for b in table.blocks:
            assert self.ref[b] > 0, b
            if self.ref[b] == 1:
                self._n_shared += 1
            self.ref[b] += 1
        self._publish()
        return BlockTable(list(table.blocks),
                          table.n_tokens if n_tokens < 0 else n_tokens)

    def cow_from(self, table: BlockTable, j: int) -> List[int]:
        """Copy-on-write: give ``table`` exclusive ownership of entries
        [j, len). Shared entries are swapped for fresh blocks (the caller
        scatters the row data); already-exclusive entries are kept.
        Returns the logical indices that changed block id."""
        changed: List[int] = []
        for i in range(j, len(table.blocks)):
            old = table.blocks[i]
            if self.ref[old] == 1:
                continue                       # already exclusive
            # alloc BEFORE release: if the pool is exhausted mid-walk
            # the table still references only live blocks
            new = self._alloc_block()
            self._release(old)
            table.blocks[i] = new
            changed.append(i)
        self._publish()
        return changed

    def append_block(self, table: BlockTable) -> int:
        """Append one freshly-owned block (decode growth). Does not
        advance ``n_tokens`` — the caller advances it as rows are
        actually written. Returns the new block id."""
        b = self._alloc_block()
        table.blocks.append(b)
        self._publish()
        return b

    def grow(self, table: BlockTable, n_tokens: int) -> List[int]:
        """Extend ``table`` to cover ``n_tokens`` rows; returns the
        logical indices of the appended blocks."""
        need = self.blocks_needed(n_tokens)
        if n_tokens < table.n_tokens:
            raise ValueError(f"grow would shrink: {n_tokens} < "
                             f"{table.n_tokens}")
        added: List[int] = []
        while len(table.blocks) < need:
            self.append_block(table)
            added.append(len(table.blocks) - 1)
        table.n_tokens = n_tokens
        return added

    # -------------------------------------------------------------- free ----
    def _release(self, b: int):
        assert 0 <= b < self.n_blocks, b
        if self.ref[b] <= 0:
            raise KVPoolExhausted(f"double free of block {b}")
        if self.ref[b] == 2:
            self._n_shared -= 1
        self.ref[b] -= 1
        if self.ref[b] == 0:
            heapq.heappush(self._free, b)

    def free(self, table: BlockTable):
        """Release every block of ``table`` and empty it (a freed table
        cannot be double-freed — it holds no blocks)."""
        for b in table.blocks:
            self._release(b)
        table.blocks = []
        table.n_tokens = 0
        self._publish()

    # -------------------------------------------------------------- stats ----
    def stats(self) -> Dict[str, int]:
        return {"kv_blocks_total": self.n_blocks,
                "kv_blocks_used": self.used_blocks(),
                "kv_blocks_free": self.free_blocks(),
                "kv_blocks_shared": self.shared_blocks(),
                "kv_blocks_owned": self.owned_blocks()}

    def check_invariants(self):
        """Internal-consistency assertions (the property tests call this
        after every operation)."""
        assert len(self._free) + sum(1 for r in self.ref if r > 0) \
            == self.n_blocks, "free + referenced != total"
        assert all(r >= 0 for r in self.ref)
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "duplicate free block"
        assert all(self.ref[b] == 0 for b in free_set), \
            "referenced block on the free list"
        assert self._n_shared == sum(1 for r in self.ref if r > 1), \
            "incremental shared count drifted from the refcounts"
