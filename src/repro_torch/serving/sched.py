"""Deterministic admission scheduling for the inference engine.

The engine's admission queue used to be a plain FIFO deque; under SLA
deadlines FIFO is the wrong order — a long-slack request admitted ahead
of a nearly-expired one burns the tight one's deadline for nothing.
``AdmissionQueue`` keeps both policies behind one surface:

  * ``"fifo"``  — arrival order (the seed behavior): a deque whose head
    is popped once per free slot; preemption requeues at the head so a
    swapped-out request resumes before new arrivals.
  * ``"slack"`` — earliest-deadline-first: requests carrying an SLA
    deadline (``Request.sla_ticks``, deadline = enqueue step + sla)
    admit in deadline order; deadline-less requests sort AFTER every
    deadline-carrying one, in arrival order. The order is a pure
    function of (deadline, request_id) — two integer keys, no dict or
    hash iteration anywhere — so the same arrivals produce the same
    admission order on any machine and under any PYTHONHASHSEED
    (tests/test_interleave.py asserts it).

Both policies are strict total orders, so the queue never depends on
heap insertion history: ``pop`` always returns the unique minimum.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Iterator, List, Optional

ADMISSION_POLICIES = ("fifo", "slack")

# deadline sentinel for requests with no SLA: sorts after every real
# deadline while keeping the key an int (no float("inf") keys — the
# determinism lint bans float ordering keys in serving)
NO_DEADLINE = 1 << 62


def deadline_step(req) -> int:
    """Absolute step by which ``req`` must FINISH to meet its SLA
    (``NO_DEADLINE`` when it carries none). e2e latency is
    ``finish_step - enqueue_step + 1`` ticks, so the last step that can
    still meet an ``sla_ticks`` budget is ``enqueue + sla - 1``; the
    deadline is the first step that cannot."""
    if req.sla_ticks is None:
        return NO_DEADLINE
    return req.enqueue_step + req.sla_ticks


class AdmissionQueue:
    """Engine admission queue with a pluggable, deterministic order."""

    def __init__(self, policy: str = "fifo", metrics=None):
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"admission policy must be one of "
                             f"{ADMISSION_POLICIES}, got {policy!r}")
        self.policy = policy
        self._fifo: deque = deque()
        self._heap: List[tuple] = []
        # optional obs registry publishers (the engine passes its
        # registry; standalone queues skip the bookkeeping entirely)
        self._c_push = metrics.counter("queue_pushes") if metrics else None
        self._c_pop = metrics.counter("queue_pops") if metrics else None
        self._g_depth = (metrics.gauge("queue_depth_peak")
                         if metrics else None)

    def _key(self, req) -> tuple:
        # (deadline, request_id): request_id is engine-local and
        # monotone, so ties between same-deadline requests stay in
        # arrival order and the key is unique (the heap never compares
        # Request objects)
        return (deadline_step(req), req.request_id)

    def push(self, req, front: bool = False):
        """Enqueue. ``front=True`` is the preemption requeue: FIFO puts
        the victim back at the head (it resumes before new arrivals);
        slack mode ignores it — the victim re-competes by its deadline,
        which is what SLA-aware scheduling means."""
        if self.policy == "fifo":
            (self._fifo.appendleft if front
             else self._fifo.append)(req)
        else:
            heapq.heappush(self._heap, (*self._key(req), req))
        if self._c_push is not None:
            self._c_push.inc()
            self._g_depth.max(len(self))

    def pop(self):
        if self._c_pop is not None:
            self._c_pop.inc()
        if self.policy == "fifo":
            return self._fifo.popleft()
        return heapq.heappop(self._heap)[-1]

    def peek(self):
        if self.policy == "fifo":
            return self._fifo[0]
        return self._heap[0][-1]

    def clear(self):
        self._fifo.clear()
        self._heap.clear()

    def __len__(self) -> int:
        return (len(self._fifo) if self.policy == "fifo"
                else len(self._heap))

    def __iter__(self) -> Iterator:
        """Iterate in pop order without mutating the queue."""
        if self.policy == "fifo":
            return iter(self._fifo)
        return (item[-1] for item in sorted(self._heap))


def victim_key(req, policy: str = "fifo"):
    """Sort key whose MAXIMUM is the preferred preemption victim.

    FIFO keeps the seed rule — preempt the latest-admitted request
    (highest request_id). Slack mode preempts the request with the most
    deadline slack (latest deadline; deadline-less requests first of
    all), tie-broken by request_id so the choice stays deterministic."""
    if policy == "fifo":
        return req.request_id
    return (deadline_step(req), req.request_id)
