"""Tick-stamped, monotonically-sequenced trace recording.

A ``Tracer`` collects ``TraceRecord``s — begin/end span markers and
instant events — stamped with the *engine tick* (``step_no`` / the
cluster's lockstep tick), never the wall clock. Each record also
carries a process-global-free, tracer-local sequence number that is
strictly increasing, so within-tick ordering is total and a trace is a
pure function of the run: same seed ⇒ byte-identical records
(tests/test_obs.py asserts this through both exporters).

Wall time is opt-in: the engine's injected ``clock=`` is bound onto
the tracer (``bind_clock``) only when a caller actually injects one
(the live-serve launcher). Records then carry a ``wall`` field and the
byte-identity guarantee is intentionally waived — determinism contracts
stay with the tick stamps.

Tracks: every record names a ``(group, lane)`` pair — the engine uses
``(replica_index, slot)`` with the reserved lanes ``"queue"`` /
``"engine"`` / ``"kv"``, the pipeline ``("pipeline", stage)``. The
Chrome exporter (obs/export.py) maps groups to Perfetto processes and
lanes to threads.

``NullTracer`` is the zero-overhead default: every method is a no-op
and ``enabled`` is False so hot loops can skip building event args
entirely. Tracing on vs off never branches engine control flow, which
is why tokens are bitwise identical either way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

Label = Union[int, str]


@dataclass(frozen=True)
class TraceRecord:
    """One trace entry. ``ph`` follows the Chrome trace-event phases:
    "B" (span begin), "E" (span end), "i" (instant). ``args`` is a
    key-sorted tuple of pairs so serialization is deterministic."""
    seq: int
    ph: str
    name: str
    tick: int
    group: Label
    lane: Label
    args: Tuple[Tuple[str, Any], ...] = ()
    wall: Optional[float] = None


class NullTracer:
    """Disabled tracer: no records, no state, no overhead. The engine
    default — guaranteed not to perturb anything (the tracer-on/off
    token-parity test rests on tracing never branching control flow)."""

    enabled = False
    records: Tuple[TraceRecord, ...] = ()

    def bind_clock(self, clock: Optional[Callable[[], float]]) -> None:
        pass

    def event(self, name: str, *, tick: int, group: Label = 0,
              lane: Label = 0, **args) -> int:
        return -1

    def begin(self, name: str, *, tick: int, group: Label = 0,
              lane: Label = 0, **args) -> int:
        return -1

    def end(self, handle: int, *, tick: int, **args) -> None:
        pass

    def open_spans(self) -> List[TraceRecord]:
        return []


NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer. All stamps are caller-supplied ticks; ``seq``
    is assigned here and is strictly increasing across every record."""

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._records: List[TraceRecord] = []
        self._seq = 0
        self._clock = clock
        # handle (the begin record's seq) -> its begin record, for the
        # matching "E" and for open-span introspection
        self._open: Dict[int, TraceRecord] = {}

    # ------------------------------------------------------- recording ----
    def bind_clock(self, clock: Optional[Callable[[], float]]) -> None:
        """Attach an injected wall clock. Only callers that hold a real
        clock (launch/) bind one; the deterministic zero-clock engines
        never do, keeping traces wall-free and byte-stable."""
        if clock is not None:
            self._clock = clock

    def _push(self, ph: str, name: str, tick: int, group: Label,
              lane: Label, args: Dict[str, Any]) -> TraceRecord:
        rec = TraceRecord(
            seq=self._seq, ph=ph, name=name, tick=tick, group=group,
            lane=lane, args=tuple(sorted(args.items())),
            wall=self._clock() if self._clock is not None else None)
        self._seq += 1
        self._records.append(rec)
        return rec

    def event(self, name: str, *, tick: int, group: Label = 0,
              lane: Label = 0, **args) -> int:
        """Record an instant event; returns its seq."""
        return self._push("i", name, tick, group, lane, args).seq

    def begin(self, name: str, *, tick: int, group: Label = 0,
              lane: Label = 0, **args) -> int:
        """Open a span; returns a handle to pass to ``end``."""
        rec = self._push("B", name, tick, group, lane, args)
        self._open[rec.seq] = rec
        return rec.seq

    def end(self, handle: int, *, tick: int, **args) -> None:
        """Close the span opened under ``handle``. The end record
        reuses the begin's (name, group, lane) so exporters can pair
        them without bookkeeping."""
        b = self._open.pop(handle)
        if tick < b.tick:
            raise ValueError(f"span {b.name!r} ends at tick {tick} "
                             f"before its begin tick {b.tick}")
        self._push("E", b.name, tick, b.group, b.lane, args)

    # --------------------------------------------------- introspection ----
    @property
    def records(self) -> Tuple[TraceRecord, ...]:
        return tuple(self._records)

    def open_spans(self) -> List[TraceRecord]:
        """Begin records with no matching end yet (a drained run should
        report none — the well-formedness tests assert it)."""
        return sorted(self._open.values(), key=lambda r: r.seq)

    def lane_of(self, handle: int) -> Optional[Label]:
        """Lane of a still-open span (engine helpers stamp follow-up
        instant events onto the request's own track)."""
        rec = self._open.get(handle)
        return rec.lane if rec is not None else None

    def clear(self) -> None:
        self._records.clear()
        self._open.clear()
        self._seq = 0
