"""Trace export: Chrome trace-event JSON (Perfetto-loadable) + JSONL.

The Chrome format (the ``chrome://tracing`` / Perfetto "JSON trace
event" schema) maps our tracks onto its process/thread axes:

  * record ``group``  -> ``pid`` (one Perfetto *process* per engine
    replica, plus string groups like ``"pipeline"``);
  * record ``lane``   -> ``tid`` (one *thread* per slot, plus the
    reserved ``queue`` / ``engine`` / ``kv`` lanes);
  * record ``tick``   -> ``ts`` in microseconds, spread by the
    within-tick ordinal so same-tick records keep their sequence order
    on the timeline (1 tick = 1000 "us"; ticks are logical time).

"M" metadata events name every process and thread. Serialization is
deterministic — events in seq order, ``sort_keys`` JSON, fixed
separators — so a same-seed run exports byte-identical files
(tests/test_obs.py and the traced cluster bench assert it).

``validate_chrome_trace`` is the schema checker the CI traced-bench
step runs (benchmarks/check_trace.py): phase vocabulary, required
fields, per-track B/E stack discipline, global ts monotonicity and
complete track naming.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple, Union

from repro_torch.obs.tracer import Label, TraceRecord, Tracer

# logical microseconds per engine tick on the Chrome timeline
TICK_US = 1000


def _label_key(v: Label) -> Tuple[int, str]:
    """Deterministic ordering over mixed int/str labels: numeric
    groups (replicas) first in numeric order, then strings."""
    return (0, f"{v:020d}") if isinstance(v, int) else (1, str(v))


def _label_name(kind: str, v: Label) -> str:
    return f"{kind} {v}" if isinstance(v, int) else str(v)


def _track_ids(records: Sequence[TraceRecord]
               ) -> Tuple[Dict[Label, int], Dict[Tuple[Label, Label], int]]:
    """Assign pids to groups and tids to (group, lane), sorted — ids
    are a pure function of the label set, not of arrival order."""
    groups = sorted({r.group for r in records}, key=_label_key)
    pids = {g: i for i, g in enumerate(groups)}
    tids: Dict[Tuple[Label, Label], int] = {}
    for g in groups:
        lanes = sorted({r.lane for r in records if r.group == g},
                       key=_label_key)
        for j, lane in enumerate(lanes):
            tids[(g, lane)] = j
    return pids, tids


def chrome_trace(records_or_tracer: Union[Tracer, Iterable[TraceRecord]]
                 ) -> Dict:
    """Build the Chrome trace-event document (a JSON-ready dict)."""
    records = (records_or_tracer.records
               if isinstance(records_or_tracer, Tracer)
               else tuple(records_or_tracer))
    pids, tids = _track_ids(records)
    events: List[Dict] = []
    for g, pid in sorted(pids.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0,
                       "args": {"name": _label_name("replica", g)}})
    for (g, lane), tid in sorted(tids.items(),
                                 key=lambda kv: (pids[kv[0][0]], kv[1])):
        events.append({"ph": "M", "name": "thread_name",
                       "pid": pids[g], "tid": tid,
                       "args": {"name": _label_name("slot", lane)}})
    ordinal: Dict[int, int] = {}          # tick -> events seen
    for r in records:                     # seq order by construction
        k = ordinal.get(r.tick, 0)
        ordinal[r.tick] = k + 1
        args = dict(r.args)
        args["seq"] = r.seq
        if r.wall is not None:
            args["wall"] = r.wall
        ev = {"ph": r.ph, "name": r.name, "pid": pids[r.group],
              "tid": tids[(r.group, r.lane)],
              "ts": r.tick * TICK_US + min(k, TICK_US - 1),
              "args": args}
        if r.ph == "i":
            ev["s"] = "t"                 # thread-scoped instant
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"tick_us": TICK_US}}


def _dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def dump_chrome_trace(tracer: Tracer, path) -> Path:
    """Write the Perfetto-loadable JSON; returns the path."""
    path = Path(path)
    path.write_text(_dumps(chrome_trace(tracer)) + "\n")
    return path


def jsonl_lines(records_or_tracer: Union[Tracer, Iterable[TraceRecord]]
                ) -> List[str]:
    """One compact JSON object per record, seq order, key-sorted."""
    records = (records_or_tracer.records
               if isinstance(records_or_tracer, Tracer)
               else tuple(records_or_tracer))
    lines = []
    for r in records:
        d = {"seq": r.seq, "ph": r.ph, "name": r.name, "tick": r.tick,
             "group": r.group, "lane": r.lane, "args": dict(r.args)}
        if r.wall is not None:
            d["wall"] = r.wall
        lines.append(_dumps(d))
    return lines


def dump_jsonl(tracer: Tracer, path) -> Path:
    path = Path(path)
    path.write_text("\n".join(jsonl_lines(tracer)) + "\n")
    return path


def write_trace(tracer: Tracer, path) -> Path:
    """``--trace-out`` dispatch: ``.jsonl`` writes the event log, any
    other suffix the Chrome trace JSON."""
    path = Path(path)
    if path.suffix == ".jsonl":
        return dump_jsonl(tracer, path)
    return dump_chrome_trace(tracer, path)


_PHASES = {"B", "E", "i", "M", "X"}


def validate_chrome_trace(doc: Dict) -> List[str]:
    """Schema/well-formedness errors in a Chrome trace document
    (empty list = valid). Checks the invariants our exporter promises,
    which are also what Perfetto needs to build the track tree."""
    errors: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document has no traceEvents array"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    named_procs, named_threads = set(), set()
    stacks: Dict[Tuple[int, int], List[str]] = {}
    last_ts: Dict[Tuple[int, int], float] = {}
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}: bad phase {ph!r}")
            continue
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            errors.append(f"{where}: pid/tid must be ints")
            continue
        key = (ev["pid"], ev["tid"])
        if ph == "M":
            if ev.get("name") == "process_name":
                named_procs.add(ev["pid"])
            elif ev.get("name") == "thread_name":
                named_threads.add(key)
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing event name")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: bad ts {ts!r}")
            continue
        if ts < last_ts.get(key, 0):
            errors.append(f"{where}: ts {ts} decreases on track {key}")
        last_ts[key] = ts
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(key, [])
            if not stack:
                errors.append(f"{where}: E with no open B on {key}")
            elif stack[-1] != ev["name"]:
                errors.append(f"{where}: E {ev['name']!r} closes "
                              f"B {stack[-1]!r} on {key}")
                stack.pop()
            else:
                stack.pop()
    for key, stack in sorted(stacks.items()):
        if stack:
            errors.append(f"track {key}: unclosed spans {stack}")
    for pid in sorted({e["pid"] for e in events
                       if isinstance(e, dict)
                       and isinstance(e.get("pid"), int)}):
        if pid not in named_procs:
            errors.append(f"pid {pid} has no process_name metadata")
    for key in sorted(last_ts):
        if key not in named_threads:
            errors.append(f"track {key} has no thread_name metadata")
    return errors


def load_and_validate(path) -> Tuple[Dict, List[str]]:
    """Round-trip helper: parse the file and validate (the Perfetto
    round-trip test and the CI checker share this)."""
    doc = json.loads(Path(path).read_text())
    return doc, validate_chrome_trace(doc)
