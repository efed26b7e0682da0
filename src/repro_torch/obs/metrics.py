"""Typed metrics registry: counters, gauges, histograms.

One ``MetricsRegistry`` backs every serving subsystem's counters —
the engine's ``stats`` mapping, the queue/pool/spec publishers and the
pipeline's ``PipelineStats`` are all *views* over registry metrics, so
a run has exactly one place its numbers live (DESIGN.md §Observability
maps each legacy stats key to its registry metric).

Conventions:

  * metrics are identified by ``(kind, name, labels)``; ``labeled()``
    returns a facade that injects fixed labels (the cluster scopes each
    replica's metrics with ``replica=i``) and whose ``reset()`` zeroes
    only the metrics created through it;
  * empty histograms report ``None`` from ``percentile()``/``mean()``
    — never 0.0 (the empty-percentile convention; renderers print
    "n/a");
  * ``snapshot()`` is deterministic: keys sorted, values plain Python.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Percentile of ``values``, or None for an empty series — 0.0
    would read as a perfect latency for a run that finished nothing
    (the single shared implementation behind every percentile the
    serving stack reports)."""
    vals = list(values)
    return float(np.percentile(np.asarray(vals), q)) if vals else None


class Counter:
    """Monotone-by-convention integer counter (views may assign it
    directly — the engine's ``stats[k] = v`` compatibility path)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def zero(self) -> None:
        self.value = 0


class Gauge:
    """Last-write-wins scalar with a ``max`` helper for peaks."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def max(self, v) -> None:
        if v > self.value:
            self.value = v

    def zero(self) -> None:
        self.value = 0


class Histogram:
    """Exact-sample histogram (serving runs observe thousands of
    points, not millions — keeping the samples makes percentiles exact
    and the registry the single source the summaries read)."""

    __slots__ = ("name", "labels", "values")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.values: List[float] = []

    def observe(self, v) -> None:
        self.values.append(v)

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def total(self) -> float:
        return sum(self.values)

    def mean(self) -> Optional[float]:
        return (self.total / len(self.values)) if self.values else None

    def percentile(self, q: float) -> Optional[float]:
        return percentile(self.values, q)

    def zero(self) -> None:
        self.values = []


class MetricsRegistry:
    """The store. ``counter``/``gauge``/``histogram`` are get-or-create
    (idempotent — a view and a publisher naming the same metric share
    one object)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, str, Tuple[Tuple[str, str], ...]],
                            object] = {}

    def _get(self, kind: str, cls, name: str, labels: Dict[str, str]):
        key = (kind, name, tuple(sorted((k, str(v))
                                        for k, v in labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[2])
            self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    def labeled(self, **labels) -> "LabeledRegistry":
        """Facade that stamps ``labels`` onto every metric created
        through it (cluster replicas share one store, scoped per
        replica) and whose reset() touches only its own metrics."""
        return LabeledRegistry(self, labels)

    def reset(self) -> None:
        """Zero every metric (engine/cluster reset; histograms drop
        their samples)."""
        for m in self._metrics.values():
            m.zero()

    def snapshot(self) -> Dict[str, Dict]:
        """Deterministic dump: ``kind -> "name{labels}" -> value``.
        Histograms render count/total and the standard percentiles —
        ``None`` when empty, never 0.0."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for (kind, name, labels), m in sorted(
                self._metrics.items(), key=lambda kv: kv[0]):
            label_s = ",".join(f"{k}={v}" for k, v in labels)
            full = f"{name}{{{label_s}}}" if label_s else name
            if kind == "counter":
                out["counters"][full] = m.value
            elif kind == "gauge":
                out["gauges"][full] = m.value
            else:
                out["histograms"][full] = {
                    "count": m.count, "total": m.total,
                    "mean": m.mean(),
                    "p50": m.percentile(50), "p95": m.percentile(95),
                    "p99": m.percentile(99)}
        return out


class LabeledRegistry:
    """Label-injecting facade over a shared ``MetricsRegistry``."""

    def __init__(self, root: MetricsRegistry, labels: Dict[str, str]):
        self._root = root
        self._labels = dict(labels)
        self._mine: List[object] = []

    def _track(self, m):
        if m not in self._mine:
            self._mine.append(m)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._track(self._root.counter(
            name, **{**self._labels, **labels}))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._track(self._root.gauge(
            name, **{**self._labels, **labels}))

    def histogram(self, name: str, **labels) -> Histogram:
        return self._track(self._root.histogram(
            name, **{**self._labels, **labels}))

    def labeled(self, **labels) -> "LabeledRegistry":
        return LabeledRegistry(self._root, {**self._labels, **labels})

    def reset(self) -> None:
        """Zero only this facade's metrics — one replica's reset must
        not clear its siblings' slices of the shared store."""
        for m in self._mine:
            m.zero()

    def snapshot(self) -> Dict[str, Dict]:
        return self._root.snapshot()


class StatsView:
    """Dict-compatible view over a fixed family of registry counters.

    Replaces the engine's ad-hoc ``self.stats`` dict: same mapping
    surface (``stats[k] += 1``, ``dict(stats)``, ``{**stats}``,
    ``.keys()``/``.items()``), but the numbers live in the registry.
    Key order is the declaration order, matching the dict it
    replaced."""

    def __init__(self, registry, keys: Sequence[str], prefix: str = ""):
        self._registry = registry
        self._prefix = prefix
        self._counters: Dict[str, Counter] = {
            k: registry.counter(prefix + k) for k in keys}

    def __getitem__(self, key: str) -> int:
        return self._counters[key].value

    def __setitem__(self, key: str, value: int) -> None:
        if key not in self._counters:
            # late-declared counters still join the view (and therefore
            # its reset sweep) — nothing can accumulate outside it
            self._counters[key] = self._registry.counter(
                self._prefix + key)
        self._counters[key].value = value

    def __contains__(self, key: str) -> bool:
        return key in self._counters

    def __iter__(self) -> Iterator[str]:
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def keys(self):
        return self._counters.keys()

    def values(self):
        return [c.value for c in self._counters.values()]

    def items(self):
        return [(k, c.value) for k, c in self._counters.items()]

    def get(self, key: str, default=None):
        c = self._counters.get(key)
        return default if c is None else c.value

    def __eq__(self, other) -> bool:
        if isinstance(other, StatsView):
            return self.items() == other.items()
        if isinstance(other, dict):
            return dict(self.items()) == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"StatsView({dict(self.items())!r})"

    def reset(self) -> None:
        for c in self._counters.values():
            c.zero()
