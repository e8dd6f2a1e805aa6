"""Typed metrics registry: counters and fixed-bucket histograms.

Counterpart of ``byzpy_tpu/observability/metrics.py``, cut to what the
orchestrators publish: one process-wide :class:`MetricsRegistry`
(:func:`registry`) of counters and histograms that are get-or-create by
``(name, labels)``, and :func:`percentile_of_sorted`, the one
nearest-rank rule of the stats views (``engine.overlap.RoundOverlapStats``).
Gauges and the JAX package's exporters (Prometheus text, JSONL) come with
the rest of the telemetry layer (ROADMAP A.6).
"""

from __future__ import annotations

import re
import threading
from bisect import bisect_left
from typing import Dict, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default latency buckets (seconds): 10 us ... 60 s, 1-2.5-5 a decade.
LATENCY_BUCKETS_S = (
    1e-5, 2.5e-5, 5e-5,
    1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def percentile_of_sorted(sorted_values: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile of an already sorted list (rank
    ``round(pct / 100 * (n - 1))``, clamped; 0.0 on an empty list)."""
    n = len(sorted_values)
    if n == 0:
        return 0.0
    rank = max(0, min(n - 1, int(round(pct / 100.0 * (n - 1)))))
    return sorted_values[rank]


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "help", "labels", "_value")

    def __init__(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        """Add ``amount`` (>= 0)."""
        if amount < 0:
            raise ValueError("counters only go up")
        self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are the ascending upper bounds,
    and one implicit ``+Inf`` bucket catches the overflow. ``observe`` is
    one bisect and two adds; :meth:`percentile` interpolates inside the
    bucket that holds the nearest-rank sample."""

    __slots__ = ("name", "help", "labels", "buckets", "counts", "_count", "_sum")

    def __init__(
        self,
        name: str,
        help: str = "",
        labels: Optional[Dict[str, str]] = None,
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
    ) -> None:
        if not buckets or list(buckets) != sorted(float(b) for b in buckets):
            raise ValueError("buckets must be a non-empty ascending sequence")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        self.counts[bisect_left(self.buckets, value)] += 1
        self._count += 1
        self._sum += value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, pct: float) -> float:
        """Bucket-estimated percentile (the overflow bucket answers with
        the top finite edge)."""
        if self._count == 0:
            return 0.0
        rank = max(0, min(self._count - 1, int(round(pct / 100.0 * (self._count - 1)))))
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c > rank:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * (rank - seen + 0.5) / c
            seen += c
        return self.buckets[-1]


class MetricsRegistry:
    """Get-or-create home of every instrument: one name, one type."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._types: Dict[str, str] = {}

    def _get_or_create(self, kind: str, cls, name: str, help: str, labels, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = (name, _label_key(labels))
        with self._lock:
            if self._types.setdefault(name, kind) != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {self._types[name]}, not {kind}")
            inst = self._metrics.get(key)
            if inst is None:
                inst = self._metrics[key] = cls(name, help, labels, **kw)
            return inst

    def counter(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create("counter", Counter, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Optional[Dict[str, str]] = None,
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
    ) -> Histogram:
        return self._get_or_create("histogram", Histogram, name, help, labels, buckets=buckets)

    def reset(self) -> None:
        """Drop every instrument (tests only)."""
        with self._lock:
            self._metrics.clear()
            self._types.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry."""
    return _REGISTRY


__all__ = [
    "Counter",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "percentile_of_sorted",
    "registry",
]
