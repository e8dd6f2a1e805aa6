"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of ``byzpy_tpu/observability/metrics.py``: one process-wide
:class:`MetricsRegistry` (:func:`registry`) that the serving frontend,
the orchestrators, the overlap engine and the actor wire publish into.
Instruments are get-or-create by ``(name, labels)`` and are plain Python
objects — a counter increment is one float add under the GIL, a
histogram observation one bisect + two adds — so publishing is safe on
the asyncio admission loop. Exporters:

* :meth:`MetricsRegistry.prometheus_text` — the Prometheus text
  exposition format (version 0.0.4), served by the serving frontend's
  TCP ingress when a peer speaks HTTP instead of wire frames;
* :meth:`MetricsRegistry.to_jsonl` — append one timestamped JSON record
  per instrument; :func:`iter_jsonl` reads such a file back.

The module also owns :func:`percentile_of_sorted`, the one nearest-rank
percentile rule shared by the stats views
(``engine.overlap.RoundOverlapStats``, ``serving.credits.RoundStats``)
so their outputs cannot drift from each other. Metric names are the
reference's.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default latency buckets (seconds): 10 µs … 60 s, roughly 1-2.5-5 per
#: decade — wide enough for both sub-ms folds and multi-second rounds.
LATENCY_BUCKETS_S = (
    1e-5, 2.5e-5, 5e-5,
    1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: Default size buckets (counts/bytes): powers of two, 1 … 1Mi.
SIZE_BUCKETS = tuple(float(2**i) for i in range(0, 21))


def percentile_of_sorted(sorted_values: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile over an ALREADY-SORTED sample list — the
    single percentile rule shared by the stats views (rank =
    ``round(pct/100 · (n-1))``, clamped; 0.0 on empty input)."""
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


def _render_labels(label_key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [
        '{}="{}"'.format(k, v.replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in label_key
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotonically increasing count (e.g. submissions, frames, bytes)."""

    __slots__ = ("name", "help", "labels", "_value")

    def __init__(
        self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None
    ) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        """Add ``amount`` (must be >= 0) to the counter."""
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self._value += amount

    @property
    def value(self) -> float:
        """Current count."""
        return self._value


class Gauge:
    """Point-in-time value that can move both ways (queue depth, lease)."""

    __slots__ = ("name", "help", "labels", "_value")

    def __init__(
        self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None
    ) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0

    def set(self, value: float) -> None:
        """Set the gauge."""
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        """Add ``amount`` (may be negative)."""
        self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        """Subtract ``amount``."""
        self._value -= amount

    @property
    def value(self) -> float:
        """Current value."""
        return self._value


class Histogram:
    """Fixed-bucket histogram with cumulative-bucket percentiles.

    ``buckets`` are the upper bounds of each bin (ascending); one
    implicit ``+Inf`` bucket catches the overflow. ``observe`` is one
    ``bisect`` + two adds, so it is cheap enough for per-submission
    paths. :meth:`percentile` answers from the bucket counts with
    linear interpolation inside the winning bucket — an estimate whose
    error is bounded by the bucket width (the exact-sample views keep
    their own raw windows; see module docstring)."""

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
        self.counts = [0] * (len(self.buckets) + 1)  # +1 = the +Inf bin
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        """Record one sample."""
        self.counts[bisect_left(self.buckets, value)] += 1
        self._count += 1
        self._sum += value

    @property
    def count(self) -> int:
        """Total samples observed."""
        return self._count

    @property
    def sum(self) -> float:
        """Sum of all observed samples."""
        return self._sum

    @property
    def mean(self) -> float:
        """Mean of observed samples (0.0 when empty)."""
        return self._sum / self._count if self._count else 0.0

    def percentile(self, pct: float) -> float:
        """Bucket-estimated percentile: find the bucket holding the
        nearest-rank sample, interpolate linearly inside it (the +Inf
        bucket answers with the top finite edge — the estimate is
        clamped, never invented)."""
        if self._count == 0:
            return 0.0
        rank = max(0, min(self._count - 1, int(round(pct / 100.0 * (self._count - 1)))))
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c > rank:
                if i >= len(self.buckets):  # overflow bin: clamp
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (rank - seen + 0.5) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.buckets[-1]


class MetricsRegistry:
    """Get-or-create home for every instrument in the process.

    Keys are ``(name, sorted-label-items)``; re-requesting an existing
    key returns the SAME instrument (publishers can re-resolve cheaply),
    while requesting an existing name with a different instrument type
    is a hard error — one name, one type, as Prometheus requires."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._types: Dict[str, str] = {}
        self._helps: Dict[str, str] = {}

    def _get_or_create(self, kind: str, cls, name: str, help: str, labels, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = (name, _label_key(labels))
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if self._types[name] != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{self._types[name]}, not {kind}"
                    )
                return existing
            if self._types.setdefault(name, kind) != kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{self._types[name]}, not {kind}"
                )
            if help:
                self._helps.setdefault(name, help)
            inst = cls(name, help, labels, **kw)
            self._metrics[key] = inst
            return inst

    def counter(
        self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None
    ) -> Counter:
        """Get or create a :class:`Counter`."""
        return self._get_or_create("counter", Counter, name, help, labels)

    def gauge(
        self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None
    ) -> Gauge:
        """Get or create a :class:`Gauge`."""
        return self._get_or_create("gauge", Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Optional[Dict[str, str]] = None,
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
    ) -> Histogram:
        """Get or create a :class:`Histogram` (``buckets`` applies only
        on first creation of the ``(name, labels)`` series)."""
        return self._get_or_create(
            "histogram", Histogram, name, help, labels, buckets=buckets
        )

    def collect(self) -> List[object]:
        """Every registered instrument, in a stable (name, labels) order."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready dict of every instrument's current state."""
        out: Dict[str, object] = {}
        for inst in self.collect():
            key = inst.name + _render_labels(_label_key(inst.labels))
            if isinstance(inst, Histogram):
                out[key] = {
                    "type": "histogram",
                    "count": inst.count,
                    "sum": inst.sum,
                    "buckets": dict(
                        zip(
                            [*map(str, inst.buckets), "+Inf"],
                            inst.counts,
                            strict=True,
                        )
                    ),
                }
            else:
                out[key] = {
                    "type": self._types[inst.name],
                    "value": inst.value,
                }
        return out

    def prometheus_text(self) -> str:
        """The Prometheus text exposition (format version 0.0.4):
        ``# HELP``/``# TYPE`` headers once per family, histogram series
        expanded into cumulative ``_bucket{le=...}`` + ``_sum`` +
        ``_count``."""
        lines: List[str] = []
        seen_header = set()
        for inst in self.collect():
            name = inst.name
            if name not in seen_header:
                seen_header.add(name)
                if self._helps.get(name):
                    lines.append(f"# HELP {name} {self._helps[name]}")
                lines.append(f"# TYPE {name} {self._types[name]}")
            lkey = _label_key(inst.labels)
            if isinstance(inst, Histogram):
                cum = 0
                # counts has one extra (+Inf) bin, rendered after the loop
                for edge, c in zip(inst.buckets, inst.counts, strict=False):
                    cum += c
                    le = _render_labels(lkey, f'le="{_fmt(edge)}"')
                    lines.append(f"{name}_bucket{le} {cum}")
                cum += inst.counts[-1]
                inf_labels = _render_labels(lkey, 'le="+Inf"')
                lines.append(f"{name}_bucket{inf_labels} {cum}")
                lines.append(f"{name}_sum{_render_labels(lkey)} {_fmt(inst.sum)}")
                lines.append(f"{name}_count{_render_labels(lkey)} {cum}")
            else:
                lines.append(
                    f"{name}{_render_labels(lkey)} {_fmt(inst.value)}"
                )
        return "\n".join(lines) + ("\n" if lines else "")

    def to_jsonl(self, path: str) -> int:
        """Append one timestamped JSON record per instrument; returns
        the record count. (Host-side file IO — call it from sync code or
        via ``run_in_executor``, never directly on an event loop.)"""
        records = self.jsonl_records()
        with open(path, "a") as fh:
            for rec in records:
                fh.write(json.dumps(rec) + "\n")
        return len(records)

    def jsonl_records(self) -> List[dict]:
        """The JSONL exporter's records (no file IO) — one dict per
        instrument with ``time``/``name``/``labels``/``type`` plus the
        type's payload."""
        now = time.time()
        out: List[dict] = []
        for inst in self.collect():
            rec: dict = {
                "time": now,
                "name": inst.name,
                "labels": dict(inst.labels),
                "type": self._types[inst.name],
            }
            if isinstance(inst, Histogram):
                rec["count"] = inst.count
                rec["sum"] = inst.sum
                rec["buckets"] = list(
                    zip(list(inst.buckets), inst.counts[:-1], strict=True)
                )
                rec["overflow"] = inst.counts[-1]
            else:
                rec["value"] = inst.value
            out.append(rec)
        return out

    def reset(self) -> None:
        """Drop every instrument (tests and tool runs only — publishers
        hold direct references, so live code keeps its instruments but
        they vanish from exporters until re-registered)."""
        with self._lock:
            self._metrics.clear()
            self._types.clear()
            self._helps.clear()


def _fmt(v: float) -> str:
    """Prometheus value rendering: integers without the trailing .0."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry every fabric publishes into."""
    return _REGISTRY


def iter_jsonl(path: str) -> Iterable[dict]:
    """Yield records from a metrics JSONL file (blank lines skipped)."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield json.loads(line)


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "SIZE_BUCKETS",
    "iter_jsonl",
    "percentile_of_sorted",
    "registry",
]
