"""Round-lifecycle tracing: lightweight spans in a bounded ring.

Counterpart of ``byzpy_tpu/observability/tracing.py``, cut to what the
orchestrators open: ``span("ps.fold", track="ps", slot=3)`` brackets one
stage of a round; closed spans land in the process :class:`Tracer`'s
ring as chrome-trace events (``name``, ``ts``, ``dur``, ``tid``, ``args``)
with the span names and tracks of the JAX package. The chrome and
Perfetto export and instants come with the rest of the telemetry layer
(ROADMAP A.6). The wire context (:func:`wire_context`,
:func:`adopt_context`) links a span across a process or socket boundary.

Cost: with telemetry off (:mod:`.runtime`) :func:`span`,
:func:`device_span` and :func:`begin_span` are one flag check returning
the shared no-op :data:`NULL_SPAN`. On, a span is two ``perf_counter_ns``
reads and one append.

Tracks: a span lands on the calling thread's track unless it names one
(``track="ps"``), so the PS and P2P round loops render on rows of their
own. Trace context: every span carries ``(trace_id, span_id, parent_id)``
through a contextvar, so a span opened inside another is its child across
``await``s.

Device correlation: :func:`device_span` also enters
``torch.profiler.record_function`` and, on a CUDA build with a card, a
``torch.cuda.nvtx`` range of the same name, where the reference enters
``jax.profiler.TraceAnnotation``: the host span then shows on the
profiler's timeline beside the kernels it launched.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import runtime

#: Synthetic tid space for named tracks.
_TRACK_TID_BASE = 1_000_000

_CTX: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = contextvars.ContextVar(
    "byzpy_torch_trace_ctx", default=None)

_ID_PREFIX = f"{os.getpid():x}{os.urandom(2).hex()}."
_IDS = itertools.count(1)


def _new_id() -> str:
    return f"{_ID_PREFIX}{next(_IDS):x}"


def wire_context() -> Optional[Tuple[str, str]]:
    """The current ``(trace_id, span_id)`` to stamp on a wire frame, with
    telemetry on and a span open; else ``None`` (one flag check)."""
    if not runtime.STATE.enabled:
        return None
    return _CTX.get()


def adopt_context(ctx: Any) -> None:
    """Make a decoded frame's context the caller's trace position, so the
    next span opened here is the remote sender's child. ``None`` clears
    it; anything malformed is ignored (a frame is never trusted)."""
    if ctx is None:
        _CTX.set(None)
        return
    try:
        trace_id, span_id = ctx
        _CTX.set((str(trace_id), str(span_id)))
    except Exception:  # noqa: BLE001 - wire input
        pass


class _NullSpan:
    """The disabled path's span: a shared, stateless no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One live span (a context manager); ``set`` and the ``span(...)``
    keywords become the event's ``args``."""

    __slots__ = ("name", "track", "attrs", "trace_id", "span_id", "parent_id",
                 "_tracer", "_t0_ns", "_token")

    def __init__(self, tracer: "Tracer", name: str, track: Optional[str],
                 attrs: Dict[str, Any]) -> None:
        self.name = name
        self.track = track
        self.attrs = attrs
        self.trace_id = ""
        self.span_id = ""
        self.parent_id: Optional[str] = None
        self._tracer = tracer
        self._t0_ns = 0
        self._token = None

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        parent = _CTX.get()
        if parent is None:
            self.trace_id = _new_id()
        else:
            self.trace_id, self.parent_id = parent
        self.span_id = _new_id()
        self._token = _CTX.set((self.trace_id, self.span_id))
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        t1 = time.perf_counter_ns()
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.attrs["trace"] = self.trace_id
        self.attrs["span"] = self.span_id
        if self.parent_id is not None:
            self.attrs["parent"] = self.parent_id
        self._tracer._record(self.name, self.track, self._t0_ns, t1, self.attrs)
        return False


class _DeviceSpan:
    """A :class:`Span` that also enters ``torch.profiler.record_function``
    and, where a card is present, a ``torch.cuda.nvtx`` range of its name
    (torch is imported on this path only)."""

    __slots__ = ("_span", "_record", "_nvtx")

    def __init__(self, span: Span) -> None:
        self._span = span
        self._record = None
        self._nvtx = False

    def set(self, **attrs: Any) -> "_DeviceSpan":
        self._span.set(**attrs)
        return self

    def __enter__(self) -> "_DeviceSpan":
        import torch

        self._span.__enter__()
        self._record = torch.profiler.record_function(self._span.name)
        self._record.__enter__()
        # NVTX exists only in a CUDA build; on a CPU build the span stays
        # a host and profiler span
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self._span.name)
            self._nvtx = True
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        import torch

        if self._nvtx:
            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        self._record.__exit__(exc_type, exc, tb)
        return self._span.__exit__(exc_type, exc, tb)


class Tracer:
    """Bounded in-memory trace: the last ``capacity`` closed spans."""

    def __init__(self, capacity: int = 65536) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._tracks: Dict[str, int] = {}
        self._epoch_ns = time.perf_counter_ns()
        self.dropped = 0

    def _tid(self, track: Optional[str]) -> int:
        if track is None:
            return threading.get_ident() & 0xFFFF
        tid = self._tracks.get(track)
        if tid is None:
            with self._lock:
                tid = self._tracks.setdefault(track, _TRACK_TID_BASE + len(self._tracks))
        return tid

    def _record(self, name: str, track: Optional[str], t0_ns: int, t1_ns: int,
                attrs: Dict[str, Any]) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0_ns - self._epoch_ns) / 1e3,
            "dur": (t1_ns - t0_ns) / 1e3,
            "tid": self._tid(track),
        }
        if attrs:
            ev["args"] = attrs
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def events(self) -> List[dict]:
        """The retained events, oldest first."""
        with self._lock:
            return list(self._events)

    def track_names(self) -> Dict[int, str]:
        """``{tid: track name}`` of the named tracks."""
        with self._lock:
            return {tid: name for name, tid in self._tracks.items()}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-wide tracer."""
    return _TRACER


def span(name: str, track: Optional[str] = None, **attrs: Any):
    """A span on the process tracer, or :data:`NULL_SPAN` with telemetry
    off."""
    if not runtime.STATE.enabled:
        return NULL_SPAN
    return Span(_TRACER, name, track, attrs)


def device_span(name: str, track: Optional[str] = None, **attrs: Any):
    """A :func:`span` that also marks the region on the profiler's and
    NVTX's timelines (around device work: folds, aggregates)."""
    if not runtime.STATE.enabled:
        return NULL_SPAN
    return _DeviceSpan(Span(_TRACER, name, track, attrs))


def begin_span(name: str, track: Optional[str] = None, **attrs: Any):
    """Open a span that :func:`end_span` closes from another call stack,
    perhaps another thread. It links into the caller's trace like ``with
    span(...)``, but the caller's context is restored at once, so later
    spans of this thread do not nest under it."""
    if not runtime.STATE.enabled:
        return NULL_SPAN
    sp = Span(_TRACER, name, track, attrs)
    sp.__enter__()
    if sp._token is not None:
        _CTX.reset(sp._token)
        sp._token = None
    return sp


def end_span(sp) -> None:
    """Close a :func:`begin_span` span; a no-op for :data:`NULL_SPAN`."""
    sp.__exit__(None, None, None)


__all__ = [
    "NULL_SPAN",
    "Span",
    "Tracer",
    "adopt_context",
    "begin_span",
    "device_span",
    "end_span",
    "span",
    "tracer",
    "wire_context",
]
