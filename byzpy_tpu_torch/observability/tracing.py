"""Round-lifecycle tracing: lightweight spans in a bounded ring.

Counterpart of ``byzpy_tpu/observability/tracing.py``, cut to what the
orchestrators open: ``span("ps.fold", track="ps", slot=3)`` brackets one
stage of a round; closed spans land in the process :class:`Tracer`'s
ring as chrome-trace events (``name``, ``ts``, ``dur``, ``tid``, ``args``)
with the span names and tracks of the JAX package; :func:`instant` records
a zero-duration event, and :meth:`Tracer.chrome_trace` /
:meth:`Tracer.export_chrome_trace` write the ring for Perfetto. The wire
context (:func:`wire_context`, :func:`adopt_context`) links a span across a
process or socket boundary; :func:`current_context`,
:class:`context_scope` and :func:`carry_context` thread it by hand and
across an executor hop (``loop.run_in_executor`` copies no contextvars).

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
import json
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


def current_context() -> Optional[Tuple[str, str]]:
    """The innermost open span's ``(trace_id, span_id)``, or ``None``
    outside any span (always ``None`` with telemetry off: a disabled span
    never sets the context)."""
    return _CTX.get()


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


class context_scope:
    """Scoped parent override: spans opened inside the ``with`` block are
    children of ``ctx`` (a ``(trace_id, span_id)`` pair, e.g. a round
    span's :attr:`Span.context`); ``ctx=None`` starts a fresh root."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[Tuple[str, str]]) -> None:
        self._ctx = None if ctx is None else (str(ctx[0]), str(ctx[1]))
        self._token = None

    def __enter__(self) -> "context_scope":
        self._token = _CTX.set(self._ctx)
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self._token is not None:
            _CTX.reset(self._token)
        return False


def carry_context(fn):
    """Wrap a callable about to cross an executor boundary so the caller's
    trace position rides along and the spans it opens stay in the caller's
    tree. With telemetry off, ``fn`` itself after one flag check."""
    if not runtime.STATE.enabled:
        return fn
    ctx = contextvars.copy_context()

    def _run(*args: Any, **kwargs: Any):
        return ctx.run(fn, *args, **kwargs)

    return _run


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

    @property
    def context(self) -> Tuple[str, str]:
        """This span's ``(trace_id, span_id)``: the parent context a child
        opened elsewhere should carry."""
        return (self.trace_id, self.span_id)

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
        self._epoch_unix_s = time.time()
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

    def span(self, name: str, track: Optional[str] = None, **attrs: Any) -> Span:
        """Open a span on this tracer (unconditionally: the flag-checked
        door is the module-level :func:`span`)."""
        return Span(self, name, track, attrs)

    def instant(self, name: str, track: Optional[str] = None, **attrs: Any) -> None:
        """Record an instant (zero-duration) event."""
        ev: Dict[str, Any] = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
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

    def chrome_trace(self) -> dict:
        """The chrome-trace JSON object (``traceEvents`` and metadata) for
        Perfetto or ``chrome://tracing``: a name event per named track the
        retained events use, the events, and a flow arrow for every
        parent/child link across tracks."""
        pid = os.getpid()
        retained = self.events()
        used_tids = {ev["tid"] for ev in retained}
        with self._lock:
            tracks = dict(self._tracks)
        events: List[dict] = []
        for track, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            if tid in used_tids:
                events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                               "args": {"name": track}})
        for ev in retained:
            events.append({"pid": pid, **ev})
        by_span = {ev["args"]["span"]: ev for ev in retained
                   if ev.get("ph") == "X" and "span" in ev.get("args", ())}
        flow_id = 0
        for ev in retained:
            if ev.get("ph") != "X":
                continue
            parent = by_span.get(ev.get("args", {}).get("parent"))
            if parent is None or parent["tid"] == ev["tid"]:
                continue
            flow_id += 1
            events.append({"name": "trace", "cat": "flow", "ph": "s", "id": flow_id, "pid": pid,
                           "tid": parent["tid"], "ts": parent["ts"]})
            events.append({"name": "trace", "cat": "flow", "ph": "f", "bp": "e", "id": flow_id,
                           "pid": pid, "tid": ev["tid"], "ts": ev["ts"]})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "byzpy_tpu_torch.observability",
                          "epoch_unix_s": self._epoch_unix_s, "dropped_events": self.dropped},
        }

    def export_chrome_trace(self, path: str) -> int:
        """Write :meth:`chrome_trace` to ``path``; returns the event count."""
        trace = self.chrome_trace()
        with open(path, "w") as fh:
            json.dump(trace, fh)
        return len(trace["traceEvents"])


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


def instant(name: str, track: Optional[str] = None, **attrs: Any) -> None:
    """Record an instant event on the process tracer (flag-checked); inside
    an open span it links into the trace (``trace`` / ``parent`` args)."""
    if runtime.STATE.enabled:
        ctx = _CTX.get()
        if ctx is not None:
            attrs.setdefault("trace", ctx[0])
            attrs.setdefault("parent", ctx[1])
        _TRACER.instant(name, track, **attrs)


__all__ = [
    "NULL_SPAN",
    "Span",
    "Tracer",
    "adopt_context",
    "begin_span",
    "carry_context",
    "context_scope",
    "current_context",
    "device_span",
    "end_span",
    "instant",
    "span",
    "tracer",
    "wire_context",
]
