"""Overlapped round machinery shared by the PS and P2P orchestrators.

Counterpart of ``byzpy_tpu/engine/overlap.py``. Two mechanisms remove the
round's barriers without changing what each node computes:

* **Arrival-order streaming aggregation**: gradients fold into the
  aggregator the moment they land (:func:`gather_arrival_order` and the
  classes' ``fold`` / ``fold_finalize``), so flattening and the
  aggregator's incremental work hide in the straggler window.
* **Cross-round prefetch**: a node's round ``r + 1`` ``compute_gradient``
  call goes out the moment its round ``r`` apply resolves. Per-node
  program order is kept (apply ``r`` before compute ``r + 1`` on a node),
  so results equal the serial schedule's; only the interleaving across
  nodes changes.

Both orchestrators take :class:`OverlapConfig`.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, List, Optional, Sequence

from ..observability import metrics as obs_metrics
from ..observability import runtime as obs_runtime


@dataclass(frozen=True)
class OverlapConfig:
    """Knobs of the overlapped round engine.

    ``stream``
        Fold gradients into the aggregator in arrival order. Applies only
        when the aggregator declares ``supports_streaming`` and neither a
        pre-aggregator nor an actor-pool executor is configured (those
        need the whole list and keep the barrier).
    ``prefetch_depth``
        Rounds of honest ``compute_gradient`` calls in flight beyond the
        round being aggregated: 0 disables prefetch, 1 (the default)
        double-buffers. Per-node order makes depths above 1 behave as 1.
    """

    stream: bool = True
    prefetch_depth: int = 1

    def __post_init__(self) -> None:
        if self.prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be >= 0 (got {self.prefetch_depth})")


@dataclass
class RoundOverlapStats:
    """One round's ingestion accounting (``ParameterServer.last_overlap_stats``).

    ``ingest_lags_s`` holds, per gradient, the time from its arrival to
    its consumption (the fold's end when streaming, the aggregate's start
    on the barrier path); ``mode`` is the path that served the round.
    With telemetry on, each lag also feeds the process histogram
    ``byzpy_overlap_ingest_lag_seconds``."""

    mode: str = "barrier"
    ingest_lags_s: List[float] = field(default_factory=list)
    round_seconds: float = 0.0

    def observe_lag(self, lag_s: float) -> None:
        self.ingest_lags_s.append(lag_s)
        if obs_runtime.STATE.enabled:
            _ingest_lag_histogram().observe(lag_s)

    def lag_percentile(self, pct: float) -> float:
        """Ingestion-lag percentile (nearest rank), seconds."""
        return obs_metrics.percentile_of_sorted(sorted(self.ingest_lags_s), pct)


def _ingest_lag_histogram() -> "obs_metrics.Histogram":
    return obs_metrics.registry().histogram(
        "byzpy_overlap_ingest_lag_seconds",
        help="arrival-to-consumption lag of each gradient (overlap engine)",
    )


async def gather_arrival_order(
    aws: Sequence[Awaitable[Any]],
    *,
    on_item: Optional[Callable[[int, Any], None]] = None,
) -> List[Any]:
    """Run awaitables concurrently, call ``on_item(index, result)`` the
    moment each completes (arrival order), and return the results in input
    order.

    Every awaitable settles before a failure is raised, and the one raised
    is the first by input index, whatever the arrival order; sibling
    exceptions are retrieved. An exception from ``on_item`` (a fold that
    rejects a gradient) counts as that item's failure. Cancelling this
    coroutine cancels every awaitable still in flight, and waits for them,
    before the cancellation propagates."""
    tasks = [asyncio.ensure_future(a) for a in aws]
    results: List[Any] = [None] * len(tasks)
    failed: List[Optional[BaseException]] = [None] * len(tasks)
    pending = set(tasks)
    index_of = {t: i for i, t in enumerate(tasks)}
    try:
        while pending:
            done, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                i = index_of[t]
                if t.cancelled():
                    failed[i] = asyncio.CancelledError()
                    continue
                exc = t.exception()
                if exc is not None:
                    failed[i] = exc
                    continue
                results[i] = t.result()
                if on_item is not None:
                    try:
                        on_item(i, results[i])
                    except BaseException as cb_exc:  # noqa: BLE001 - the item's failure
                        failed[i] = cb_exc
    except asyncio.CancelledError:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise
    for exc in failed:
        if exc is not None:
            raise exc
    return results


async def settle_all(aws: Sequence[Awaitable[Any]]) -> List[Any]:
    """Await every awaitable, then raise the first failure by input order
    with every sibling's exception retrieved: the barrier counterpart of
    :func:`gather_arrival_order`."""
    results = await asyncio.gather(*aws, return_exceptions=True)
    for r in results:
        if isinstance(r, BaseException):
            raise r
    return results


def now() -> float:
    """Monotonic stamp of the ingestion-lag accounting."""
    return time.perf_counter()


__all__ = [
    "OverlapConfig",
    "RoundOverlapStats",
    "gather_arrival_order",
    "now",
    "settle_all",
]
