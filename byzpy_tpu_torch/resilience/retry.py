"""Retry with exponential backoff, decorrelated jitter, and a deadline.

Counterpart of ``byzpy_tpu/resilience/retry.py``. One policy object, one
async driver. The schedule is the "decorrelated jitter" rule, ``sleep =
min(cap, uniform(base, 3 * prev_sleep))``, which spreads synchronized
retry storms instead of letting plain exponential backoff re-synchronize
them. Two budgets bound every retry loop: ``max_attempts`` and a total
wall-clock ``deadline_s``; whichever runs out first raises
:class:`RetryBudgetExceededError` with the last real error chained as
``__cause__``.

Classification is explicit: ``fatal`` exception types re-raise at once,
then ``retryable`` types retry, and anything unlisted is fatal (the safe
side for a wire that carries at-least-once effects). Time, sleep and
randomness are injectable; the driver publishes ``byzpy_retry_total`` /
``byzpy_retry_exhausted_total`` per component into the process registry.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

from ..observability import metrics as _obs_metrics

#: Errors a wire operation may hit without the request having taken
#: effect: connection refused / reset / aborted, timeouts, half-read
#: frames (``OSError`` covers the ``ConnectionError`` family).
DEFAULT_RETRYABLE: Tuple[type, ...] = (
    OSError,
    TimeoutError,
    asyncio.TimeoutError,
    asyncio.IncompleteReadError,
    EOFError,
)


class RetryBudgetExceededError(RuntimeError):
    """Every attempt failed and the attempt/deadline budget is spent.

    The last underlying error is chained as ``__cause__``; ``attempts``
    and ``elapsed_s`` record how much budget the loop consumed."""

    def __init__(self, message: str, *, attempts: int, elapsed_s: float) -> None:
        super().__init__(message)
        self.attempts = attempts
        self.elapsed_s = elapsed_s


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule + budgets + error classification (immutable).

    ``base_s`` seeds the first sleep; every subsequent sleep draws
    uniformly from ``[base_s, 3 * previous]`` capped at ``cap_s``
    (decorrelated jitter). ``deadline_s`` is the TOTAL budget across
    attempts and sleeps - a retry that could not possibly finish before
    the deadline is not started. ``fatal`` wins over ``retryable`` when
    both match; unlisted exception types are fatal."""

    max_attempts: int = 5
    base_s: float = 0.05
    cap_s: float = 2.0
    deadline_s: float = 30.0
    retryable: Tuple[type, ...] = DEFAULT_RETRYABLE
    fatal: Tuple[type, ...] = field(default_factory=tuple)

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1 (got {self.max_attempts})")
        if self.base_s <= 0 or self.cap_s < self.base_s:
            raise ValueError(
                f"need 0 < base_s <= cap_s (got {self.base_s}/{self.cap_s})"
            )
        if self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0 (got {self.deadline_s})")

    def is_retryable(self, exc: BaseException) -> bool:
        """``fatal`` first, then ``retryable``; unlisted types are fatal."""
        if isinstance(exc, self.fatal):
            return False
        return isinstance(exc, self.retryable)

    def next_backoff_s(self, prev_s: Optional[float], rng: random.Random) -> float:
        """One decorrelated-jitter draw: ``min(cap, U(base, 3*prev))``
        (the first draw uses ``base_s`` as ``prev``)."""
        prev = self.base_s if prev_s is None else prev_s
        return min(self.cap_s, rng.uniform(self.base_s, 3.0 * prev))


#: (retries, exhausted) counter pairs per component - resolved once.
_COUNTER_CACHE: Dict[str, tuple] = {}


def _counters(component: str) -> tuple:
    pair = _COUNTER_CACHE.get(component)
    if pair is None:
        reg = _obs_metrics.registry()
        labels = {"component": component}
        pair = _COUNTER_CACHE[component] = (
            reg.counter(
                "byzpy_retry_total",
                help="re-attempts after a retryable failure",
                labels=labels,
            ),
            reg.counter(
                "byzpy_retry_exhausted_total",
                help="retry loops that spent their whole attempt/deadline budget",
                labels=labels,
            ),
        )
    return pair


async def retry_async(
    fn: Callable[[int], Awaitable[Any]],
    *,
    policy: RetryPolicy,
    component: str = "generic",
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], Awaitable[None]] = asyncio.sleep,
    clock: Callable[[], float] = time.monotonic,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
) -> Any:
    """Run ``await fn(attempt)`` under ``policy`` (attempt is 0-based).

    Retryable failures sleep the jittered backoff and try again until
    either budget is spent; fatal failures re-raise immediately.
    ``on_retry(attempt, exc, backoff_s)`` fires before each sleep (the
    serving client uses it to drop its dead connection). ``rng``,
    ``sleep`` and ``clock`` are injectable for deterministic tests."""
    rng = rng if rng is not None else random.Random()
    retries, exhausted = _counters(component)
    start = clock()
    prev_backoff: Optional[float] = None
    last_exc: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return await fn(attempt)
        except BaseException as exc:  # noqa: BLE001 - classified below
            if isinstance(exc, (KeyboardInterrupt, SystemExit, asyncio.CancelledError)):
                raise
            if not policy.is_retryable(exc):
                raise
            last_exc = exc
        elapsed = clock() - start
        backoff = policy.next_backoff_s(prev_backoff, rng)
        prev_backoff = backoff
        if (
            attempt + 1 >= policy.max_attempts
            or elapsed + backoff >= policy.deadline_s
        ):
            break
        retries.inc()
        if on_retry is not None:
            on_retry(attempt, last_exc, backoff)
        await sleep(backoff)
    exhausted.inc()
    elapsed = clock() - start
    raise RetryBudgetExceededError(
        f"{component}: retry budget spent ({policy.max_attempts} attempts max, "
        f"{policy.deadline_s}s deadline, {elapsed:.3f}s elapsed); "
        f"last error: {type(last_exc).__name__}: {last_exc}",
        attempts=policy.max_attempts,
        elapsed_s=elapsed,
    ) from last_exc


async def connect_with_retry(
    host: str,
    port: int,
    *,
    policy: RetryPolicy,
    component: str = "connect",
    rng: Optional[random.Random] = None,
) -> tuple:
    """``asyncio.open_connection`` under ``policy`` - the one dial path
    shared by the serving client and the actor TCP transport, so a
    frontend/server restart window is ridden out instead of surfacing as
    ``ConnectionRefusedError`` to every caller."""

    async def dial(_attempt: int) -> tuple:
        return await asyncio.open_connection(host, port)

    return await retry_async(dial, policy=policy, component=component, rng=rng)


__all__ = [
    "DEFAULT_RETRYABLE",
    "RetryBudgetExceededError",
    "RetryPolicy",
    "connect_with_retry",
    "retry_async",
]
