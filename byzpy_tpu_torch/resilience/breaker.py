"""Per-tenant circuit breaker: failed rounds quarantine, never crash-loop.

Counterpart of ``byzpy_tpu/resilience/breaker.py``.

A tenant whose rounds keep failing (poisoned cohorts, an aggregator that
OOMs at some bucket, a byzantine payload that reliably crashes the fold)
would otherwise burn the device lock forever: every window closes a
cohort, every cohort dies in the crash guard, every accepted submission
is dropped. The breaker turns that loop into a bounded degraded mode:

* ``closed`` — normal serving; consecutive failures count up.
* ``open`` — after ``threshold`` CONSECUTIVE failed rounds the tenant is
  quarantined: new submissions are rejected with an explicit reason and
  the admission queue is drained (accounted, never silent), so clients
  see backpressure instead of acks that can only be dropped.
* ``half_open`` — after ``cooldown_s`` one probe round is allowed
  through; success closes the breaker, another failure re-opens it for a
  fresh cooldown.

The clock is injected (the serving frontend passes its own, so the chaos
harness drives breakers on virtual time deterministically)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class BreakerOpenError(RuntimeError):
    """Raised by callers that treat quarantine as exceptional (the
    serving frontend rejects with a reason instead)."""


@dataclass(frozen=True)
class BreakerPolicy:
    """Quarantine knobs (immutable; state lives in :class:`CircuitBreaker`).

    ``threshold`` consecutive failed rounds open the breaker;
    ``cooldown_s`` is how long the quarantine holds before one probe
    round is allowed through."""

    threshold: int = 5
    cooldown_s: float = 30.0

    def __post_init__(self) -> None:
        if self.threshold < 1:
            raise ValueError(f"threshold must be >= 1 (got {self.threshold})")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0 (got {self.cooldown_s})")


class CircuitBreaker:
    """The closed → open → half-open state machine (module docstring)."""

    __slots__ = (
        "policy", "_clock", "state", "consecutive_failures",
        "opened_at", "opens", "last_error",
    )

    def __init__(
        self,
        policy: BreakerPolicy,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.policy = policy
        self._clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        #: lifetime count of closed→open transitions (telemetry)
        self.opens = 0
        self.last_error = ""

    def allow(self) -> bool:
        """Whether the tenant may accept work right now. An open breaker
        past its cooldown transitions to half-open and allows the probe."""
        if self.state == OPEN:
            assert self.opened_at is not None
            if self._clock() - self.opened_at >= self.policy.cooldown_s:
                self.state = HALF_OPEN
                return True
            return False
        return True

    def record_failure(self, error: str = "") -> bool:
        """Count one failed round; returns True when this failure OPENS
        the breaker (the caller then drains its queue once)."""
        self.consecutive_failures += 1
        if error:
            self.last_error = error
        if self.state == HALF_OPEN or (
            self.state == CLOSED
            and self.consecutive_failures >= self.policy.threshold
        ):
            self.state = OPEN
            self.opened_at = self._clock()
            self.opens += 1
            return True
        return False

    def record_success(self) -> None:
        """A round closed cleanly: reset the failure streak and close."""
        self.consecutive_failures = 0
        self.state = CLOSED
        self.opened_at = None

    def snapshot(self) -> dict:
        """JSON-ready state for stats/metrics exporters."""
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "opens": self.opens,
            "last_error": self.last_error,
        }


__all__ = ["BreakerOpenError", "BreakerPolicy", "CLOSED", "CircuitBreaker", "HALF_OPEN", "OPEN"]
