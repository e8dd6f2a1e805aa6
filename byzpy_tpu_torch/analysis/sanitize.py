"""Runtime invariant sanitizer of the serving tier.

Counterpart of ``byzpy_tpu/analysis/sanitize.py`` (the dynamic half of the
reference's static rules, which the port does not have yet: ROADMAP A.8).
It asserts invariants that only exist at runtime, as cheap opt-in hooks:

* ``loop_tick(name, threshold_s)`` — event-loop stall watchdog: each
  scheduler-loop iteration ticks; a monotonic gap above the threshold
  means something blocked the loop.
* ``audit_fold(tenant, round_id, keys)`` — exactly-once fold audit on
  every round close: a tenant's round ids must be strictly increasing
  (a repeated id is a double fold), and an idempotency-keyed submission
  must fold at most once.
* ``check_drained(name, value)`` — quiescence drain: a gauge that must
  read 0 at close.

The sanitizer never raises on the hot path and touches no RNG or
virtual clock — violations are recorded and surfaced later via
:func:`assert_clean`. Enable with ``BYZPY_TPU_TORCH_SANITIZE=1`` in the
environment (the port's own variable, as its wire reads
``BYZPY_TPU_TORCH_WIRE_*``) or :func:`enable` in code; disabled, every
hook is one predicate check.

Standard library only.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

_TRUTHY = ("1", "true", "yes", "on")


class _Sanitizer:
    """Process-wide sanitizer state (thread-safe; hooks fire from the
    event loop, the fold executor, and reader threads alike)."""

    def __init__(self) -> None:
        self.enabled = os.environ.get(
            "BYZPY_TPU_TORCH_SANITIZE", ""
        ).lower() in _TRUTHY
        self._lock = threading.Lock()
        self.violations: List[str] = []
        self._last_tick: Dict[str, float] = {}
        self._last_round: Dict[str, int] = {}
        self._folded_keys: set = set()
        self.counters: Dict[str, int] = {
            "loop_ticks": 0,
            "folds_audited": 0,
            "drain_checks": 0,
        }

    def _violate(self, message: str) -> None:
        with self._lock:
            self.violations.append(message)


_STATE = _Sanitizer()


def enabled() -> bool:
    """Whether hooks are live (env ``BYZPY_TPU_TORCH_SANITIZE`` or
    :func:`enable`)."""
    return _STATE.enabled


def enable() -> None:
    """Turn the hooks on for this process (tests, bench legs)."""
    _STATE.enabled = True


def disable() -> None:
    """Turn the hooks back off (state is kept; :func:`reset` drops it)."""
    _STATE.enabled = False


def reset() -> None:
    """Drop recorded violations, watchdog marks, audit state and
    counters — call between independent runs (the enable flag is
    preserved)."""
    with _STATE._lock:
        _STATE.violations.clear()
        _STATE._last_tick.clear()
        _STATE._last_round.clear()
        _STATE._folded_keys.clear()
        for k in _STATE.counters:
            _STATE.counters[k] = 0


def loop_tick(name: str, threshold_s: float = 1.0) -> None:
    """One scheduler-loop heartbeat. A monotonic gap since the previous
    tick above ``threshold_s`` records a stall violation — something
    blocked the loop between iterations. Thresholds are the CALLER's
    job to set generously (a window-length sleep is not a stall)."""
    if not _STATE.enabled:
        return
    now = time.monotonic()
    with _STATE._lock:
        _STATE.counters["loop_ticks"] += 1
        prev = _STATE._last_tick.get(name)
        _STATE._last_tick[name] = now
    if prev is not None and now - prev > threshold_s:
        _STATE._violate(
            f"loop-stall[{name}]: {now - prev:.3f}s between ticks "
            f"(threshold {threshold_s:.3f}s) — a blocking call is "
            f"riding the loop"
        )


def audit_fold(
    tenant: str,
    round_id: int,
    keys: Iterable[Tuple[str, Optional[Any]]] = (),
) -> None:
    """Exactly-once audit for one round close. ``keys`` is the folded
    cohort's ``(client, seq)`` pairs; pairs with ``seq=None`` (legacy
    clients — no idempotency key) are skipped, the round-monotonicity
    check still runs."""
    if not _STATE.enabled:
        return
    with _STATE._lock:
        _STATE.counters["folds_audited"] += 1
        last = _STATE._last_round.get(tenant)
        _STATE._last_round[tenant] = round_id
        dup_rounds = last is not None and round_id <= last
        dup_keys = []
        for client, seq in keys:
            if seq is None:
                continue
            key = (tenant, client, seq)
            if key in _STATE._folded_keys:
                dup_keys.append((client, seq))
            else:
                _STATE._folded_keys.add(key)
    if dup_rounds:
        _STATE._violate(
            f"double-fold[{tenant}]: round {round_id} closed after "
            f"round {last} — round ids must strictly increase "
            f"(exactly-once close)"
        )
    for client, seq in dup_keys:
        _STATE._violate(
            f"double-fold[{tenant}]: submission ({client}, seq={seq}) "
            f"folded twice"
        )


def check_drained(name: str, value: int) -> None:
    """Quiescence check: ``value`` must be 0 (e.g. the
    ``byzpy_root_partials_inflight`` gauge at coordinator close)."""
    if not _STATE.enabled:
        return
    with _STATE._lock:
        _STATE.counters["drain_checks"] += 1
    if value != 0:
        _STATE._violate(
            f"leak[{name}]: {value} still in flight at quiescence — "
            f"a decrement was lost on some verify/merge path"
        )


def violations() -> List[str]:
    """Snapshot of recorded violations (copy; safe to mutate)."""
    with _STATE._lock:
        return list(_STATE.violations)


def counters() -> Dict[str, int]:
    """Snapshot of hook-fire counters — a sanitized run with zero
    ``folds_audited`` proves nothing; assert these are nonzero."""
    with _STATE._lock:
        return dict(_STATE.counters)


def assert_clean() -> None:
    """Raise ``AssertionError`` listing every recorded violation (the
    bench/test-side teeth — never called on the hot path)."""
    found = violations()
    if found:
        raise AssertionError(
            "sanitizer recorded %d violation(s):\n  %s"
            % (len(found), "\n  ".join(found))
        )


__all__ = [
    "enabled",
    "enable",
    "disable",
    "reset",
    "loop_tick",
    "audit_fold",
    "check_drained",
    "violations",
    "counters",
    "assert_clean",
]
