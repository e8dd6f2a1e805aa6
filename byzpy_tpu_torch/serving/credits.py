"""Per-client rate/credit accounting for the serving admission tier.

Counterpart of ``byzpy_tpu/serving/credits.py``.

A classic token bucket per client: submissions spend one token, tokens
refill at ``rate_per_s`` up to ``burst``. A client flooding the front
end exhausts its own bucket and gets per-client rejections; the shared
admission queue (and every other client's credit) is untouched. The
ledger also keeps the tier's rejection statistics — the observable
contract of the bounded queue is "reject at the door with a reason",
never silent drops or unbounded growth.

Time is injected (``now`` arguments) rather than read from the wall
clock so the accounting is exactly testable and the asyncio front end
can stamp one clock read per submission.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict

from ..observability.metrics import percentile_of_sorted


@dataclass(frozen=True)
class CreditPolicy:
    """Admission credit parameters applied to every client of a tenant.

    ``burst`` tokens are available immediately (bucket capacity);
    ``rate_per_s`` is the steady-state refill. ``rate_per_s <= 0``
    disables rate limiting (every submission has credit).

    ``max_tracked_clients`` bounds the ledger's per-client state: the
    least-recently-seen bucket is evicted past the cap, so a client-id
    churn attack costs bounded memory, not process growth. Per-client
    credit is only as strong as the client ids are: the HMAC wire key
    authenticates the TRANSPORT, not the id a client claims, so a
    sybil flood under fresh ids re-arms ``burst`` each time — the
    bounded admission queue (reject-at-the-door) is the backstop that
    keeps such a flood from becoming unbounded state or starvation."""

    rate_per_s: float = 100.0
    burst: float = 20.0
    max_tracked_clients: int = 65536

    def __post_init__(self) -> None:
        if self.burst <= 0:
            raise ValueError("burst must be > 0")
        if self.max_tracked_clients < 1:
            raise ValueError("max_tracked_clients must be >= 1")


class TokenBucket:
    """One client's credit state: ``tokens`` available at time ``last``."""

    __slots__ = ("policy", "tokens", "last")

    def __init__(self, policy: CreditPolicy, now: float) -> None:
        self.policy = policy
        self.tokens = policy.burst
        self.last = now

    def try_consume(
        self, now: float, cost: float = 1.0, *, rate_scale: float = 1.0
    ) -> bool:
        """Refill for the elapsed time, then spend ``cost`` tokens if
        available. Unlimited-rate policies always succeed.
        ``rate_scale`` multiplies the refill rate for THIS elapsed
        window — the forensics plane's trust-weighted refill hook
        (``scale == 1.0`` is bit-identical to the unscaled arithmetic:
        IEEE ``x * 1.0 == x``)."""
        if self.policy.rate_per_s <= 0:
            return True
        elapsed = max(0.0, now - self.last)
        self.tokens = min(
            self.policy.burst,
            self.tokens + elapsed * self.policy.rate_per_s * rate_scale,
        )
        self.last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


#: Rejection/acceptance reasons recorded by the ledger (the admission
#: queue adds ``"queue_full"``; the frontend adds transport reasons).
ACCEPTED = "accepted"
REJECTED_RATE = "rejected_rate"
REJECTED_FULL = "rejected_queue_full"
REJECTED_STALE = "rejected_too_stale"
REJECTED_SHAPE = "rejected_bad_shape"
REJECTED_TENANT = "rejected_unknown_tenant"


class CreditLedger:
    """Token buckets + admission statistics for one tenant.

    ``admit(client, now)`` answers the rate question only; the queue
    answers capacity. Every outcome is recorded through ``record`` so
    ``snapshot()`` is the tier's complete accept/reject accounting."""

    def __init__(self, policy: CreditPolicy) -> None:
        self.policy = policy
        # LRU order (most recent last): bounded by
        # policy.max_tracked_clients so id churn can't grow the ledger
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self.totals: Dict[str, int] = {}
        self.per_client_rejected: "OrderedDict[str, int]" = OrderedDict()
        #: buckets dropped past the tracking cap (an evicted client
        #: re-appears with a fresh burst — visible, not silent)
        self.evicted = 0

    def admit(self, client: str, now: float, *, rate_scale: float = 1.0) -> bool:
        """Spend one credit of ``client``'s bucket (created on first
        sight with a full burst allowance; least-recently-seen bucket
        evicted past ``max_tracked_clients``). ``rate_scale`` is the
        trust-weighted refill multiplier (1.0 = exact pre-forensics
        arithmetic)."""
        bucket = self._buckets.get(client)
        if bucket is None:
            bucket = self._buckets[client] = TokenBucket(self.policy, now)
            if len(self._buckets) > self.policy.max_tracked_clients:
                self._buckets.popitem(last=False)
                self.evicted += 1
        else:
            self._buckets.move_to_end(client)
        return bucket.try_consume(now, rate_scale=rate_scale)

    def record(self, outcome: str, client: str) -> None:
        """Count one admission outcome (see the reason constants)."""
        self.totals[outcome] = self.totals.get(outcome, 0) + 1
        if outcome != ACCEPTED:
            self.per_client_rejected[client] = (
                self.per_client_rejected.get(client, 0) + 1
            )
            self.per_client_rejected.move_to_end(client)
            if len(self.per_client_rejected) > self.policy.max_tracked_clients:
                self.per_client_rejected.popitem(last=False)

    def snapshot(self) -> dict:
        """Accept/reject totals, clients seen, and the worst offenders."""
        worst = heapq.nlargest(
            8, self.per_client_rejected.items(), key=lambda kv: kv[1]
        )
        return {
            "totals": dict(self.totals),
            "clients_seen": len(self._buckets),
            "most_rejected_clients": worst,
            "evicted": self.evicted,
        }


@dataclass
class RoundStats:
    """Per-tenant round telemetry kept by the frontend: close-to-close
    latencies (seconds) and cohort sizes, bounded to the last ``limit``
    rounds so serving stats never grow without bound either."""

    limit: int = 4096
    latencies_s: list = field(default_factory=list)
    cohort_sizes: list = field(default_factory=list)
    rounds: int = 0

    def record(self, latency_s: float, cohort_m: int) -> None:
        """Append one closed round's latency and cohort size."""
        self.rounds += 1
        self.latencies_s.append(latency_s)
        self.cohort_sizes.append(cohort_m)
        if len(self.latencies_s) > self.limit:
            del self.latencies_s[: -self.limit]
            del self.cohort_sizes[: -self.limit]

    def percentile_latency_s(self, pct: float) -> float:
        """Latency percentile over the retained window (0 when empty)."""
        return self.latency_percentiles_s(pct)[0]

    def latency_percentiles_s(self, *pcts: float) -> tuple:
        """Several latency percentiles from ONE sort of the retained
        window — a stats poll asking for p50 and p99 should not pay two
        full sorts of a 4096-entry window on the admission loop. The
        rank rule is the telemetry layer's shared
        :func:`~byzpy_tpu_torch.observability.metrics.percentile_of_sorted`."""
        data = sorted(self.latencies_s)
        return tuple(percentile_of_sorted(data, p) for p in pcts)


__all__ = [
    "ACCEPTED",
    "CreditLedger",
    "CreditPolicy",
    "REJECTED_FULL",
    "REJECTED_RATE",
    "REJECTED_SHAPE",
    "REJECTED_STALE",
    "REJECTED_TENANT",
    "RoundStats",
    "TokenBucket",
]
