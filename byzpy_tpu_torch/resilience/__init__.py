"""The self-healing runtime (counterpart of ``byzpy_tpu/resilience``):
the retry policies the wire and the serving client share, the per-tenant
write-ahead round log and snapshots behind ``ServingFrontend.recover``
(:mod:`.durable`), and the per-tenant circuit breaker (:mod:`.breaker`).
The heartbeat bridge and the kill-and-recover drill wait for ROADMAP
A.6(c)."""

from .breaker import BreakerOpenError, BreakerPolicy, CircuitBreaker
from .durable import DurabilityConfig, RecoveredTenant, RoundLog, TenantDurability, read_wal
from .retry import (
    DEFAULT_RETRYABLE,
    RetryBudgetExceededError,
    RetryPolicy,
    connect_with_retry,
    retry_async,
)

__all__ = [
    "BreakerOpenError",
    "BreakerPolicy",
    "CircuitBreaker",
    "DEFAULT_RETRYABLE",
    "DurabilityConfig",
    "RecoveredTenant",
    "RetryBudgetExceededError",
    "RetryPolicy",
    "RoundLog",
    "TenantDurability",
    "connect_with_retry",
    "read_wal",
    "retry_async",
]
