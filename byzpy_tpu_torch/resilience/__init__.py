"""Retry policies for the wire (counterpart of ``byzpy_tpu/resilience``,
the dial policy the actor transports share)."""

from .retry import (
    DEFAULT_RETRYABLE,
    RetryBudgetExceededError,
    RetryPolicy,
    connect_with_retry,
    retry_async,
)

__all__ = [
    "DEFAULT_RETRYABLE",
    "RetryBudgetExceededError",
    "RetryPolicy",
    "connect_with_retry",
    "retry_async",
]
