"""Stale-gradient discounts of the serving tier.

Counterpart of ``byzpy_tpu/serving/staleness.py``. A client computes
against the model round it last pulled; when its submission reaches the
scheduler the server may be ``delta`` rounds ahead, and the gradient is
scaled by a decreasing function of ``delta`` before it enters the
aggregate. ``discount(0)`` is exactly 1.0, so a fresh row's bits never
change (IEEE ``1.0 * x == x``); ``cutoff`` turns "too stale" into an
admission rejection. Host code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

_KINDS = ("none", "exponential", "polynomial")


@dataclass(frozen=True)
class StalenessPolicy:
    """Discount ``w = discount(delta)`` of a ``delta``-rounds-stale gradient.

    ``kind``: ``"none"`` (full weight), ``"exponential"`` (``gamma **
    delta``) or ``"polynomial"`` (``1 / (1 + delta) ** alpha``).
    ``cutoff``: submissions with ``delta > cutoff`` are not admitted."""

    kind: str = "none"
    gamma: float = 0.5
    alpha: float = 1.0
    cutoff: Optional[int] = None

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError("gamma must be in (0, 1]")
        if self.alpha < 0:
            raise ValueError("alpha must be >= 0")
        if self.cutoff is not None and self.cutoff < 0:
            raise ValueError("cutoff must be >= 0")

    def admits(self, delta: int) -> bool:
        """False when the submission is beyond the staleness cutoff."""
        return self.cutoff is None or delta <= self.cutoff

    def discount(self, delta: int) -> float:
        """Weight of a ``delta``-rounds-stale gradient; exactly 1.0 for
        ``delta <= 0`` (a client ahead of the server folds at full weight)
        and for ``kind="none"``."""
        if delta <= 0 or self.kind == "none":
            return 1.0
        if self.kind == "exponential":
            return float(self.gamma) ** int(delta)
        return 1.0 / float(1 + delta) ** float(self.alpha)


__all__ = ["StalenessPolicy"]
