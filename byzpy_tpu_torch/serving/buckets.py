"""Bucketed cohort shapes of the serving tier.

Counterpart of ``byzpy_tpu/serving/buckets.py``. A front end closes rounds
with whatever cohort size ``m`` its window produced; the ladder of
power-of-two buckets up to the cohort cap gives every cohort one of
``log2(cap) + 1`` padded shapes, and the masked finalize
(:mod:`byzpy_tpu_torch.ops.robust`) keeps the result the unpadded
aggregate's. Host code.
"""

from __future__ import annotations

from typing import Tuple


class BucketLadder:
    """Power-of-two bucket sizes ``min_bucket, 2 min_bucket, ..., cap``.

    ``cap`` is rounded up to the next power-of-two multiple of
    ``min_bucket``, so the top bucket always holds a full cohort (the
    scheduler never drains more than ``cap`` submissions a round)."""

    __slots__ = ("sizes",)

    def __init__(self, cap: int, *, min_bucket: int = 2) -> None:
        if cap <= 0 or min_bucket <= 0:
            raise ValueError("cap and min_bucket must be >= 1")
        if min_bucket > cap:
            raise ValueError(f"min_bucket {min_bucket} > cap {cap}")
        sizes = [min_bucket]
        while sizes[-1] < cap:
            sizes.append(sizes[-1] * 2)
        self.sizes: Tuple[int, ...] = tuple(sizes)

    @property
    def cap(self) -> int:
        """Largest bucket (the scheduler's largest cohort)."""
        return self.sizes[-1]

    def bucket_for(self, m: int) -> int:
        """Smallest ladder size that holds an ``m``-row cohort."""
        if m <= 0:
            raise ValueError(f"cohort size must be >= 1 (got {m})")
        for size in self.sizes:
            if m <= size:
                return size
        raise ValueError(
            f"cohort of {m} exceeds the bucket cap {self.cap} — the "
            "scheduler must drain at most cap submissions per round"
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"BucketLadder(sizes={self.sizes})"


__all__ = ["BucketLadder"]
