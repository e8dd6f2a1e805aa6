"""ARC: Adaptive Robust Clipping.

Counterpart of ``byzpy_tpu/pre_aggregators/arc.py`` (behavioral parity:
``byzpy/pre_aggregators/arc.py:36-161``): ``preagg.arc_clip``.
"""

from __future__ import annotations

import torch

from ..ops import preagg
from ..utils.device import DeviceLike
from .base import PreAggregator


class ARC(PreAggregator):
    """Adaptive Robust Clipping: clip the largest-norm rows to the
    next-largest remaining norm."""

    name = "pre-agg/arc"

    def __init__(self, f: int = 0, *, device: DeviceLike = None) -> None:
        if f < 0:
            raise ValueError("f must be >= 0")
        self.f = int(f)
        super().__init__(device=device)

    def validate_n(self, n: int) -> None:
        if self.f > n:
            raise ValueError(f"f must be <= number of vectors (got f={self.f}, n={n})")

    def _transform_matrix(self, x: torch.Tensor) -> torch.Tensor:
        return preagg.arc_clip(x, f=self.f)


__all__ = ["ARC"]
