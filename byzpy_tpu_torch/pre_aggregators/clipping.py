"""Static L2-norm clipping.

Counterpart of ``byzpy_tpu/pre_aggregators/clipping.py`` (behavioral
parity: ``byzpy/pre_aggregators/clipping.py:35-130``): ``preagg.clip_rows``.
"""

from __future__ import annotations

import torch

from ..ops import preagg
from ..utils.device import DeviceLike
from .base import PreAggregator


class Clipping(PreAggregator):
    """Static norm clipping: scale every row into an L2 ball."""

    name = "pre-agg/clipping"

    def __init__(self, threshold: float, *, device: DeviceLike = None) -> None:
        if threshold < 0:
            raise ValueError("threshold must be >= 0")
        self.threshold = float(threshold)
        super().__init__(device=device)

    def _transform_matrix(self, x: torch.Tensor) -> torch.Tensor:
        return preagg.clip_rows(x, threshold=self.threshold)


__all__ = ["Clipping"]
