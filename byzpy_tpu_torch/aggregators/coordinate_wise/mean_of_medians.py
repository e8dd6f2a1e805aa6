"""MeaMed: per-coordinate mean of the ``n - f`` values nearest the median.

Counterpart of ``byzpy_tpu/aggregators/coordinate_wise/mean_of_medians.py``
(behavioral parity: ``byzpy/aggregators/coordinate_wise/mean_of_medians.py:28-162``):
``robust.mean_of_medians``, B6 on the card. On an actor pool it fans out
feature chunks (``aggregators/chunked.py``), each chunk B6 on the card.
"""

from __future__ import annotations

import torch

from ...ops import robust
from ...utils.device import DeviceLike
from ..base import Aggregator, check_chunk_size
from ..chunked import FeatureChunkedAggregator


def _meamed_chunk(chunk: torch.Tensor, *, f: int) -> torch.Tensor:
    return robust.mean_of_medians(chunk.contiguous(), f=f)


class MeanOfMedians(FeatureChunkedAggregator, Aggregator):
    """MeaMed: per coordinate, average the n - f values closest to the median."""

    name = "mean-of-medians"
    _chunk_fn = staticmethod(_meamed_chunk)

    def __init__(self, f: int, *, chunk_size: int = 8192, device: DeviceLike = None) -> None:
        if f < 0:
            raise ValueError("f must be >= 0")
        self.chunk_size = check_chunk_size(chunk_size)
        self.f = int(f)
        super().__init__(device=device)

    def validate_n(self, n: int) -> None:
        if self.f >= n:
            raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={self.f})")

    def _chunk_params(self):
        return {"f": self.f}

    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        return robust.mean_of_medians(x, f=self.f)

    supports_masked_finalize = True

    def _aggregate_matrix_masked(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return robust.masked_mean_of_medians(x, valid, f=self.f)

    def _aggregate_stream_matrix(self, xs: torch.Tensor) -> torch.Tensor:
        return robust.mean_of_medians_stream(xs, f=self.f)


__all__ = ["MeanOfMedians"]
