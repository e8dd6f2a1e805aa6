"""Coordinate-wise median aggregator.

Counterpart of ``byzpy_tpu/aggregators/coordinate_wise/median.py``
(behavioral parity: ``byzpy/aggregators/coordinate_wise/median.py:28-178``):
``robust.coordinate_median``, B1 on the card; the ragged program is the
segmented sort-reduce on the card. On an actor pool it fans out feature
chunks (``aggregators/chunked.py``), each chunk's median B1 on the card.
"""

from __future__ import annotations

import torch

from ...ops import ragged as ragged_ops
from ...ops import robust
from ...utils.device import DeviceLike
from ..base import Aggregator, check_chunk_size
from ..chunked import FeatureChunkedAggregator


def _median_chunk(chunk: torch.Tensor) -> torch.Tensor:
    return robust.coordinate_median(chunk.contiguous())


class CoordinateWiseMedian(FeatureChunkedAggregator, Aggregator):
    """Per-coordinate median over the node axis."""

    name = "coordinate-wise-median"
    _chunk_fn = staticmethod(_median_chunk)

    def __init__(self, *, chunk_size: int = 8192, device: DeviceLike = None) -> None:
        self.chunk_size = check_chunk_size(chunk_size)
        super().__init__(device=device)

    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        return robust.coordinate_median(x)

    supports_masked_finalize = True

    def _aggregate_matrix_masked(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return robust.masked_coordinate_median(x, valid)

    def _aggregate_stream_matrix(self, xs: torch.Tensor) -> torch.Tensor:
        return robust.coordinate_median_stream(xs)

    def ragged_matrix_fn(self):
        """The ragged program, chosen from the device (see
        ``CoordinateWiseTrimmedMean.ragged_matrix_fn``): on the card the
        segmented program (``ops.ragged.ragged_median``; finite rows: the
        serving door sends a non-finite cohort to the exact path), on the
        CPU the generic door."""
        if self.device.type != "cuda":
            return super().ragged_matrix_fn()

        def fn(flat, seg, offsets, lengths, *, n_cohorts, segment_sum=None, long_slots=False):
            return ragged_ops.ragged_median(flat, seg, offsets, lengths, n_cohorts=n_cohorts,
                                            long_slots=long_slots), None, None

        return fn


__all__ = ["CoordinateWiseMedian"]
