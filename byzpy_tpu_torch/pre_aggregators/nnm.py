"""NNM: Nearest-Neighbour Mixing (Allouah et al. 2023).

Counterpart of ``byzpy_tpu/pre_aggregators/nnm.py`` (behavioral parity:
``byzpy/pre_aggregators/nnm.py:21-95``): ``preagg.nnm`` per round and
``kernels.nnm_stream`` over stacked rounds, B3 + B8 on the card up to 128
rows; above them ``preagg.nnm``'s PyTorch path, round by round.
"""

from __future__ import annotations

import torch

from ..ops import kernels, preagg
from ..utils.device import DeviceLike
from .base import PreAggregator


class NearestNeighborMixing(PreAggregator):
    """Replace each row by the mean of its n - f nearest neighbours."""

    name = "pre-agg/nnm"

    def __init__(self, f: int, *, device: DeviceLike = None) -> None:
        if f < 0:
            raise ValueError("f must be >= 0")
        self.f = int(f)
        super().__init__(device=device)

    def validate_n(self, n: int) -> None:
        if not 0 <= self.f < n:
            raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={self.f})")

    def _transform_matrix(self, x: torch.Tensor) -> torch.Tensor:
        return preagg.nnm(x, f=self.f)

    def _transform_stream_matrix(self, xs: torch.Tensor) -> torch.Tensor:
        if not kernels.use_kernel_for(xs.shape[-2]):
            return torch.stack([preagg.nnm(x, f=self.f) for x in xs])
        return kernels.nnm_stream(xs, f=self.f)


__all__ = ["NearestNeighborMixing"]
