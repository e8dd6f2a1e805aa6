"""Geometric median via Weiszfeld iterations.

Counterpart of ``byzpy_tpu/aggregators/geometric_wise/geometric_median.py``
(behavioral parity: ``byzpy/aggregators/geometric_wise/geometric_median.py:33-158``):
``robust.geometric_median``, one B7 step per iteration on the card, the
loop on the host. The pool's barriered mode waits for the engine slice.
"""

from __future__ import annotations

import torch

from ...ops import robust
from ...utils.device import DeviceLike
from ..base import Aggregator


class GeometricMedian(Aggregator):
    """Weiszfeld-iterated geometric median of the gradient rows."""

    name = "geometric-median"

    def __init__(
        self,
        *,
        tol: float = 1e-6,
        max_iter: int = 256,
        eps: float = 1e-12,
        init: str = "median",
        device: DeviceLike = None,
    ) -> None:
        if tol <= 0:
            raise ValueError("tol must be > 0")
        if max_iter <= 0:
            raise ValueError("max_iter must be > 0")
        if eps <= 0:
            raise ValueError("eps must be > 0")
        if init not in {"median", "mean"}:
            raise ValueError("init must be 'median' or 'mean'")
        self.tol = float(tol)
        self.max_iter = int(max_iter)
        self.eps = float(eps)
        self.init = init
        super().__init__(device=device)

    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        return robust.geometric_median(
            x, tol=self.tol, max_iter=self.max_iter, eps=self.eps, init=self.init
        )

    supports_masked_finalize = True

    def _aggregate_matrix_masked(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return robust.masked_geometric_median(
            x, valid, tol=self.tol, max_iter=self.max_iter, eps=self.eps, init=self.init
        )


__all__ = ["GeometricMedian"]
