"""Geometric median via Weiszfeld iterations.

Counterpart of ``byzpy_tpu/aggregators/geometric_wise/geometric_median.py``
(behavioral parity: ``byzpy/aggregators/geometric_wise/geometric_median.py:33-158``):
``robust.geometric_median``, one B7 step per iteration on the card, the
loop on the host. On an actor pool (two workers or more) it runs the
reference's barriered mode instead (``aggregators/chunked.py``): every
Weiszfeld step fans row-block weighted sums over the pool, the centre and
the blocks stay on the device, and the coordinator reads the step length
once a step.
"""

from __future__ import annotations

import torch

from ...ops import kernels, robust
from ...utils.device import DeviceLike
from ..base import Aggregator
from ..chunked import BarrieredIterativeAggregator, _weiszfeld_chunk, sum_in_order


class GeometricMedian(BarrieredIterativeAggregator, Aggregator):
    """Weiszfeld-iterated geometric median of the gradient rows."""

    name = "geometric-median"
    _barrier_chunk_fn = staticmethod(_weiszfeld_chunk)

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

    def round_evidence(self, matrix, valid, *, aggregate=None):
        """Weiszfeld-weight view: each row's distance to the published
        geometric median (``kernels.row_sq_dists`` on the rows' device; a
        large score is a down-weighted row). Needs the round's
        ``aggregate``; ``None`` without it."""
        if aggregate is None:
            return None
        pre = self._evidence_rows(matrix, valid)
        if pre is None:
            return None
        rows, idx, n = pre
        dists = torch.sqrt(kernels.row_sq_dists(rows, self._evidence_center(aggregate, rows)))
        return self._evidence_view("geomed_distance", n, idx, dists)

    # -- barriered hooks (pool mode) -----------------------------------------

    def _barrier_params(self):
        return {"eps": self.eps}

    def _barrier_init(self, x: torch.Tensor) -> torch.Tensor:
        if self.init == "median":
            return robust.coordinate_median(x)
        return robust._row_mean(x)

    def _barrier_update(self, partials, center):
        num = sum_in_order([p[0] for p in partials])
        den = sum_in_order([p[1] for p in partials])
        return num / torch.clamp(den, min=1e-30)

    def _barrier_max_iters(self) -> int:
        return self.max_iter

    def _barrier_converged(self, old, new) -> bool:
        # the iteration's one host read
        return float(torch.linalg.norm(new - old)) <= self.tol


__all__ = ["GeometricMedian"]
