"""Centered Clipping (Karimireddy et al. 2021, ICML).

Counterpart of ``byzpy_tpu/aggregators/norm_wise/center_clipping.py``
(behavioral parity: ``byzpy/aggregators/norm_wise/center_clipping.py:29-269``):
``robust.centered_clipping``, ``M`` B7 steps in ``clip`` mode on the card.
On an actor pool (two workers or more) it runs the reference's barriered
mode instead (``aggregators/chunked.py``): each of the ``M`` steps fans
row-block clip sums over the pool and the coordinator applies ``v +=
mean``, all on the device.
"""

from __future__ import annotations

import torch

from ...ops import robust
from ...utils.device import DeviceLike
from ..base import Aggregator
from ..chunked import BarrieredIterativeAggregator, _centered_clip_chunk, sum_in_order


class CenteredClipping(BarrieredIterativeAggregator, Aggregator):
    """Iterative centred clipping: clip each row to a radius around the
    running centre, then re-centre."""

    name = "centered-clipping"
    _barrier_chunk_fn = staticmethod(_centered_clip_chunk)

    def __init__(
        self,
        *,
        c_tau: float,
        M: int = 10,
        eps: float = 1e-12,
        init: str = "mean",
        device: DeviceLike = None,
    ) -> None:
        if c_tau < 0:
            raise ValueError("c_tau must be >= 0")
        if M <= 0:
            raise ValueError("M must be >= 1")
        if eps <= 0:
            raise ValueError("eps must be > 0")
        if init not in {"mean", "median", "zero"}:
            raise ValueError("init must be one of {'mean','median','zero'}")
        self.c_tau = float(c_tau)
        self.M = int(M)
        self.eps = float(eps)
        self.init = init
        super().__init__(device=device)

    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        return robust.centered_clipping(
            x, c_tau=self.c_tau, M=self.M, eps=self.eps, init=self.init
        )

    supports_masked_finalize = True

    def _aggregate_matrix_masked(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return robust.masked_centered_clipping(
            x, valid, c_tau=self.c_tau, M=self.M, eps=self.eps, init=self.init
        )

    # -- barriered hooks (pool mode) -----------------------------------------

    def _barrier_params(self):
        return {"c_tau": self.c_tau, "eps": self.eps}

    def _barrier_init(self, x: torch.Tensor) -> torch.Tensor:
        if self.init == "mean":
            return robust._row_mean(x)
        if self.init == "median":
            return robust.coordinate_median(x)
        return x.new_zeros((x.shape[1],))

    def _barrier_update(self, partials, center):
        # the row count from the partials themselves, as the reference does
        total = sum_in_order([p[0] for p in partials])
        rows = sum(p[1] for p in partials)
        return center + total / rows

    def _barrier_max_iters(self) -> int:
        return self.M


__all__ = ["CenteredClipping"]
