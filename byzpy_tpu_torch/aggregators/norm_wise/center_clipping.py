"""Centered Clipping (Karimireddy et al. 2021, ICML).

Counterpart of ``byzpy_tpu/aggregators/norm_wise/center_clipping.py``
(behavioral parity: ``byzpy/aggregators/norm_wise/center_clipping.py:29-269``):
``robust.centered_clipping``, ``M`` B7 steps in ``clip`` mode on the card.
The pool's barriered mode waits for the engine slice.
"""

from __future__ import annotations

import torch

from ...ops import robust
from ...utils.device import DeviceLike
from ..base import Aggregator


class CenteredClipping(Aggregator):
    """Iterative centred clipping: clip each row to a radius around the
    running centre, then re-centre."""

    name = "centered-clipping"

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


__all__ = ["CenteredClipping"]
