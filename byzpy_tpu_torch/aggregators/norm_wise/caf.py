"""CAF: Covariance-bound Agnostic Filter.

Counterpart of ``byzpy_tpu/aggregators/norm_wise/caf.py`` (behavioral
parity: ``byzpy/aggregators/norm_wise/caf.py:36-185``): ``robust.caf``,
plain PyTorch as the JAX package leaves it to XLA.

The power iteration starts from a ``(d,)`` draw. The JAX package draws it
with ``jax.random.normal(PRNGKey(seed), (d,))``, which PyTorch cannot
reproduce: here ``seed`` seeds a ``torch.Generator`` (the same draw on
every call, as the JAX class's), or ``v_init`` gives the raw draw itself
(pass JAX's to get the JAX result).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ...ops import robust
from ...utils.device import DeviceLike
from ..base import Aggregator


class CAF(Aggregator):
    """Covariance-bound Agnostic Filter: iteratively down-weights rows
    along the top covariance eigendirection until the spectral bound
    holds."""

    name = "caf"

    def __init__(
        self,
        f: int,
        *,
        power_iters: int = 3,
        seed: int = 0,
        v_init: Optional[Any] = None,
        device: DeviceLike = None,
    ) -> None:
        if f < 0:
            raise ValueError("f must be >= 0")
        if power_iters <= 0:
            raise ValueError("power_iters must be > 0")
        self.f = int(f)
        self.power_iters = int(power_iters)
        self.seed = int(seed)
        super().__init__(device=device)
        self.v_init = None if v_init is None else torch.as_tensor(v_init, device=self.device)

    def validate_n(self, n: int) -> None:
        if 2 * self.f >= n:
            raise ValueError(f"Cannot tolerate 2f >= n (got n={n}, f={self.f})")

    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        generator = None
        if self.v_init is None:
            generator = torch.Generator(device=x.device).manual_seed(self.seed)
        return robust.caf(
            x, f=self.f, power_iters=self.power_iters, v_init=self.v_init, generator=generator
        )


__all__ = ["CAF"]
