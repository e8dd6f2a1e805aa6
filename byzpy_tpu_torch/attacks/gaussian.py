"""Gaussian attack: iid ``N(mu, sigma^2)`` coordinates, seedable.

Counterpart of ``byzpy_tpu/attacks/gaussian.py`` (behavioral parity:
``byzpy/attacks/gaussian.py:38-139``). The draws come from a
``torch.Generator`` on the attack's device, seeded from ``seed`` (or one
passed in): each ``apply`` draws fresh noise, and the same seed replays
the same draws. JAX's key chain cannot be reproduced in PyTorch, so the
two packages draw different numbers from the same distribution
(ROADMAP C). The pool fan-out mixin comes with the actor pools (ROADMAP
A.4)."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from ..ops import attack_ops
from ..utils.device import DeviceLike
from .base import Attack


class GaussianAttack(Attack):
    """Send IID Gaussian noise in place of a gradient."""

    name = "gaussian"
    uses_honest_grads = True

    def __init__(self, *, mu: float = 0.0, sigma: float = 1.0, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> None:
        if sigma < 0:
            raise ValueError("sigma must be >= 0")
        self.mu = float(mu)
        self.sigma = float(sigma)
        super().__init__(device=device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(int(seed))
        elif generator.device.type != self.device.type:
            raise ValueError(
                f"generator lives on {generator.device}, the attack draws on {self.device}"
            )
        self.generator = generator

    def apply(self, *, model=None, x=None, y=None,
              honest_grads: Optional[List[Any]] = None, base_grad: Any = None) -> Any:
        if not honest_grads:
            raise ValueError("GaussianAttack requires honest_grads")
        matrix, unravel = self._stack_honest(honest_grads)
        noise = attack_ops.gaussian(self.generator, (matrix.shape[1],), dtype=matrix.dtype,
                                    mu=self.mu, sigma=self.sigma, device=matrix.device)
        return unravel(noise)


__all__ = ["GaussianAttack"]
