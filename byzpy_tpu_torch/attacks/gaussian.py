"""Gaussian attack: iid ``N(mu, sigma^2)`` coordinates, seedable.

Counterpart of ``byzpy_tpu/attacks/gaussian.py`` (behavioral parity:
``byzpy/attacks/gaussian.py:38-139``). The draws come from a
``torch.Generator`` on the attack's device, seeded from ``seed`` (or one
passed in): each ``apply`` draws fresh noise, and the same seed replays
the same draws. JAX's key chain cannot be reproduced in PyTorch, so the
two packages draw different numbers from the same distribution
(ROADMAP C). On an actor pool each column span is drawn from a generator
of its own, seeded from (the attack's seed, the fan-out's count, the
span's index) where the JAX package folds the span's index into a key
(``attacks/chunked.py``): the same seed gives the same fan-outs, the
draws differ from ``apply``'s and have its distribution."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from ..ops import attack_ops
from ..utils.device import DeviceLike
from .base import Attack
from .chunked import FeatureChunkedAttack, _gaussian_chunk, mix_seed


class GaussianAttack(FeatureChunkedAttack, Attack):
    """Send IID Gaussian noise in place of a gradient."""

    name = "gaussian"
    uses_honest_grads = True
    _chunk_fn = staticmethod(_gaussian_chunk)

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
        self._fanouts = 0
        self._fanout_seed = 0

    def apply(self, *, model=None, x=None, y=None,
              honest_grads: Optional[List[Any]] = None, base_grad: Any = None) -> Any:
        if not honest_grads:
            raise ValueError("GaussianAttack requires honest_grads")
        matrix, unravel = self._stack_honest(honest_grads)
        noise = attack_ops.gaussian(self.generator, (matrix.shape[1],), dtype=matrix.dtype,
                                    mu=self.mu, sigma=self.sigma, device=matrix.device)
        return unravel(noise)

    # -- fan-out: each span from a generator seeded from (seed, fan-out,
    # span); the JAX package folds the span's index into a split key ------

    def create_subtasks(self, inputs, *, context):
        self._fanouts += 1
        self._fanout_seed = mix_seed(self.generator.initial_seed(), self._fanouts)
        return super().create_subtasks(inputs, context=context)

    def _chunk_params(self, host):
        return {"mu": self.mu, "sigma": self.sigma, "dtype": host.dtype, "device": host.device}

    def _chunk_args(self, host, start, end, idx):
        return (end - start, mix_seed(self._fanout_seed, idx))


__all__ = ["GaussianAttack"]
