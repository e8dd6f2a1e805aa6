"""Bucketing (Karimireddy et al.): random permutation -> buckets -> means.

Counterpart of ``byzpy_tpu/pre_aggregators/bucketing.py`` (behavioral
parity: ``byzpy/pre_aggregators/bucketing.py:28-120``):
``preagg.bucket_means``. The permutation is explicit (``perm``) or drawn
with ``torch.randperm`` from a ``torch.Generator`` (the caller's, or one
seeded with ``seed``) in place of the JAX package's ``jax.random`` key;
the two give different permutations from one seed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops import preagg
from ..utils.device import DeviceLike
from .base import PreAggregator


class Bucketing(PreAggregator):
    """Shuffle the rows and average fixed-size buckets, diluting byzantine
    influence."""

    name = "pre-agg/bucketing"

    def __init__(
        self,
        bucket_size: int,
        *,
        perm: Optional[Sequence[int]] = None,
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ) -> None:
        if bucket_size <= 0:
            raise ValueError("bucket_size must be > 0")
        self.bucket_size = int(bucket_size)
        super().__init__(device=device)
        self._explicit_perm = None if perm is None else torch.as_tensor(perm, dtype=torch.int64)
        self._generator = generator if generator is not None else torch.Generator().manual_seed(seed)

    def _resolve_perm(self, n: int) -> torch.Tensor:
        if self._explicit_perm is not None:
            if tuple(self._explicit_perm.shape) != (n,):
                raise ValueError(
                    f"perm must have shape ({n},); got {tuple(self._explicit_perm.shape)}"
                )
            return self._explicit_perm
        # the generator advances, so successive calls see fresh permutations
        return torch.randperm(n, generator=self._generator)

    def _transform_matrix(self, x: torch.Tensor) -> torch.Tensor:
        perm = self._resolve_perm(x.shape[0]).to(x.device)
        return preagg.bucket_means(x, perm, bucket_size=self.bucket_size)


__all__ = ["Bucketing"]
