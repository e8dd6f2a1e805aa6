"""Byzantine attack primitives as plain tensor functions.

Counterpart of ``byzpy_tpu/ops/attack_ops.py``. Each takes honest gradient
information and emits one malicious ``(d,)`` vector. Randomness comes from
an explicit ``torch.Generator``; it does not reproduce ``jax.random``'s
bits, so parity tests hand both packages the same noise.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Sequence

import torch

from ..utils.device import DeviceLike, resolve_device


def sign_flip(base_grad: torch.Tensor, *, scale: float = -1.0) -> torch.Tensor:
    """``scale * base_grad``."""
    return scale * base_grad


def empire(honest: torch.Tensor, *, scale: float = -1.0) -> torch.Tensor:
    """``scale * mean(honest)`` over the node axis."""
    return scale * honest.mean(dim=0)


def little(honest: torch.Tensor, *, f: int, n_total: int) -> torch.Tensor:
    """'A Little Is Enough' (Baruch et al. 2019): ``mu + z_max * sigma``
    with ``s = floor(N/2) + 1 - f`` and ``z_max`` the inverse normal CDF
    of ``(N - s) / N``. ``p`` is static, so ``z_max`` is taken on the host
    (``statistics.NormalDist().inv_cdf``)."""
    if n_total < f:
        raise ValueError(f"N must be >= f (got N={n_total}, f={f})")
    s = n_total // 2 + 1 - f
    p = (n_total - s) / float(n_total)
    p = min(max(p, 1e-12), 1.0 - 1e-12)
    z = NormalDist().inv_cdf(p)
    mu = honest.mean(dim=0)
    sigma = torch.sqrt(((honest - mu[None, :]) ** 2).mean(dim=0))
    return (mu + z * sigma).to(honest.dtype)


def gaussian(
    generator: torch.Generator,
    shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    *,
    mu: float = 0.0,
    sigma: float = 1.0,
    device: DeviceLike = None,
) -> torch.Tensor:
    """IID ``N(mu, sigma^2)`` coordinates drawn from ``generator`` (which
    must live on ``device``)."""
    dev = resolve_device(device)
    noise = torch.randn(tuple(shape), generator=generator, dtype=dtype, device=dev)
    return mu + sigma * noise


def inf_vector(
    shape: Sequence[int], dtype: torch.dtype = torch.float32, *, device: DeviceLike = None
) -> torch.Tensor:
    """``+inf``-filled vector."""
    return torch.full(tuple(shape), float("inf"), dtype=dtype, device=resolve_device(device))


def mimic(honest: torch.Tensor, *, epsilon: int = 0) -> torch.Tensor:
    """Copy honest worker ``epsilon``'s vector."""
    if not 0 <= epsilon < honest.shape[0]:
        raise ValueError(
            f"epsilon must index an honest worker in [0, {honest.shape[0]}) (got {epsilon})"
        )
    return honest[epsilon]


__all__ = ["sign_flip", "empire", "little", "gaussian", "inf_vector", "mimic"]
