"""Pre-aggregation of the stacked ``(n, d)`` gradient matrix: static
clipping, bucketing, Nearest-Neighbour Mixing and Adaptive Robust
Clipping.

Counterpart of ``byzpy_tpu/ops/preagg.py``. Each function returns a
transformed matrix (bucketing: fewer rows) for the round's
``pre_aggregate`` hook. ``clip_rows``, ``bucket_means`` and ``arc_clip``
are plain PyTorch, as the JAX package leaves them to XLA. ``nnm`` runs the
B8 kernels (:func:`.kernels.nnm_stream`) on a CUDA tensor with ``n <= 128``
(B8's plain version on a CPU tensor), and above 128 rows, on any device,
the reference's XLA branch in PyTorch (:func:`_nnm_xla`).
"""

from __future__ import annotations

import math

import torch

from . import kernels


def clip_rows(x: torch.Tensor, *, threshold: float) -> torch.Tensor:
    """Static L2-norm clipping of each row to ``threshold``, in ``x``'s
    dtype (ref: ``byzpy/pre_aggregators/clipping.py``)."""
    norms = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    # a tensor numerator: PyTorch computes a host scalar over a tensor as a
    # reciprocal times the scalar, two roundings where jnp divides once
    quotient = torch.full_like(norms, threshold) / torch.clamp(norms, min=1e-12)
    factors = torch.clamp(quotient, max=1.0)
    return x * factors


def bucket_means(x: torch.Tensor, perm: torch.Tensor, *, bucket_size: int) -> torch.Tensor:
    """Bucketing (Karimireddy et al.): permute the rows by ``perm``, split
    them into buckets of ``bucket_size`` (the last may be smaller) and
    return each bucket's mean (ref:
    ``byzpy/pre_aggregators/bucketing.py:101-120``). ``perm`` is an
    explicit permutation of ``range(n)``; draw it with a
    ``torch.Generator`` (``torch.randperm(n, generator=g)``)."""
    n = x.shape[0]
    if tuple(perm.shape) != (n,):
        raise ValueError(f"perm must have shape ({n},); got {tuple(perm.shape)}")
    nb = math.ceil(n / bucket_size)
    pad = nb * bucket_size - n
    xp = torch.cat([x[perm], x.new_zeros((pad, x.shape[1]))])
    weights = torch.cat([x.new_ones(n), x.new_zeros(pad)]).reshape(nb, bucket_size)
    xb = xp.reshape(nb, bucket_size, -1)
    return torch.sum(xb * weights[:, :, None], dim=1) / torch.sum(weights, dim=1, keepdim=True)


def nnm(x: torch.Tensor, *, f: int) -> torch.Tensor:
    """Nearest-Neighbour Mixing: each row becomes the mean of its
    ``k = n - f`` nearest rows, self included (ref:
    ``byzpy/pre_aggregators/nnm.py:50-95``). A mixed row that selected a
    row whose squared norm is not finite is NaN; rows that did not stay
    finite, as in the JAX package. The B8 kernels on the card."""
    n = x.shape[0]
    if not 0 <= f < n:
        raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={f})")
    if not kernels.use_kernel_for(n):
        return _nnm_xla(x, f=f)
    return kernels.nnm_stream(x[None], f=f)[0]


def _nnm_xla(x: torch.Tensor, *, f: int) -> torch.Tensor:
    """NNM by the reference's XLA branch (``preagg.nnm`` off the Pallas
    gate): the Gram (f32 for 16-bit inputs), each row's ``k`` nearest by a
    stable argsort of the clamped squared distances, one ``(n, n) @ (n,
    d)`` mixing product over taint-zeroed rows, and NaN for a mixed row
    that selected a row with a non-finite squared norm."""
    from .robust import gram_matrix

    n = x.shape[0]
    k = n - f
    gram = gram_matrix(x)
    norms = torch.diagonal(gram)
    d2 = torch.clamp(norms[:, None] + norms[None, :] - 2.0 * gram, min=0.0)
    idx = torch.argsort(d2, dim=1, stable=True)[:, :k]
    mask = torch.zeros_like(d2).scatter_(1, idx, 1.0)
    taint = ~torch.isfinite(norms)
    x_clean = torch.where(taint[:, None], torch.zeros((), dtype=x.dtype, device=x.device), x)
    mixed = (mask @ x_clean.to(gram.dtype)) / torch.full((), k, dtype=gram.dtype, device=x.device)
    sel_taint = (mask @ taint.to(gram.dtype)) > 0.5
    nan = torch.full((), float("nan"), dtype=gram.dtype, device=x.device)
    return torch.where(sel_taint[:, None], nan, mixed).to(x.dtype)


def arc_cut_off(n: int, f: int) -> int:
    """ARC's 1-based rank of the threshold norm: clip the
    ``floor(2f/n * (n-f))`` largest-norm rows to the ``cut_off``-th
    smallest norm. The one implementation of the formula, for
    :func:`arc_clip` and the B10 kernel
    (:func:`.kernels.arc_selection_mean_stream`) alike."""
    nb_clipped = int(math.floor((2.0 * f / n) * (n - f)))
    nb_clipped = max(0, min(nb_clipped, n - 1))
    return max(1, n - nb_clipped)


def arc_clip(x: torch.Tensor, *, f: int) -> torch.Tensor:
    """Adaptive Robust Clipping: clip the ``floor(2f/n * (n-f))``
    largest-norm rows to the norm of the next-largest remaining row (ref:
    ``byzpy/pre_aggregators/arc.py:36-51``)."""
    n = x.shape[0]
    if f > n:
        raise ValueError(f"f must be <= n (got f={f}, n={n})")
    norms = torch.sqrt(torch.sum(x * x, dim=1))
    threshold = torch.sort(norms).values[arc_cut_off(n, f) - 1]  # NaN sorts last
    factors = torch.clamp(threshold / torch.clamp(norms, min=1e-12), max=1.0)
    return x * factors[:, None]


__all__ = ["arc_clip", "arc_cut_off", "bucket_means", "clip_rows", "nnm"]
