"""The aggregators and pre-aggregators on feature-sharded columns.

In the mesh round (``parallel.ps.build_ps_train_step(mesh=...)``) every
rank holds all ``n`` rows of the gradient matrix but only its block of
the ``d`` columns. The JAX package gets there by GSPMD: on sharded
operands its Pallas dispatchers step aside (``sharding_allows_pallas``)
and XLA partitions the aggregators' XLA branches, each sum over ``d``
becoming a per-shard partial and a psum. The port writes those forms
out:

* coordinate-wise functions run the port's ordinary function on the
  local columns: the mean, the coordinate median, the trimmed mean and
  MeaMed (B1 and B6 on the card where ``kernels.use_kernel_for(n)``);
* row-coupled functions take the forms of ``ops/robust.py``'s "Above the
  networks" section with every sum over ``d`` all-reduced over the
  feature group before it is read: Krum / Multi-Krum a partial Gram (B3
  on the card up to 128 rows, then B5 on the local columns), CGE, MoNNA,
  static clipping and ARC partial row sums of squares
  (``kernels.row_sq_dists``), NNM a partial Gram, the geometric median
  and centred clipping partial distances and the stop test every step
  (B11's row chains on the local columns).

Every rank reads the all-reduce's result, never a sum of its own, so all
ranks select the same rows and stop at the same step. A function
without a sharded form (CAF, MDA, SMEA, bucketing, anything not listed)
raises ``NotImplementedError`` naming ROADMAP A.7: nothing gathers the
whole matrix instead.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ..ops import preagg, robust
from .collectives import all_reduce_sum


@dataclass(frozen=True)
class FeatureGroup:
    """The feature axis a form all-reduces over: a mesh and its axis, or a
    tuple of axes (their product group, ``parallel.mesh.axis_group``)."""

    mesh: Any
    axis: Any

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t, self.axis, mesh=self.mesh)


Form = Callable[..., torch.Tensor]  # form(x_local, group, *args, **kwargs)
_FORMS: Dict[Any, Form] = {}


def _unwrap(fn: Any):
    args, kwargs = (), {}
    while isinstance(fn, functools.partial):
        args, kwargs = fn.args + args, {**fn.keywords, **kwargs}
        fn = fn.func
    return fn, args, kwargs


def _name(fn: Any) -> str:
    return getattr(fn, "__qualname__", None) or type(fn).__name__


def class_function(obj: Any) -> Any:
    """The port's function (a ``functools.partial``) that an aggregator
    class's ``matrix_fn()`` runs, for the classes with a sharded form; the
    exact type, since a subclass may override its matrix function. Any
    other object is returned as it is."""
    from .. import aggregators as A

    table = {
        A.CoordinateWiseMedian: lambda a: robust.coordinate_median,
        A.CoordinateWiseTrimmedMean: lambda a: functools.partial(robust.trimmed_mean, f=a.f),
        A.MeanOfMedians: lambda a: functools.partial(robust.mean_of_medians, f=a.f),
        A.MultiKrum: lambda a: functools.partial(robust.multi_krum, f=a.f, q=a.q),
        A.Krum: lambda a: functools.partial(robust.multi_krum, f=a.f, q=a.q),
        A.GeometricMedian: lambda a: functools.partial(
            robust.geometric_median, tol=a.tol, max_iter=a.max_iter, eps=a.eps, init=a.init),
        A.CenteredClipping: lambda a: functools.partial(
            robust.centered_clipping, c_tau=a.c_tau, M=a.M, eps=a.eps, init=a.init),
        A.ComparativeGradientElimination: lambda a: functools.partial(robust.cge, f=a.f),
        A.MoNNA: lambda a: functools.partial(robust.monna, f=a.f,
                                             reference_index=a.reference_index),
    }
    make = table.get(type(obj))
    return make(obj) if make is not None else obj


def sharded_form(fn: Any, group: FeatureGroup) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn``'s form on local columns, a callable ``(n, d_local) ->
    (d_local,)`` (an aggregator) or ``(m, d_local)`` (a pre-aggregator).
    ``fn`` is one of the port's functions, a ``functools.partial`` of one,
    or an aggregator class with a form (:func:`class_function`); anything
    else raises ``NotImplementedError``."""
    base, args, kwargs = _unwrap(class_function(fn))
    form = _FORMS.get(base)
    if form is None:
        raise NotImplementedError(
            f"{_name(base)} has no feature-sharded form: the mesh round runs the coordinate-wise, "
            "Gram, norm and distance families; CAF, MDA, SMEA, bucketing and other callables "
            "are not ported to the mesh (ROADMAP A.7)")
    return lambda x: form(x, group, *args, **kwargs)


# -- coordinate-wise: the ordinary function on the local columns -----------


def _local(fn: Callable[..., torch.Tensor]) -> Form:
    def form(x: torch.Tensor, group: FeatureGroup, *args, **kwargs) -> torch.Tensor:
        return fn(x, *args, **kwargs)

    form.__name__ = f"local_{fn.__name__}"
    return form


def _mean_form(x: torch.Tensor, group: FeatureGroup, *, dim) -> torch.Tensor:
    if dim not in (0, -2):
        raise NotImplementedError("a feature-sharded mean reduces over the rows (dim=0) only "
                                  "(ROADMAP A.7)")
    return torch.mean(x, dim=0)


# -- row-coupled: partial sums over d, all-reduced --------------------------


def partial_gram(x: torch.Tensor, group: FeatureGroup) -> torch.Tensor:
    """The ``(n, n)`` Gram of the whole rows: the local columns' Gram (B3
    on the card up to 128 rows) summed over the feature group."""
    return group.psum(robust.gram_matrix(x))


def row_sums_sq(x: torch.Tensor, group: FeatureGroup,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum((x - z)^2, axis=1)`` over the whole rows (``z=None``: the
    squared norms), f32: ``kernels.row_sq_dists`` on the local columns
    summed over the feature group."""
    return group.psum(robust._row_sums_sq(x, z))


def _multi_krum_form(x, group, *, f: int, q: int) -> torch.Tensor:
    robust._check_matrix(x)
    n = x.shape[0]
    if not 1 <= q <= n - f:
        raise ValueError(f"q must satisfy 1 <= q <= n - f (got n={n}, f={f}, q={q})")
    return robust.multi_krum_from_gram(x, partial_gram(x, group), f=f, q=q)


def _krum_form(x, group, *, f: int) -> torch.Tensor:
    return _multi_krum_form(x, group, f=f, q=1)


def _cge_form(x, group, *, f: int) -> torch.Tensor:
    robust._check_matrix(x)
    n = x.shape[0]
    if not 0 <= f < n:
        raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={f})")
    norms = row_sums_sq(x, group)
    return robust._selected_rows_mean(x, robust._nan_last_ranks(norms) < n - f, n - f)


def _monna_form(x, group, *, f: int, reference_index: int = 0) -> torch.Tensor:
    robust._check_matrix(x)
    n = x.shape[0]
    robust._check_monna(n, f, reference_index)
    dists = row_sums_sq(x, group, x[reference_index])
    return robust._selected_rows_mean(x, robust._nan_last_ranks(dists) < n - f, n - f)


def _geometric_median_form(x, group, *, tol: float = 1e-6, max_iter: int = 256,
                           eps: float = 1e-12, init: str = "median") -> torch.Tensor:
    """The Weiszfeld loop of ``robust._weiszfeld_xla`` with the squared
    distances and the squared step length all-reduced; the stop test reads
    the merged step on the host, the same on every rank."""
    if init not in {"median", "mean"}:
        raise ValueError("init must be 'median' or 'mean'")
    robust._check_matrix(x)
    robust._refuse_capture(x, "the geometric median", "on feature-sharded columns")
    n = x.shape[0]
    x = x.contiguous()
    z = robust.coordinate_median(x) if init == "median" else robust._row_mean_einsum(x)
    ones = torch.ones((n, 1), dtype=x.dtype, device=x.device)
    it, delta = 0, None
    while it < max_iter and (it == 0 or bool(delta > tol)):
        dist = torch.sqrt(row_sums_sq(x, group, z))
        w = (torch.ones_like(dist) / torch.clamp(dist, min=eps)).to(x.dtype)
        z_new = robust._contract_rows(w, x) / robust._contract_rows(w, ones)[0]
        step = z_new - z
        delta = torch.sqrt(group.psum(torch.sum(step * step)))
        z, it = z_new, it + 1
    robust.last_iterations["geometric_median"] = it
    return z


def _centered_clipping_form(x, group, *, c_tau: float, M: int = 10, eps: float = 1e-12,
                            init: str = "mean") -> torch.Tensor:
    """``M`` steps of ``robust._centered_clipping_xla`` with each row's
    distance to the centre all-reduced; no host read."""
    if init not in {"mean", "median", "zero"}:
        raise ValueError("init must be one of {'mean','median','zero'}")
    robust._check_matrix(x)
    if init == "mean":
        v = robust._row_mean_einsum(x)
    elif init == "median":
        v = robust.coordinate_median(x)
    else:
        v = x.new_zeros((x.shape[1],))
    inv = robust._masked_recip(torch.full((), x.shape[0], device=x.device), x.dtype)
    for _ in range(M):
        diff = (x - v[None, :]).contiguous()
        dist = torch.sqrt(row_sums_sq(diff, group))
        scale = torch.clamp(torch.full_like(dist, c_tau) / torch.clamp(dist, min=eps), max=1.0)
        v = v + robust._contract_rows(scale.to(x.dtype), diff) * inv
    return v


def _clip_rows_form(x, group, *, threshold: float) -> torch.Tensor:
    norms = torch.sqrt(row_sums_sq(x, group)).to(x.dtype)[:, None]
    quotient = torch.full_like(norms, threshold) / torch.clamp(norms, min=1e-12)
    return x * torch.clamp(quotient, max=1.0)


def _arc_form(x, group, *, f: int) -> torch.Tensor:
    n = x.shape[0]
    if f > n:
        raise ValueError(f"f must be <= n (got f={f}, n={n})")
    norms = torch.sqrt(row_sums_sq(x, group)).to(x.dtype)
    threshold = torch.sort(norms).values[preagg.arc_cut_off(n, f) - 1]  # NaN sorts last
    factors = torch.clamp(threshold / torch.clamp(norms, min=1e-12), max=1.0)
    return x * factors[:, None]


def _nnm_form(x, group, *, f: int) -> torch.Tensor:
    """``preagg._nnm_xla`` on the merged Gram: each row's ``k`` nearest
    rows from the whole-row distances, the mixing product on the local
    columns."""
    n = x.shape[0]
    if not 0 <= f < n:
        raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={f})")
    k = n - f
    gram = partial_gram(x, group)
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


def _nnm_multi_krum_form(x, group, *, f_nnm: int, f: int, q: int) -> torch.Tensor:
    return _multi_krum_form(_nnm_form(x, group, f=f_nnm), group, f=f, q=q)


def _clipped_multi_krum_form(x, group, *, tau: float, f: int, q: int) -> torch.Tensor:
    if not tau > 0:
        raise ValueError(f"tau must be positive (got {tau})")
    return _multi_krum_form(_clip_rows_form(x, group, threshold=tau), group, f=f, q=q)


def _arc_multi_krum_form(x, group, *, f_arc: int, f: int, q: int) -> torch.Tensor:
    if not 0 <= f_arc <= x.shape[0]:
        raise ValueError(f"f_arc must satisfy 0 <= f_arc <= n (got {f_arc}, n={x.shape[0]})")
    return _multi_krum_form(_arc_form(x, group, f=f_arc), group, f=f, q=q)


# the function (or the function a functools.partial wraps) -> its form
_FORMS.update({fn: _local(fn) for fn in (robust.coordinate_median, robust.trimmed_mean,
                                         robust.mean_of_medians)})
_FORMS.update({
    torch.mean: _mean_form,
    robust.multi_krum: _multi_krum_form,
    robust.krum: _krum_form,
    robust.cge: _cge_form,
    robust.monna: _monna_form,
    robust.geometric_median: _geometric_median_form,
    robust.centered_clipping: _centered_clipping_form,
    robust.nnm_multi_krum: _nnm_multi_krum_form,
    robust.clipped_multi_krum: _clipped_multi_krum_form,
    robust.arc_multi_krum: _arc_multi_krum_form,
    preagg.clip_rows: _clip_rows_form,
    preagg.arc_clip: _arc_form,
    preagg.nnm: _nnm_form,
})

__all__ = ["FeatureGroup", "class_function", "sharded_form"]
