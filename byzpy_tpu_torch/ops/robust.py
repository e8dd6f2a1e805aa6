"""Byzantine-robust aggregation of an ``(n, d)`` gradient matrix.

Counterpart of ``byzpy_tpu/ops/robust.py`` (main-path subset). Every
function takes the stacked matrix ``x`` (n nodes, d coordinates) and
static hyper-parameters. Where the JAX package dispatches to a Pallas
kernel, this module calls the matching wrapper in :mod:`.kernels`:

* ``n <= 128`` (:func:`kernels.use_kernel_for`, the reference's
  ``use_pallas_for`` with no ``d`` floor): a CUDA tensor launches the
  hand-written kernel, a CPU tensor takes the kernel's plain PyTorch
  version;
* ``n > 128``: every device takes the PyTorch counterpart of the
  reference's XLA branch (the section "Above the networks" below), as
  the reference leaves such a matrix to XLA. Its row contractions are
  B11 and its per-row sums ``kernels.row_sq_dists``, the kernels with
  no row cap; no network kernel launches.

The fused pre-aggregated pipelines (``nnm_multi_krum``,
``clipped_multi_krum``, ``arc_multi_krum`` and their streams) take the
fused kernels' path up to 128 rows, where the JAX package takes it at
large ``d`` on the TPU, and the two-step composition above; the two agree within f32
rounding on finite inputs, and the fused path's documented deviations on
non-finite ones are the port's.

Functions the JAX package leaves to plain XLA (``sort_rows``,
``krum_scores``, ``ranked_mean``, ``caf``, and the arrival-order fold
primitives but ``multi_krum_from_gram``, which is B5 on the card) are
plain PyTorch here. The folds update their state in place where the JAX
package donates it.

The masked family (``masked_*``, the serving tier's bucketed cohorts)
aggregates the valid rows of a padded matrix with the cohort size on the
device; its row contractions are B11, its column sorts B2 (see the
section's notes).

``geometric_median``, ``centered_clipping`` and ``masked_geometric_median``
run their whole loop in one B7 launch on the card (the unmasked geometric
median then reads its iteration count, except while captured); CAF runs a
fixed number of passes, each a no-op after the reference's loop would
have stopped, and reads nothing on the host. :data:`last_iterations` keeps
the last call's count of each.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from . import kernels

# iterations the last call of each loop took: Weiszfeld steps of
# geometric_median (an int after an eager unmasked call, else a 0-d device
# tensor: read it with int()), filter passes of caf (a 0-d device tensor)
last_iterations = {"geometric_median": 0, "caf": 0}


def _check_matrix(x: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be a 2-D (n, d) matrix, got shape {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# Pairwise geometry
# ---------------------------------------------------------------------------


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """``(n, n)`` Gram matrix ``x @ x.T`` in f32 (the B3 kernel on the card)."""
    _check_matrix(x)
    if not kernels.use_kernel_for(x.shape[0]):
        return _gram_xla(x)
    return kernels.gram(x[None])[0]


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Columns of ``x`` sorted ascending along axis 0, through the int32
    total-order key for f32 (and, by an exact f32 round-trip, 16-bit)
    floats: -inf < finite < +inf < NaN, -0.0 before +0.0, NaN
    canonicalized (B2, ``kernels.sort_columns``, on the card up to 128
    rows; ``torch.sort`` of the keys above). Other dtypes sort as they
    are."""
    if x.ndim >= 1 and x.dtype in (torch.float32, torch.bfloat16, torch.float16):
        x2 = x.reshape(x.shape[0], -1)
        if not kernels.use_kernel_for(x.shape[0]):
            return _sort_rows_xla(x2).reshape(x.shape)
        return kernels.sort_columns(x2.contiguous()).reshape(x.shape)
    return torch.sort(x, dim=0).values


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """``(n, n)`` squared Euclidean distances via the Gram trick, clamped
    at 0."""
    return _sq_dists_from_gram(gram_matrix(x))


def _sq_dists_from_gram(g: torch.Tensor) -> torch.Tensor:
    norms = torch.diagonal(g)
    d2 = (norms[:, None] + norms[None, :]) - 2.0 * g
    return torch.where(d2 < 0, torch.zeros_like(d2), d2)  # NaN stays NaN


# ---------------------------------------------------------------------------
# Coordinate-wise aggregators (B1)
# ---------------------------------------------------------------------------


def coordinate_median(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median (``jnp.median(x, axis=0)`` semantics: the
    midpoint of the middle rows in ``x``'s dtype, NaN where a column holds
    a NaN)."""
    _check_matrix(x)
    if not kernels.use_kernel_for(x.shape[0]):
        return _median_from_sorted(sort_rows(x))
    return kernels.sorted_reduce_stream(x[None], mode="median")[0]


def coordinate_median_stream(xs: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over ``K`` stacked rounds ``(K, n, d)``."""
    if not kernels.use_kernel_for(xs.shape[-2]):
        return aggregate_stream(coordinate_median, xs)
    return kernels.sorted_reduce_stream(xs, mode="median")


def trimmed_mean(x: torch.Tensor, *, f: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean: drop the ``f`` smallest and ``f``
    largest values of each coordinate, average the middle ``n - 2f``."""
    _check_matrix(x)
    n = x.shape[0]
    if not 0 <= 2 * f < n:
        raise ValueError(f"trim parameter f must satisfy 0 <= 2f < n (got n={n}, f={f})")
    if not kernels.use_kernel_for(n):
        return _windowed_row_mean(sort_rows(x), n, f=f)
    return kernels.sorted_reduce_stream(x[None], mode="trimmed", f=f)[0]


def trimmed_mean_stream(xs: torch.Tensor, *, f: int) -> torch.Tensor:
    """f-trimmed coordinate mean over ``K`` stacked rounds ``(K, n, d)``."""
    if not kernels.use_kernel_for(xs.shape[-2]):
        return aggregate_stream(functools.partial(trimmed_mean, f=f), xs)
    return kernels.sorted_reduce_stream(xs, mode="trimmed", f=f)


def mean_of_medians(x: torch.Tensor, *, f: int) -> torch.Tensor:
    """MeaMed: per coordinate, the mean of the ``n - f`` values closest to
    the median, ties at the cut taken in node order (ref:
    ``aggregators/coordinate_wise/mean_of_medians.py:28-82``). One key sort
    gives both the median and the cut, computed in f32 (the B6 kernel on
    the card, at every ``d``)."""
    _check_matrix(x)
    if not kernels.use_kernel_for(x.shape[0]):
        return _mean_of_medians_xla(x, f=f)
    return kernels.meamed_stream(x[None], f=f)[0]


def mean_of_medians_stream(xs: torch.Tensor, *, f: int) -> torch.Tensor:
    """MeaMed over ``K`` stacked rounds ``(K, n, d)``."""
    if not kernels.use_kernel_for(xs.shape[-2]):
        return aggregate_stream(functools.partial(mean_of_medians, f=f), xs)
    return kernels.meamed_stream(xs, f=f)


# ---------------------------------------------------------------------------
# Geometric aggregators (B3 + B4)
# ---------------------------------------------------------------------------


def krum_scores(x: torch.Tensor, *, f: int) -> torch.Tensor:
    """Krum score per node: the sum of squared distances to its
    ``n - f - 1`` nearest neighbours, self excluded (the sorted row's first
    entry is the self-distance 0)."""
    _check_matrix(x)
    return krum_scores_from_gram(gram_matrix(x), f=f)


def _nan_last_ranks(scores: torch.Tensor) -> torch.Tensor:
    """Rank of each row under the order every selection shares: ascending
    score, ties by row index, NaN scores last (a NaN-score row must never
    rank first)."""
    n = scores.shape[0]
    isnan = torch.isnan(scores)
    s = torch.where(isnan, torch.zeros_like(scores), scores)
    s = torch.where(s == 0, torch.zeros_like(s), s)  # -0.0 ties +0.0
    order = torch.argsort(s, stable=True)
    order = order[torch.argsort(isnan[order].to(torch.int8), stable=True)]
    ranks = torch.empty(n, dtype=torch.int64, device=scores.device)
    ranks[order] = torch.arange(n, device=scores.device)
    return ranks


def ranked_mean(x: torch.Tensor, scores: torch.Tensor, q: int) -> torch.Tensor:
    """Mean of the ``q`` lowest-score rows of ``x`` (ties by index, NaN
    scores last). Rows not selected are zeroed before the contraction, so
    a non-finite row that is not chosen cannot leak in."""
    selected = _nan_last_ranks(scores) < q
    w = torch.where(selected, 1.0 / q, 0.0).to(torch.float32)
    xm = torch.where(selected[:, None], x.float(), torch.zeros((), device=x.device))
    return (w @ xm).to(x.dtype)


def selection_sweep_mean(x: torch.Tensor, scores: torch.Tensor, q: int) -> torch.Tensor:
    """Mean of the ``q`` lowest-score rows of ``x`` (the order of
    :func:`ranked_mean`: ties by index, NaN scores last) as the selection
    kernels finish theirs: weight ``1/q`` in f32 on the selected rows and
    B4's row sweep (:func:`kernels.weighted_rows`, rows ascending, a row
    of weight 0 never read). Given the same rows it equals
    :func:`multi_krum`'s, :func:`cge`'s and :func:`monna`'s result bit for
    bit; the pool path of those classes selects from row-range scores
    with it."""
    selected = _nan_last_ranks(scores) < q
    if not kernels.use_kernel_for(x.shape[0]):
        return _selected_rows_mean(x, selected, q)
    w = torch.where(selected, torch.full_like(scores, 1.0 / q, dtype=torch.float32),
                    torch.zeros((), dtype=torch.float32, device=scores.device))
    return kernels.weighted_rows(x[None], w[None])[0]


def multi_krum(x: torch.Tensor, *, f: int, q: int) -> torch.Tensor:
    """Multi-Krum: the mean of the ``q`` rows with the lowest Krum score
    (the fused B3 + B4 kernels on the card)."""
    _check_matrix(x)
    n = x.shape[0]
    if not 1 <= q <= n - f:
        raise ValueError(f"q must satisfy 1 <= q <= n - f (got n={n}, f={f}, q={q})")
    if not kernels.use_kernel_for(n):
        return _multi_krum_from_gram_xla(x, gram_matrix(x), f=f, q=q)
    return kernels.selection_mean_stream(x[None], f=f, q=q, mode="krum")[0]


def multi_krum_stream(xs: torch.Tensor, *, f: int, q: int) -> torch.Tensor:
    """Multi-Krum over ``K`` stacked rounds ``(K, n, d)``."""
    if not kernels.use_kernel_for(xs.shape[-2]):
        return aggregate_stream(functools.partial(multi_krum, f=f, q=q), xs)
    return kernels.selection_mean_stream(xs, f=f, q=q, mode="krum")


def krum(x: torch.Tensor, *, f: int) -> torch.Tensor:
    """Classic Krum = Multi-Krum with ``q=1``."""
    return multi_krum(x, f=f, q=1)


def cge(x: torch.Tensor, *, f: int) -> torch.Tensor:
    """Comparative gradient elimination: drop the ``f`` largest-L2-norm
    rows, average the rest (ref:
    ``aggregators/norm_wise/comparative_gradient_elimination.py``). The
    selection kernel in its ``cge`` mode (B3 + B4 on the card)."""
    _check_matrix(x)
    n = x.shape[0]
    if not kernels.use_kernel_for(n):
        if not 0 <= f < n:
            raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={f})")
        return _selected_rows_mean(x, _nan_last_ranks(_row_sums_sq(x)) < n - f, n - f)
    return cge_stream(x[None], f=f)[0]


def cge_stream(xs: torch.Tensor, *, f: int) -> torch.Tensor:
    """CGE over ``K`` stacked rounds ``(K, n, d)``."""
    n = xs.shape[-2]
    if not 0 <= f < n:
        raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={f})")
    if not kernels.use_kernel_for(n):
        return aggregate_stream(functools.partial(cge, f=f), xs)
    return kernels.selection_mean_stream(xs, f=0, q=n - f, mode="cge")


def _check_monna(n: int, f: int, reference_index: int) -> None:
    if 2 * f >= n:
        raise ValueError(f"Cannot tolerate 2f >= n (got n={n}, f={f})")
    if not 0 <= reference_index < n:
        raise ValueError(f"reference_index must be in [0, {n}) (got {reference_index})")


def monna(x: torch.Tensor, *, f: int, reference_index: int = 0) -> torch.Tensor:
    """MoNNA: the mean of the ``n - f`` nearest rows (squared distance, self
    included) of the trusted row ``reference_index`` (ref:
    ``aggregators/geometric_wise/monna.py:36-83``). The selection kernel in
    its ``monna`` mode (B3 + B4 on the card)."""
    _check_matrix(x)
    n = x.shape[0]
    if not kernels.use_kernel_for(n):
        _check_monna(n, f, reference_index)
        dists = _row_sums_sq(x, x[reference_index])
        return _selected_rows_mean(x, _nan_last_ranks(dists) < n - f, n - f)
    return monna_stream(x[None], f=f, reference_index=reference_index)[0]


def monna_stream(xs: torch.Tensor, *, f: int, reference_index: int = 0) -> torch.Tensor:
    """MoNNA over ``K`` stacked rounds ``(K, n, d)``."""
    n = xs.shape[-2]
    _check_monna(n, f, reference_index)
    if not kernels.use_kernel_for(n):
        return aggregate_stream(functools.partial(monna, f=f, reference_index=reference_index), xs)
    return kernels.selection_mean_stream(
        xs, f=0, q=n - f, mode="monna", reference_index=reference_index
    )


# ---------------------------------------------------------------------------
# Centre-seeking aggregators (B7) and CAF
# ---------------------------------------------------------------------------


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """``mean(x, axis=0)`` in ``x``'s dtype, summed in f32."""
    return torch.mean(x.float(), dim=0).to(x.dtype)


def geometric_median(
    x: torch.Tensor,
    *,
    tol: float = 1e-6,
    max_iter: int = 256,
    eps: float = 1e-12,
    init: str = "median",
) -> torch.Tensor:
    """Geometric median by Weiszfeld iterations (ref:
    ``aggregators/geometric_wise/geometric_median.py:69-104``): the B7 loop
    in ``weiszfeld`` mode (:func:`kernels.center_loop`), which steps as the
    JAX package's ``while_loop`` does, while ``(it == 0 or delta > tol) and
    it < max_iter``, ``delta`` the L2 step length in ``x``'s dtype. On the
    card the whole loop is one launch; the call reads one value on the
    host, the iteration count, into :data:`last_iterations`, except while
    the stream is captured in a CUDA graph: there the record is the 0-d
    device tensor itself, which each replay of the graph rewrites.
    ``init="median"`` starts from :func:`coordinate_median` (the midpoint
    at even ``n``, as ``jnp.median``), ``"mean"`` from the row mean."""
    if init not in {"median", "mean"}:
        raise ValueError("init must be 'median' or 'mean'")
    _check_matrix(x)
    if not kernels.use_kernel_for(x.shape[0]):
        z0 = coordinate_median(x) if init == "median" else _row_mean_einsum(x)
        return _weiszfeld_xla(x, z0, None, tol=tol, max_iter=max_iter, eps=eps)
    z0 = coordinate_median(x) if init == "median" else _row_mean(x)
    z, iterations = kernels.center_loop(x, z0, mode="weiszfeld", eps=eps, tol=tol, max_iter=max_iter)
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        last_iterations["geometric_median"] = iterations
    else:
        last_iterations["geometric_median"] = int(iterations)
    return z


def centered_clipping(
    x: torch.Tensor,
    *,
    c_tau: float,
    M: int = 10,
    eps: float = 1e-12,
    init: str = "mean",
) -> torch.Tensor:
    """Centred clipping (Karimireddy et al. 2021): ``M`` steps of ``v <- v
    + mean_i clip(x_i - v, c_tau)`` (ref:
    ``aggregators/norm_wise/center_clipping.py:29-120``): the B7 loop in
    ``clip`` mode, one launch on the card and no host read, each step
    ``alpha v + sum_i w_i x_i`` with ``w_i = min(1, c_tau / |x_i - v|) / n``
    and ``alpha = 1 - sum_i w_i`` (the JAX package's kernel formula, equal
    in algebra to its XLA one)."""
    if init not in {"mean", "median", "zero"}:
        raise ValueError("init must be one of {'mean','median','zero'}")
    _check_matrix(x)
    above = not kernels.use_kernel_for(x.shape[0])
    if init == "mean":
        v = _row_mean_einsum(x) if above else _row_mean(x)
    elif init == "median":
        v = coordinate_median(x)
    else:
        v = x.new_zeros((x.shape[1],))
    if above:
        return _centered_clipping_xla(x, v, c_tau=c_tau, M=M, eps=eps)
    return kernels.center_loop(x, v, mode="clip", eps=eps, c_tau=c_tau, max_iter=M)[0]


def caf(
    x: torch.Tensor,
    *,
    f: int,
    power_iters: int = 3,
    v_init: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Covariance-bound-agnostic filter: down-weight rows along the dominant
    residual direction until at most ``n - 2f`` weight remains; return the
    mean seen at the smallest dominant eigenvalue (ref:
    ``aggregators/norm_wise/caf.py:140-185``). Plain PyTorch, as the JAX
    package leaves it to XLA, and no value read on the host, so a step
    that calls it can be captured in a CUDA graph.

    The reference's ``while_loop`` runs while ``~stop & (sum(w) > n - 2f) &
    (it < 4n)``. Here a fixed ``min(2f, 4n)`` passes run, each applying its
    update where that condition holds on the device and keeping the state
    (``torch.where``) where it does not, so a pass after the stop changes
    no bit. The bound: each pass zeroes the surviving row of largest
    leverage (``tau / tau_max`` is exactly 1 there) and no weight grows past
    1, so after ``p`` passes ``sum(w) <= n - p`` (a rounded sum of values at
    most 1 stays at most their count) and the condition fails by pass
    ``2f``; a NaN weight fails it at once. :data:`last_iterations` keeps the
    passes that applied, a 0-d device tensor.

    The power iteration starts from ``v_init``, a raw ``(d,)`` draw that
    is normalized here. The JAX package draws it with
    ``jax.random.normal(PRNGKey(seed), (d,))``, which PyTorch cannot
    reproduce: pass that draw to get the JAX result, or leave ``v_init``
    out to draw it with ``torch.randn`` from ``generator``."""
    _check_matrix(x)
    n, d = x.shape
    if 2 * f >= n:
        raise ValueError(f"Cannot tolerate 2f >= n (got n={n}, f={f})")
    if v_init is None:
        v_init = torch.randn((d,), generator=generator, dtype=x.dtype, device=x.device)
    elif tuple(v_init.shape) != (d,):
        raise ValueError(f"v_init must have shape ({d},), got {tuple(v_init.shape)}")
    v_init = v_init.to(x.dtype)
    # torch.clamp keeps NaN, as jnp.maximum / jnp.clip do; scalar bounds
    # need no host-to-device copy
    v_init = v_init / torch.linalg.vector_norm(v_init).clamp(min=1e-12)

    def dominant_eigenpair(diffs, w):
        vec = v_init
        for _ in range(power_iters):
            nxt = torch.sum((w * (diffs @ vec))[:, None] * diffs, dim=0)
            nn = torch.linalg.vector_norm(nxt)
            vec = torch.where(nn > 1e-12, nxt / nn.clamp(min=1e-30), vec)
        proj = diffs @ vec
        eig = torch.sum(w * proj * proj) / torch.sum(w).clamp(min=1e-12)
        return eig, vec

    w = torch.ones((n,), dtype=x.dtype, device=x.device)
    best_mu = torch.mean(x, dim=0)
    best_lam = torch.full((), torch.finfo(torch.float32).max, dtype=x.dtype, device=x.device)
    stop = torch.zeros((), dtype=torch.bool, device=x.device)
    applied = torch.zeros((), dtype=torch.int64, device=x.device)
    # it < 4n holds on every pass: 2f < n
    for _ in range(min(2 * f, 4 * n)):
        active = (~stop) & (torch.sum(w) > n - 2 * f)
        mu = torch.sum(w[:, None] * x, dim=0) / torch.sum(w)
        diffs = x - mu[None, :]
        lam, vec = dominant_eigenpair(diffs, w)
        better = active & (lam < best_lam)
        best_lam = torch.where(better, lam, best_lam)
        best_mu = torch.where(better, mu, best_mu)
        proj = diffs @ vec
        tau = proj * proj
        # leverage among surviving rows only (see the JAX package's note)
        tau_max = torch.max(torch.where(w > 0.0, tau, -float("inf")))
        degenerate = tau_max <= 1e-12
        w_new = torch.clamp(w * (1.0 - tau / tau_max.clamp(min=1e-30)), min=0.0)
        w = torch.where(active & ~degenerate, w_new, w)
        stop = torch.where(active, degenerate | (torch.sum(w) <= 0.0), stop)
        applied = applied + active
    last_iterations["caf"] = applied
    return best_mu


# ---------------------------------------------------------------------------
# Pre-aggregation fused into Multi-Krum (B3 + B9, B3 + B10)
# ---------------------------------------------------------------------------


def nnm_multi_krum(x: torch.Tensor, *, f_nnm: int, f: int, q: int) -> torch.Tensor:
    """Nearest-Neighbour Mixing feeding Multi-Krum (ref:
    ``byzpy/pre_aggregators/nnm.py`` composed with
    ``aggregators/geometric_wise/krum.py``), with the mixed matrix never
    built: the mixed rows' Gram comes from the raw one and the mean
    collapses to source-row weights (the B3 + B9 kernels on the card)."""
    _check_matrix(x)
    if not kernels.use_kernel_for(x.shape[0]):
        from .preagg import nnm

        return multi_krum(nnm(x, f=f_nnm), f=f, q=q)
    return kernels.nnm_selection_mean_stream(x[None], f_nnm=f_nnm, f=f, q=q, mode="krum")[0]


def nnm_multi_krum_stream(xs: torch.Tensor, *, f_nnm: int, f: int, q: int) -> torch.Tensor:
    """``nnm_multi_krum`` over ``K`` stacked rounds ``(K, n, d)``."""
    if not kernels.use_kernel_for(xs.shape[-2]):
        return aggregate_stream(functools.partial(nnm_multi_krum, f_nnm=f_nnm, f=f, q=q), xs)
    return kernels.nnm_selection_mean_stream(xs, f_nnm=f_nnm, f=f, q=q, mode="krum")


def clipped_multi_krum(x: torch.Tensor, *, tau: float, f: int, q: int) -> torch.Tensor:
    """Static L2 clipping to ``tau`` feeding Multi-Krum: the clip factors
    come off the Gram diagonal, the clipped Gram is ``c_i c_j G_ij`` and the
    mean's weights ``w_sel * c`` (the B3 + B10 kernels on the card)."""
    if not tau > 0:
        # checked before the kernel: a clip at tau <= 0 would sign-flip or
        # zero every row
        raise ValueError(f"tau must be positive (got {tau})")
    _check_matrix(x)
    if not kernels.use_kernel_for(x.shape[0]):
        from .preagg import clip_rows

        return multi_krum(clip_rows(x, threshold=tau), f=f, q=q)
    return kernels.clip_selection_mean_stream(x[None], tau=tau, f=f, q=q, mode="krum")[0]


def clipped_multi_krum_stream(xs: torch.Tensor, *, tau: float, f: int, q: int) -> torch.Tensor:
    """``clipped_multi_krum`` over ``K`` stacked rounds ``(K, n, d)``."""
    if not kernels.use_kernel_for(xs.shape[-2]):
        return aggregate_stream(functools.partial(clipped_multi_krum, tau=tau, f=f, q=q), xs)
    return kernels.clip_selection_mean_stream(xs, tau=tau, f=f, q=q, mode="krum")


def arc_multi_krum(x: torch.Tensor, *, f_arc: int, f: int, q: int) -> torch.Tensor:
    """Adaptive Robust Clipping feeding Multi-Krum: ARC's threshold is the
    ``preagg.arc_cut_off``-th smallest norm, rank-counted from the Gram
    diagonal (the B3 + B10 kernels on the card)."""
    if not 0 <= f_arc <= x.shape[0]:
        # checked before the kernel, as the JAX package does: a negative
        # f_arc would otherwise clip nothing without a word
        raise ValueError(
            f"f_arc must satisfy 0 <= f_arc <= n (got {f_arc}, n={x.shape[0]})"
        )
    _check_matrix(x)
    if not kernels.use_kernel_for(x.shape[0]):
        from .preagg import arc_clip

        return multi_krum(arc_clip(x, f=f_arc), f=f, q=q)
    return kernels.arc_selection_mean_stream(x[None], f_arc=f_arc, f=f, q=q, mode="krum")[0]


def arc_multi_krum_stream(xs: torch.Tensor, *, f_arc: int, f: int, q: int) -> torch.Tensor:
    """``arc_multi_krum`` over ``K`` stacked rounds ``(K, n, d)``."""
    if not 0 <= f_arc <= xs.shape[-2]:
        raise ValueError(
            f"f_arc must satisfy 0 <= f_arc <= n (got {f_arc}, n={xs.shape[-2]})"
        )
    if not kernels.use_kernel_for(xs.shape[-2]):
        return aggregate_stream(functools.partial(arc_multi_krum, f_arc=f_arc, f=f, q=q), xs)
    return kernels.arc_selection_mean_stream(xs, f_arc=f_arc, f=f, q=q, mode="krum")


# ---------------------------------------------------------------------------
# Arrival-order fold primitives (the aggregator classes' ``fold`` hooks)
# ---------------------------------------------------------------------------

# columns of a 16-bit staging buffer upcast at a time by gram_fold_update
_FOLD_CHUNK = 1 << 16


def extremes_fold_update(buf: torch.Tensor, row: torch.Tensor, *, largest: bool) -> torch.Tensor:
    """Fold ``row`` into ``buf: (f, d)``, the per-coordinate ``f`` smallest
    (``largest=False``) or largest values seen so far, ascending (filler
    rows of ``+inf`` / ``-inf`` to start), in place; returns ``buf``.

    The JAX package sorts the ``(f + 1, d)`` rows per arrival; since
    ``buf`` is already sorted, one insertion pass of elementwise min / max
    per buffer row gives the same values (a ``torch.sort`` along the short
    axis is a key-value sort of every column, 0.26 ms at (3, 421,642) on
    an H100). Assumes finite inputs (a NaN would corrupt the buffer); the
    trimmed-mean fold keeps raw rows and falls back to the exact path when
    it saw one."""
    carry = row.to(buf.dtype)
    # the f smallest drop the largest value: walk up, keeping the minimum;
    # the f largest drop the smallest: walk down, keeping the maximum
    keep, drop = (torch.maximum, torch.minimum) if largest else (torch.minimum, torch.maximum)
    order = range(buf.shape[0] - 1, -1, -1) if largest else range(buf.shape[0])
    for k in order:
        out = drop(buf[k], carry)
        keep(buf[k], carry, out=buf[k])
        carry = out
    return buf


def trimmed_mean_from_extremes(
    total: torch.Tensor, low: torch.Tensor, high: torch.Tensor, n: int, *, f: int
) -> torch.Tensor:
    """f-trimmed coordinate mean from a running sum and the folded extreme
    buffers, ``(sum x - sum low - sum high) / (n - 2f)`` in ``total``'s
    dtype. The sum follows arrival order, so it meets
    :func:`trimmed_mean` within rounding, not bitwise."""
    if not 0 <= 2 * f < n:
        raise ValueError(f"trim parameter f must satisfy 0 <= 2f < n (got n={n}, f={f})")
    kept = total
    if f > 0:
        kept = kept - torch.sum(low, dim=0) - torch.sum(high, dim=0)
    # a tensor divisor: jnp divides by the array, not by a reciprocal
    return kept / torch.full((), n - 2 * f, dtype=total.dtype, device=total.device)


def fold_add(total: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``total += row`` in place (the JAX package donates ``total``);
    returns ``total``."""
    return total.add_(row)


def gram_fold_update(
    buffer: torch.Tensor, gram: torch.Tensor, row: torch.Tensor, index: int
) -> tuple:
    """Fold one arriving gradient into streaming-Gram state, in place: the
    row lands in slot ``index`` of the ``(n, d)`` staging buffer (zero rows
    for slots not yet arrived), one matvec gives its dot products with
    every staged row, and row and column ``index`` of the ``(n, n)`` Gram
    are set. Returns ``(buffer, gram)``.

    The matvec accumulates in the Gram's dtype: a 16-bit buffer is upcast
    to f32 a column chunk at a time (``preferred_element_type``; a 16-bit
    ``torch.mv`` would round its output to 16 bits). The JAX package
    leaves the matvec to XLA, so it is ``torch.mv`` here."""
    rowc = row.to(buffer.dtype)
    buffer[index] = rowc
    if buffer.dtype == gram.dtype:
        g = torch.mv(buffer, rowc)
    else:
        g = torch.zeros(buffer.shape[0], dtype=gram.dtype, device=buffer.device)
        for c in range(0, buffer.shape[1], _FOLD_CHUNK):
            cols = slice(c, c + _FOLD_CHUNK)
            g += torch.mv(buffer[:, cols].to(gram.dtype), rowc[cols].to(gram.dtype))
    gram[index, :] = g
    gram[:, index] = g
    return buffer, gram


def krum_scores_from_gram(gram: torch.Tensor, *, f: int) -> torch.Tensor:
    """Krum score per node from a precomputed ``(n, n)`` Gram (the
    streaming fold's): the sum of the ``n - f - 1`` smallest squared
    distances to other rows (the sorted row's first entry is the
    self-distance 0)."""
    n = gram.shape[0]
    if not 0 <= f < n - 1:
        raise ValueError(f"f must satisfy 0 <= f < n-1 (got n={n}, f={f})")
    return torch.sort(_sq_dists_from_gram(gram), dim=1).values[:, 1:n - f].sum(dim=1)


def multi_krum_from_gram(
    x: torch.Tensor, gram: torch.Tensor, *, f: int, q: int
) -> torch.Tensor:
    """Multi-Krum given the stacked matrix and its Gram (built by the
    streaming fold): scores from the Gram, mean of the ``q`` best rows,
    with no Gram recompute (B5 on the card)."""
    n = x.shape[0]
    if not 1 <= q <= n - f:
        raise ValueError(f"q must satisfy 1 <= q <= n - f (got n={n}, f={f}, q={q})")
    _check_matrix(x)
    if not kernels.use_kernel_for(n):
        return _multi_krum_from_gram_xla(x, gram, f=f, q=q)
    return kernels.selection_mean_from_gram(x, gram, f=f, q=q, mode="krum")


# ---------------------------------------------------------------------------
# Masked aggregators: the serving tier's bucketed cohorts (B2, B3, B11)
# ---------------------------------------------------------------------------
#
# Counterpart of byzpy_tpu/ops/robust.py:1344-1656. Each function takes a
# padded ``(bucket, d)`` matrix ``x`` and a ``(bucket,)`` bool ``valid``
# and aggregates the valid rows as the unpadded function aggregates the
# compacted matrix, with the cohort size ``m`` a device scalar: windows
# and gathers are tensor comparisons and index tensors, so nothing but the
# geometric median's loop reads a value on the host. A padded bucket gives
# the bits of its compacted cohort because
# * every row contraction (the reference's ``einsum("n,nd->d")``) is B11
#   (``kernels.segment_sum``), one FMA chain over rows in index order, so
#   appended zero rows keep every partial sum;
# * every per-row reduction over ``d`` is ``kernels.row_sq_dists``, whose
#   order depends on ``d`` alone;
# * column sorts are B2 (:func:`sort_rows`), and Multi-Krum's Gram is B3,
#   whose entries do not depend on the number of rows. (On the CPU the
#   Gram is a BLAS product, whose last bits can move with the row count:
#   there Multi-Krum's padded and compacted selections agree unless two
#   scores tie within an ulp.)
# Contract as in the reference: ``x`` floating, invalid rows finite (zero
# in every caller), valid rows finite; ``Aggregator.aggregate_masked``
# routes a non-finite cohort to the exact subset path, and
# masked_coordinate_median alone keeps exact NaN column semantics. The
# reference's selection mean copies the rows masked only when a score is
# not finite (``lax.cond``); here the masked copy is always taken: on
# finite rows both give the same bits (a zero row adds an exact zero to a
# chain that starts at +0.0), and no host read picks the branch.


def _masked_count(valid: torch.Tensor) -> torch.Tensor:
    """Number of valid rows ``m`` as a device scalar (int64)."""
    return torch.sum(valid.to(torch.int64))


def _masked_recip(count: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``1 / count`` rounded once in ``dtype``: the reciprocal that the
    reference's divide-by-constant rewrite multiplies the unpadded sum by."""
    c = count.to(dtype)
    return torch.ones((), dtype=dtype, device=c.device) / c


def _contract_rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("n,nd->d", w, x)`` in ``x``'s dtype, accumulated in f32:
    B11 with one cohort."""
    return kernels.segment_sum(x.contiguous(), w.to(torch.float32).reshape(1, -1))[0]


def _row_mean_einsum(x: torch.Tensor) -> torch.Tensor:
    """``mean(x, axis=0)`` as a row contraction times the rounded
    reciprocal of ``n``: the padding-stable mean that :func:`masked_mean`
    reproduces at any bucket."""
    total = _contract_rows(torch.ones(x.shape[0], device=x.device), x)
    return total * _masked_recip(torch.full((), x.shape[0], device=x.device), total.dtype)


def _windowed_row_mean(s: torch.Tensor, count, *, f: int) -> torch.Tensor:
    """Mean of sorted rows ``[f, count - f)`` as a zero-masked row
    contraction (``count`` an int or a device scalar), times the rounded
    reciprocal of ``count - 2f``."""
    if not isinstance(count, torch.Tensor):
        count = torch.full((), count, device=s.device)
    pos = torch.arange(s.shape[0], device=s.device)[:, None]
    window = (pos >= f) & (pos < count - f)
    kept = torch.where(window, s, torch.zeros((), dtype=s.dtype, device=s.device))
    total = _contract_rows(torch.ones(s.shape[0], device=s.device), kept)
    return total * _masked_recip(count - 2 * f, total.dtype)


def masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean of the valid rows at the padded shape, bit for bit
    :func:`_row_mean_einsum` of the compacted matrix."""
    _check_matrix(x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = _contract_rows(valid, torch.where(valid[:, None], x, zero))
    return s * _masked_recip(_masked_count(valid), s.dtype)


def _masked_sorted(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Columns sorted with invalid rows replaced by ``+inf`` (they land
    after every finite valid value), by :func:`sort_rows` (B2 on the card):
    the valid prefix holds the compacted matrix's sorted values."""
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    return sort_rows(torch.where(valid[:, None], x, inf))


def _masked_rows_at(s: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Row ``pos`` (a device scalar) of the sorted matrix ``s``, the
    position clamped into it as a JAX gather clamps: an empty cohort (a
    ragged batch's padding cohort, whose output is discarded) reads row 0
    instead of faulting."""
    return s.index_select(0, torch.clamp(pos, 0, s.shape[0] - 1).reshape(1))[0]


def _masked_mid_rows(s: torch.Tensor, m: torch.Tensor) -> tuple:
    """``(s[(m - 1) // 2], s[m // 2], lo == hi)`` at the device count ``m``.
    The midpoint rule stays with each caller: it must match that caller's
    unpadded counterpart."""
    lo, hi = torch.div(m - 1, 2, rounding_mode="floor"), torch.div(m, 2, rounding_mode="floor")
    return _masked_rows_at(s, lo), _masked_rows_at(s, hi), lo == hi


def _nan_columns(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.any(torch.isnan(x) & valid[:, None], dim=0)


def masked_coordinate_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median of the valid rows (``coordinate_median``'s
    semantics, column-wide NaN included) at the padded shape."""
    _check_matrix(x)
    s = _masked_sorted(x, valid)
    s_lo, s_hi, single = _masked_mid_rows(s, _masked_count(valid))
    med = torch.where(single, s_lo, (s_lo + s_hi) * 0.5)
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return torch.where(_nan_columns(x, valid), nan, med)


def masked_trimmed_mean(x: torch.Tensor, valid: torch.Tensor, *, f: int) -> torch.Tensor:
    """f-trimmed coordinate mean of the valid rows: the windowed row
    contraction of the sorted matrix with the cohort size on the device
    (callers guarantee ``2f < m``)."""
    _check_matrix(x)
    return _windowed_row_mean(_masked_sorted(x, valid), _masked_count(valid), f=f)


def masked_mean_of_medians(x: torch.Tensor, valid: torch.Tensor, *, f: int) -> torch.Tensor:
    """MeaMed over the valid rows (ref ``masked_mean_of_medians``): the
    ``k = m - f`` values closest to the median form a contiguous window of
    the sorted column, whose ``f + 1`` candidate starts do not depend on
    ``m``; only the window's end moves with the cohort. Ties at the cut are
    filled in node order."""
    _check_matrix(x)
    n, d = x.shape
    m = _masked_count(valid)
    k = m - f
    s = _masked_sorted(x, valid)
    s_lo, s_hi, single = _masked_mid_rows(s, m)
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    med = torch.where(single, s_lo, s_lo * 0.5 + s_hi * 0.5)
    med = torch.where(_nan_columns(x, valid), nan, med)
    starts = s[: f + 1]
    # clamped as a JAX gather clamps (an empty padding cohort has k < 1)
    end_pos = torch.clamp(torch.arange(f + 1, device=x.device)[:, None] + (k - 1), 0, n - 1)
    end_pos = end_pos.expand(f + 1, d)
    ends = torch.gather(s, 0, end_pos)
    # torch.maximum / torch.amin keep NaN, as jnp.maximum / jnp.min do
    radius = torch.maximum(med[None, :] - starts, ends - med[None, :])
    dev = torch.abs(x - med[None, :])
    finite_dev = (~torch.isnan(dev) & valid[:, None]).sum(dim=0)
    cut_nonfinite = torch.where(finite_dev >= k, inf, nan)
    cut = torch.where(torch.isfinite(med), torch.amin(radius, dim=0), cut_nonfinite)
    below = (dev < cut[None, :]) & valid[:, None]
    at = (dev == cut[None, :]) & valid[:, None]
    quota = k - below.sum(dim=0)
    take_at = at & (torch.cumsum(at.to(torch.int64), dim=0) <= quota[None, :])
    sel = torch.where(below | take_at, x, torch.zeros((), dtype=x.dtype, device=x.device))
    out = _contract_rows(torch.ones(n, device=x.device), sel) * _masked_recip(k, x.dtype)
    return torch.where(torch.isnan(cut), nan, out)


def _masked_nan_last_ranks(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Selection rank counting only valid competitors, under
    :func:`_nan_last_ranks`'s order (ascending score, -0.0 tying +0.0, NaN
    last, ties by index): a valid row gets its rank in the compacted
    matrix; an invalid row ranks ``n`` and is never selected."""
    n = scores.shape[0]
    isnan = torch.isnan(scores)
    s = torch.where(isnan, torch.zeros_like(scores), scores)
    s = torch.where(s == 0, torch.zeros_like(s), s)
    order = torch.argsort(s, stable=True)
    order = order[torch.argsort(isnan[order].to(torch.int8), stable=True)]
    order = order[torch.argsort((~valid[order]).to(torch.int8), stable=True)]
    pos = torch.empty(n, dtype=torch.int64, device=scores.device)
    pos[order] = torch.arange(n, device=scores.device)
    return torch.where(valid, pos, torch.full_like(pos, n))


def _selected_rows_mean(x: torch.Tensor, selected: torch.Tensor, q) -> torch.Tensor:
    """``mean(x[selected])`` for exactly ``q`` selected rows (``q`` an int
    or a device scalar): weight ``1/q`` rounded once in f32 on the selected
    rows, unselected rows zeroed, one row contraction (B11)."""
    # a fill, not a host-to-device copy of q
    q = q if isinstance(q, torch.Tensor) else torch.full((), q, device=x.device)
    w = torch.where(selected, _masked_recip(q, torch.float32), 0.0)
    xm = torch.where(selected[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return _contract_rows(w, xm)


def masked_selection_mean(
    x: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, q
) -> torch.Tensor:
    """Mean of the ``q`` lowest-score valid rows (ties by index, NaN scores
    last)."""
    return _selected_rows_mean(x, _masked_nan_last_ranks(scores, valid) < q, q)


def masked_krum_scores_from_gram(
    gram: torch.Tensor, valid: torch.Tensor, *, f: int
) -> torch.Tensor:
    """Krum score per valid row from the padded Gram: invalid columns go
    to ``+inf`` before the row sort (``torch.sort`` of the ``(n, n)``
    distances, as the unmasked scores), so each valid row's sorted prefix
    is the compacted one, and the sum of its ``m - f - 1`` nearest
    squared distances reads a positional window as a row contraction over
    the sorted positions (B11). Invalid rows score ``+inf``."""
    n = gram.shape[0]
    m = _masked_count(valid)
    inf = torch.full((), float("inf"), dtype=gram.dtype, device=gram.device)
    d2 = torch.where(valid[None, :], _sq_dists_from_gram(gram), inf)
    row_sorted = torch.sort(d2, dim=1).values
    pos = torch.arange(n, device=gram.device)[None, :]
    window = (pos >= 1) & (pos < m - f)
    kept = torch.where(window, row_sorted, torch.zeros((), dtype=d2.dtype, device=d2.device))
    scores = _contract_rows(torch.ones(n, device=gram.device), kept.T)
    return torch.where(valid, scores, inf)


def masked_multi_krum(x: torch.Tensor, valid: torch.Tensor, *, f: int, q: int) -> torch.Tensor:
    """Multi-Krum over the valid rows at the padded shape, the Gram by B3
    (callers guarantee ``f < m - 1`` and ``q <= m - f``)."""
    _check_matrix(x)
    scores = masked_krum_scores_from_gram(gram_matrix(x), valid, f=f)
    return masked_selection_mean(x, scores, valid, q)


def masked_cge(x: torch.Tensor, valid: torch.Tensor, *, f: int) -> torch.Tensor:
    """CGE over the valid rows: the ``m - f`` smallest squared norms
    (``kernels.row_sq_dists``), the keep count on the device."""
    _check_matrix(x)
    return masked_selection_mean(x, kernels.row_sq_dists(x.contiguous()), valid,
                                 _masked_count(valid) - f)


def masked_monna(
    x: torch.Tensor, valid: torch.Tensor, *, f: int, reference_index: int = 0
) -> torch.Tensor:
    """MoNNA over the valid rows: the trusted row is the
    ``reference_index``-th valid one (the compacted matrix's
    ``reference_index``; callers guarantee ``reference_index < m``), the
    ``m - f`` rows nearest to it by squared distance are averaged."""
    _check_matrix(x)
    x = x.contiguous()
    count = torch.cumsum(valid.to(torch.int64), dim=0)
    ref_slot = torch.argmax((count == reference_index + 1).to(torch.int8))
    ref = x.index_select(0, ref_slot.reshape(1))[0]
    dists = kernels.row_sq_dists(x, ref)
    return masked_selection_mean(x, dists, valid, _masked_count(valid) - f)


def _masked_median_rows(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``median(compacted, axis=0)`` at the padded shape, the midpoint of
    the middle rows with no NaN rewrite (the iterative aggregators'
    ``init="median"``)."""
    s = _masked_sorted(x, valid)
    s_lo, s_hi, single = _masked_mid_rows(s, _masked_count(valid))
    return torch.where(single, s_lo, (s_lo + s_hi) * 0.5)


def _masked_weights(valid: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.where(valid, w, torch.zeros((), dtype=w.dtype, device=w.device)).to(dtype)


def masked_geometric_median(
    x: torch.Tensor,
    valid: torch.Tensor,
    *,
    tol: float = 1e-6,
    max_iter: int = 256,
    eps: float = 1e-12,
    init: str = "median",
) -> torch.Tensor:
    """Geometric median of the valid rows at the padded shape (ref
    ``masked_geometric_median``): Weiszfeld steps with every invalid row's
    weight 0, the distances by ``kernels.row_sq_dists``' order, the
    numerator ``sum_i w_i x_i`` and the denominator ``sum_i w_i`` B11's row
    chains, so each step and the trip count are the compacted cohort's.
    The loop is B7's ``masked_weiszfeld`` mode (:func:`kernels.center_loop`):
    one launch on the card, its stopping test on the device (the step
    length summed in B7's column order), no value read on the host;
    :data:`last_iterations` keeps the count as a 0-d device tensor."""
    if init not in {"median", "mean"}:
        raise ValueError("init must be 'median' or 'mean'")
    _check_matrix(x)
    x = x.contiguous()
    z = _masked_median_rows(x, valid) if init == "median" else masked_mean(x, valid)
    if not kernels.use_kernel_for(x.shape[0]):
        return _weiszfeld_xla(x, z, valid, tol=tol, max_iter=max_iter, eps=eps)
    z, iterations = kernels.center_loop(x, z, mode="masked_weiszfeld", valid=valid.contiguous(),
                                        eps=eps, tol=tol, max_iter=max_iter)
    last_iterations["geometric_median"] = iterations
    return z


def masked_centered_clipping(
    x: torch.Tensor,
    valid: torch.Tensor,
    *,
    c_tau: float,
    M: int = 10,
    eps: float = 1e-12,
    init: str = "mean",
) -> torch.Tensor:
    """Centred clipping of the valid rows at the padded shape (ref
    ``masked_centered_clipping``): ``M`` steps ``v <- v + (sum_i w_i (x_i -
    v)) / m`` with ``w_i = min(1, c_tau / max(|x_i - v|, eps))`` on valid
    rows and 0 on the others, the distances by ``kernels.row_sq_dists``'
    order and the step a row contraction (B11's chain). The loop is B7's
    ``masked_clip`` mode (:func:`kernels.center_loop`): one launch on the
    card, no value read on the host. Above the networks' rows it is the
    same steps as PyTorch calls."""
    if init not in {"mean", "median", "zero"}:
        raise ValueError("init must be one of {'mean','median','zero'}")
    _check_matrix(x)
    x = x.contiguous()
    if init == "mean":
        v = masked_mean(x, valid)
    elif init == "median":
        v = _masked_median_rows(x, valid)
    else:
        v = x.new_zeros((x.shape[1],))
    if kernels.use_kernel_for(x.shape[0]):
        # fori_loop(0, M) in the reference: no step for M <= 0
        return kernels.center_loop(x, v, mode="masked_clip", valid=valid.contiguous(), eps=eps,
                                   c_tau=c_tau, max_iter=max(M, 0))[0]
    return _masked_clip_steps(x, valid, v, c_tau=c_tau, M=M, eps=eps)


def _masked_clip_steps(x: torch.Tensor, valid: torch.Tensor, v: torch.Tensor, *, c_tau: float,
                       M: int, eps: float) -> torch.Tensor:
    """``M`` masked centred-clipping steps from ``v`` as PyTorch calls: a
    ``row_sq_dists`` launch, the clipped weights and B11 over a fresh ``x -
    v`` a step, the same bits as B7's ``masked_clip`` mode."""
    inv = _masked_recip(_masked_count(valid), x.dtype)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    eps_t = torch.full((), eps, dtype=torch.float32, device=x.device)
    c_tau_t = torch.full((), c_tau, dtype=torch.float32, device=x.device)
    for _ in range(M):
        dist = torch.sqrt(kernels.row_sq_dists(x, v))
        w = _masked_weights(valid, torch.minimum(one, c_tau_t / torch.maximum(dist, eps_t)), x.dtype)
        # invalid rows: diff = -v (finite), weight exactly 0
        v = v + _contract_rows(w, x - v[None, :]) * inv
    return v


# ---------------------------------------------------------------------------
# Subset-search aggregators (MDA / SMEA). Enumeration stays on the host;
# scoring is batched over an int64 ``(c, m)`` index tensor on the inputs'
# device. The JAX package leaves these to XLA (no Pallas kernel), so they
# are plain PyTorch here; the Gram under them is B3 on the card.
# ---------------------------------------------------------------------------


def subset_diameters(d2: torch.Tensor, combos: torch.Tensor) -> torch.Tensor:
    """Diameter (max pairwise squared distance) of each row-index subset.

    ``d2``: ``(n, n)`` pairwise squared distances; ``combos``: ``(c, m)``.
    A NaN entry makes its subset's diameter NaN, as ``jnp.max`` does."""
    combos = combos.long()
    sub = d2[combos[:, :, None], combos[:, None, :]]  # (c, m, m)
    return torch.amax(sub, dim=(1, 2))


def _centering(m: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``I - 1/m``: the (m, m) centering matrix."""
    return (torch.eye(m, dtype=dtype, device=device)
            - torch.full((m, m), 1.0 / m, dtype=dtype, device=device))


def subset_max_eigvals(gram: torch.Tensor, combos: torch.Tensor) -> torch.Tensor:
    """SMEA score per subset: largest eigenvalue of the centered Gram block
    divided by ``m`` (``torch.linalg.eigvalsh``; ref
    ``aggregators/geometric_wise/smea.py:63-88``)."""
    combos = combos.long()
    m = combos.shape[1]
    sub = gram[combos[:, :, None], combos[:, None, :]]  # (c, m, m)
    h = _centering(m, sub.dtype, sub.device)
    vals = torch.linalg.eigvalsh(h @ sub @ h)
    return torch.clamp_min(vals[:, -1], 0.0) / m


def _parallel_jacobi_schedule(m: int):
    """Round-robin (circle-method) rotation schedule: ``m_pad - 1``
    rounds of ``m_pad // 2`` DISJOINT (p, q) pairs covering every pair
    exactly once per sweep. Disjointness lets one step apply all its
    rotations at once. Odd ``m`` pads with a dummy player; the bye pair
    is encoded ``(b, b)`` with valid=0 (its rotation is forced to the
    identity, and ``b`` appears nowhere else that round, so the row/col
    scatters never collide). Numpy, the JAX package's code."""
    m_pad = m + (m & 1)
    half = m_pad // 2
    players = list(range(m_pad))
    p_rounds, q_rounds, valid = [], [], []
    for _ in range(m_pad - 1):
        ps, qs, vs = [], [], []
        for i in range(half):
            a_, b_ = players[i], players[m_pad - 1 - i]
            lo, hi = min(a_, b_), max(a_, b_)
            if hi >= m:  # bye: partner sits this round out
                ps.append(lo)
                qs.append(lo)
                vs.append(0.0)
            else:
                ps.append(lo)
                qs.append(hi)
                vs.append(1.0)
        p_rounds.append(ps)
        q_rounds.append(qs)
        valid.append(vs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return (
        np.asarray(p_rounds, np.int32),
        np.asarray(q_rounds, np.int32),
        np.asarray(valid, np.float32),
    )


@functools.lru_cache(maxsize=64)
def _schedule_on(m: int, device: torch.device) -> list:
    """Each round of :func:`_parallel_jacobi_schedule` as tensors on
    ``device``, copied there once without a host synchronization: ``(pq,
    qp, flat, sign)`` with ``pq = p ++ q`` the rotated rows, ``qp = q ++ p``
    the row each combines with, ``flat`` the offsets of the ``(p, p)``,
    ``(q, q)`` and ``(p, q)`` entries of each rotated row's pair in a
    row-major ``(m, m)`` block, and ``sign`` -1 on the ``p`` rows, +1 on the
    ``q`` rows. The bye pair of an odd ``m`` is left out: its rotation is
    the identity, which rewrites its row and column with their own bits."""
    p_r, q_r, v_r = _parallel_jacobi_schedule(m)
    rounds = []
    for p, q, v in zip(p_r, q_r, v_r):
        p, q = p[v > 0.5].astype(np.int64), q[v > 0.5].astype(np.int64)
        pp, qq, pq = np.tile(p * m + p, 2), np.tile(q * m + q, 2), np.tile(p * m + q, 2)
        host = (np.concatenate([p, q]), np.concatenate([q, p]), np.concatenate([pp, qq, pq]),
                np.repeat(np.float32([-1.0, 1.0]), len(p)))
        rounds.append(tuple(torch.from_numpy(a).to(device, non_blocking=True) for a in host))
    return rounds


def subset_max_eigvals_jacobi(
    gram: torch.Tensor, combos: torch.Tensor, *, sweeps: int = 8
) -> torch.Tensor:
    """SMEA score per subset, the quantity of :func:`subset_max_eigvals`,
    by batched parallel-order Jacobi: the JAX package's ``fori_loop`` as a
    Python loop over the static schedule, ``sweeps * n_rounds`` steps of
    34 PyTorch operations each. Each step applies one round's disjoint
    rotations with the reference body's arithmetic in its order: the
    ``safe`` test, ``sgn`` taken with ``tau >= 0`` (so ``tau == 0`` gives a
    45-degree rotation), then the rows and the columns of the pairs, each
    as one indexed copy of ``c * r_p - s * r_q`` and ``s * r_p + c * r_q``
    (written ``c * r + (-s) * r'``, the same IEEE results). 16-bit Grams
    accumulate in f32. A subset touching a non-finite entry is set to the
    identity and scores ``+inf``. No host read: the schedule lives on the
    device."""
    combos = combos.long()
    m = combos.shape[1]
    c_n = combos.shape[0]
    acc = torch.float32 if gram.dtype in (torch.bfloat16, torch.float16) else gram.dtype
    sub = gram[combos[:, :, None], combos[:, None, :]].to(acc)  # (c, m, m)
    if m < 2:
        # the centered 1x1 (or empty) Gram is identically zero; non-finite
        # singleton rows still score +inf
        zeros = torch.zeros((c_n,), dtype=gram.dtype, device=gram.device)
        if m == 0:
            return zeros
        bad1 = ~torch.isfinite(sub[:, 0, 0])
        return torch.where(bad1, torch.full_like(zeros, float("inf")), zeros)
    h = _centering(m, acc, gram.device)
    a = h @ sub @ h
    bad = ~torch.isfinite(a).all(dim=2).all(dim=1)
    eye = torch.eye(m, dtype=acc, device=gram.device)
    a = torch.where(bad[:, None, None], eye, a).contiguous()
    rounds = _schedule_on(m, gram.device)
    for i in range(sweeps * len(rounds)):
        pq, qp, flat, sign = rounds[i % len(rounds)]
        # (c, 2P) each: every pair's entries twice, for its p row and its q row
        app, aqq, apq = a.view(c_n, m * m).index_select(1, flat).chunk(3, dim=1)
        safe = apq.abs() > 1e-30
        tau = (aqq - app) / torch.where(safe, 2.0 * apq, 1.0)
        sgn = torch.where(tau >= 0.0, 1.0, -1.0)
        t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(safe, t, 0.0)
        cc = torch.reciprocal(torch.sqrt(1.0 + t * t))  # c, as 1.0 / sqrt(...)
        ss = (t * cc) * sign  # -s on the p rows, s on the q rows
        rows = cc[:, :, None] * a.index_select(1, pq) + ss[:, :, None] * a.index_select(1, qp)
        a.index_copy_(1, pq, rows)
        cols = cc[:, None, :] * a.index_select(2, pq) + ss[:, None, :] * a.index_select(2, qp)
        a.index_copy_(2, pq, cols)
    top = torch.amax(torch.diagonal(a, dim1=1, dim2=2), dim=1)
    scores = torch.clamp_min(top, 0.0) / m
    return torch.where(bad, torch.full_like(scores, float("inf")), scores).to(gram.dtype)


def subset_mean(x: torch.Tensor, combo: torch.Tensor) -> torch.Tensor:
    """Mean of the rows selected by ``combo``."""
    return x.index_select(0, combo.long()).mean(dim=0)


def best_subset_by_score(scores: torch.Tensor) -> torch.Tensor:
    """Index of the minimum score (first on ties, matching the host loop)."""
    return torch.argmin(scores)


# ---------------------------------------------------------------------------
# Above the networks: the counterparts of the reference's XLA branches
# ---------------------------------------------------------------------------
#
# Where ``kernels.use_kernel_for(n)`` is False the reference leaves the
# matrix to XLA (``use_pallas_for``), and so does the port, in PyTorch on
# the matrix's device: the int32-key ``torch.sort`` for ``sort_rows``, a
# ``torch.matmul`` Gram (accumulated in f32 for 16-bit inputs; the
# caller's TF32 setting applies, off by default), ``torch.sort`` rows for
# the Krum scores. Each reference ``einsum("n,nd->d")`` is B11
# (:func:`_contract_rows`, the same FMA chain over rows in index order)
# and each per-row sum over ``d`` ``kernels.row_sq_dists``: those kernels
# take any number of rows. No network kernel launches here.


def _gram_xla(x: torch.Tensor) -> torch.Tensor:
    """``x @ x.T`` accumulated in f32 for 16-bit inputs (ref
    ``gram_matrix``: an XLA dot outside any Pallas kernel)."""
    acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    xf = x.to(acc)
    return xf @ xf.T


def _sort_rows_xla(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``sort_rows`` fallback: ``torch.sort`` of the int32
    total-order keys along the rows, 16-bit floats through the exact f32
    round trip, NaN canonical."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return kernels.canonical_nan(_sort_rows_xla(x.float()).to(x.dtype))
    return kernels.keys_to_float(torch.sort(kernels.float_sort_keys(x), dim=0).values)


def _median_from_sorted(s: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=0)`` from the sorted matrix (ref
    ``_median_from_sorted``): the midpoint of the middle rows in ``s``'s
    dtype, NaN column-wide where the last sorted row is NaN."""
    n = s.shape[0]
    lo, hi = (n - 1) // 2, n // 2
    med = s[lo] if lo == hi else (s[lo] + s[hi]) * 0.5
    nan = torch.full((), float("nan"), dtype=s.dtype, device=s.device)
    return torch.where(torch.isnan(s[n - 1]), nan, med)


def _mean_of_medians_xla(x: torch.Tensor, *, f: int) -> torch.Tensor:
    """MeaMed by the reference's sort / window / mask pipeline
    (``_mean_of_medians_xla``): one sort gives the median and, through the
    contiguous-window identity, the cut deviation; rows strictly below the
    cut are kept and ties at it filled in node order."""
    n = x.shape[0]
    if not 0 <= f < n:
        raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={f})")
    k = n - f
    xs = sort_rows(x)
    lo, hi = (n - 1) // 2, n // 2
    # 0.5 a + 0.5 b: the sum of two near-max values would overflow
    med = xs[lo] if lo == hi else xs[lo] * 0.5 + xs[hi] * 0.5
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    med = torch.where(torch.isnan(xs[n - 1]), nan, med)
    radius = torch.maximum(med[None, :] - xs[: n - k + 1], xs[k - 1:] - med[None, :])
    dev = torch.abs(x - med[None, :])
    cut_nonfinite = torch.where((~torch.isnan(dev)).sum(dim=0) >= k, inf, nan)
    cut = torch.where(torch.isfinite(med), torch.amin(radius, dim=0), cut_nonfinite)
    below = dev < cut[None, :]
    at = dev == cut[None, :]
    quota = k - below.sum(dim=0)
    take_at = at & (torch.cumsum(at.to(torch.int64), dim=0) <= quota[None, :])
    sel = torch.where(below | take_at, x, torch.zeros((), dtype=x.dtype, device=x.device))
    out = _contract_rows(torch.ones(n, device=x.device), sel.contiguous())
    out = out * _masked_recip(torch.full((), k, device=x.device), x.dtype)
    return torch.where(torch.isnan(cut), nan, out)


def _row_sums_sq(x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum((x - z)^2, axis=1)`` (``z=None``: the squared norms), f32."""
    return kernels.row_sq_dists(x.contiguous(), None if z is None else z.contiguous())


def _multi_krum_from_gram_xla(
    x: torch.Tensor, gram: torch.Tensor, *, f: int, q: int
) -> torch.Tensor:
    """Multi-Krum from a Gram (ref ``_multi_krum_from_gram_xla``): the
    sorted-row scores, the ``q`` best rows under the shared rank order,
    weight ``1/q`` and one row contraction."""
    scores = krum_scores_from_gram(gram, f=f)
    return _selected_rows_mean(x, _nan_last_ranks(scores) < q, q)


def _refuse_capture(x: torch.Tensor, what: str, where: Optional[str] = None) -> None:
    """Raise ``GraphCaptureError`` inside a capture: ``what`` (``where``
    it runs; default above the networks' rows) reads its stopping test on
    the host every step."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        from ..utils.cuda_graph import GraphCaptureError

        where = where or f"above {kernels.MAX_NETWORK_ROWS} rows"
        raise GraphCaptureError(
            f"{what} {where} reads its stopping test on the host every step (the reference's "
            "while_loop on XLA); it runs eagerly only"
        )


def _weiszfeld_xla(
    x: torch.Tensor,
    z0: torch.Tensor,
    valid: Optional[torch.Tensor],
    *,
    tol: float,
    max_iter: int,
    eps: float,
) -> torch.Tensor:
    """Weiszfeld steps by the reference's XLA body (``_geometric_median_impl``
    with ``use_kernel=False``, and ``masked_geometric_median`` with
    ``valid``): ``w = 1 / max(|x_i - z|, eps)`` in ``x``'s dtype (0 on
    invalid rows), ``z <- sum_i w_i x_i / sum_i w_i``, while ``(it == 0 or
    delta > tol) and it < max_iter``. The stopping test is read on the
    host each step, so a CUDA-graph capture refuses it."""
    _refuse_capture(x, "the geometric median")
    n = x.shape[0]
    x = x.contiguous()
    ones = torch.ones((n, 1), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    z, it, delta = z0, 0, None
    while it < max_iter and (it == 0 or bool(delta > tol)):
        dist = torch.sqrt(_row_sums_sq(x, z))
        w = (torch.ones_like(dist) / torch.clamp(dist, min=eps)).to(x.dtype)
        if valid is not None:
            w = torch.where(valid, w, zero)
        z_new = _contract_rows(w, x) / _contract_rows(w, ones)[0]
        delta = torch.sqrt(torch.sum((z_new - z) ** 2))
        z, it = z_new, it + 1
    last_iterations["geometric_median"] = it
    return z


def _centered_clipping_xla(
    x: torch.Tensor, v: torch.Tensor, *, c_tau: float, M: int, eps: float
) -> torch.Tensor:
    """``M`` steps of the reference's XLA body (``_centered_clipping_impl``
    with ``use_kernel=False``): ``v <- v + sum_i s_i (x_i - v) / n`` with
    ``s_i = min(1, c_tau / max(|x_i - v|, eps))``; no host read."""
    inv = _masked_recip(torch.full((), x.shape[0], device=x.device), x.dtype)
    for _ in range(M):
        diff = (x - v[None, :]).contiguous()
        dist = torch.sqrt(_row_sums_sq(diff))
        scale = torch.clamp(torch.full_like(dist, c_tau) / torch.clamp(dist, min=eps), max=1.0)
        v = v + _contract_rows(scale.to(x.dtype), diff) * inv
    return v


def aggregate_stream(
    agg_fn: Callable[[torch.Tensor], torch.Tensor], xs: torch.Tensor
) -> torch.Tensor:
    """Apply ``agg_fn`` to each of ``K`` stacked matrices ``(K, n, d)`` and
    stack the ``(K, d)`` results."""
    if xs.ndim != 3:
        raise ValueError(f"xs must be (K, n, d), got shape {tuple(xs.shape)}")
    return torch.stack([agg_fn(xs[k]) for k in range(xs.shape[0])])


__all__ = [
    "aggregate_stream",
    "arc_multi_krum",
    "best_subset_by_score",
    "arc_multi_krum_stream",
    "caf",
    "centered_clipping",
    "cge",
    "cge_stream",
    "clipped_multi_krum",
    "clipped_multi_krum_stream",
    "coordinate_median",
    "coordinate_median_stream",
    "extremes_fold_update",
    "fold_add",
    "geometric_median",
    "gram_fold_update",
    "gram_matrix",
    "krum",
    "krum_scores",
    "krum_scores_from_gram",
    "last_iterations",
    "masked_centered_clipping",
    "masked_cge",
    "masked_coordinate_median",
    "masked_geometric_median",
    "masked_krum_scores_from_gram",
    "masked_mean",
    "masked_mean_of_medians",
    "masked_monna",
    "masked_multi_krum",
    "masked_selection_mean",
    "masked_trimmed_mean",
    "mean_of_medians",
    "mean_of_medians_stream",
    "monna",
    "monna_stream",
    "multi_krum",
    "multi_krum_from_gram",
    "multi_krum_stream",
    "nnm_multi_krum",
    "nnm_multi_krum_stream",
    "pairwise_sq_dists",
    "ranked_mean",
    "selection_sweep_mean",
    "sort_rows",
    "subset_diameters",
    "subset_max_eigvals",
    "subset_max_eigvals_jacobi",
    "subset_mean",
    "trimmed_mean",
    "trimmed_mean_from_extremes",
    "trimmed_mean_stream",
]
