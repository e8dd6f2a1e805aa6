"""Hand-written CUDA kernels of the robust-aggregation hot path, with
their plain PyTorch versions and launch counters.

Counterpart of ``byzpy_tpu/ops/pallas_kernels.py``. Each wrapper checks
its inputs, then:

* on a CPU tensor computes the kernel's plain PyTorch version (the same
  arithmetic, the port's CPU path and the kernels' oracle);
* on a CUDA tensor launches its kernel from ``csrc/`` and adds one to its
  entry in :data:`launch_counts`, or raises. It never falls back to the
  plain version, ``torch.sort`` or ``torch.matmul`` on the card.

Kernels (TPU kernel they replace -> CUDA source):

* B1 ``sorted_reduce_stream``: ``_sorted_reduce_stream_kernel``
  (pallas_kernels.py:363) -> ``csrc/sorted_reduce.cu``;
* B3 ``gram``: ``_gram_kernel`` (:289) and the Gram phase of the fused
  selection kernel (:820) -> ``csrc/gram.cu``;
* B4 ``selection_mean_stream``: ``_selection_mean_stream_kernel`` (:928)
  -> ``csrc/gram.cu`` + ``csrc/selection.cu``.

Dtypes are f32, bf16 and f16, accumulated in f32. A network holds at most
``MAX_NETWORK_ROWS`` rows: a larger ``n`` on the card raises
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from . import _build

MAX_NETWORK_ROWS = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INF_KEY = 0x7F800000  # sort key of +inf; canonical NaN keys upper-bound it
_CANONICAL_NAN_BITS = 0x7FC00000
_SORT_MODES = {"median": 0, "trimmed": 1}
_SELECTION_MODES = {"krum": 0, "cge": 1, "monna": 2}
# split-K Gram: aim for this many blocks per SM of the card, with chunks of
# at least _GRAM_MIN_CHUNK columns (16 shared-memory tiles) each
_GRAM_BLOCKS_PER_SM = 4
_GRAM_TK = 32
_GRAM_MIN_CHUNK = 16 * _GRAM_TK

# Launches of each kernel since the last reset, keyed "kernel" or
# "kernel:mode". Only a wrapper's CUDA branch adds to it, right after its
# kernel launched.
launch_counts = {
    "sorted_reduce:median": 0,
    "sorted_reduce:trimmed": 0,
    "gram": 0,
    "selection_weights:krum": 0,
    "selection_weights:cge": 0,
    "selection_weights:monna": 0,
    "weighted_rows": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# Sort keys and the network (shared by every sort path)
# ---------------------------------------------------------------------------


def batcher_pairs(n: int):
    """Compare-exchange pairs of Batcher's merge-exchange sort for any n
    (Knuth TAOCP 5.2.2 Algorithm M). ``csrc/common.cuh:batcher_sort`` runs
    the same network for power-of-two widths."""
    pairs = []
    t = max(1, (n - 1).bit_length())
    p = 1 << (t - 1)
    while p > 0:
        q = 1 << (t - 1)
        r = 0
        d = p
        while True:
            for i in range(n - d):
                if (i & p) == r:
                    pairs.append((i, i + d))
            if q == p:
                break
            d = q - p
            q >>= 1
            r = p
        p >>= 1
    return pairs


def float_sort_keys(x: torch.Tensor) -> torch.Tensor:
    """Monotone int32 sort keys of an f32 tensor: canonicalize NaN,
    bitcast, flip the magnitude bits of negatives. Total order
    -inf < finite < +inf < NaN, -0.0 before +0.0; self-inverse with
    :func:`keys_to_float`."""
    if x.dtype != torch.float32:
        raise ValueError(f"sort keys need float32, got {x.dtype}")
    keys = x.view(torch.int32)
    keys = torch.where(torch.isnan(x), torch.full_like(keys, _CANONICAL_NAN_BITS), keys)
    return torch.where(keys < 0, keys ^ 0x7FFFFFFF, keys)


def keys_to_float(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`float_sort_keys` (returns float32)."""
    return torch.where(keys < 0, keys ^ 0x7FFFFFFF, keys).view(torch.float32)


def network_width(n: int) -> int:
    """Rows of the unrolled network that holds ``n`` rows: the smallest
    power of two in {8, ..., 128} at or above ``n``."""
    w = 8
    while w < n:
        w *= 2
    return w


# ---------------------------------------------------------------------------
# Input checks and the launch helpers
# ---------------------------------------------------------------------------


def _check_float(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {x.dtype}")


def _check_ndim(x: torch.Tensor, ndim: int, what: str) -> None:
    if x.ndim != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got shape {tuple(x.shape)}")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors
    (kernel); any other device, or a mix, raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, got {types}")


def _check_cuda_input(x: torch.Tensor, n: int) -> None:
    if n > MAX_NETWORK_ROWS:
        raise NotImplementedError(
            f"n={n} rows exceed the {MAX_NETWORK_ROWS}-row CUDA network"
        )
    if not x.is_contiguous():
        raise ValueError("CUDA kernels take contiguous tensors")


def _call(fn: str, *args) -> None:
    err = _build.function(fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, m: int) -> int:
    return _ceil_div(a, m) * m


# ---------------------------------------------------------------------------
# B1: fused column sort + reduce
# ---------------------------------------------------------------------------


def sorted_reduce_stream(xs: torch.Tensor, *, mode: str = "median", f: int = 0) -> torch.Tensor:
    """Coordinate-wise median (``mode='median'``) or f-trimmed mean
    (``mode='trimmed'``) of ``K`` stacked rounds ``xs: (K, n, d)``,
    returning ``(K, d)`` in ``xs``'s dtype (B1; ref
    ``pallas_kernels.sorted_reduce_stream_pallas``). The median is the
    midpoint in the output dtype and NaN iff the column holds a NaN; the
    trimmed mean is the f32 sum of sorted rows ``[f, n - f)`` over
    ``n - 2f``."""
    if mode not in _SORT_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _check_ndim(xs, 3, "xs")
    K, n, d = xs.shape
    if mode == "trimmed" and not 0 <= 2 * f < n:
        raise ValueError(f"f must satisfy 0 <= 2f < n (got n={n}, f={f})")
    _check_float(xs)
    if _on_cpu(xs):
        return sorted_reduce_stream_plain(xs, mode=mode, f=f)
    _check_cuda_input(xs, n)
    out = torch.empty((K, d), dtype=xs.dtype, device=xs.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(xs.device):
        _call(
            "byz_sorted_reduce", xs.data_ptr(), out.data_ptr(), K, n, d,
            _SORT_MODES[mode], f, _DTYPE_CODES[xs.dtype], _stream(xs),
        )
    launch_counts[f"sorted_reduce:{mode}"] += 1
    return out


def _sequential_row_sum(rows: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 of ``(K, m, d)``, rows ascending, one rounding per
    add (the kernels' order)."""
    acc = torch.zeros(
        (rows.shape[0], rows.shape[2]), dtype=torch.float32, device=rows.device
    )
    for i in range(rows.shape[1]):
        acc = acc + rows[:, i]
    return acc


def canonical_nan(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every NaN as the positive quiet NaN (0x7FC00000 f32,
    0x7FC0 bf16, 0x7E00 f16), as the kernels write it and ``jnp.nan`` is;
    PyTorch's own casts and the card's arithmetic leave other NaN bits."""
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)


def _true_div(x: torch.Tensor, denom: int) -> torch.Tensor:
    # a device tensor divisor: PyTorch turns division by a host scalar into
    # a multiply by its reciprocal, which is not the kernels' IEEE divide
    return x / torch.full((), float(denom), dtype=x.dtype, device=x.device)


def sorted_reduce_stream_plain(xs: torch.Tensor, *, mode: str, f: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`sorted_reduce_stream` (same key
    sort, same f32 accumulation order)."""
    n = xs.shape[1]
    srt = torch.sort(float_sort_keys(xs.float()), dim=1).values
    if mode == "median":
        vlo = keys_to_float(srt[:, (n - 1) // 2]).to(xs.dtype)
        vhi = keys_to_float(srt[:, n // 2]).to(xs.dtype)
        med = (vlo + vhi) * 0.5
        has_nan = srt[:, n - 1] > _INF_KEY
        return canonical_nan(torch.where(has_nan, torch.full_like(med, float("nan")), med))
    acc = _sequential_row_sum(keys_to_float(srt[:, f:n - f]))
    return canonical_nan(_true_div(acc, n - 2 * f).to(xs.dtype))


# ---------------------------------------------------------------------------
# B3: Gram matrix
# ---------------------------------------------------------------------------


def gram(xs: torch.Tensor) -> torch.Tensor:
    """``(K, n, n)`` f32 Gram matrices ``x @ x.T`` of ``K`` stacked rounds
    ``xs: (K, n, d)``, accumulated in f32 (B3; ref
    ``pallas_kernels.gram_pallas``). On the card: split-K partials plus a
    fixed-order reduction, the same bits on every run."""
    _check_ndim(xs, 3, "xs")
    _check_float(xs)
    K, n, d = xs.shape
    if _on_cpu(xs):
        return gram_plain(xs)
    _check_cuda_input(xs, n)
    if K == 0 or d == 0:
        return torch.zeros((K, n, n), dtype=torch.float32, device=xs.device)
    npad = max(16, network_width(n))
    sms = torch.cuda.get_device_properties(xs.device).multi_processor_count
    per_round = max(1, _GRAM_BLOCKS_PER_SM * sms // K)
    chunk = max(_GRAM_MIN_CHUNK, _round_up(_ceil_div(d, per_round), _GRAM_TK))
    nchunks = _ceil_div(d, chunk)
    partial = torch.empty(K * nchunks * npad * npad, dtype=torch.float32, device=xs.device)
    out = torch.empty((K, n, n), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        _call(
            "byz_gram", xs.data_ptr(), partial.data_ptr(), out.data_ptr(), K, n, d,
            chunk, nchunks, npad, _DTYPE_CODES[xs.dtype], _stream(xs),
        )
    launch_counts["gram"] += 1
    return out


def gram_plain(xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gram`: one f32 matmul per round.
    (A batched matmul over the K rounds lost precision at (4, 64,
    1,048,576) on an H100, beyond the kernel check's 1e-5 |x_i| |x_j|;
    the per-round product stays within it.)"""
    x = xs.float()
    if x.shape[0] == 0:
        return x.new_zeros((0, x.shape[1], x.shape[1]))
    return torch.stack([xk @ xk.T for xk in x])


# ---------------------------------------------------------------------------
# B4: fused score -> select -> weighted mean
# ---------------------------------------------------------------------------


def check_selection_args(n: int, *, f: int, q: int, mode: str, reference_index: int) -> None:
    """The selection kernels' argument checks (ref
    ``selection_mean_stream_pallas``)."""
    if mode not in _SELECTION_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "krum" and not (0 <= f < n - 1 and 1 <= q <= n - f):
        raise ValueError(f"invalid (n={n}, f={f}, q={q}) for krum")
    if not 1 <= q <= n:
        raise ValueError(f"q must be in [1, n] (got q={q}, n={n})")
    if not 0 <= reference_index < n:
        raise ValueError(f"reference_index out of range (got {reference_index})")


def selection_mean_stream(
    xs: torch.Tensor,
    *,
    f: int,
    q: int,
    mode: str = "krum",
    reference_index: int = 0,
) -> torch.Tensor:
    """Mean of the ``q`` lowest-score rows of each of ``K`` stacked rounds
    ``xs: (K, n, d)``, returning ``(K, d)`` in ``xs``'s dtype (B4; ref
    ``pallas_kernels.selection_mean_stream_pallas``). Scores: ``krum``,
    the sum of the ``n - f - 1`` smallest squared distances to other rows;
    ``cge``, squared norms; ``monna``, squared distance to row
    ``reference_index``. Ties go to the lower index, NaN scores last.

    A composition of :func:`gram`, :func:`selection_weights` and
    :func:`weighted_rows`, which check their inputs and count their own
    launches; an empty input launches nothing."""
    _check_ndim(xs, 3, "xs")
    K, n, d = xs.shape
    check_selection_args(n, f=f, q=q, mode=mode, reference_index=reference_index)
    _check_float(xs)
    if K == 0 or d == 0:
        return xs.new_empty((K, d))
    w = selection_weights(gram(xs), f=f, q=q, mode=mode, reference_index=reference_index)
    return weighted_rows(xs, w)


def selection_weights(
    g: torch.Tensor, *, f: int, q: int, mode: str = "krum", reference_index: int = 0
) -> torch.Tensor:
    """``(K, n)`` f32 weights from ``(K, n, n)`` Gram matrices: ``1/q`` on
    the ``q`` lowest-score rows, else 0 (B4 phase 2)."""
    _check_ndim(g, 3, "gram")
    K, n, n2 = g.shape
    if n != n2 or g.dtype != torch.float32:
        raise ValueError(f"gram must be (K, n, n) float32, got {tuple(g.shape)} {g.dtype}")
    check_selection_args(n, f=f, q=q, mode=mode, reference_index=reference_index)
    if _on_cpu(g):
        return selection_weights_plain(g, f=f, q=q, mode=mode, reference_index=reference_index)
    _check_cuda_input(g, n)
    w = torch.empty((K, n), dtype=torch.float32, device=g.device)
    if K == 0:
        return w
    with torch.cuda.device(g.device):
        _call(
            "byz_selection_weights", g.data_ptr(), w.data_ptr(), K, n, f, q,
            _SELECTION_MODES[mode], reference_index, _stream(g),
        )
    launch_counts[f"selection_weights:{mode}"] += 1
    return w


def selection_weights_plain(
    g: torch.Tensor, *, f: int, q: int, mode: str, reference_index: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of :func:`selection_weights`."""
    n = g.shape[1]
    norms = torch.diagonal(g, dim1=1, dim2=2)
    d2 = (norms[:, :, None] + norms[:, None, :]) - 2.0 * g
    d2 = torch.where(d2 < 0, torch.zeros_like(d2), d2)  # NaN stays NaN
    if mode == "cge":
        scores = norms
    elif mode == "monna":
        scores = d2[:, reference_index, :]
    else:
        srt = torch.sort(float_sort_keys(d2.contiguous()), dim=1).values
        scores = _sequential_row_sum(keys_to_float(srt[:, 1:n - f]))
    bad = torch.isnan(scores)
    s = torch.where(bad, torch.zeros_like(scores), scores)
    # before[k, c, j]: row c ranks ahead of row j (NaN last, ties by index)
    bc, bj = bad[:, :, None], bad[:, None, :]
    sc, sj = s[:, :, None], s[:, None, :]
    idx = torch.arange(n, device=g.device)
    lower = (idx[:, None] < idx[None, :])[None]
    before = (~bc & bj) | ((bc == bj) & ((sc < sj) | ((sc == sj) & lower)))
    rank = before.sum(dim=1)
    return torch.where(
        rank < q,
        torch.full_like(scores, 1.0 / q, dtype=torch.float32),
        torch.zeros_like(scores, dtype=torch.float32),
    )


def weighted_rows(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(K, d)`` sums ``sum_i (w_i > 0 ? x_i : 0) * w_i`` in f32, rows
    ascending, cast to ``xs``'s dtype (B4 phase 3)."""
    _check_ndim(xs, 3, "xs")
    _check_float(xs)
    K, n, d = xs.shape
    if w.shape != (K, n) or w.dtype != torch.float32:
        raise ValueError(f"w must be ({K}, {n}) float32, got {tuple(w.shape)} {w.dtype}")
    if _on_cpu(xs, w):
        return weighted_rows_plain(xs, w)
    _check_cuda_input(xs, n)
    _check_cuda_input(w, n)
    out = torch.empty((K, d), dtype=xs.dtype, device=xs.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(xs.device):
        _call(
            "byz_weighted_rows", xs.data_ptr(), w.data_ptr(), out.data_ptr(), K, n, d,
            _DTYPE_CODES[xs.dtype], _stream(xs),
        )
    launch_counts["weighted_rows"] += 1
    return out


def weighted_rows_plain(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`weighted_rows`."""
    sel = w > 0
    rows = torch.where(sel[:, :, None], xs.float(), torch.zeros((), device=xs.device)) * w[:, :, None]
    return canonical_nan(_sequential_row_sum(rows).to(xs.dtype))


__all__ = [
    "MAX_NETWORK_ROWS",
    "batcher_pairs",
    "canonical_nan",
    "check_selection_args",
    "float_sort_keys",
    "gram",
    "gram_plain",
    "keys_to_float",
    "launch_counts",
    "network_width",
    "reset_launch_counts",
    "selection_mean_stream",
    "selection_weights",
    "selection_weights_plain",
    "sorted_reduce_stream",
    "sorted_reduce_stream_plain",
    "weighted_rows",
    "weighted_rows_plain",
]
