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
  -> ``csrc/gram.cu`` + ``csrc/selection.cu``;
* B5 ``selection_mean_from_gram``: ``_selection_from_gram_kernel``
  (:1094) -> ``csrc/selection.cu`` (B4's weights block and a sweep of the
  selected rows on a given Gram, one launch);
* B6 ``meamed_stream``: ``_meamed_stream_kernel`` (:619) ->
  ``csrc/meamed.cu``, on the column-sort engine;
* B7 ``center_loop`` (and its first step, ``weighted_center_step``):
  ``_weighted_center_step_kernel`` (:470) and the reference's loops around
  it, modes ``weiszfeld`` and ``clip`` -> ``csrc/center_step.cu``, one
  launch a loop; its ``masked_weiszfeld`` and ``masked_clip`` modes run the
  masked family's Weiszfeld and centred-clipping loops
  (``byzpy_tpu/ops/robust.py:1581`` and :1623, plain XLA) the same way;
* B8 ``nnm_stream``: ``_nnm_stream_kernel`` (:1245) -> ``csrc/gram.cu`` +
  ``csrc/nnm.cu``;
* B9 ``nnm_selection_mean_stream``: ``_nnm_selection_stream_kernel``
  (:1380) -> ``csrc/gram.cu`` + ``csrc/nnm.cu`` + B4's row sweep;
* B10 ``clip_selection_mean_stream`` / ``arc_selection_mean_stream``:
  ``_clip_selection_stream_kernel`` (:1466) -> ``csrc/gram.cu`` +
  ``csrc/clip_selection.cu`` + B4's row sweep;
* B2 ``sort_columns``: ``_sort_columns_kernel`` (:155) ->
  ``csrc/sort_columns.cu``;
* B11 ``segment_sum``: ``_ragged_segment_sum_kernel`` (:1840) ->
  ``csrc/segment_sum.cu``, beside ``row_sq_dists``, the masked family's
  per-row reduction (no Pallas kernel: it stands in for a plain XLA
  reduce whose bits must not depend on the number of rows);
* B12 ``segment_sum_dequant``: ``_ragged_segment_sum_dequant_kernel``
  (:1973) -> ``csrc/segment_sum.cu``: B11 over wire codes, decoded as
  B14 and B17 decode them (``csrc/codec.cuh``);
* ``segmented_sort_reduce`` (no Pallas kernel): the ragged door's sort
  family, every cohort's trimmed mean or median in one launch, the
  counterpart of the reference's two-key ``lax.sort`` and windowed
  ``einsum`` (``byzpy_tpu/ops/ragged.py:96-192``) -> ``csrc/segmented_sort.cu``.

B1, B6 and the segmented sort-reduce are three instances of one
column-sort engine, ``csrc/column_sort.cuh`` (its run rule:
:func:`column_runs`). The selection family's weights (B4, B5, B9, B10)
and B8's selection state work block-wide on the round's ``(n, n)``
problem in shared memory (``csrc/selection_block.cuh``).

The codec kernels B13-B17 (``parallel/quantization.py``) have their
wrappers in ``ops/codec_kernels.py``; their launch counters live in this
module's :data:`launch_counts` with the others.

Dtypes are f32, bf16 and f16, accumulated in f32. A network (B1, B2, B6
and the selection kernels) holds at most ``MAX_NETWORK_ROWS`` rows: its
wrapper raises ``NotImplementedError`` for a larger ``n`` on the card.
Callers ask :func:`use_kernel_for` first, the counterpart of the JAX
package's ``use_pallas_for``, and take their PyTorch counterpart of the
reference's XLA branch above it (``ops/robust.py``, ``ops/preagg.py``).
The row contractions (B11, B12, ``row_sq_dists``) and the segmented
sort-reduce's batch take any number of rows; a segmented slot still
holds at most ``MAX_NETWORK_ROWS``.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from . import _build

MAX_NETWORK_ROWS = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INF_KEY = 0x7F800000  # sort key of +inf; canonical NaN keys upper-bound it
_CANONICAL_NAN_BITS = 0x7FC00000
_SORT_MODES = {"median": 0, "trimmed": 1}
_SELECTION_MODES = {"krum": 0, "cge": 1, "monna": 2}
_CLIP_MODES = {"clip": 0, "arc": 1}
_CENTER_MODES = {"weiszfeld": 0, "clip": 1, "masked_weiszfeld": 2, "masked_clip": 3}
# the masked family's modes: the loop of a padded cohort's valid rows
_MASKED_CENTER_MODES = ("masked_weiszfeld", "masked_clip")
# split-K Gram: aim for this many blocks per SM of the card, with chunks of
# at least _GRAM_MIN_CHUNK columns (16 shared-memory tiles) each
_GRAM_BLOCKS_PER_SM = 4
_GRAM_TK = 32
_GRAM_MIN_CHUNK = 16 * _GRAM_TK
# B8's mixing sweep: at most this many persistent blocks per SM stride over
# the column tiles (csrc/nnm.cu also caps them at what fits on the card)
_MIX_BLOCKS_PER_SM = 4
# B7's loop kernel: its sums over columns take chunks of this many
# columns, a block of _CENTER_THREADS threads a chunk (csrc/center_step.cu)
_CENTER_CHUNK = 1024
_CENTER_THREADS = 256
# row_sq_dists: stage-1 lanes per row (csrc/segment_sum.cu kLanes)
_ROW_LANES = 4096

# Launches of each kernel since the last reset, keyed "kernel" or
# "kernel:mode". Only a wrapper's CUDA branch adds to it, through
# count_launch, right after its kernel launched.
launch_counts = {
    "sorted_reduce:median": 0,
    "sorted_reduce:trimmed": 0,
    "gram": 0,
    "selection_weights:krum": 0,
    "selection_weights:cge": 0,
    "selection_weights:monna": 0,
    "weighted_rows": 0,
    # B5: its weights and sweep in one launch
    "selection_mean_from_gram:krum": 0,
    "selection_mean_from_gram:cge": 0,
    "selection_mean_from_gram:monna": 0,
    "meamed": 0,
    # B7: the whole loops, and the one-step phases of the same kernel
    "center_loop:weiszfeld": 0,
    "center_loop:clip": 0,
    "center_loop:masked_weiszfeld": 0,
    "center_loop:masked_clip": 0,
    "center_weights:weiszfeld": 0,
    "center_weights:clip": 0,
    "center_sweep": 0,
    "nnm_weights": 0,
    "mix_rows": 0,
    "nnm_selection_weights:krum": 0,
    "nnm_selection_weights:cge": 0,
    "nnm_selection_weights:monna": 0,
    "clip_selection_weights:clip": 0,
    "clip_selection_weights:arc": 0,
    # the codecs' kernels, launched by ops/codec_kernels.py
    "quantize:int8": 0,
    "quantize:fp8": 0,
    "quantize:fp8_e5m2": 0,
    "dequantize:int8": 0,
    "dequantize:fp8": 0,
    "quantize:s4": 0,
    "dequantize:s4": 0,
    # the masked family's kernels
    "sort_columns": 0,
    "segment_sum": 0,
    "row_sq_dists": 0,
    # the ragged door's fused-dequant contraction, by wire mode
    "segment_sum_dequant:int8": 0,
    "segment_sum_dequant:fp8": 0,
    "segment_sum_dequant:fp8_e5m2": 0,
    "segment_sum_dequant:s4": 0,
    # the ragged door's sort family
    "segmented_sort_reduce": 0,
    # replays of a compiled step's CUDA graph (utils/cuda_graph.py), by
    # step: the kernels a graph holds count once, when it is captured
    "graph_replay:ps_train_step": 0,
    "graph_replay:serving_ps_step": 0,
    "graph_replay:ragged_serving_ps_step": 0,
    "graph_replay:gossip_train_step": 0,
}


# several actor threads of a pool launch at once (engine/actor/backends/
# cuda.py); a plain `+= 1` on the dict could lose a count between its read
# and its write
_count_lock = threading.Lock()


def count_launch(key: str) -> None:
    """Add one launch of ``key`` to :data:`launch_counts`, exactly, from
    any thread."""
    with _count_lock:
        launch_counts[key] += 1


def reset_launch_counts() -> None:
    with _count_lock:
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


def use_kernel_for(n: int) -> bool:
    """True when an ``n``-row matrix fits the networks: the gate of every
    dispatch site (ref ``pallas_kernels.use_pallas_for``, with no ``d``
    floor and no environment switch). Above it the caller takes its
    PyTorch counterpart of the reference's XLA branch, on any device."""
    return n <= MAX_NETWORK_ROWS


def _check_cuda_input(x: torch.Tensor, n: int) -> None:
    if n > MAX_NETWORK_ROWS:
        raise NotImplementedError(
            f"n={n} rows exceed the {MAX_NETWORK_ROWS}-row CUDA network"
        )
    if not x.is_contiguous():
        raise ValueError("CUDA kernels take contiguous tensors")


def _check_gram(g: torch.Tensor) -> tuple:
    """``(K, n)`` of a ``(K, n, n)`` float32 Gram stack; raises otherwise."""
    _check_ndim(g, 3, "gram")
    K, n, n2 = g.shape
    if n != n2 or g.dtype != torch.float32:
        raise ValueError(f"gram must be (K, n, n) float32, got {tuple(g.shape)} {g.dtype}")
    return K, n


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
# The column-sort engine of B1, B6 and the segmented sort-reduce
# ---------------------------------------------------------------------------

# csrc/column_sort.cuh: a block takes a run of tiles of this many columns of
# one slot; the ring's 69,760 bytes of shared memory a block leave room for
# three blocks in an SM's 228 KB (B6's one-buffer ring is half that, but its
# 128 registers a thread hold it to three blocks as well)
_SORT_TILE = 128
_SORT_BLOCKS_PER_SM = 3


def column_runs(d: int, sms: int) -> tuple:
    """``(T, runs)``: the tiles of ``_SORT_TILE`` columns a block of the
    column-sort engine takes, and the runs a slot of ``d`` columns splits
    into, so that a slot's blocks fill one wave of the blocks a card of
    ``sms`` SMs holds at once (``_SORT_BLOCKS_PER_SM`` an SM). Every tile
    is in exactly one run and no run is empty. B1, B6 and the segmented
    sort-reduce launch with T on a grid of (runs, slots)."""
    if d < 1 or sms < 1:
        raise ValueError(f"column_runs needs positive sizes, got {(d, sms)}")
    tiles = _ceil_div(d, _SORT_TILE)
    t = _ceil_div(tiles, _SORT_BLOCKS_PER_SM * sms)
    return t, _ceil_div(tiles, t)


def _run_tiles(x: torch.Tensor, d: int) -> int:
    """The column-sort engine's T for ``d`` columns on ``x``'s card."""
    return column_runs(d, torch.cuda.get_device_properties(x.device).multi_processor_count)[0]


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
            _SORT_MODES[mode], f, _DTYPE_CODES[xs.dtype], _run_tiles(xs, d), _stream(xs),
        )
    count_launch(f"sorted_reduce:{mode}")
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


def _recip(k: int, like: torch.Tensor) -> torch.Tensor:
    """The f32 reciprocal of ``k``, rounded once, on ``like``'s device: the
    reference's division by a constant count compiles to a multiply by it
    (B6, B7)."""
    return torch.reciprocal(torch.full((), float(k), dtype=torch.float32, device=like.device))


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


def gram_chunks(d: int, K: int, sms: int) -> tuple:
    """``(chunk, nchunks)`` of B3's split-K Gram over ``K`` rounds of ``d``
    columns on a card of ``sms`` SMs: about ``_GRAM_BLOCKS_PER_SM`` blocks
    a SM, each a chunk of a multiple of ``_GRAM_TK`` columns and at least
    ``_GRAM_MIN_CHUNK``, the chunks covering ``d``. They fix the summation
    order (:func:`gram_split_k_plain`)."""
    per_round = max(1, _GRAM_BLOCKS_PER_SM * sms // K)
    chunk = max(_GRAM_MIN_CHUNK, _round_up(_ceil_div(d, per_round), _GRAM_TK))
    return chunk, _ceil_div(d, chunk)


def gram(xs: torch.Tensor) -> torch.Tensor:
    """``(K, n, n)`` f32 Gram matrices ``x @ x.T`` of ``K`` stacked rounds
    ``xs: (K, n, d)``, accumulated in f32 (B3; ref
    ``pallas_kernels.gram_pallas``). On the card: split-K partials plus a
    fixed-order reduction, the same bits on every run; they equal
    :func:`gram_split_k_plain` at the card's chunking (:func:`gram_chunks`)."""
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
    chunk, nchunks = gram_chunks(d, K, sms)
    # each chunk's partial Gram: its entries i <= j packed row by row
    partial = torch.empty(K * nchunks * (n * (n + 1) // 2), dtype=torch.float32, device=xs.device)
    out = torch.empty((K, n, n), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        _call(
            "byz_gram", xs.data_ptr(), partial.data_ptr(), out.data_ptr(), K, n, d,
            chunk, nchunks, npad, _DTYPE_CODES[xs.dtype], _stream(xs),
        )
    count_launch("gram")
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


def gram_split_k_plain(xs: torch.Tensor, chunk: int) -> torch.Tensor:
    """B3's own summation order in plain PyTorch, on any device: per chunk
    of ``chunk`` columns, each entry's ascending :func:`fma_f32` chain from
    +0.0 over the chunk's columns (the last chunk's zero-padded past ``d``
    to a multiple of ``_GRAM_TK``, and no further), all chunks at once;
    then the chunks' partials added in chunk order in f32. At the card's
    :func:`gram_chunks` it equals :func:`gram` on the card bit for bit (NaN
    payloads aside). No path runs it: :func:`gram_plain` is the CPU path."""
    _check_ndim(xs, 3, "xs")
    if chunk < 1 or chunk % _GRAM_TK:
        raise ValueError(f"chunk must be a positive multiple of {_GRAM_TK}, got {chunk}")
    x = xs.float()
    K, n, d = x.shape
    s = x.new_zeros((K, n, n))
    if K == 0 or d == 0:
        return s
    nchunks = _ceil_div(d, chunk)
    cols = torch.zeros((K, n, nchunks * chunk), dtype=torch.float32, device=x.device)
    cols[..., :d] = x
    cols = cols.view(K, n, nchunks, chunk).permute(0, 2, 3, 1)  # (K, chunk b, column, row)
    acc = x.new_zeros((K, nchunks, n, n))
    last_end = _round_up(d, _GRAM_TK) - (nchunks - 1) * chunk  # the last chunk's columns
    for c in range(chunk):
        v = cols[:, :, c]  # (K, nchunks, n)
        step = fma_f32(v[..., :, None], v[..., None, :], acc)
        if c >= last_end:
            step[:, -1] = acc[:, -1]
        acc = step
    for b in range(nchunks):
        s = s + acc[:, b]
    return s


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
    K, n = _check_gram(g)
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
    count_launch(f"selection_weights:{mode}")
    return w


def _sq_dists(g: torch.Tensor) -> torch.Tensor:
    """``d2[:, i, j] = max(G_ii + G_jj - 2 G_ij, 0)`` of a Gram stack, NaN
    kept (the kernels' ``sq_dist``)."""
    norms = torch.diagonal(g, dim1=1, dim2=2)
    d2 = (norms[:, :, None] + norms[:, None, :]) - 2.0 * g
    return torch.where(d2 < 0, torch.zeros_like(d2), d2)


def selection_weights_plain(
    g: torch.Tensor, *, f: int, q: int, mode: str, reference_index: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of :func:`selection_weights`."""
    n = g.shape[1]
    norms = torch.diagonal(g, dim1=1, dim2=2)
    d2 = _sq_dists(g)
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
    """``(K, d)`` sums ``sum_i (w_i != 0 ? x_i : 0) * w_i`` in f32, rows
    ascending, cast to ``xs``'s dtype (B4 phase 3, and the sweep of B9 and
    B10). A NaN weight is read, so the all-NaN weights of a selection that
    took a non-finite row give an all-NaN output, as in the reference; a
    row of weight 0 is never read."""
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
    count_launch("weighted_rows")
    return out


def weighted_rows_plain(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`weighted_rows`."""
    sel = w != 0
    rows = torch.where(sel[:, :, None], xs.float(), torch.zeros((), device=xs.device)) * w[:, :, None]
    return canonical_nan(_sequential_row_sum(rows).to(xs.dtype))


# ---------------------------------------------------------------------------
# B5: selection mean from a precomputed Gram
# ---------------------------------------------------------------------------


def _check_from_gram(x: torch.Tensor, g: torch.Tensor, **sel) -> None:
    """``selection_mean_from_gram_pallas``'s checks, in its order."""
    if sel["mode"] not in _SELECTION_MODES:
        raise ValueError(f"unknown mode {sel['mode']!r}")
    _check_ndim(x, 2, "x")
    n = x.shape[0]
    if tuple(g.shape) != (n, n):
        raise ValueError(f"gram must have shape ({n}, {n}), got {tuple(g.shape)}")
    check_selection_args(n, **sel)
    _check_float(x)


def selection_mean_from_gram(
    x: torch.Tensor,
    gram: torch.Tensor,
    *,
    f: int,
    q: int,
    mode: str = "krum",
    reference_index: int = 0,
) -> torch.Tensor:
    """Mean of the ``q`` lowest-score rows of ``x: (n, d)`` given its
    precomputed ``(n, n)`` Gram (B5; ref
    ``pallas_kernels.selection_mean_from_gram_pallas``), returning ``(d,)``
    in ``x``'s dtype: the finalize of the streaming Multi-Krum fold, whose
    Gram grew one row per arrival. Scores, ties and NaN order as in
    :func:`selection_mean_stream`; the Gram is read as f32.

    On the card one launch (counter ``selection_mean_from_gram:<mode>``):
    the first block computes B4's weights on the Gram and every block then
    sums the selected rows (those with ``w != 0``; B5's weights are ``1/q``
    or 0, so this is the reference's ``w > 0``), one read of the Gram, one
    of the selected rows and a ``(d,)`` write, the TPU kernel's traffic. It
    uses a small zeroed scratch kept for each device and stream (zeroed
    once, when first made, and left zeroed by every call). ``d = 0``
    launches nothing."""
    sel = dict(f=f, q=q, mode=mode, reference_index=reference_index)
    _check_from_gram(x, gram, **sel)
    if _on_cpu(x, gram):
        return selection_mean_from_gram_plain(x, gram, **sel)
    n, d = x.shape
    _check_cuda_input(x, n)
    g = gram.to(torch.float32).contiguous()
    out = torch.empty((d,), dtype=x.dtype, device=x.device)
    if d == 0:
        return out
    with torch.cuda.device(x.device):
        _call(
            "byz_selection_mean_from_gram", x.data_ptr(), g.data_ptr(), out.data_ptr(),
            _from_gram_scratch(x).data_ptr(), n, d, f, q, _SELECTION_MODES[mode],
            reference_index, _DTYPE_CODES[x.dtype], _stream(x),
        )
    count_launch(f"selection_mean_from_gram:{mode}")
    return out


# B5's scratch by (device, stream): zeroed when made, and each call leaves it
# zeroed; calls on one stream run one after another, so they can share one
_FROM_GRAM_SCRATCH: dict = {}


def _from_gram_scratch(x: torch.Tensor) -> torch.Tensor:
    key = (x.device.index, _stream(x))
    scratch = _FROM_GRAM_SCRATCH.get(key)
    if scratch is None:
        size = _build.function("byz_from_gram_scratch_bytes")()
        scratch = torch.zeros((size,), dtype=torch.uint8, device=x.device)
        _FROM_GRAM_SCRATCH[key] = scratch
    return scratch


def selection_mean_from_gram_plain(
    x: torch.Tensor,
    gram: torch.Tensor,
    *,
    f: int,
    q: int,
    mode: str = "krum",
    reference_index: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`selection_mean_from_gram`: the two
    plain versions composed."""
    sel = dict(f=f, q=q, mode=mode, reference_index=reference_index)
    _check_from_gram(x, gram, **sel)
    w = selection_weights_plain(gram.to(torch.float32)[None], **sel)
    return weighted_rows_plain(x[None], w)[0]


# ---------------------------------------------------------------------------
# B6: MeaMed (mean around the median)
# ---------------------------------------------------------------------------


def meamed_stream(xs: torch.Tensor, *, f: int) -> torch.Tensor:
    """MeaMed of ``K`` stacked rounds ``xs: (K, n, d)``, returning ``(K,
    d)`` in ``xs``'s dtype (B6; ref ``pallas_kernels.meamed_stream_pallas``):
    per column, in f32, the mean of the ``k = n - f`` values closest to the
    median, ties at the cut taken in node order. The median is the middle
    value or ``0.5 a + 0.5 b`` of the middle two, NaN iff the column holds a
    NaN; the output is NaN where the median or the cut is."""
    _check_ndim(xs, 3, "xs")
    K, n, d = xs.shape
    if not 0 <= f < n:
        raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={f})")
    _check_float(xs)
    if _on_cpu(xs):
        return meamed_stream_plain(xs, f=f)
    _check_cuda_input(xs, n)
    out = torch.empty((K, d), dtype=xs.dtype, device=xs.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(xs.device):
        _call("byz_meamed", xs.data_ptr(), out.data_ptr(), K, n, d, f, _DTYPE_CODES[xs.dtype],
              _run_tiles(xs, d), _stream(xs))
    count_launch("meamed")
    return out


def meamed_stream_plain(xs: torch.Tensor, *, f: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`meamed_stream`: one key sort gives the
    median and the window-minimum cut (the ``k`` values closest to the
    median are a window of the sorted column); the select runs on the
    original column and its sum adds the selected rows in node order."""
    n = xs.shape[1]
    k = n - f
    x = xs.float()
    keys = torch.sort(float_sort_keys(x), dim=1).values
    srt = keys_to_float(keys)
    lo, hi = (n - 1) // 2, n // 2
    med = srt[:, lo] if lo == hi else srt[:, lo] * 0.5 + srt[:, hi] * 0.5
    med = torch.where(keys[:, n - 1] > _INF_KEY, float("nan"), med)
    # torch.maximum and amin keep NaN, as jnp's do
    radius = torch.maximum(med[:, None] - srt[:, :f + 1], srt[:, k - 1:] - med[:, None])
    dev = (x - med[:, None]).abs()
    enough = (~torch.isnan(dev)).sum(dim=1) >= k
    cut = torch.where(
        torch.isfinite(med),
        radius.amin(dim=1),
        torch.where(enough, float("inf"), float("nan")),
    )
    below = dev < cut[:, None]
    at = dev == cut[:, None]
    quota = k - below.sum(dim=1, keepdim=True)
    sel = below | (at & (torch.cumsum(at, dim=1) <= quota))
    total = _sequential_row_sum(torch.where(sel, x, 0.0))
    out = torch.where(torch.isnan(cut) | torch.isnan(med), float("nan"), total * _recip(k, x))
    return canonical_nan(out.to(xs.dtype))


# ---------------------------------------------------------------------------
# B7: the Weiszfeld and centred-clipping loops
# ---------------------------------------------------------------------------


def _check_center(x: torch.Tensor, z: torch.Tensor, mode: str = "weiszfeld", *,
                  loop: bool = False) -> tuple:
    """``(n, d)`` of a centre step's inputs (ref
    ``weighted_center_step_pallas``'s checks); raises otherwise. The
    masked modes run only as a whole loop (``loop``)."""
    if mode not in _CENTER_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode in _MASKED_CENTER_MODES and not loop:
        raise ValueError(f"{mode} runs only as a whole loop (center_loop)")
    _check_ndim(x, 2, "x")
    n, d = x.shape
    if tuple(z.shape) != (d,):
        raise ValueError(f"z must have shape ({d},), got {tuple(z.shape)}")
    _check_float(x)
    if z.dtype != x.dtype:
        raise ValueError(f"z must have x's dtype {x.dtype}, got {z.dtype}")
    return n, d


def _center_tree(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of 32 lanes by the kernel's warp butterfly
    (xor 16, 8, 4, 2, 1): lane 0's value."""
    idx = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., idx ^ o]
    return v[..., 0]


def _center_order_sum(v: torch.Tensor) -> torch.Tensor:
    """``(r,)`` sums of the rows of ``v: (r, d)`` f32 in ``csrc/center_step.cu``'s
    order, fixed by ``d`` alone: chunks of ``_CENTER_CHUNK`` columns; in a
    chunk, thread ``t`` of ``_CENTER_THREADS`` adds columns ``t + 256 k`` in
    order, a butterfly adds each warp's 32 threads, the 8 warp sums add in
    order; lane ``l`` adds chunks ``l, l + 32, ...`` in order and a
    butterfly adds the 32 lanes. Every add starts from +0.0; the padding
    adds +0.0, which leaves these non-negative (or NaN) sums as they are."""
    r, d = v.shape
    nchunks = _ceil_div(d, _CENTER_CHUNK)
    steps = _CENTER_CHUNK // _CENTER_THREADS
    v = torch.nn.functional.pad(v, (0, nchunks * _CENTER_CHUNK - d))
    v = v.view(r, nchunks, steps, _CENTER_THREADS)
    acc = torch.zeros((r, nchunks, _CENTER_THREADS), dtype=torch.float32, device=v.device)
    for k in range(steps):
        acc = acc + v[:, :, k]
    warps = _center_tree(acc.view(r, nchunks, _CENTER_THREADS // 32, 32))
    part = torch.zeros((r, nchunks), dtype=torch.float32, device=v.device)
    for w in range(warps.shape[2]):
        part = part + warps[:, :, w]
    rounds = _ceil_div(nchunks, 32)
    part = torch.nn.functional.pad(part, (0, rounds * 32 - nchunks)).view(r, rounds, 32)
    lanes = torch.zeros((r, 32), dtype=torch.float32, device=v.device)
    for m in range(rounds):
        lanes = lanes + part[:, m]
    return _center_tree(lanes)


def center_sq_dists_plain(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``(n,)`` f32 ``sum_c (x_ic - z_c)^2``, each difference and square
    rounded once, summed in the loop kernel's order (:func:`_center_order_sum`)."""
    diff = x.float() - z.float()
    return _center_order_sum(diff * diff)


def _center_round(v: torch.Tensor, dtype) -> torch.Tensor:
    """f32 ``v`` rounded to ``dtype`` and back (``rnd`` in the kernel)."""
    return v.to(dtype).float()


def _center_weights_from(sq: torch.Tensor, n: int, *, mode: str, eps: float, c_tau: float):
    """``(w (n,), alpha (1,))`` f32 from the squared distances: the raw
    weights row by row, their sum in row order."""
    one = torch.ones((), dtype=torch.float32, device=sq.device)
    # torch.maximum / torch.minimum keep NaN, as jnp's do
    den = torch.maximum(torch.sqrt(sq), torch.full_like(one, eps))
    if mode == "weiszfeld":
        raw = one / den
    else:
        raw = torch.minimum(one, torch.full_like(den, c_tau) / den) * _recip(n, sq)
    total = _sequential_row_sum(raw[None, :, None])[0]
    if mode == "weiszfeld":
        return raw / total, torch.zeros_like(total)
    return raw, one - total


def _check_max_iter(max_iter: int) -> None:
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")


def _check_valid(x: torch.Tensor, mode: str, valid) -> None:
    if (mode in _MASKED_CENTER_MODES) != (valid is not None):
        raise ValueError(f"valid is given exactly in the masked modes {_MASKED_CENTER_MODES}")
    if valid is not None and (tuple(valid.shape) != (x.shape[0],) or valid.dtype != torch.bool):
        raise ValueError(f"valid must be ({x.shape[0]},) bool, got {tuple(valid.shape)} {valid.dtype}")


def center_loop(
    x: torch.Tensor,
    z0: torch.Tensor,
    *,
    mode: str,
    eps: float = 1e-12,
    c_tau: float = 1.0,
    tol: float = 1e-6,
    max_iter: int = 256,
    valid: Optional[torch.Tensor] = None,
) -> tuple:
    """A whole centre-seeking loop on ``x: (n, d)`` from ``z0: (d,)`` (B7;
    ref ``byzpy_tpu/ops/robust.py:727-754`` and :814 around
    ``pallas_kernels.weighted_center_step_pallas``): ``(z, iterations)``,
    the final centre in ``x``'s dtype and the steps taken as an int32
    scalar on ``x``'s device.

    Each step is ``z <- alpha z + sum_i w_i x_i`` in f32, rounded to
    ``x``'s dtype. ``weiszfeld``: ``w_i = (1/max(dist_i, eps)) / sum_j
    (...)``, ``alpha = 0``, stepping while ``(it == 0 or delta > tol) and it
    < max_iter``, ``delta`` the step length in ``x``'s dtype; ``clip``:
    ``w_i = min(1, c_tau/max(dist_i, eps)) / n``, ``alpha = 1 - sum_i w_i``,
    exactly ``max_iter`` steps (``tol`` unused). Every row enters the sum, so
    an inf row (``w = 0``) or a NaN one makes the step NaN, as in the
    reference.

    ``masked_weiszfeld`` (ref ``robust.py:1581`` ``masked_geometric_median``)
    takes the rows where ``valid`` (``(n,)`` bool) is set: each step is the
    masked family's, ``z <- (sum_i w_i x_i) / sum_i w_i`` with ``w_i =
    1/max(dist_i, eps)`` rounded to ``x``'s dtype on a valid row and 0 on
    the others, the distances in :func:`row_sq_dists`' order and both sums
    :func:`segment_sum`'s row chain, so a padded matrix steps as its valid
    rows alone; it stops as ``weiszfeld`` does. ``masked_clip`` (ref
    ``robust.py:1623`` ``masked_centered_clipping``) runs exactly
    ``max_iter`` (M) steps ``v <- v + (sum_i w_i rnd(x_i - v)) * inv`` with
    ``w_i = min(1, c_tau/max(dist_i, eps))`` rounded to ``x``'s dtype on a
    valid row and 0 on the others, the sum :func:`segment_sum`'s row chain
    rounded to ``x``'s dtype and ``inv`` the reciprocal of the valid rows'
    count rounded to it (``tol`` unused).

    On the card: one launch of ``csrc/center_step.cu`` whatever the step
    count, its stopping test on the device (counter ``center_loop:<mode>``);
    ``max_iter = 0`` or ``d = 0`` launches nothing and returns a copy of
    ``z0``."""
    n, d = _check_center(x, z0, mode, loop=True)
    _check_valid(x, mode, valid)
    _check_max_iter(max_iter)
    if _on_cpu(x, z0, *(() if valid is None else (valid,))):
        return center_loop_plain(x, z0, mode=mode, eps=eps, c_tau=c_tau, tol=tol,
                                 max_iter=max_iter, valid=valid)
    _check_cuda_input(x, n)
    _check_cuda_input(z0, n)
    if valid is not None:
        _check_cuda_input(valid, n)
    if max_iter == 0 or d == 0:
        return z0.clone(), torch.zeros((), dtype=torch.int32, device=x.device)
    if n < 1:
        raise ValueError(f"x must have at least one row, got {(n, d)}")
    out = torch.empty((d,), dtype=x.dtype, device=x.device)
    ints = _center_launch(x, z0, out, mode=mode, eps=eps, c_tau=c_tau, tol=tol, max_iter=max_iter,
                          valid=valid)
    count_launch(f"center_loop:{mode}")
    return out, ints[0]


def _center_launch(x, z0, out, *, mode, eps, c_tau, tol=0.0, max_iter=1, w_in=None,
                   alpha_in=None, wa_out=None, valid=None) -> torch.Tensor:
    """One launch of ``byz_center_loop``; returns its two int32 (the steps
    taken, the barrier's counter). Scratch: the chunk partials of the n
    rows and the step length, the raw weights, delta; in the masked modes
    also the n x 4,096 lane partials of the distances and the d rounded
    squares of a step's length."""
    n, d = x.shape
    nchunks = _ceil_div(d, _CENTER_CHUNK)
    masked = n * _ROW_LANES + d if valid is not None else 0
    scratch = torch.empty(((n + 1) * nchunks + n + 1 + masked,), dtype=torch.float32,
                          device=x.device)
    ints = torch.empty((2,), dtype=torch.int32, device=x.device)
    tol_x = float(torch.tensor(tol, dtype=x.dtype))  # the comparison runs in x's dtype

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        _call(
            "byz_center_loop", x.data_ptr(), z0.data_ptr(), ptr(out), ptr(w_in),
            ptr(alpha_in), ptr(wa_out), scratch.data_ptr(), ints.data_ptr(), ptr(valid), n, d,
            _CENTER_MODES[mode], eps, c_tau, tol_x, max_iter, _DTYPE_CODES[x.dtype], _stream(x),
        )
    return ints


def _center_delta(zn: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The step length ``|zn - z|`` in ``z``'s dtype as the loop kernel forms
    it: each difference and square rounded to the dtype, their sum in
    :func:`_center_order_sum`'s order rounded, its root rounded."""
    e = _center_round(zn.float() - z.float(), z.dtype)
    s = _center_order_sum(_center_round(e * e, z.dtype)[None])[0]
    return _center_round(torch.sqrt(_center_round(s, z.dtype)), z.dtype)


def _masked_center_step(x: torch.Tensor, z: torch.Tensor, valid: torch.Tensor, *, mode: str,
                        eps: float, c_tau: float) -> torch.Tensor:
    """One step of a masked mode: the masked family's arithmetic (see
    :func:`center_loop`)."""
    n = x.shape[0]
    one = torch.ones((), dtype=torch.float32, device=x.device)
    dist = torch.maximum(torch.sqrt(row_sq_dists_plain(x, z)), torch.full_like(one, eps))
    if mode == "masked_clip":
        w = torch.minimum(one, torch.full_like(one, c_tau) / dist)
    else:
        w = one / dist
    w = torch.where(valid, w, torch.zeros_like(one)).to(x.dtype)
    if mode == "masked_clip":
        # 1 / count rounded to x's dtype; invalid rows: diff = -z, weight 0
        inv = torch.ones((), dtype=x.dtype, device=x.device) / valid.sum().to(x.dtype)
        step = segment_sum_plain(x - z[None, :], w.float().reshape(1, -1))[0]
        return canonical_nan(z + step * inv)
    num = segment_sum_plain(x, w.float().reshape(1, -1))[0]
    den = segment_sum_plain(w[:, None], torch.ones((1, n), device=x.device))[0]
    return canonical_nan(num / den)


def center_loop_plain(
    x: torch.Tensor,
    z0: torch.Tensor,
    *,
    mode: str,
    eps: float = 1e-12,
    c_tau: float = 1.0,
    tol: float = 1e-6,
    max_iter: int = 256,
    valid: Optional[torch.Tensor] = None,
) -> tuple:
    """Plain PyTorch version of :func:`center_loop`: the same steps in the
    same order (the distances and the step length by
    :func:`_center_order_sum`; the masked modes' distances and sums by
    :func:`row_sq_dists_plain` and :func:`segment_sum_plain`), the stopping
    test read on the host."""
    n, d = _check_center(x, z0, mode, loop=True)
    _check_valid(x, mode, valid)
    _check_max_iter(max_iter)
    z, it = z0.clone(), 0
    if d == 0:
        max_iter = 0
    tol_x = float(torch.tensor(tol, dtype=x.dtype))
    masked = mode in _MASKED_CENTER_MODES
    sq = center_sq_dists_plain(x, z) if max_iter and not masked else None
    while it < max_iter:
        if masked:
            zn = _masked_center_step(x, z, valid, mode=mode, eps=eps, c_tau=c_tau)
        else:
            w, alpha = _center_weights_from(sq, n, mode=mode, eps=eps, c_tau=c_tau)
            zn = center_sweep_plain(x, z, w, alpha)
        it += 1
        if it == max_iter:
            z = zn
            break
        if mode in ("weiszfeld", "masked_weiszfeld") and not bool(_center_delta(zn, z) > tol_x):
            z = zn
            break
        z = zn
        if not masked:
            sq = center_sq_dists_plain(x, z)
    return z, torch.tensor(it, dtype=torch.int32, device=x.device)


def weighted_center_step(
    x: torch.Tensor,
    z: torch.Tensor,
    *,
    mode: str = "weiszfeld",
    eps: float = 1e-12,
    c_tau: float = 1.0,
) -> torch.Tensor:
    """One step of a centre-seeking aggregator on ``x: (n, d)`` and the
    centre ``z: (d,)`` (B7; ref ``pallas_kernels.weighted_center_step_pallas``):
    the new centre ``alpha z + sum_i w_i x_i`` in ``x``'s dtype (see
    :func:`center_loop`). :func:`center_loop` at ``max_iter = 1``, so it is
    that loop's first step bit for bit; ``d = 0`` launches nothing."""
    n, d = _check_center(x, z, mode)
    if d == 0:
        return x.new_empty((0,))
    return center_loop(x, z, mode=mode, eps=eps, c_tau=c_tau, max_iter=1)[0]


def weighted_center_step_plain(
    x: torch.Tensor,
    z: torch.Tensor,
    *,
    mode: str = "weiszfeld",
    eps: float = 1e-12,
    c_tau: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`weighted_center_step`."""
    return center_loop_plain(x, z, mode=mode, eps=eps, c_tau=c_tau, max_iter=1)[0]


def center_weights(
    x: torch.Tensor, z: torch.Tensor, *, mode: str, eps: float = 1e-12, c_tau: float = 1.0
) -> tuple:
    """``(w (n,), alpha (1,))`` f32 of one centre step (the weights the
    loop's first step takes). On the card: the loop kernel's first pass,
    row reduce and weights, then it stops (counter ``center_weights:<mode>``)."""
    n, d = _check_center(x, z, mode)
    if n < 1 or d < 1:
        raise ValueError(f"x must have at least one row and one column, got {(n, d)}")
    if _on_cpu(x, z):
        return center_weights_plain(x, z, mode=mode, eps=eps, c_tau=c_tau)
    _check_cuda_input(x, n)
    _check_cuda_input(z, n)
    wa = torch.empty((n + 1,), dtype=torch.float32, device=x.device)
    _center_launch(x, z, None, mode=mode, eps=eps, c_tau=c_tau, wa_out=wa)
    count_launch(f"center_weights:{mode}")
    return wa[:n], wa[n:]


def center_weights_plain(
    x: torch.Tensor, z: torch.Tensor, *, mode: str, eps: float = 1e-12, c_tau: float = 1.0
) -> tuple:
    """Plain PyTorch version of :func:`center_weights` (the distances in the
    kernel's order, the weights' sum in row order)."""
    return _center_weights_from(center_sq_dists_plain(x, z), x.shape[0], mode=mode, eps=eps,
                                c_tau=c_tau)


def center_sweep(
    x: torch.Tensor, z: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """``alpha z + sum_i w_i x_i`` in f32, rows ascending, cast to ``x``'s
    dtype (a step under given weights). Every row is read, ``w = 0`` ones
    included, so that ``0 * inf`` poisons the output as in the reference
    (B4's :func:`weighted_rows` skips them). On the card: the loop
    kernel's sweep alone (counter ``center_sweep``)."""
    n, d = _check_center(x, z)
    if w.shape != (n,) or w.dtype != torch.float32:
        raise ValueError(f"w must be ({n},) float32, got {tuple(w.shape)} {w.dtype}")
    if alpha.shape != (1,) or alpha.dtype != torch.float32:
        raise ValueError(f"alpha must be (1,) float32, got {tuple(alpha.shape)} {alpha.dtype}")
    if _on_cpu(x, z, w, alpha):
        return center_sweep_plain(x, z, w, alpha)
    for t in (x, z, w, alpha):
        _check_cuda_input(t, n)
    out = torch.empty((d,), dtype=x.dtype, device=x.device)
    if d == 0:
        return out
    _center_launch(x, z, out, mode="clip", eps=0.0, c_tau=0.0, w_in=w, alpha_in=alpha)
    count_launch("center_sweep")
    return out


def center_sweep_plain(
    x: torch.Tensor, z: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`center_sweep`."""
    acc = _sequential_row_sum((x.float() * w[:, None])[None])[0]
    return canonical_nan((alpha * z.float() + acc).to(x.dtype))


# ---------------------------------------------------------------------------
# B8: Nearest-Neighbour Mixing
# ---------------------------------------------------------------------------


def nnm_stream(xs: torch.Tensor, *, f: int) -> torch.Tensor:
    """Nearest-Neighbour Mixing of ``K`` stacked rounds ``xs: (K, n, d)``
    (B8; ref ``pallas_kernels.nnm_stream_pallas``): each row becomes the
    mean of its ``k = n - f`` nearest rows, self included, ties by row
    index, NaN distances last; a row that selected a row whose squared norm
    is not finite becomes NaN. Returns ``(K, n, d)`` in ``xs``'s dtype.

    A composition of :func:`gram`, :func:`nnm_weights` and
    :func:`mix_rows`, which count their own launches; an empty input
    launches nothing."""
    _check_ndim(xs, 3, "xs")
    K, n, d = xs.shape
    if not 0 <= f < n:
        raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={f})")
    _check_float(xs)
    if K == 0 or d == 0:
        return xs.new_empty((K, n, d))
    mask, sel_taint = nnm_weights(gram(xs), k=n - f)
    return mix_rows(xs, mask, sel_taint, k=n - f)


def nnm_weights(g: torch.Tensor, *, k: int) -> tuple:
    """NNM's selection state from ``(K, n, n)`` Gram matrices (B8 phase
    2): ``mask (K, n, n)`` f32, 1 at ``[:, j, i]`` iff row ``i`` mixes row
    ``j`` (one of its ``k`` nearest) and row ``j``'s squared norm is
    finite; ``sel_taint (K, n)`` f32, 1 where row ``i`` selected a row
    whose squared norm is not finite."""
    K, n = _check_gram(g)
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, n] (got k={k}, n={n})")
    if _on_cpu(g):
        return nnm_weights_plain(g, k=k)
    _check_cuda_input(g, n)
    mask = torch.empty((K, n, n), dtype=torch.float32, device=g.device)
    sel_taint = torch.empty((K, n), dtype=torch.float32, device=g.device)
    if K == 0:
        return mask, sel_taint
    with torch.cuda.device(g.device):
        _call("byz_nnm_weights", g.data_ptr(), mask.data_ptr(), sel_taint.data_ptr(), K, n, k,
              _stream(g))
    count_launch("nnm_weights")
    return mask, sel_taint


def nnm_weights_plain(g: torch.Tensor, *, k: int) -> tuple:
    """Plain PyTorch version of :func:`nnm_weights`: per column, the keys
    below the ``k``-th smallest plus keys equal to it in row order until
    ``k`` are taken (ref ``_stable_k_select_mask``)."""
    keys = float_sort_keys(_sq_dists(g).contiguous())  # keys[:, j, i]: row j, mixer i
    cut = torch.sort(keys, dim=1).values[:, k - 1:k, :]
    below = keys < cut
    at = keys == cut
    quota = k - below.sum(dim=1, keepdim=True)
    sel = below | (at & (torch.cumsum(at, dim=1) <= quota))
    taint = ~torch.isfinite(torch.diagonal(g, dim1=1, dim2=2))[:, :, None]
    return (sel & ~taint).float(), (sel & taint).any(dim=1).float()


def mix_rows(
    xs: torch.Tensor, mask: torch.Tensor, sel_taint: torch.Tensor, *, k: int
) -> torch.Tensor:
    """``(K, n, d)`` mixed rows ``out[:, i] = (sum_j mask[:, j, i] x_j) / k``
    in f32, rows ``j`` ascending, NaN where ``sel_taint``, cast to ``xs``'s
    dtype (B8 phase 3). ``mask`` is 0/1 and clear on rows that are not
    finite, as :func:`nnm_weights` makes it; only selected rows are
    added."""
    _check_ndim(xs, 3, "xs")
    _check_float(xs)
    K, n, d = xs.shape
    if mask.shape != (K, n, n) or mask.dtype != torch.float32:
        raise ValueError(f"mask must be ({K}, {n}, {n}) float32, got {tuple(mask.shape)} {mask.dtype}")
    if sel_taint.shape != (K, n) or sel_taint.dtype != torch.float32:
        raise ValueError(
            f"sel_taint must be ({K}, {n}) float32, got {tuple(sel_taint.shape)} {sel_taint.dtype}"
        )
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, n] (got k={k}, n={n})")
    if _on_cpu(xs, mask, sel_taint):
        return mix_rows_plain(xs, mask, sel_taint, k=k)
    for t in (xs, mask, sel_taint):
        _check_cuda_input(t, n)
    out = torch.empty_like(xs)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(xs.device).multi_processor_count
    with torch.cuda.device(xs.device):
        _call(
            "byz_mix_rows", xs.data_ptr(), mask.data_ptr(), sel_taint.data_ptr(), out.data_ptr(),
            K, n, k, d, _MIX_BLOCKS_PER_SM * sms, _DTYPE_CODES[xs.dtype], _stream(xs),
        )
    count_launch("mix_rows")
    return out


def mix_rows_plain(
    xs: torch.Tensor, mask: torch.Tensor, sel_taint: torch.Tensor, *, k: int
) -> torch.Tensor:
    """Plain PyTorch version of :func:`mix_rows` (an unselected row adds
    +0, which leaves every sum as it is)."""
    x = xs.float()
    acc = torch.zeros_like(x)
    for j in range(xs.shape[1]):
        acc = acc + torch.where(mask[:, j, :, None] != 0, x[:, j, None, :], 0.0)
    out = torch.where(sel_taint[:, :, None] != 0, float("nan"), _true_div(acc, k))
    return canonical_nan(out.to(xs.dtype))


# ---------------------------------------------------------------------------
# B9: NNM -> selection mean through the collapsed Gram
# ---------------------------------------------------------------------------


def nnm_selection_mean_stream(
    xs: torch.Tensor,
    *,
    f_nnm: int,
    f: int,
    q: int,
    mode: str = "krum",
    reference_index: int = 0,
) -> torch.Tensor:
    """Selection mean of the NNM-mixed rows of ``K`` stacked rounds
    ``xs: (K, n, d)``, returning ``(K, d)`` in ``xs``'s dtype, with the
    mixed matrix never built (B9; ref
    ``pallas_kernels.nnm_selection_mean_stream_pallas``): the mixed rows'
    Gram is ``A^T G~ A / k^2`` and their selected mean the source-row
    weights ``A w_sel / k``, NaN when a mixed row that selected a
    non-finite row is chosen.

    A composition of :func:`gram`, :func:`nnm_selection_weights` and
    :func:`weighted_rows`; an empty input launches nothing."""
    if mode not in _SELECTION_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _check_ndim(xs, 3, "xs")
    K, n, d = xs.shape
    if not 0 <= f_nnm < n:
        raise ValueError(f"f_nnm must satisfy 0 <= f_nnm < n (got {f_nnm})")
    check_selection_args(n, f=f, q=q, mode=mode, reference_index=reference_index)
    _check_float(xs)
    if K == 0 or d == 0:
        return xs.new_empty((K, d))
    w = nnm_selection_weights(
        gram(xs), k=n - f_nnm, f=f, q=q, mode=mode, reference_index=reference_index
    )
    return weighted_rows(xs, w)


def nnm_selection_weights(
    g: torch.Tensor, *, k: int, f: int, q: int, mode: str = "krum", reference_index: int = 0
) -> torch.Tensor:
    """``(K, n)`` f32 source-row weights ``w_eff`` of B9 from ``(K, n, n)``
    Gram matrices, ``k = n - f_nnm`` (B9 phase 2)."""
    K, n = _check_gram(g)
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, n] (got k={k}, n={n})")
    check_selection_args(n, f=f, q=q, mode=mode, reference_index=reference_index)
    if _on_cpu(g):
        return nnm_selection_weights_plain(
            g, k=k, f=f, q=q, mode=mode, reference_index=reference_index
        )
    _check_cuda_input(g, n)
    w = torch.empty((K, n), dtype=torch.float32, device=g.device)
    if K == 0:
        return w
    with torch.cuda.device(g.device):
        _call(
            "byz_nnm_selection_weights", g.data_ptr(), w.data_ptr(), K, n, k, f, q,
            _SELECTION_MODES[mode], reference_index, _stream(g),
        )
    count_launch(f"nnm_selection_weights:{mode}")
    return w


def _ordered_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` in f32 with each sum taken in ascending index
    order, one rounding per add; one factor is 0/1, so every product is
    exact and this is the kernels' order of adds."""
    acc = torch.zeros((a.shape[0], a.shape[1], b.shape[2]), dtype=torch.float32, device=a.device)
    for j in range(a.shape[2]):
        acc = acc + a[:, :, j, None] * b[:, None, j, :]
    return acc


def nnm_selection_weights_plain(
    g: torch.Tensor, *, k: int, f: int, q: int, mode: str, reference_index: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of :func:`nnm_selection_weights`."""
    mask, sel_taint = nnm_weights_plain(g, k=k)
    taint = ~torch.isfinite(torch.diagonal(g, dim1=1, dim2=2))
    g_clean = torch.where(taint[:, :, None] | taint[:, None, :], 0.0, g)
    ga = _ordered_products(g_clean, mask)
    gm = _true_div(_ordered_products(mask.transpose(1, 2), ga), k * k)
    bad = sel_taint != 0
    gm = torch.where(bad[:, :, None] | bad[:, None, :], float("nan"), gm)
    w_sel = selection_weights_plain(gm, f=f, q=q, mode=mode, reference_index=reference_index)
    picked_bad = ((w_sel > 0) & bad).any(dim=1, keepdim=True)
    w_eff = _true_div(_ordered_products(mask, w_sel[:, :, None])[:, :, 0], k)
    return torch.where(picked_bad, float("nan"), w_eff)


# ---------------------------------------------------------------------------
# B10: static clipping or ARC -> selection mean through the clipped Gram
# ---------------------------------------------------------------------------


def clip_selection_mean_stream(
    xs: torch.Tensor,
    *,
    tau: float,
    f: int,
    q: int,
    mode: str = "krum",
    reference_index: int = 0,
) -> torch.Tensor:
    """Selection mean of ``K`` stacked rounds ``xs: (K, n, d)`` after each
    row is clipped to L2 norm ``tau``, returning ``(K, d)`` in ``xs``'s
    dtype (B10, ``pre="clip"``; ref
    ``pallas_kernels.clip_selection_mean_stream_pallas``). A row whose
    squared norm is not finite clips to factor 0 and is excluded, also
    when only the square overflows f32 (the reference's documented
    deviation). A composition of :func:`gram`,
    :func:`clip_selection_weights` and :func:`weighted_rows`."""
    if mode not in _SELECTION_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _check_ndim(xs, 3, "xs")
    K, n, d = xs.shape
    if not tau > 0:
        raise ValueError(f"tau must be positive (got {tau})")
    check_selection_args(n, f=f, q=q, mode=mode, reference_index=reference_index)
    _check_float(xs)
    if K == 0 or d == 0:
        return xs.new_empty((K, d))
    w = clip_selection_weights(
        gram(xs), pre="clip", tau=tau, f=f, q=q, mode=mode, reference_index=reference_index
    )
    return weighted_rows(xs, w)


def arc_selection_mean_stream(
    xs: torch.Tensor,
    *,
    f_arc: int,
    f: int,
    q: int,
    mode: str = "krum",
    reference_index: int = 0,
) -> torch.Tensor:
    """Selection mean of ``K`` stacked rounds after Adaptive Robust
    Clipping: the ``n - cut_off`` largest-norm rows clip to the
    ``cut_off``-th smallest norm, ``cut_off = preagg.arc_cut_off(n,
    f_arc)`` (B10, ``pre="arc"``; ref
    ``pallas_kernels.arc_selection_mean_stream_pallas``)."""
    from .preagg import arc_cut_off  # preagg imports this module

    if mode not in _SELECTION_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _check_ndim(xs, 3, "xs")
    K, n, d = xs.shape
    if not 0 <= f_arc <= n:
        raise ValueError(f"f_arc must satisfy 0 <= f_arc <= n (got {f_arc})")
    check_selection_args(n, f=f, q=q, mode=mode, reference_index=reference_index)
    _check_float(xs)
    if K == 0 or d == 0:
        return xs.new_empty((K, d))
    w = clip_selection_weights(
        gram(xs), pre="arc", cut_off=arc_cut_off(n, f_arc), f=f, q=q, mode=mode,
        reference_index=reference_index,
    )
    return weighted_rows(xs, w)


def clip_selection_weights(
    g: torch.Tensor,
    *,
    pre: str,
    f: int,
    q: int,
    mode: str = "krum",
    reference_index: int = 0,
    tau: float = 0.0,
    cut_off: int = 0,
) -> torch.Tensor:
    """``(K, n)`` f32 source-row weights ``w_eff`` of B10 from ``(K, n,
    n)`` Gram matrices (B10 phase 2): clip factors ``c = min(1, threshold /
    max(norm, 1e-12))`` with the threshold ``tau`` (``pre="clip"``) or the
    norm at rank ``cut_off - 1`` (``pre="arc"``), the selection weights
    ``w_sel`` of the clipped Gram ``c_i c_j G_ij``, then ``w_sel * c``, 0 on
    rows with a non-finite norm, all NaN if such a row was selected."""
    if pre not in _CLIP_MODES:
        raise ValueError(f"unknown pre-aggregation {pre!r}")
    K, n = _check_gram(g)
    if pre == "clip" and not tau > 0:
        raise ValueError(f"tau must be positive (got {tau})")
    if pre == "arc" and not 1 <= cut_off <= n:
        raise ValueError(f"cut_off must be in [1, n] (got cut_off={cut_off}, n={n})")
    check_selection_args(n, f=f, q=q, mode=mode, reference_index=reference_index)
    if _on_cpu(g):
        return clip_selection_weights_plain(
            g, pre=pre, tau=tau, cut_off=cut_off, f=f, q=q, mode=mode,
            reference_index=reference_index,
        )
    _check_cuda_input(g, n)
    w = torch.empty((K, n), dtype=torch.float32, device=g.device)
    if K == 0:
        return w
    with torch.cuda.device(g.device):
        _call(
            "byz_clip_selection_weights", g.data_ptr(), w.data_ptr(), K, n, _CLIP_MODES[pre],
            tau, cut_off, f, q, _SELECTION_MODES[mode], reference_index, _stream(g),
        )
    count_launch(f"clip_selection_weights:{pre}")
    return w


def clip_selection_weights_plain(
    g: torch.Tensor,
    *,
    pre: str,
    f: int,
    q: int,
    mode: str,
    reference_index: int = 0,
    tau: float = 0.0,
    cut_off: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`clip_selection_weights` (the ARC
    threshold is the sorted key at ``cut_off - 1``: the row of that stable
    rank)."""
    sq = torch.diagonal(g, dim1=1, dim2=2)
    norms = torch.sqrt(torch.where(sq < 0, torch.zeros_like(sq), sq))  # NaN stays NaN
    if pre == "clip":
        threshold = torch.full((g.shape[0], 1), tau, dtype=torch.float32, device=g.device)
    else:
        keys = torch.sort(float_sort_keys(norms), dim=1).values
        threshold = keys_to_float(keys[:, cut_off - 1:cut_off])
    # torch.maximum / torch.minimum propagate NaN, as jnp's do
    den = torch.maximum(norms, torch.full((), 1e-12, dtype=torch.float32, device=g.device))
    c = torch.minimum(torch.ones((), dtype=torch.float32, device=g.device), threshold / den)
    w_sel = selection_weights_plain(
        (c[:, :, None] * c[:, None, :]) * g, f=f, q=q, mode=mode, reference_index=reference_index
    )
    bad = ~torch.isfinite(norms)
    picked_bad = ((w_sel > 0) & bad).any(dim=1, keepdim=True)
    w_eff = torch.where(bad, 0.0, w_sel * c)
    return torch.where(picked_bad, float("nan"), w_eff)


# ---------------------------------------------------------------------------
# B2: full column sort
# ---------------------------------------------------------------------------


def sort_columns(x: torch.Tensor) -> torch.Tensor:
    """Columns of ``x: (n, d)`` sorted ascending, in ``x``'s dtype (B2; ref
    ``pallas_kernels.sort_columns``): the int32 total-order key sort,
    -inf < finite < +inf < NaN, -0.0 before +0.0, NaN canonical; 16-bit
    floats through the exact f32 round trip."""
    _check_ndim(x, 2, "x")
    _check_float(x)
    n, d = x.shape
    if _on_cpu(x):
        return sort_columns_plain(x)
    _check_cuda_input(x, n)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _call("byz_sort_columns", x.data_ptr(), out.data_ptr(), n, d, _DTYPE_CODES[x.dtype],
              _stream(x))
    count_launch("sort_columns")
    return out


def sort_columns_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`sort_columns` (the same keys,
    ``torch.sort`` along the rows)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return canonical_nan(sort_columns_plain(x.float()).to(x.dtype))
    return keys_to_float(torch.sort(float_sort_keys(x), dim=0).values)


# ---------------------------------------------------------------------------
# B11: row-ordered segment sum, and the row reduction beside it
# ---------------------------------------------------------------------------


def _check_segment(x: torch.Tensor, w: torch.Tensor, fill) -> None:
    _check_ndim(x, 2, "x")
    _check_float(x)
    _check_ndim(w, 2, "w")
    if w.shape[1] != x.shape[0] or w.dtype != torch.float32:
        raise ValueError(
            f"w must be (C, {x.shape[0]}) float32, got {tuple(w.shape)} {w.dtype}"
        )
    _check_fill(fill)


def _check_fill(fill) -> None:
    if isinstance(fill, torch.Tensor) and (fill.numel() != 1 or fill.dtype != torch.int32):
        raise ValueError(f"fill must be one int32, got {tuple(fill.shape)} {fill.dtype}")


def segment_sum(x: torch.Tensor, w: torch.Tensor, *, fill=None) -> torch.Tensor:
    """``out[c] = sum_r w[c, r] x[r]`` for ``x: (R, d)`` and ``w: (C, R)``
    float32, returning ``(C, d)`` in ``x``'s dtype (B11; ref
    ``pallas_kernels.ragged_segment_sum_pallas``). Each output is one
    fused multiply-add chain over rows ``0 .. fill - 1`` in index order,
    from +0.0, each step rounded once: the order of XLA:CPU's row einsum,
    so appended zero rows leave every partial sum as it was. ``fill`` (an
    int, or one int32 on ``x``'s device; default ``R``) bounds the rows
    read: callers keep ``w`` and ``x`` zero past it, as the Pallas kernel
    skips whole row tiles. A device ``fill`` is never read on the host."""
    _check_segment(x, w, fill)
    R, d = x.shape
    C = w.shape[0]
    fill_t = fill if isinstance(fill, torch.Tensor) else None
    if _on_cpu(x, w, *(() if fill_t is None else (fill_t,))):
        return segment_sum_plain(x, w, fill=fill)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("CUDA kernels take contiguous tensors")
    if C > 65535:
        raise NotImplementedError(f"C={C} cohorts exceed the kernel's grid (65,535)")
    out = torch.empty((C, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fill_host = R if fill is None else (0 if fill_t is not None else int(fill))
    with torch.cuda.device(x.device):
        _call(
            "byz_segment_sum", x.data_ptr(), w.data_ptr(),
            None if fill_t is None else fill_t.data_ptr(), fill_host, out.data_ptr(), C, R, d,
            _DTYPE_CODES[x.dtype], _stream(x),
        )
    count_launch("segment_sum")
    return out


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on float32 tensors (broadcast) with one rounding, as
    ``__fmaf_rn``: the product of two f32 values is exact in f64, the f64
    sum's own rounding error is recovered (TwoSum), and where the f64 sum
    sits exactly halfway between two f32 values that error picks the side
    that a single rounding of the exact value takes."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = c64 + p
    bb = s - c64
    err = (c64 - (s - bb)) + (p - bb)
    r = s.float()
    back = r.double()
    other = torch.nextafter(r, torch.where(s > back, float("inf"), float("-inf")).float())
    other64 = other.double()
    tie = (s == (back + other64) * 0.5) & torch.isfinite(s) & (err != 0)
    return torch.where(tie & ((err > 0) == (other64 > back)), other, r)


def segment_sum_plain(x: torch.Tensor, w: torch.Tensor, *, fill=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_sum`: the same row-ordered
    chain, each step :func:`fma_f32`."""
    R, d = x.shape
    rows = R if fill is None else max(0, min(int(fill), R))
    acc = torch.zeros((w.shape[0], d), dtype=torch.float32, device=x.device)
    for r in range(rows):
        acc = fma_f32(w[:, r:r + 1], x[r:r + 1].float(), acc)
    return canonical_nan(acc.to(x.dtype))


def segment_sum_dequant(
    codes: torch.Tensor,
    scales: torch.Tensor,
    w: torch.Tensor,
    *,
    mode: str,
    block: int,
    d: int,
    fill=None,
    row_weights=None,
) -> torch.Tensor:
    """:func:`segment_sum` over still-coded wire rows (B12; ref
    ``pallas_kernels.ragged_segment_sum_dequant_pallas``): ``out[c] =
    sum_r w[c, r] x_r`` as ``(C, d)`` float32, where ``x_r`` is row ``r`` of
    ``codes: (R, ncodes)`` (int8 codes, fp8 bit patterns as uint8 or as
    their dtype, or packed s4 nibbles) times its block's scale in
    ``scales: (R, nb)`` float32, rounded once, then, with ``row_weights``
    (an ``(R,)`` float32 staleness discount), times ``row_weights[r]``,
    rounded once. One fused multiply-add chain per output over rows ``0 ..
    fill - 1`` in index order from +0.0: B11 on the decoded (and scaled)
    rows, bit for bit, without the ``(R, d)`` matrix. ``fill`` as in
    :func:`segment_sum`."""
    from . import codec_kernels as ck

    if mode not in ck.WIRE_CODES:
        raise ValueError(f"no wire row codec for mode {mode!r}")
    codes = ck.from_wire(codes, mode)
    _check_ndim(codes, 2, "codes")
    _check_ndim(scales, 2, "scales")
    _check_ndim(w, 2, "w")
    R, ncodes = codes.shape
    nb = scales.shape[1]
    if scales.dtype != torch.float32 or scales.shape[0] != R:
        raise ValueError(f"scales must be ({R}, nb) float32, got {tuple(scales.shape)} {scales.dtype}")
    if w.dtype != torch.float32 or w.shape[1] != R:
        raise ValueError(f"w must be (C, {R}) float32, got {tuple(w.shape)} {w.dtype}")
    if row_weights is not None and (tuple(row_weights.shape) != (R,)
                                    or row_weights.dtype != torch.float32):
        raise ValueError(f"row_weights must be ({R},) float32, got {tuple(row_weights.shape)}")
    if not isinstance(block, int) or block <= 0 or (mode == "s4" and block % 2):
        raise ValueError(f"block must be a positive int (even for s4), got {block!r}")
    if d and (nb * block < d or (2 * ncodes if mode == "s4" else ncodes) < d):
        raise ValueError(f"codes ({ncodes}) and {nb} scales of block {block} do not cover d={d}")
    _check_fill(fill)
    fill_t = fill if isinstance(fill, torch.Tensor) else None
    extra = tuple(t for t in (fill_t, row_weights) if t is not None)
    if _on_cpu(codes, scales, w, *extra):
        return segment_sum_dequant_plain(codes, scales, w, mode=mode, block=block, d=d, fill=fill,
                                         row_weights=row_weights)
    if not all(t.is_contiguous() for t in (codes, scales, w, *extra)):
        raise ValueError("CUDA kernels take contiguous tensors")
    C = w.shape[0]
    if C > 65535:
        raise NotImplementedError(f"C={C} cohorts exceed the kernel's grid (65,535)")
    out = torch.empty((C, d), dtype=torch.float32, device=codes.device)
    if out.numel() == 0:
        return out
    fill_host = R if fill is None else (0 if fill_t is not None else int(fill))
    with torch.cuda.device(codes.device):
        _call(
            "byz_segment_sum_dequant", codes.data_ptr(), scales.data_ptr(), w.data_ptr(),
            None if row_weights is None else row_weights.data_ptr(),
            None if fill_t is None else fill_t.data_ptr(), fill_host, out.data_ptr(), C, R, d,
            ncodes, nb, block, ck.WIRE_CODES[mode], _stream(codes),
        )
    count_launch(f"segment_sum_dequant:{mode}")
    return out


def segment_sum_dequant_plain(
    codes: torch.Tensor,
    scales: torch.Tensor,
    w: torch.Tensor,
    *,
    mode: str,
    block: int,
    d: int,
    fill=None,
    row_weights=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_sum_dequant`: the plain
    decode (B14's or B17's), the rows times ``row_weights``, then
    :func:`segment_sum_plain`."""
    from .codec_kernels import decode_wire_rows_plain

    x = decode_wire_rows_plain(codes, scales, mode=mode, block=block, d=d)
    if row_weights is not None:
        x = x * row_weights[:, None]
    return segment_sum_plain(x, w, fill=fill)


# ---------------------------------------------------------------------------
# The ragged door's segmented sort-reduce
# ---------------------------------------------------------------------------


def _check_layout(t: torch.Tensor, C: int, what: str) -> None:
    if tuple(t.shape) != (C,) or t.dtype != torch.int32:
        raise ValueError(f"{what} must be ({C},) int32, got {tuple(t.shape)} {t.dtype}")


def segmented_sort_reduce(
    flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor, *, mode: str, f: int = 0
) -> torch.Tensor:
    """Every cohort's f-trimmed coordinate mean (``mode='trimmed'``) or
    coordinate median (``mode='median'``) of a ragged batch, ``(C, d)``
    float32. ``flat: (R, d)`` float32 holds cohort ``c`` in rows
    ``[offsets[c], offsets[c] + lengths[c])`` (``(C,)`` int32 on ``flat``'s
    device, never read on the host). Each column of a cohort is sorted by
    the int32 total-order key; the trimmed mean adds sorted positions ``[f,
    m - f)`` in ascending order from +0.0 and multiplies by the rounded
    reciprocal of ``m - 2f``; the median is the middle value, or ``(lo +
    hi) * 0.5``. A slot of length 0 gives zeros, one whose rows leave
    ``[0, R)`` or that holds more than ``MAX_NETWORK_ROWS`` rows NaN; NaN
    canonical. ``R`` itself is free (a block reads its slot's offset and
    length; the ring is fixed). On finite rows, bit for bit the
    reference's ``ragged_trimmed_mean`` / ``ragged_median`` and the masked
    door's per-cohort programs."""
    if mode not in _SORT_MODES:
        raise ValueError(f"mode must be one of {sorted(_SORT_MODES)}, got {mode!r}")
    _check_ndim(flat, 2, "flat")
    if flat.dtype != torch.float32:
        raise ValueError(f"flat must be float32, got {flat.dtype}")
    if not isinstance(f, int) or f < 0:
        raise ValueError(f"f must be a non-negative int, got {f!r}")
    _check_ndim(offsets, 1, "offsets")
    C = offsets.shape[0]
    _check_layout(offsets, C, "offsets")
    _check_layout(lengths, C, "lengths")
    R, d = flat.shape
    if _on_cpu(flat, offsets, lengths):
        return segmented_sort_reduce_plain(flat, offsets, lengths, mode=mode, f=f)
    # any R: the ring is fixed and a block reads its slot from offsets[c];
    # a slot longer than MAX_NETWORK_ROWS writes NaN (callers route such a
    # batch to ops.ragged's torch path)
    if not (flat.is_contiguous() and offsets.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("CUDA kernels take contiguous tensors")
    if C > 65535:
        raise NotImplementedError(f"C={C} cohorts exceed the kernel's grid (65,535)")
    out = torch.empty((C, d), dtype=torch.float32, device=flat.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(flat.device):
        _call("byz_segmented_sort_reduce", flat.data_ptr(), offsets.data_ptr(), lengths.data_ptr(),
              out.data_ptr(), R, C, d, _SORT_MODES[mode], f, _run_tiles(flat, d), _stream(flat))
    count_launch("segmented_sort_reduce")
    return out


def segmented_sort_reduce_plain(
    flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor, *, mode: str, f: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of :func:`segmented_sort_reduce`: the
    segmented programs' arithmetic (``ops.ragged.segmented_sort``, one
    ``torch.sort`` of every cohort's columns, then the reference's
    zero-masked window chain or the clamped midpoint gathers). Cohorts
    are packed disjoint blocks, as ``RaggedExecutor`` lays them out."""
    from .ragged import _segment_positions, segment_ids, segmented_sort
    from .robust import _masked_rows_at

    R, d = flat.shape
    C = offsets.shape[0]
    if C == 0:
        return flat.new_zeros((0, d))
    # a slot whose rows leave [0, R), or longer than the network, takes
    # none of them and gives NaN
    bad = (lengths != 0) & ((offsets < 0) | (lengths < 0) | (lengths > MAX_NETWORK_ROWS)
                            | (offsets.long() + lengths.long() > R))
    lengths = torch.where(bad, 0, lengths)
    seg = segment_ids(offsets, lengths, R, C)
    s = segmented_sort(flat, seg)
    if mode == "trimmed":
        rel = _segment_positions(seg, offsets, C)
        windows = torch.stack([(seg == c) & (rel >= f) & (rel < lengths[c] - f) for c in range(C)])
        # fma(1, x, acc) = RN(acc + x); a zero outside a window leaves acc
        zero = torch.zeros((), dtype=torch.float32, device=flat.device)
        acc = torch.zeros((C, d), dtype=torch.float32, device=flat.device)
        for r in range(R):
            acc = acc + torch.where(windows[:, r:r + 1], s[r:r + 1], zero)
        recips = torch.ones((), device=flat.device) / (lengths - 2 * f).to(torch.float32)
        out = acc * recips[:, None]
    else:
        outs = []
        for c in range(C):
            m = lengths[c]
            lo = torch.div(m - 1, 2, rounding_mode="floor")
            hi = torch.div(m, 2, rounding_mode="floor")
            s_lo = _masked_rows_at(s, offsets[c] + lo)
            s_hi = _masked_rows_at(s, offsets[c] + hi)
            outs.append(torch.where(lo == hi, s_lo, (s_lo + s_hi) * 0.5))
        out = torch.stack(outs)
    out = torch.where(lengths[:, None] == 0, 0.0, out)
    return canonical_nan(torch.where(bad[:, None], float("nan"), out))


def row_sq_dists(x: torch.Tensor, z=None) -> torch.Tensor:
    """``(n,)`` float32 ``sum_c (x[i, c] - z[c])^2`` (``z=None``: the
    squared norms) in an order fixed by ``d`` alone, so a row's value does
    not depend on how many rows ``x`` has: lane ``l`` of ``_ROW_LANES``
    adds columns ``l, l + _ROW_LANES, ...`` in order, then 32 lanes each
    add every 32nd lane partial in order, and a butterfly adds the 32
    (``csrc/segment_sum.cu``)."""
    _check_ndim(x, 2, "x")
    _check_float(x)
    n, d = x.shape
    if z is not None and (tuple(z.shape) != (d,) or z.dtype != x.dtype):
        raise ValueError(f"z must be ({d},) {x.dtype}, got {tuple(z.shape)} {z.dtype}")
    if _on_cpu(x, *(() if z is None else (z,))):
        return row_sq_dists_plain(x, z)
    if not (x.is_contiguous() and (z is None or z.is_contiguous())):
        raise ValueError("CUDA kernels take contiguous tensors")
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    partial = torch.empty((n * _ROW_LANES,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _call(
            "byz_row_sq_dists", x.data_ptr(), None if z is None else z.data_ptr(),
            partial.data_ptr(), out.data_ptr(), n, d, _DTYPE_CODES[x.dtype], _stream(x),
        )
    count_launch("row_sq_dists")
    return out


def row_sq_dists_plain(x: torch.Tensor, z=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`row_sq_dists`: the same lanes and
    the same order, each product and sum rounded once."""
    n, d = x.shape
    v = x.float() if z is None else x.float() - z.float()
    sq = v * v
    steps = _ceil_div(d, _ROW_LANES)
    sq = torch.nn.functional.pad(sq, (0, steps * _ROW_LANES - d)).view(n, steps, _ROW_LANES)
    acc = torch.zeros((n, _ROW_LANES), dtype=torch.float32, device=x.device)
    for k in range(steps):
        acc = acc + sq[:, k]
    acc = acc.view(n, _ROW_LANES // 32, 32)
    lanes = torch.zeros((n, 32), dtype=torch.float32, device=x.device)
    for t in range(acc.shape[1]):
        lanes = lanes + acc[:, t]
    idx = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ o]
    return canonical_nan(lanes[:, 0].contiguous())


__all__ = [
    "MAX_NETWORK_ROWS",
    "arc_selection_mean_stream",
    "use_kernel_for",
    "batcher_pairs",
    "canonical_nan",
    "center_loop",
    "center_loop_plain",
    "center_sq_dists_plain",
    "center_sweep",
    "center_sweep_plain",
    "center_weights",
    "center_weights_plain",
    "check_selection_args",
    "clip_selection_mean_stream",
    "clip_selection_weights",
    "clip_selection_weights_plain",
    "float_sort_keys",
    "fma_f32",
    "gram",
    "column_runs",
    "gram_chunks",
    "gram_plain",
    "gram_split_k_plain",
    "keys_to_float",
    "launch_counts",
    "meamed_stream",
    "meamed_stream_plain",
    "mix_rows",
    "mix_rows_plain",
    "network_width",
    "nnm_selection_mean_stream",
    "nnm_selection_weights",
    "nnm_selection_weights_plain",
    "nnm_stream",
    "nnm_weights",
    "nnm_weights_plain",
    "reset_launch_counts",
    "count_launch",
    "row_sq_dists",
    "row_sq_dists_plain",
    "segment_sum",
    "segment_sum_dequant",
    "segment_sum_dequant_plain",
    "segment_sum_plain",
    "segmented_sort_reduce",
    "segmented_sort_reduce_plain",
    "selection_mean_from_gram",
    "selection_mean_from_gram_plain",
    "selection_mean_stream",
    "selection_weights",
    "selection_weights_plain",
    "sort_columns",
    "sort_columns_plain",
    "sorted_reduce_stream",
    "sorted_reduce_stream_plain",
    "weighted_center_step",
    "weighted_center_step_plain",
    "weighted_rows",
    "weighted_rows_plain",
]
