"""Ragged multi-cohort aggregation: one program, any cohort mix.

Counterpart of ``byzpy_tpu/ops/ragged.py``. Every function here reads a
batch of cohorts in the **flat-rows layout**:

* ``flat``: ``(R, d)`` float32, cohort ``c``'s rows in the contiguous
  block ``[offsets[c], offsets[c] + lengths[c])`` in admission order, the
  remaining rows zero. ``R`` is the batch's row capacity.
* ``seg``: ``(R,)`` int32, each row's cohort index, ``C`` (one past the
  last cohort) for capacity rows.
* ``offsets`` / ``lengths``: ``(C,)`` int32 on the device. A batch with
  fewer cohorts than ``C`` (``n_cohorts``) pads with ``lengths = 0``
  entries, whose outputs are garbage and are discarded by the caller.

Contract (the masked family's, extended): each cohort's aggregate is bit
for bit the masked aggregate of that cohort alone, and so the unpadded
aggregate, for any batch composition, on finite rows. Nothing is read on
the host: cohort sizes, windows and gathers stay on the device.

* Every row contraction (the reference's ``einsum("n,nd->d")``, or its
  ``segment_sum=`` kernel) is a ``(C, R)`` weight matrix times the rows,
  by ``segment_sum`` (default: B11, ``kernels.segment_sum``, one FMA
  chain per output over rows in index order): a caller may pass B11 with
  a fill, or B12 for the rows that are still wire codes.
* Every per-row sum over ``d`` (CGE's norms, the evidence norms) is
  ``kernels.row_sq_dists``, whose order depends on ``d`` alone.
* The segmented programs (:func:`ragged_trimmed_mean`,
  :func:`ragged_median`) are one ``kernels.segmented_sort_reduce``: one
  launch sorts each cohort's own rows and reduces them, where the
  reference makes one two-key ``lax.sort`` (no Pallas kernel) and a
  windowed contraction. The classes route to them on the card and take the
  generic masked door on the CPU, the reference's ``_on_tpu()`` split.
  :func:`segmented_sort` (one ``torch.sort`` over an int64 key ``seg << 32
  | (key + 2**31)``, ``key`` the int32 total-order key of
  ``kernels.float_sort_keys``: exact) is the counterpart of that
  ``lax.sort`` and the kernel's plain version's sort.

The reference's ``flat_dequantize`` is ``parallel.quantization.dequantize_rows``
here (B14, or B17 for s4, on the card), which the quantized door calls
as its first operation.

The reference's Pallas gate (``BYZPY_TPU_RAGGED_PALLAS``) has no
counterpart: the contractions always run on the port's kernels.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import kernels
from .robust import _masked_recip, _masked_rows_at, _sq_dists_from_gram, gram_matrix

#: eps matching the forensics plane's cosine denominator floor
_EVIDENCE_EPS = 1e-12

SegmentSum = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _segment_sum(segment_sum: Optional[SegmentSum]) -> SegmentSum:
    return segment_sum if segment_sum is not None else kernels.segment_sum


def _cohort_of(seg: torch.Tensor, n_cohorts: int) -> torch.Tensor:
    """Each row's cohort as an index, capacity rows at ``n_cohorts``."""
    return torch.clamp(seg, max=n_cohorts).long()


def segment_ids(offsets: torch.Tensor, lengths: torch.Tensor, n_rows: int,
                n_cohorts: int) -> torch.Tensor:
    """Per-row segment ids on the device from ``offsets`` / ``lengths``:
    ``seg[r] = c`` inside cohort ``c``'s block, ``n_cohorts`` for capacity
    rows."""
    pos = torch.arange(n_rows, device=offsets.device)
    seg = torch.full((n_rows,), n_cohorts, dtype=torch.int32, device=offsets.device)
    for c in range(n_cohorts):
        inside = (pos >= offsets[c]) & (pos < offsets[c] + lengths[c])
        seg = torch.where(inside, torch.full_like(seg, c), seg)
    return seg


def segmented_sort(flat: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Every cohort's columns sorted in one pass: a sort along the rows of
    the int64 key ``seg << 32 | (key + 2**31)`` keeps each segment's block
    contiguous with its values in the order :func:`robust.sort_rows` gives
    the compacted cohort (the same int32 key: NaN canonical, -0.0 before
    +0.0); capacity rows sort after every cohort. f32 only."""
    keys = kernels.float_sort_keys(flat).to(torch.int64) + (1 << 31)
    sorted_keys = torch.sort((seg.to(torch.int64)[:, None] << 32) | keys, dim=0).values
    return kernels.keys_to_float(((sorted_keys & 0xFFFFFFFF) - (1 << 31)).to(torch.int32))


def _segment_positions(seg: torch.Tensor, offsets: torch.Tensor, n_cohorts: int) -> torch.Tensor:
    """Each row's position within its segment block (garbage for capacity
    rows: mask by ``seg`` before use)."""
    pos = torch.arange(seg.shape[0], device=seg.device)
    off = torch.cat([offsets, offsets.new_zeros(1)])
    return pos - off[_cohort_of(seg, n_cohorts)]


def ragged_trimmed_mean(
    flat: torch.Tensor,
    seg: torch.Tensor,
    offsets: torch.Tensor,
    lengths: torch.Tensor,
    *,
    f: int,
    n_cohorts: int,
    segment_sum: Optional[SegmentSum] = None,
    long_slots: bool = False,
) -> torch.Tensor:
    """f-trimmed coordinate mean of every cohort (callers guarantee ``2f <
    m_c``): each cohort's columns sorted, the sorted window ``[f, m_c - f)``
    added in ascending order from +0.0 (the reference's zero-masked window
    contraction) times the rounded reciprocal of ``m_c - 2f``, in one
    ``kernels.segmented_sort_reduce``. With ``long_slots`` (some cohort has
    more than ``kernels.MAX_NETWORK_ROWS`` rows, which the kernel's network
    cannot hold) the reference's own program instead: :func:`segmented_sort`
    and the windowed contraction, by B11. ``segment_sum`` is accepted for
    the ragged program's signature and not read: a sorted operand is no
    wire row. Returns ``(n_cohorts, d)``: ``offsets`` and ``lengths`` hold
    ``n_cohorts`` slots."""
    if long_slots:
        s = segmented_sort(flat, seg)
        rel = _segment_positions(seg, offsets, n_cohorts)
        windows = torch.stack([((seg == c) & (rel >= f) & (rel < lengths[c] - f)).to(torch.float32)
                               for c in range(n_cohorts)])
        recips = _masked_recip(lengths - 2 * f, torch.float32)
        return kernels.segment_sum(s, windows) * recips[:, None]
    return kernels.segmented_sort_reduce(flat, offsets, lengths, mode="trimmed", f=f)


def ragged_median(
    flat: torch.Tensor,
    seg: torch.Tensor,
    offsets: torch.Tensor,
    lengths: torch.Tensor,
    *,
    n_cohorts: int,
    long_slots: bool = False,
) -> torch.Tensor:
    """Coordinate-wise median of every cohort (finite rows): the middle
    value of each cohort's sorted column, or the midpoint ``(a + b) * 0.5``
    of the two middle ones as ``masked_coordinate_median``, in one
    ``kernels.segmented_sort_reduce`` (``seg`` is not read). With
    ``long_slots``, the reference's program: :func:`segmented_sort` and
    the two middle rows gathered at each cohort's device offsets."""
    if long_slots:
        s = segmented_sort(flat, seg)
        outs = []
        for c in range(n_cohorts):
            m = lengths[c]
            lo = torch.div(m - 1, 2, rounding_mode="floor")
            hi = torch.div(m, 2, rounding_mode="floor")
            s_lo = _masked_rows_at(s, offsets[c] + lo)
            s_hi = _masked_rows_at(s, offsets[c] + hi)
            outs.append(torch.where(lo == hi, s_lo, (s_lo + s_hi) * 0.5))
        return torch.stack(outs)
    return kernels.segmented_sort_reduce(flat, offsets, lengths, mode="median")


def ragged_segment_ranks(scores: torch.Tensor, seg: torch.Tensor, n_cohorts: int) -> torch.Tensor:
    """Each row's selection rank within its own cohort under the order
    every selection shares (ascending score, -0.0 tying +0.0, NaN last,
    ties by row index): stable sorts by score, then NaN, then segment,
    and each row's position less its segment's start. Cohort rows sit in
    admission order, so a row's rank is its rank in the compacted cohort.
    Capacity rows rank ``R`` and are never selected."""
    n = scores.shape[0]
    isnan = torch.isnan(scores)
    s = torch.where(isnan, torch.zeros_like(scores), scores)
    s = torch.where(s == 0, torch.zeros_like(s), s)
    order = torch.argsort(s, stable=True)
    order = order[torch.argsort(isnan[order].to(torch.int8), stable=True)]
    order = order[torch.argsort(seg[order], stable=True)]
    pos = torch.empty(n, dtype=torch.int64, device=scores.device)
    pos[order] = torch.arange(n, device=scores.device)
    cohorts = torch.arange(n_cohorts + 1, device=seg.device)
    counts = (seg[None, :] == cohorts[:, None]).sum(dim=1)
    start = torch.cumsum(counts, dim=0) - counts
    ranks = pos - start[_cohort_of(seg, n_cohorts)]
    return torch.where(seg < n_cohorts, ranks, torch.full_like(ranks, n))


def ragged_selection_mean(
    flat: torch.Tensor,
    seg: torch.Tensor,
    scores: torch.Tensor,
    keep_counts: torch.Tensor,
    *,
    n_cohorts: int,
    segment_sum: Optional[SegmentSum] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of each cohort's ``keep_counts[c]`` lowest-score rows: weight
    ``1 / keep_counts[c]``, rounded once in f32, on each kept row of
    cohort ``c``, one row contraction of ``flat`` (the reference's
    ``segment_sum=`` branch; on finite rows its masked branch gives the
    same bits). Returns ``((C, d) means, (R,) keep mask)``."""
    ranks = ragged_segment_ranks(scores, seg, n_cohorts)
    q_of = torch.cat([keep_counts, keep_counts.new_ones(1)])
    keep = (ranks < q_of[_cohort_of(seg, n_cohorts)]) & (seg < n_cohorts)
    zero = torch.zeros((), dtype=torch.float32, device=flat.device)
    w_rows = torch.stack([
        torch.where(keep & (seg == c), _masked_recip(keep_counts[c], torch.float32), zero)
        for c in range(n_cohorts)
    ])
    return _segment_sum(segment_sum)(flat, w_rows), keep


def ragged_cge(
    flat: torch.Tensor,
    seg: torch.Tensor,
    lengths: torch.Tensor,
    *,
    f: int,
    n_cohorts: int,
    segment_sum: Optional[SegmentSum] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CGE over every cohort: one squared-norm pass (``row_sq_dists``)
    scores every row, and each cohort keeps its ``lengths[c] - f``
    smallest. Returns ``(aggregates, L2-norm scores, keep)``, the scores
    and keep set the fused forensics view."""
    norms = kernels.row_sq_dists(flat.contiguous())
    inf = torch.full((), float("inf"), dtype=norms.dtype, device=norms.device)
    scores = torch.where(seg < n_cohorts, norms, inf)
    aggs, keep = ragged_selection_mean(flat, seg, scores, lengths - f, n_cohorts=n_cohorts,
                                       segment_sum=segment_sum)
    return aggs, torch.sqrt(scores), keep


def ragged_krum_scores(
    flat: torch.Tensor, seg: torch.Tensor, lengths: torch.Tensor, *, f: int, n_cohorts: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Krum scores of every cohort's rows from one shared Gram (B3, whose
    entries do not depend on the other rows): cross-cohort and capacity
    columns go to ``+inf`` before the row sort, and each row's ``m_c - f -
    1`` nearest squared distances are summed through a positional window
    by one row contraction over the sorted positions (B11), as
    ``masked_krum_scores_from_gram``. Returns ``(scores, any_bad)``, the
    latter a device bool: some cohort row has a non-finite norm."""
    R = flat.shape[0]
    gram = gram_matrix(flat)
    norms = torch.diagonal(gram)
    inf = torch.full((), float("inf"), dtype=gram.dtype, device=gram.device)
    coseg = (seg[None, :] == seg[:, None]) & (seg[None, :] < n_cohorts)
    d2 = torch.where(coseg, _sq_dists_from_gram(gram), inf)
    row_sorted = torch.sort(d2, dim=1).values
    m_of = torch.cat([lengths, lengths.new_zeros(1)])
    m_row = m_of[_cohort_of(seg, n_cohorts)]
    pos = torch.arange(R, device=flat.device)[None, :]
    window = (pos >= 1) & (pos < (m_row[:, None] - f))
    kept = torch.where(window, row_sorted, torch.zeros((), dtype=d2.dtype, device=d2.device))
    scores = kernels.segment_sum(kept.T.contiguous(), torch.ones((1, R), device=flat.device))[0]
    scores = torch.where(seg < n_cohorts, scores, inf)
    diag_ok = torch.where(seg < n_cohorts, torch.isfinite(norms), torch.ones_like(norms, dtype=torch.bool))
    return scores, ~torch.all(diag_ok)


def ragged_multi_krum(
    flat: torch.Tensor,
    seg: torch.Tensor,
    lengths: torch.Tensor,
    *,
    f: int,
    q: int,
    n_cohorts: int,
    segment_sum: Optional[SegmentSum] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-Krum over every cohort (shared Gram, one selection pass; callers
    guarantee ``f < m_c - 1`` and ``q <= m_c - f``). Returns
    ``(aggregates, Krum scores, keep)``."""
    scores, _ = ragged_krum_scores(flat, seg, lengths, f=f, n_cohorts=n_cohorts)
    aggs, keep = ragged_selection_mean(flat, seg, scores, torch.full_like(lengths, q),
                                       n_cohorts=n_cohorts, segment_sum=segment_sum)
    return aggs, scores, keep


def ragged_via_masked(
    masked_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    flat: torch.Tensor,
    seg: torch.Tensor,
    *,
    n_cohorts: int,
) -> torch.Tensor:
    """The generic ragged door for any aggregator with a masked program:
    ``masked_fn(flat, seg == c)`` per cohort. The masked contract holds at
    any padded shape, so each cohort's result is its unpadded aggregate;
    nothing is shared between cohorts."""
    return torch.stack([masked_fn(flat, seg == c) for c in range(n_cohorts)])


def ragged_evidence(
    flat: torch.Tensor, seg: torch.Tensor, aggregates: torch.Tensor, *, n_cohorts: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row forensics features: the L2 norm (``row_sq_dists``) and the
    cosine to the row's own cohort aggregate, ``(R,)`` each, 0 for
    capacity rows."""
    norm = torch.sqrt(kernels.row_sq_dists(flat.contiguous()))
    agg_pad = torch.cat([aggregates, aggregates.new_zeros((1, flat.shape[1]))])
    agg_rows = agg_pad[_cohort_of(seg, n_cohorts)]
    agg_norm = torch.sqrt(kernels.row_sq_dists(agg_rows.contiguous()))
    dot = torch.sum(flat * agg_rows.to(flat.dtype), dim=1)
    cos = dot / (norm * agg_norm + _EVIDENCE_EPS)
    live = seg < n_cohorts
    zero = torch.zeros((), dtype=norm.dtype, device=norm.device)
    return torch.where(live, norm, zero), torch.where(live, cos, zero)


__all__ = [
    "ragged_cge",
    "ragged_evidence",
    "ragged_krum_scores",
    "ragged_median",
    "ragged_multi_krum",
    "ragged_segment_ranks",
    "ragged_selection_mean",
    "ragged_trimmed_mean",
    "ragged_via_masked",
    "segment_ids",
    "segmented_sort",
]
