"""SMEA: Smallest Maximum Eigenvalue Averaging.

Counterpart of ``byzpy_tpu/aggregators/geometric_wise/smea.py``
(behavioral parity: ``byzpy/aggregators/geometric_wise/smea.py:110-228``).
Two scoring paths, the same score, split as the JAX class splits them:

* **device** (combo spaces up to ``_DEVICE_COMBO_CAP`` and ``m <= 32``):
  the Gram (B3 on the card), every subset's top eigenvalue by batched
  parallel Jacobi (``ops.robust.subset_max_eigvals_jacobi``), the argmin
  and the winner's mean, all on the inputs' device with no host read;
* **host LAPACK** (larger spaces): stacked ``numpy.linalg.eigvalsh`` over
  the combo range on the host Gram, the JAX package's code.

On an actor pool the combo ranges fan out as the reference's do
(``create_subtasks`` / ``reduce_subtasks``): the Gram (B3 on the card) is
read to the host once and each subtask scores ``chunk_size`` subsets by
host LAPACK; the winner's mean is taken on the matrix's device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ...ops import robust
from ...utils.device import DeviceLike
from ...engine.graph.chunking import pool_size_from_context, select_adaptive_chunk_size
from ...engine.graph.operator import OpContext
from ...engine.graph.subtask import SubTask
from ...utils.trees import stack_gradients
from ..base import Aggregator, check_chunk_size
from .minimum_diameter_average import _combo_batches, _to_device

_DEVICE_BATCH = 2048
# the device path materializes the (n_combos, m, m) centered blocks:
# 32768 x 32 x 32 f32 = 134 MB, a comfortable cap
_DEVICE_COMBO_CAP = 32768
# the fixed-8-sweep Jacobi scorer is precision-validated for m <= 32;
# larger subsets take the exact host-LAPACK path
_DEVICE_JACOBI_MAX_M = 32


@functools.lru_cache(maxsize=32)
def _device_combos(n: int, m: int, device: torch.device) -> torch.Tensor:
    """Every m-combination of ``range(n)`` in lexicographic order, an int64
    ``(comb(n, m), m)`` tensor on ``device``, copied there once without a
    host synchronization."""
    parts = [np.asarray(c) for c in _combo_batches(n, m, _DEVICE_COMBO_CAP)]
    # _combo_batches pads its tail block by repeating the first combo;
    # slice back to the exact count
    return _to_device(np.concatenate(parts, axis=0)[: math.comb(n, m)], device)


def _smea_select_mean(x: torch.Tensor, combos: torch.Tensor) -> tuple:
    """Gram -> Jacobi subset scores -> argmin -> winner mean, all on
    ``x``'s device (ties: the first combo in enumeration order, like the
    host loop). Returns ``(mean, winner)``."""
    gram = robust.gram_matrix(x)
    scores = robust.subset_max_eigvals_jacobi(gram, combos)
    # index_select keeps the index on the device (no host read)
    winner = combos.index_select(0, robust.best_subset_by_score(scores).reshape(1))[0]
    return robust.subset_mean(x, winner), winner


def _score_combo_range_smea(
    host_gram: np.ndarray, n: int, m: int, start: int, count: int
) -> tuple[float, np.ndarray]:
    """Best (min top-eigenvalue) combo in [start, start+count), scored on
    the host by stacked LAPACK ``eigvalsh`` (the JAX package's code). A
    node whose gradient holds NaN/inf poisons its Gram row; LAPACK raises
    on non-finite input, so subsets holding such a node score +inf
    without entering the eigensolver."""
    h = np.eye(m) - np.full((m, m), 1.0 / m)
    batch = min(_DEVICE_BATCH, count)
    bad_row = ~np.isfinite(host_gram).all(axis=1)
    best_score, best_combo = np.inf, None
    for combos in _combo_batches(n, m, batch, start=start, count=count):
        sub = host_gram[combos[:, :, None], combos[:, None, :]]  # (c, m, m)
        centered = h @ sub @ h
        combo_bad = bad_row[combos].any(axis=1)
        if combo_bad.any():
            centered[combo_bad] = np.eye(m)
        top = np.linalg.eigvalsh(centered)[:, -1]
        scores = np.where(combo_bad, np.inf, np.maximum(top, 0.0) / m)
        i = int(np.argmin(scores))
        if best_combo is None or scores[i] < best_score:
            best_score, best_combo = float(scores[i]), combos[i]
    return best_score, np.asarray(best_combo)


class SMEA(Aggregator):
    """Smallest-Maximum-Eigenvalue Averaging: average the (n - f)-subset
    whose centered Gram has the smallest top eigenvalue (batched-Jacobi
    scoring on the inputs' device)."""

    name = "smea"
    supports_subtasks = True

    def __init__(self, f: int, *, chunk_size: int = 4096, device: DeviceLike = None) -> None:
        if f < 0:
            raise ValueError("f must be >= 0")
        self.f = int(f)
        self.chunk_size = check_chunk_size(chunk_size)
        super().__init__(device=device)
        #: the row indices the last aggregation averaged, on its device
        self.last_selection: Optional[torch.Tensor] = None

    def validate_n(self, n: int) -> None:
        if 2 * self.f >= n:
            raise ValueError(f"2f must be < n (got n={n}, f={self.f})")

    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        m = n - self.f
        if math.comb(n, m) <= _DEVICE_COMBO_CAP and m <= _DEVICE_JACOBI_MAX_M:
            mean, self.last_selection = _smea_select_mean(x, _device_combos(n, m, x.device))
            return mean
        gram = robust.gram_matrix(x)
        _, best_combo = _score_combo_range_smea(gram.cpu().numpy(), n, m, 0, math.comb(n, m))
        self.last_selection = _to_device(best_combo, x.device)
        return robust.subset_mean(x, self.last_selection)

    # -- pool path ----------------------------------------------------------

    def create_subtasks(self, inputs, *, context: OpContext):
        matrix, _ = stack_gradients(inputs.get(self.input_key), device=self.device)
        self.validate_n(matrix.shape[0])
        n = matrix.shape[0]
        m = n - self.f
        total = math.comb(n, m)
        host_gram = robust.gram_matrix(matrix).cpu().numpy()  # the one host read
        chunk = select_adaptive_chunk_size(
            total, self.chunk_size, pool_size=pool_size_from_context(context)
        )

        def gen():
            for start in range(0, total, chunk):
                count = min(chunk, total - start)
                yield SubTask(fn=_score_combo_range_smea, args=(host_gram, n, m, start, count),
                              name=f"smea-combos[{start}:{start + count}]")

        return gen()

    def reduce_subtasks(self, partials, inputs, *, context: OpContext):
        _, best_combo = min(partials, key=lambda p: p[0])
        matrix, unravel = stack_gradients(inputs.get(self.input_key), device=self.device)
        self.last_selection = _to_device(best_combo, matrix.device)
        return unravel(robust.subset_mean(matrix, self.last_selection))


__all__ = ["SMEA"]
