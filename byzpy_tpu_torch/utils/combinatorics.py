"""Lexicographic combination unranking.

Counterpart of ``byzpy_tpu/utils/combinatorics.py``: plain Python, the
same code. MDA/SMEA fan combination ranges out to pool workers; each
worker must start enumerating at its range's first combination in
O(n*m) instead of skipping ``start`` tuples with ``islice`` (which would
make total enumeration cost quadratic in the number of subsets).
"""

from __future__ import annotations

from math import comb
from typing import Iterator, Tuple


def unrank_combination(n: int, m: int, rank: int) -> Tuple[int, ...]:
    """The ``rank``-th (0-based) m-combination of ``range(n)`` in
    lexicographic order."""
    total = comb(n, m)
    if not 0 <= rank < total:
        raise ValueError(f"rank must be in [0, {total}) (got {rank})")
    combo = []
    e = 0
    for i in range(m):
        # combos beginning with element e number comb(n-1-e, m-1-i)
        while comb(n - 1 - e, m - 1 - i) <= rank:
            rank -= comb(n - 1 - e, m - 1 - i)
            e += 1
        combo.append(e)
        e += 1
    return tuple(combo)


def iter_combinations(n: int, m: int, start: int = 0) -> Iterator[Tuple[int, ...]]:
    """Lexicographic m-combinations of ``range(n)`` starting at rank
    ``start`` (equivalent to ``islice(combinations(range(n), m), start, None)``
    but O(n*m) to position)."""
    if m == 0:
        if start == 0:
            yield ()
        return
    if start >= comb(n, m):
        return
    c = list(unrank_combination(n, m, start))
    while True:
        yield tuple(c)
        i = m - 1
        while i >= 0 and c[i] == n - m + i:
            i -= 1
        if i < 0:
            return
        c[i] += 1
        for j in range(i + 1, m):
            c[j] = c[j - 1] + 1


__all__ = ["unrank_combination", "iter_combinations"]
