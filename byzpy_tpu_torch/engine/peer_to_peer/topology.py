"""Directed communication topology of the gossip round.

The port's own copy of ``byzpy_tpu/engine/peer_to_peer/topology.py``
(pure numpy there too). The gossip step
(:mod:`byzpy_tpu_torch.parallel.gossip`) consumes
:meth:`Topology.in_neighbor_groups`: every node aggregates exactly its
in-neighbourhood, self included, grouped by in-degree.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np


@dataclass
class Topology:
    """Directed graph over integer node indices ``0..n-1``."""

    n_nodes: int
    edges: Set[Tuple[int, int]] = field(default_factory=set)

    def add_edge(self, src: int, dst: int) -> None:
        self._check(src)
        self._check(dst)
        if src != dst:
            self.edges.add((src, dst))

    def _check(self, i: int) -> None:
        if not 0 <= i < self.n_nodes:
            raise ValueError(f"node index {i} out of range [0, {self.n_nodes})")

    def out_neighbors(self, i: int) -> List[int]:
        self._check(i)
        return sorted(dst for src, dst in self.edges if src == i)

    def in_neighbors(self, i: int) -> List[int]:
        self._check(i)
        return sorted(src for src, dst in self.edges if dst == i)

    @classmethod
    def complete(cls, n: int) -> "Topology":
        t = cls(n)
        t.edges = {(i, j) for i in range(n) for j in range(n) if i != j}
        return t

    @classmethod
    def ring(cls, n: int, k: int = 1) -> "Topology":
        """Each node sends to its next ``k`` clockwise neighbors."""
        t = cls(n)
        for i in range(n):
            for step in range(1, k + 1):
                t.add_edge(i, (i + step) % n)
        return t

    @classmethod
    def from_edges(cls, n: int, edges: Iterable[Tuple[int, int]]) -> "Topology":
        t = cls(n)
        for s, d in edges:
            t.add_edge(s, d)
        return t

    def is_ring(self) -> Optional[int]:
        """Return ``k`` if this is exactly ``ring(n, k)``, else ``None``."""
        for k in range(1, self.n_nodes):
            if self.edges == Topology.ring(self.n_nodes, k).edges:
                return k
        return None

    def in_neighbor_lists(self, *, include_self: bool = True) -> List[List[int]]:
        """Per-node in-neighbor index lists (self prepended by default).

        With ``include_self=False`` every node must have at least one
        in-neighbor — there is no value that could pad an empty row without
        silently re-including the excluded self.
        """
        rows = []
        for i in range(self.n_nodes):
            nb = ([i] if include_self else []) + self.in_neighbors(i)
            if not nb:
                raise ValueError(
                    f"node {i} has no in-neighbors; with include_self=False "
                    "every node needs at least one"
                )
            rows.append(nb)
        return rows

    def in_neighbor_matrix(self, *, include_self: bool = True) -> np.ndarray:
        """``(n, k)`` int32 matrix of in-neighbor indices. Only valid for
        **regular** topologies (every node has the same in-degree); for
        irregular ones use :meth:`in_neighbor_groups`."""
        rows = self.in_neighbor_lists(include_self=include_self)
        degs = {len(nb) for nb in rows}
        if len(degs) > 1:
            raise ValueError(
                f"topology is irregular (in-degrees {sorted(degs)}); use "
                "in_neighbor_groups() instead of a padded matrix"
            )
        return np.asarray(rows, dtype=np.int32)

    def in_neighbor_groups(
        self, *, include_self: bool = True
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Group nodes by in-degree: list of ``(node_idx (g,), neighbors
        (g, k))`` int32 pairs, one per distinct in-degree ``k``, in
        ascending ``k`` (a regular topology yields exactly one group)."""
        rows = self.in_neighbor_lists(include_self=include_self)
        by_deg: Dict[int, List[int]] = {}
        for i, nb in enumerate(rows):
            by_deg.setdefault(len(nb), []).append(i)
        return [
            (
                np.asarray(idxs, dtype=np.int32),
                np.asarray([rows[i] for i in idxs], dtype=np.int32),
            )
            for _, idxs in sorted(by_deg.items())
        ]

    def in_mask(self, *, include_self: bool = True) -> np.ndarray:
        """``(n, n)`` float32 mask: ``m[i, j] = 1`` if node i receives from j."""
        m = np.zeros((self.n_nodes, self.n_nodes), dtype=np.float32)
        for src, dst in self.edges:
            m[dst, src] = 1.0
        if include_self:
            np.fill_diagonal(m, 1.0)
        return m


__all__ = ["Topology"]
