"""'A Little Is Enough' attack (Baruch et al. 2019).

Counterpart of ``byzpy_tpu/attacks/little.py`` (behavioral parity:
``byzpy/attacks/little.py:81-150``): ``mu + z_max * sigma`` with ``s =
floor(N/2) + 1 - f``, ``z_max = ndtri((N - s) / N)``. ``N`` defaults to
``len(honest_grads) + f`` as in the reference. On an actor pool it fans out column spans
(``attacks/chunked.py``)."""

from __future__ import annotations

from typing import Any, List, Optional

from ..ops import attack_ops
from ..utils.device import DeviceLike
from .base import Attack
from .chunked import FeatureChunkedAttack, _little_chunk


class LittleAttack(FeatureChunkedAttack, Attack):
    """'A Little Is Enough': shift the mean by z_max standard deviations
    per coordinate, staying inside the honest spread."""

    name = "little"
    uses_honest_grads = True
    _chunk_fn = staticmethod(_little_chunk)

    def __init__(self, f: int, N: Optional[int] = None, *, device: DeviceLike = None) -> None:
        if f < 0:
            raise ValueError("f must be >= 0")
        self.f = int(f)
        self.N = None if N is None else int(N)
        super().__init__(device=device)

    def _chunk_params(self, host):
        return {"f": self.f, "n_total": self._resolve_total(host.shape[0])}

    def _resolve_total(self, n_honest: int) -> int:
        """``N`` defaults to honest count + f (ref little.py:81-139); one
        resolver serves the direct and the pooled path."""
        total = self.N if self.N is not None else n_honest + self.f
        if total < self.f:
            raise ValueError(f"N must be >= f (got N={total}, f={self.f})")
        return total

    def apply(self, *, model=None, x=None, y=None,
              honest_grads: Optional[List[Any]] = None, base_grad: Any = None) -> Any:
        if not honest_grads:
            raise ValueError("LittleAttack requires honest_grads")
        matrix, unravel = self._stack_honest(honest_grads)
        total = self._resolve_total(matrix.shape[0])
        return unravel(attack_ops.little(matrix, f=self.f, n_total=total))


__all__ = ["LittleAttack"]
