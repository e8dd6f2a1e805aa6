"""Empire attack: ``scale * mean(honest_grads)``, default scale -1.

Counterpart of ``byzpy_tpu/attacks/empire.py`` (behavioral parity:
``byzpy/attacks/empire.py:23-187``). On an actor pool it fans out column spans
(``attacks/chunked.py``)."""

from __future__ import annotations

from typing import Any, List, Optional

from ..ops import attack_ops
from ..utils.device import DeviceLike
from .base import Attack
from .chunked import FeatureChunkedAttack, _empire_chunk


class EmpireAttack(FeatureChunkedAttack, Attack):
    """Send ``scale * mean(honest)`` — inner-product manipulation of the
    average."""

    name = "empire"
    uses_honest_grads = True
    _chunk_fn = staticmethod(_empire_chunk)

    def __init__(self, *, scale: float = -1.0, device: DeviceLike = None) -> None:
        self.scale = float(scale)
        super().__init__(device=device)

    def _chunk_params(self, host):
        return {"scale": self.scale}

    def apply(self, *, model=None, x=None, y=None,
              honest_grads: Optional[List[Any]] = None, base_grad: Any = None) -> Any:
        if not honest_grads:
            raise ValueError("EmpireAttack requires honest_grads")
        matrix, unravel = self._stack_honest(honest_grads)
        return unravel(attack_ops.empire(matrix, scale=self.scale))


__all__ = ["EmpireAttack"]
