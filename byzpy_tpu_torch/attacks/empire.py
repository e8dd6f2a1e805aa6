"""Empire attack: ``scale * mean(honest_grads)``, default scale -1.

Counterpart of ``byzpy_tpu/attacks/empire.py`` (behavioral parity:
``byzpy/attacks/empire.py:23-187``). The pool fan-out mixin comes with the
actor pools (ROADMAP A.4)."""

from __future__ import annotations

from typing import Any, List, Optional

from ..ops import attack_ops
from ..utils.device import DeviceLike
from .base import Attack


class EmpireAttack(Attack):
    """Send ``scale * mean(honest)`` — inner-product manipulation of the
    average."""

    name = "empire"
    uses_honest_grads = True

    def __init__(self, *, scale: float = -1.0, device: DeviceLike = None) -> None:
        self.scale = float(scale)
        super().__init__(device=device)

    def apply(self, *, model=None, x=None, y=None,
              honest_grads: Optional[List[Any]] = None, base_grad: Any = None) -> Any:
        if not honest_grads:
            raise ValueError("EmpireAttack requires honest_grads")
        matrix, unravel = self._stack_honest(honest_grads)
        return unravel(attack_ops.empire(matrix, scale=self.scale))


__all__ = ["EmpireAttack"]
