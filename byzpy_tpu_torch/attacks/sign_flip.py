"""Sign-flip attack: ``scale * base_grad``, default scale -1.

Counterpart of ``byzpy_tpu/attacks/sign_flip.py`` (behavioral parity:
``byzpy/attacks/sign_flip.py:22-145``). On an actor pool it fans out
column spans of the base gradient (``attacks/chunked.py``)."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from ..ops import attack_ops
from ..utils.device import DeviceLike
from ..utils.trees import map_leaves
from .base import Attack
from .chunked import BaseGradChunkedAttack, _sign_flip_chunk


class SignFlipAttack(BaseGradChunkedAttack, Attack):
    """Send ``scale * base_grad`` — the scaled-negated true gradient."""

    name = "sign-flip"
    uses_base_grad = True
    _chunk_fn = staticmethod(_sign_flip_chunk)

    def __init__(self, *, scale: float = -1.0, device: DeviceLike = None) -> None:
        self.scale = float(scale)
        super().__init__(device=device)

    def _chunk_params(self, host):
        return {"scale": self.scale}

    def apply(self, *, model=None, x=None, y=None,
              honest_grads: Optional[List[Any]] = None, base_grad: Any = None) -> Any:
        if base_grad is None:
            raise ValueError("SignFlipAttack requires base_grad")
        return map_leaves(
            lambda leaf: attack_ops.sign_flip(torch.as_tensor(leaf, device=self.device),
                                              scale=self.scale),
            base_grad,
        )


__all__ = ["SignFlipAttack"]
