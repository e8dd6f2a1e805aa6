"""Label-flip attack: the gradient of the loss on flipped labels.

Counterpart of ``byzpy_tpu/attacks/label_flip.py`` (behavioral parity:
``byzpy/attacks/label_flip.py:35-91``): labels map through an explicit
lookup table or the default ``num_classes - 1 - y``. ``model`` is a
:class:`byzpy_tpu_torch.models.ModelBundle` (a pure ``loss_fn`` and its
parameter dictionary); the gradient is ``torch.func.grad`` of the loss,
a dictionary like the parameters.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
from torch.func import grad

from ..ops import attack_ops
from ..utils.device import DeviceLike
from .base import Attack


class LabelFlipAttack(Attack):
    """Train on flipped labels and send the resulting (poisoned) gradient."""

    name = "label-flip"
    uses_model_batch = True

    def __init__(
        self,
        *,
        num_classes: Optional[int] = None,
        mapping: Optional[Sequence[int]] = None,
        device: DeviceLike = None,
    ) -> None:
        if num_classes is None and mapping is None:
            raise ValueError("LabelFlipAttack requires num_classes or mapping")
        super().__init__(device=device)
        self.num_classes = num_classes
        self.mapping = None if mapping is None else torch.as_tensor(mapping, device=self.device)

    def apply(self, *, model: Any = None, x: Any = None, y: Any = None,
              honest_grads: Optional[List[Any]] = None, base_grad: Any = None) -> Any:
        if model is None or x is None or y is None:
            raise ValueError("LabelFlipAttack requires model, x, and y")
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        return attack_ops.label_flip_grad(grad(model.loss_fn), model.params, x, y,
                                          num_classes=self.num_classes, mapping=self.mapping)


__all__ = ["LabelFlipAttack"]
