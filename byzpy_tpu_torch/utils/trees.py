"""Flat vectors <-> parameter dictionaries.

Counterpart of ``byzpy_tpu/utils/trees.py``. Where the JAX package ravels
a parameter pytree, the port ravels a parameter dictionary (name ->
tensor, in the module's ``named_parameters`` order) into one flat ``(d,)``
vector. The flat order is the port's own: tests compare parameters after
``models.convert``, never flat vectors across the two packages.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]


def ravel_fn(
    example: Params,
) -> Tuple[Callable[[Params], torch.Tensor], Callable[[torch.Tensor], Params]]:
    """``(ravel, unravel)`` for dictionaries shaped like ``example``.

    ``ravel`` concatenates the flattened tensors in ``example``'s key
    order; ``unravel`` splits a ``(d,)`` vector back into views shaped
    like ``example``'s tensors."""
    names = list(example)
    shapes = [tuple(example[k].shape) for k in names]
    sizes = [int(example[k].numel()) for k in names]

    def ravel(params: Params) -> torch.Tensor:
        return torch.cat([params[k].reshape(-1) for k in names])

    def unravel(flat: torch.Tensor) -> Params:
        if flat.shape != (sum(sizes),):
            raise ValueError(f"expected a flat vector of {sum(sizes)}, got {tuple(flat.shape)}")
        parts = torch.split(flat, sizes)
        return {k: p.view(s) for k, p, s in zip(names, parts, shapes)}

    return ravel, unravel


def stack_gradients(
    gradients: Union[Sequence[Params], torch.Tensor],
) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Params]]:
    """Stack per-node gradient dictionaries into an ``(n, d)`` matrix.

    Accepts a sequence of same-structure dictionaries, or an already
    stacked 2-D tensor (returned unchanged). Returns ``(matrix,
    unravel)``, where ``unravel(row)`` maps a ``(d,)`` row back to one
    gradient dictionary."""
    if isinstance(gradients, torch.Tensor):
        if gradients.ndim != 2:
            raise ValueError(
                f"stacked gradient array must be 2-D (n, d); got shape {tuple(gradients.shape)}"
            )
        return gradients, lambda row: row
    if len(gradients) == 0:
        raise ValueError("gradients must be a non-empty sequence")
    ravel, unravel = ravel_fn(gradients[0])
    rows: List[torch.Tensor] = [ravel(g) for g in gradients]
    d = rows[0].shape[0]
    for r in rows[1:]:
        if r.shape[0] != d:
            raise ValueError(
                f"all gradients must flatten to the same length (got {r.shape[0]} != {d})"
            )
    matrix = torch.stack(rows)
    if not matrix.is_floating_point():
        matrix = matrix.float()
    return matrix, unravel


__all__ = ["Params", "ravel_fn", "stack_gradients"]
