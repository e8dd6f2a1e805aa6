"""Gradients <-> flat vectors and the stacked ``(n, d)`` matrix.

Counterpart of ``byzpy_tpu/utils/trees.py``. A gradient is a tensor or a
numpy array of any rank, or a nested structure of dictionaries, lists and
tuples whose leaves are tensors, numpy arrays or Python numbers (the JAX
package's pytrees). :func:`ravel_pytree` flattens one into a ``(d,)``
vector; :func:`stack_gradients` stacks a sequence of them into the matrix
the aggregators take.

The flat order inside a structure is the port's own: dictionaries in key
insertion order (the JAX package sorts keys), lists and tuples in order.
Tests compare structures leaf by leaf, or parameters after
``models.convert``, never flat vectors of a structure across the two
packages. :func:`ravel_fn` is the PS round's flattener for one parameter
dictionary.
"""

from __future__ import annotations

import numbers
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from .device import DeviceLike

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


# ---------------------------------------------------------------------------
# Nested structures
# ---------------------------------------------------------------------------


def _as_tensor(leaf: Any, device: DeviceLike) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf if device is None else leaf.to(device)
    if isinstance(leaf, (np.ndarray, np.generic, numbers.Number)):
        return torch.as_tensor(np.asarray(leaf), device=device)
    raise TypeError(f"unsupported gradient leaf of type {type(leaf).__name__}")


def _spec(tree: Any, leaves: List[Any]) -> Any:
    """The structure of ``tree`` (``None`` marks a leaf), collecting its
    leaves in flat order."""
    if isinstance(tree, dict):
        return (type(tree), tuple((k, _spec(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_spec(v, leaves) for v in tree))
    leaves.append(tree)
    return None


def _leaves_like(tree: Any, spec: Any, out: List[Any]) -> None:
    """``tree``'s leaves in the flat order of ``spec`` (another gradient's
    structure: dictionaries are read by its keys, whatever their order)."""
    if spec is None:
        out.append(tree)
        return
    kind, children = spec
    if issubclass(kind, dict):
        if not isinstance(tree, dict) or len(tree) != len(children):
            raise ValueError("all gradients must have the same structure")
        for k, sub in children:
            _leaves_like(tree[k], sub, out)
        return
    if not isinstance(tree, (list, tuple)) or len(tree) != len(children):
        raise ValueError("all gradients must have the same structure")
    for t, sub in zip(tree, children):
        _leaves_like(t, sub, out)


def _build(spec: Any, leaves) -> Any:
    if spec is None:
        return next(leaves)
    kind, children = spec
    if issubclass(kind, dict):
        return kind((k, _build(sub, leaves)) for k, sub in children)
    values = [_build(sub, leaves) for sub in children]
    if kind is list:
        return values
    return kind._make(values) if hasattr(kind, "_make") else kind(values)


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to each leaf, its structure kept (the
    one-tree ``jax.tree_util.tree_map``)."""
    leaves: List[Any] = []
    spec = _spec(tree, leaves)
    return _build(spec, iter([fn(leaf) for leaf in leaves]))


def _cat(leaves: List[torch.Tensor]) -> torch.Tensor:
    """The leaves raveled into one vector of their promoted dtype (one leaf
    of that dtype: a view where it can be)."""
    if not leaves:
        return torch.zeros((0,))
    dtype = leaves[0].dtype
    for t in leaves[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    if len(leaves) == 1:
        return leaves[0].reshape(-1).to(dtype)
    return torch.cat([t.reshape(-1).to(dtype) for t in leaves])


def ravel_pytree(
    tree: Any, *, device: DeviceLike = None
) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """``(flat, unravel)`` of one gradient: ``flat`` is its leaves raveled
    into a ``(d,)`` vector of their promoted dtype, on ``device`` (where
    they lie, when ``None``); ``unravel`` maps a ``(d,)`` vector back to the
    structure and leaf shapes of ``tree``. As with
    ``jax.flatten_util.ravel_pytree``, a structure of mixed dtypes casts
    each floating leaf back to its own dtype; a structure of one dtype
    keeps the vector's."""
    flat, unravel, _ = _ravel(tree, device)
    return flat, unravel


def _ravel(tree: Any, device: DeviceLike) -> Tuple[torch.Tensor, Callable, Any]:
    """:func:`ravel_pytree`'s ``(flat, unravel)`` and ``tree``'s structure."""
    raw: List[Any] = []
    spec = _spec(tree, raw)
    leaves = [_as_tensor(t, device) for t in raw]
    shapes = [tuple(t.shape) for t in leaves]
    dtypes = [t.dtype for t in leaves]
    sizes = [int(t.numel()) for t in leaves]
    mixed = len(set(dtypes)) > 1
    flat = _cat(leaves)
    total = sum(sizes)

    def unravel(vec: torch.Tensor) -> Any:
        if tuple(vec.shape) != (total,):
            raise ValueError(f"expected a flat vector of {total}, got {tuple(vec.shape)}")
        parts = []
        for p, shape, dt in zip(torch.split(vec, sizes), shapes, dtypes):
            p = p.reshape(shape)
            if mixed and dt.is_floating_point and dt != p.dtype:
                p = p.to(dt)
            parts.append(p)
        return _build(spec, iter(parts))

    return flat, unravel, spec


def stack_gradients(
    gradients: Any, *, device: DeviceLike = None
) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """Stack a sequence of gradients into an ``(n, d)`` matrix.

    Accepts a sequence of same-structure gradients (tensors or numpy arrays
    of any rank, nested dictionaries / lists / tuples of them), or an
    already stacked 2-D tensor or numpy array (returned as it is). Every
    input is moved to ``device`` (``None``: left where it is, numpy on the
    CPU). Returns ``(matrix, unravel)``, where ``unravel(row)`` maps a
    ``(d,)`` row back to the structure of one input gradient. Rows of
    mixed dtypes promote as ``torch.stack`` does; a matrix that is not
    floating becomes float32."""
    if isinstance(gradients, (torch.Tensor, np.ndarray)):
        arr = _as_tensor(gradients, device)
        if arr.ndim != 2:
            raise ValueError(
                f"stacked gradient array must be 2-D (n, d); got shape {tuple(arr.shape)}"
            )
        return arr, lambda row: row
    if len(gradients) == 0:
        raise ValueError("gradients must be a non-empty sequence")
    flat0, unravel, spec = _ravel(gradients[0], device)
    d = flat0.shape[0]
    rows = [flat0]
    for g in gradients[1:]:
        raw: List[Any] = []
        _leaves_like(g, spec, raw)
        flat = _cat([_as_tensor(t, device) for t in raw])
        if flat.shape[0] != d:
            raise ValueError(
                f"all gradients must flatten to the same length (got {flat.shape[0]} != {d})"
            )
        rows.append(flat)
    matrix = torch.stack(rows)
    if not matrix.is_floating_point():
        matrix = matrix.float()
    return matrix, unravel


def unstack_rows(matrix: torch.Tensor, unravel: Callable[[torch.Tensor], Any]) -> List[Any]:
    """Split an ``(n, d)`` matrix back into a list of per-node gradients."""
    return [unravel(matrix[i]) for i in range(matrix.shape[0])]


__all__ = ["Params", "map_leaves", "ravel_fn", "ravel_pytree", "stack_gradients", "unstack_rows"]
