"""Device resolution and gradient-structure helpers (``utils.cuda_graph``,
the compiled steps' CUDA-graph capture, is imported on its own)."""

from .device import resolve_device
from .trees import ravel_fn, ravel_pytree, ravel_pytree_fn, stack_gradients, tree_size, unstack_rows

__all__ = [
    "resolve_device",
    "ravel_fn",
    "ravel_pytree",
    "ravel_pytree_fn",
    "stack_gradients",
    "tree_size",
    "unstack_rows",
]
