"""Device resolution and gradient-structure helpers."""

from .device import resolve_device
from .trees import ravel_fn, ravel_pytree, stack_gradients, unstack_rows

__all__ = ["resolve_device", "ravel_fn", "ravel_pytree", "stack_gradients", "unstack_rows"]
