"""Device resolution and flat-parameter helpers."""

from .device import resolve_device
from .trees import ravel_fn, stack_gradients

__all__ = ["resolve_device", "ravel_fn", "stack_gradients"]
