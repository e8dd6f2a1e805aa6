"""Process-wide settings (counterpart of ``byzpy_tpu/configs``): so far
the default actor backend."""

from .actor import get_actor, set_actor, use_actor

__all__ = ["get_actor", "set_actor", "use_actor"]
