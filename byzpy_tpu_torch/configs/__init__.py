"""Process-wide settings (counterpart of ``byzpy_tpu/configs``): the
default actor backend and the default device mesh."""

from .actor import get_actor, set_actor, use_actor
from .mesh import get_default_mesh, set_default_mesh, use_mesh

__all__ = [
    "get_actor",
    "set_actor",
    "use_actor",
    "get_default_mesh",
    "set_default_mesh",
    "use_mesh",
]
