"""Host-side shared-memory store (counterpart of ``byzpy_tpu/engine/storage``)."""

from .native_store import (
    SharedTensorHandle,
    available,
    cleanup_tensor,
    close_tensor,
    open_tensor,
    register_tensor,
)

__all__ = [
    "SharedTensorHandle",
    "available",
    "cleanup_tensor",
    "close_tensor",
    "open_tensor",
    "register_tensor",
]
