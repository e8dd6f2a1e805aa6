"""The process-wide default device mesh.

Counterpart of ``byzpy_tpu/configs/mesh.py``: the mesh that sharded
aggregation, the collectives and the SPMD training step use when none is
passed. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
(``parallel.mesh``); each SPMD process keeps its own default.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

_default_mesh = None


def set_default_mesh(mesh) -> None:
    """Set (or clear, with ``None``) the process-wide default mesh."""
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh(*, create: bool = False):
    """The configured default mesh. With ``create=True`` and nothing
    configured, builds a 1-D ``nodes`` mesh over every rank of the
    initialized process group (on the card)."""
    if _default_mesh is not None:
        return _default_mesh
    if create:
        from ..parallel.mesh import node_mesh

        return node_mesh()
    return None


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Temporarily set the default mesh."""
    global _default_mesh
    previous = _default_mesh
    _default_mesh = mesh
    try:
        yield mesh
    finally:
        _default_mesh = previous


__all__ = ["set_default_mesh", "get_default_mesh", "use_mesh"]
