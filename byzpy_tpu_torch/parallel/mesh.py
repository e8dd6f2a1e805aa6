"""Device-mesh construction over ``torch.distributed``.

Counterpart of ``byzpy_tpu/parallel/mesh.py``, with its axis names:

* ``"nodes"``: the Byzantine-training node axis; per-node gradients shard
  over it and the robust aggregation reduces across it;
* ``"feat"``: the flattened parameter axis; the coordinate-wise
  aggregators run on a rank's local columns;
* ``"data"``: batch parallelism inside a node.

The port's program is SPMD: one process a device (``torchrun`` or
``torch.multiprocessing.spawn``), NCCL between cards and gloo on the CPU.
A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
ranks of the initialized process group (the JAX package's mesh is over
the devices one controller sees); its dimension names are the axis names,
and :meth:`DeviceMesh.get_group` gives the process group a collective of
``parallel.collectives`` runs on. :func:`sharding` and :func:`replicated`
give the counterparts of ``NamedSharding(mesh, PartitionSpec(...))``: the
spec and, for each mesh dimension, its DTensor placement (``Shard(i)`` or
``Replicate()``).

The mesh runs on the card unless ``device="cpu"`` is given (a gloo group
on the CPU, as the tests run it).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..utils.device import DeviceLike, resolve_device

AXIS_NAMES = ("nodes", "feat", "data")

SpecEntry = Union[str, None, Tuple[str, ...]]


def init_process_group(
    address: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> bool:
    """Join the SPMD program's process group: the counterpart of the JAX
    package's ``initialize_multihost``. With neither ``address`` nor
    ``world_size`` there is nothing to coordinate and it returns ``False``;
    it returns ``False`` too when a group is already initialized. Nothing
    tells a process of its cluster: pass ``address`` (``"tcp://host:port"``,
    ``"file:///path"``, or ``"env://"`` under ``torchrun``), ``world_size``
    and ``rank``. ``backend`` defaults to NCCL where a card is present and gloo
    otherwise."""
    if address is None and world_size is None:
        return False
    if dist.is_initialized():
        return False
    if address is None or world_size is None or rank is None:
        raise ValueError("init_process_group needs address, world_size and rank together")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=address, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _device_type(device: DeviceLike) -> str:
    return resolve_device(device).type


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("nodes",),
    *,
    device: DeviceLike = None,
) -> DeviceMesh:
    """A mesh over the process group's ranks. With ``axis_sizes=None``
    every rank goes to the first axis; a size of -1 means "whatever is
    left" (at most one -1, as in numpy). The mesh may cover the first
    ranks only; every rank of the group must call this."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.mesh.init_process_group(address, world_size, rank) "
            "(or torch.distributed.init_process_group) in every rank first")
    world = dist.get_world_size()
    names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = [world] + [1] * (len(names) - 1)
    sizes = list(axis_sizes)
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} axis sizes for {len(names)} axis names")
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        if world % known:
            raise ValueError(f"cannot infer -1 axis: {world} ranks not divisible by {known}")
        sizes[sizes.index(-1)] = world // known
    total = 1
    for s in sizes:
        total *= s
    if total > world:
        raise ValueError(f"mesh wants {total} ranks but the process group has {world}")
    ranks = torch.arange(total, dtype=torch.int64).reshape(sizes)
    return DeviceMesh(_device_type(device), ranks, mesh_dim_names=names)


def node_mesh(n_nodes: Optional[int] = None, *, device: DeviceLike = None) -> DeviceMesh:
    """1-D mesh over the ``nodes`` axis (one rank a training node, or a
    block of nodes a rank)."""
    n = n_nodes or dist.get_world_size()
    return make_mesh([n], ("nodes",), device=device)


def feature_mesh(n_shards: Optional[int] = None, *, device: DeviceLike = None) -> DeviceMesh:
    """1-D mesh over the ``feat`` axis for coordinate-sharded aggregation."""
    n = n_shards or dist.get_world_size()
    return make_mesh([n], ("feat",), device=device)


def grid_mesh(n_nodes: int, data_per_node: int = 1, *, device: DeviceLike = None) -> DeviceMesh:
    """2-D ``(nodes, data)`` mesh: the nodes axis times batch parallelism
    inside a node."""
    return make_mesh([n_nodes, data_per_node], ("nodes", "data"), device=device)


def node_axis(mesh: DeviceMesh) -> str:
    """The mesh axis training nodes shard over: ``"nodes"`` when present,
    else the first axis."""
    names = mesh.mesh_dim_names
    return "nodes" if "nodes" in names else names[0]


def axis_key(axis_name: SpecEntry) -> Union[str, Tuple[str, ...]]:
    """An axis name as the collectives key it: a name, or a tuple of two or
    more names (a tuple of one is its name)."""
    if isinstance(axis_name, tuple):
        if not axis_name:
            raise ValueError("an axis tuple names at least one mesh axis")
        return axis_name[0] if len(axis_name) == 1 else tuple(axis_name)
    return axis_name


def axis_group(mesh: DeviceMesh, axis_name: SpecEntry):
    """The process group of a mesh axis, or of several axes at once: a
    tuple such as ``("nodes", "data")`` is the group of their product, the
    reference's ``P(None, ("nodes", "data"))``, its ranks ordered with the
    first axis major. The axes of a tuple follow the mesh's dimension
    order. A tuple's groups are made on its first use, one for every
    position on the other axes (``dist.new_group`` is collective, so every
    rank of the process group must reach that first use), and kept on the
    mesh: once a mesh, never once a call."""
    key = axis_key(axis_name)
    names = mesh.mesh_dim_names
    if isinstance(key, str):
        if key not in names:
            raise ValueError(f"mesh has no axis {key!r} (axes {names})")
        return mesh.get_group(key)
    missing = [a for a in key if a not in names]
    if missing:
        raise ValueError(f"mesh has no axis {missing[0]!r} (axes {names})")
    dims = [names.index(a) for a in key]
    if dims != sorted(dims) or len(set(dims)) != len(dims):
        raise ValueError(f"the axes {key} must be distinct and in the mesh's order {names}")
    cache = mesh.__dict__.setdefault("_byzpy_axis_groups", {})
    group = cache.get(key)
    if group is None:
        ranks = mesh.mesh
        rest = [i for i in range(ranks.ndim) if i not in dims]
        # the axes of the tuple last, so each row is one group in row-major order
        size = 1
        for i in dims:
            size *= ranks.shape[i]
        rows = ranks.permute(*rest, *dims).reshape(-1, size)
        me = dist.get_rank()
        for row in rows.tolist():
            if row != sorted(row):
                raise ValueError(f"the ranks of {key} ({row}) are not in the process group's "
                                 "order, which a new group takes")
            made = dist.new_group(ranks=row)
            if me in row:
                group = made
        cache[key] = group
    return group


@dataclass(frozen=True)
class Sharding:
    """A layout over a mesh, the counterpart of ``NamedSharding``: ``spec``
    names, for each tensor dimension, the mesh axis (or axes) it is split
    over (``None``: whole), and ``placements`` gives each mesh dimension's
    DTensor placement (``Shard(dim)`` or ``Replicate()``)."""

    mesh: DeviceMesh
    spec: Tuple[SpecEntry, ...]
    placements: tuple

    def sharded_dim(self, axis: str) -> Optional[int]:
        """The tensor dimension split over mesh axis ``axis``, or ``None``."""
        for placement, name in zip(self.placements, self.mesh.mesh_dim_names):
            if name == axis and isinstance(placement, Shard):
                return placement.dim
        return None


def sharding(mesh: DeviceMesh, *spec: SpecEntry) -> Sharding:
    """``sharding(mesh, "nodes", None)`` is the counterpart of
    ``NamedSharding(mesh, PartitionSpec("nodes", None))``: dimension 0
    split over ``nodes``, dimension 1 whole."""
    names = mesh.mesh_dim_names
    placements = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis not in names:
                raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
            placements[names.index(axis)] = Shard(dim)
    return Sharding(mesh, tuple(spec), tuple(placements))


def replicated(mesh: DeviceMesh) -> Sharding:
    """The fully replicated layout (an empty spec)."""
    return sharding(mesh)


__all__ = [
    "AXIS_NAMES",
    "DeviceMesh",
    "Sharding",
    "axis_group",
    "axis_key",
    "feature_mesh",
    "grid_mesh",
    "init_process_group",
    "make_mesh",
    "node_axis",
    "node_mesh",
    "replicated",
    "sharding",
]
