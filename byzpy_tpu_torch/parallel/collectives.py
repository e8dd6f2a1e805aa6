"""Collectives over a device mesh, and the compressed wire fabric.

Counterpart of ``byzpy_tpu/parallel/collectives.py``. There the functions
run inside ``shard_map`` over a named mesh axis and XLA lowers them to
ICI collectives. Here the program is SPMD over ``torch.distributed``
(``parallel.mesh``): every function runs in each rank on that rank's
local tensor, and ``axis_name`` resolves to the process group of that
mesh dimension (``mesh=`` or the default mesh of ``configs.mesh``). An
axis name may be a tuple of mesh dimensions, as in the reference's
``P(None, ("nodes", "data"))``: the group of their product, ranked with
the first axis major (``parallel.mesh.axis_group``). Every rank of the
group must make the same calls in the same order.

* the primitives: :func:`all_gather`, :func:`all_reduce_sum`,
  :func:`all_reduce_mean`, :func:`reduce_scatter_sum`,
  :func:`all_to_all`, :func:`neighbor_shift` (the ``ppermute`` ring hop:
  one ``batch_isend_irecv`` on NCCL, one ``all_to_all_single`` with a
  single non-empty split on gloo) and :func:`ring_all_reduce_sum` (the
  reference's explicit ring of hops, with an optional compressed payload);
* the quantized collectives :func:`all_gather_q`,
  :func:`reduce_scatter_sum_q` and :func:`all_to_all_q`: each shard is
  encoded once at its source (int8: B13, fp8: B15, s4: B16 on the card),
  the codes and f32 scales ride the collective (fp8 values as uint8 bit
  patterns), and the receiver decodes (B14, or B17 for s4);
  ``reduce_scatter_sum_q`` sums the decoded slices in f32;
* :func:`reshard_q` / :func:`reshard_q_ef`: the move of a local tensor
  from one layout (``parallel.mesh.sharding``) to another with the payload
  compressed (and error feedback), the collective chosen by the two
  layouts: an ``all_to_all`` for a shard transpose, an ``all_gather`` to
  replicate, a local slice to split; a transpose from one axis to that
  axis and more (``P("nodes")`` rows to ``P(None, ("nodes", "data"))``
  columns) slices over the added axes and exchanges over the first, and
  back. Blockwise codes never straddle a
  shard: a trailing-axis shard must be a whole number of blocks. With
  ``src = dst = None`` nothing moves and the hop is the encode -> decode
  round trip on one device;
* :func:`sharded_fn` / :func:`allreduce_sharded`: a per-shard function
  run on every rank's block of a tensor that every rank holds whole.

Inside a CUDA-graph capture a collective over a gloo group raises
``GraphCaptureError``: gloo runs on the host and cannot be captured.

Every collective appends an entry to the traffic record of
:func:`record_traffic` where one is open (opcode, payload dtype, bytes of
the per-device result, group size): ``parallel.comms.collective_traffic``
reads it, where the reference parses compiled HLO.
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..ops.codec_kernels import code_dtype
from .quantization import (
    CommPrecision,
    QuantizedBlocks,
    as_comm_precision,
    dequantize_blockwise,
    encode_blockwise,
)

_FP8_MODES = ("fp8", "fp8_e5m2")


# ---------------------------------------------------------------------------
# The traffic record
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CollectiveRecord:
    """One collective a rank ran: the reference's HLO opcode name
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), the payload dtype, the bytes of the
    per-device result buffer and the group size."""

    opcode: str
    dtype: str
    result_bytes: int
    group_size: int


_records = threading.local()


@contextlib.contextmanager
def record_traffic() -> Iterator[List[CollectiveRecord]]:
    """Collect every collective this thread runs inside the block into the
    yielded list (nested records each get every entry)."""
    out: List[CollectiveRecord] = []
    stack = getattr(_records, "stack", None)
    if stack is None:
        stack = _records.stack = []
    stack.append(out)
    try:
        yield out
    finally:
        stack.remove(out)


def _record(opcode: str, result: torch.Tensor, group_size: int) -> None:
    stack = getattr(_records, "stack", None)
    if not stack:
        return
    entry = CollectiveRecord(opcode, str(result.dtype).replace("torch.", ""),
                             result.numel() * result.element_size(), group_size)
    for out in stack:
        out.append(entry)


def _quiet(fn, *args, **kwargs):
    # torch 2.13 marks all_gather_into_tensor / reduce_scatter_tensor
    # deprecated; they are the names both 2.11 and 2.13 have
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# Axis resolution
# ---------------------------------------------------------------------------


def _mesh_of(mesh):
    if mesh is not None:
        return mesh
    from ..configs.mesh import get_default_mesh

    found = get_default_mesh()
    if found is None:
        raise RuntimeError("no mesh: pass mesh= or set a default mesh (configs.use_mesh)")
    return found


def _axis(axis_name):
    from .mesh import axis_key

    return axis_key(axis_name)


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def refuse_gloo_capture(group) -> None:
    """Raise ``GraphCaptureError`` when ``group`` is a gloo group: its
    collectives run on the host, so a CUDA graph cannot hold them (and
    nothing runs eagerly in the graph's place)."""
    if dist.get_backend(group) == "gloo":
        from ..utils.cuda_graph import GraphCaptureError

        raise GraphCaptureError(
            "a collective over a gloo process group cannot be captured in a CUDA graph: gloo "
            "moves CUDA tensors through the host; run the mesh step eagerly "
            "(build_ps_train_step / build_gossip_train_step) or over NCCL")


def _group(axis_name, mesh):
    """``(process group, its size, this rank's index in it)``."""
    from .mesh import axis_group

    group = axis_group(_mesh_of(mesh), _axis(axis_name))
    if _capturing():
        refuse_gloo_capture(group)
    return group, dist.get_world_size(group), dist.get_rank(group)


def axis_size(axis_name, *, mesh=None) -> int:
    """Size of the named mesh axis."""
    return _group(axis_name, mesh)[1]


def axis_index(axis_name, *, mesh=None) -> int:
    """This rank's index along the named mesh axis."""
    return _group(axis_name, mesh)[2]


# ---------------------------------------------------------------------------
# Group-level operations (every rank of ``group`` calls them)
# ---------------------------------------------------------------------------


def _gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``(size, *x.shape)``: every rank's ``x`` in rank order."""
    src = x.contiguous().reshape((-1, *x.shape[1:]) if x.ndim else (1,))
    # gloo takes the concatenation along dim 0, not a stacked output
    out = src.new_empty((size * src.shape[0], *src.shape[1:]))
    _quiet(dist.all_gather_into_tensor, out, src, group=group)
    _record("all-gather", out, size)
    return out.reshape((size, *x.shape))


def _reduce(x: torch.Tensor, group, size: int) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    _record("all-reduce", out, size)
    return out


def _reduce_scatter(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Sum over ranks of ``x``, this rank keeping its ``1/size`` of axis 0."""
    if x.shape[0] % size:
        raise ValueError(f"reduce_scatter needs axis 0 ({x.shape[0]}) divisible by the axis size "
                         f"({size})")
    src = x.contiguous()
    out = src.new_empty((src.shape[0] // size, *src.shape[1:]))
    _quiet(dist.reduce_scatter_tensor, out, src, group=group)
    _record("reduce-scatter", out, size)
    return out


def _exchange(x: torch.Tensor, group, size: int, split_axis: int, concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all: ``x`` split along ``split_axis`` into ``size``
    equal pieces, piece ``j`` to rank ``j``, the received pieces
    concatenated along ``concat_axis`` in rank order."""
    split_axis %= max(x.ndim, 1)
    concat_axis %= max(x.ndim, 1)
    if x.shape[split_axis] % size:
        raise ValueError(f"all_to_all needs the split axis ({x.shape[split_axis]}) divisible by "
                         f"the axis size ({size})")
    pieces = torch.stack(torch.chunk(x, size, dim=split_axis)).contiguous()
    out = torch.empty_like(pieces)
    dist.all_to_all_single(out, pieces, group=group)
    _record("all-to-all", out, size)
    return torch.cat(list(out.unbind(0)), dim=concat_axis)


def _shift(x: torch.Tensor, group, size: int, rank: int, offset: int) -> torch.Tensor:
    """Receive the tensor of the rank ``offset`` places behind on the ring
    (``lax.ppermute`` with ``i -> i + offset``). The group's backend picks
    the route: NCCL (and any backend but gloo) one ``batch_isend_irecv``
    of a send and a receive; gloo one ``all_to_all_single`` whose only
    non-empty splits are the send to ``rank + offset`` and the receive
    from ``rank - offset``, since gloo refuses ``batch_isend_irecv`` on
    CUDA tensors (``chip_gloo_probe.py``)."""
    if size == 1 or offset % size == 0:
        return x
    src = x.contiguous()
    out = torch.empty_like(src)
    to, frm = (rank + offset) % size, (rank - offset) % size
    if dist.get_backend(group) == "gloo":
        numel = src.numel()
        send = [numel if r == to else 0 for r in range(size)]
        recv = [numel if r == frm else 0 for r in range(size)]
        dist.all_to_all_single(out.view(-1), src.view(-1), output_split_sizes=recv,
                               input_split_sizes=send, group=group)
    else:
        ops = [dist.P2POp(dist.isend, src, dist.get_global_rank(group, to), group=group),
               dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm), group=group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _record("collective-permute", out, size)
    return out


# ---------------------------------------------------------------------------
# In-SPMD primitives
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, axis_name, *, axis: int = 0, tiled: bool = True,
               mesh=None) -> torch.Tensor:
    """Gather every shard along ``axis`` (``tiled``: concatenated; else
    stacked on a new axis)."""
    group, size, _ = _group(axis_name, mesh)
    g = _gather(x, group, size)
    if not tiled:
        return torch.movedim(g, 0, axis % (x.ndim + 1))
    return torch.cat(list(g.unbind(0)), dim=axis % max(x.ndim, 1))


def all_reduce_sum(x: torch.Tensor, axis_name, *, mesh=None) -> torch.Tensor:
    """Sum ``x`` across the axis' ranks (replicated result)."""
    group, size, _ = _group(axis_name, mesh)
    return _reduce(x, group, size)


def all_reduce_mean(x: torch.Tensor, axis_name, *, mesh=None) -> torch.Tensor:
    """Mean of ``x`` across the axis' ranks: the sum over the axis size."""
    group, size, _ = _group(axis_name, mesh)
    return _reduce(x, group, size) / size


def reduce_scatter_sum(x: torch.Tensor, axis_name, *, axis: int = 0, mesh=None) -> torch.Tensor:
    """Sum across the axis' ranks, each keeping its ``1/N`` slice of ``axis``."""
    group, size, _ = _group(axis_name, mesh)
    axis %= max(x.ndim, 1)
    out = _reduce_scatter(torch.movedim(x, axis, 0), group, size)
    return torch.movedim(out, 0, axis)


def all_to_all(x: torch.Tensor, axis_name, *, split_axis: int, concat_axis: int,
               mesh=None) -> torch.Tensor:
    """Transpose shard ownership: rank ``i`` sends slice ``j`` of
    ``split_axis`` to rank ``j``, slices received concatenated on
    ``concat_axis``."""
    group, size, _ = _group(axis_name, mesh)
    return _exchange(x, group, size, split_axis, concat_axis)


def neighbor_shift(x: torch.Tensor, axis_name, *, offset: int = 1, mesh=None) -> torch.Tensor:
    """Receive the shard of the rank ``offset`` places behind on the ring:
    on NCCL one ``batch_isend_irecv``, on gloo one ``all_to_all_single``
    with a single non-empty split each way (:func:`_shift`)."""
    group, size, rank = _group(axis_name, mesh)
    return _shift(x, group, size, rank, offset)


def ring_all_reduce_sum(
    x: torch.Tensor,
    axis_name,
    *,
    precision: Union[CommPrecision, str, None] = None,
    mesh=None,
) -> torch.Tensor:
    """The explicit ring all-reduce: ``N - 1`` reduce-scatter hops and
    ``N - 1`` all-gather hops of ``1/N``-size chunks to the next rank, in
    the reference's order of additions (so the result's bits are its).

    With ``precision`` on, only each hop's payload is compressed: the
    reduce half encodes the running partial each hop and adds the decoded
    value in ``x``'s dtype; in the gather half the owner encodes its
    reduced chunk once and the codes are forwarded as they are, so every
    rank decodes the same bits. ``None`` / ``"off"`` is the plain ring."""
    p = as_comm_precision(precision)
    group, n, me = _group(axis_name, mesh)
    if n == 1:
        return x
    shape, size = x.shape, x.numel()
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(n, -1).clone()

    def hop(t):
        return _shift(t, group, n, me, 1)

    if p.enabled:
        clen = chunks.shape[1]
        for s in range(n - 1):
            incoming = _map_payload(hop, _encode_wire(chunks[(me - s) % n], p))
            idx = (me - s - 1) % n
            chunks[idx] = chunks[idx] + _decode_wire(incoming, p, chunks.dtype, clen)
        carry = _encode_wire(chunks[(me + 1) % n], p)
        for s in range(n - 1):
            nxt = _map_payload(hop, carry)
            chunks[(me - s + 1) % n] = _decode_wire(carry, p, chunks.dtype, clen)
            carry = nxt
        chunks[(me - n + 2) % n] = _decode_wire(carry, p, chunks.dtype, clen)
        return chunks.reshape(-1)[:size].reshape(shape)
    for s in range(n - 1):
        incoming = hop(chunks[(me - s) % n])
        idx = (me - s - 1) % n
        chunks[idx] = chunks[idx] + incoming
    for s in range(n - 1):
        incoming = hop(chunks[(me + 1 - s) % n])
        chunks[(me - s) % n] = incoming
    return chunks.reshape(-1)[:size].reshape(shape)


# ---------------------------------------------------------------------------
# The compressed wire payload
# ---------------------------------------------------------------------------


def _encode_wire(x: torch.Tensor, p: CommPrecision):
    """One wire payload under ``p``: a bf16 cast for ``bf16``; for the
    blockwise modes ``(codes, scales)``, fp8 codes as their uint8 bit
    patterns so that every transport moves opaque bytes."""
    if p.mode == "bf16":
        return x.to(torch.bfloat16)
    q = encode_blockwise(x, p)
    v = q.values
    if p.mode in _FP8_MODES:
        v = v.view(torch.uint8)
    return (v, q.scales)


def _decode_wire(payload, p: CommPrecision, dtype, d_last: int) -> torch.Tensor:
    """Inverse of :func:`_encode_wire` (lossy), in ``dtype``. ``d_last`` is
    the encoded tensor's trailing length (packed s4 halves it)."""
    if p.mode == "bf16":
        return payload.to(dtype)
    values, scales = payload
    if p.mode in _FP8_MODES:
        values = values.view(code_dtype(p.mode))
    return dequantize_blockwise(
        QuantizedBlocks(values, scales, p.block, "float32", p.mode,
                        d_last if p.mode == "s4" else -1),
        dtype=dtype,
    )


def _map_payload(fn, payload):
    return tuple(fn(t) for t in payload) if isinstance(payload, tuple) else fn(payload)


def all_gather_q(
    x: torch.Tensor,
    axis_name,
    *,
    precision: Union[CommPrecision, str, None] = None,
    axis: int = 0,
    tiled: bool = True,
    mesh=None,
) -> torch.Tensor:
    """:func:`all_gather` with a compressed payload: each shard encoded
    locally, codes and scales gathered, every rank decoding the whole. A
    tiled gather along the trailing axis needs the shard's trailing length
    to be a whole number of blocks. ``None`` / ``"off"`` is exactly
    :func:`all_gather`."""
    p = as_comm_precision(precision)
    if not p.enabled:
        return all_gather(x, axis_name, axis=axis, tiled=tiled, mesh=mesh)
    if p.mode == "bf16":
        return all_gather(x.to(torch.bfloat16), axis_name, axis=axis, tiled=tiled,
                          mesh=mesh).to(x.dtype)
    axis_norm = axis % max(x.ndim, 1)
    trailing = bool(tiled and x.ndim and axis_norm == x.ndim - 1)
    if trailing and x.shape[-1] % p.block:
        raise ValueError(
            f"{p.mode} all_gather along the trailing axis needs the shard "
            f"dim ({x.shape[-1]}) to be a multiple of the quantization "
            f"block ({p.block}); gather a leading axis or adjust the block"
        )
    group, size, _ = _group(axis_name, mesh)
    values, scales = _encode_wire(x, p)
    v = all_gather(values, axis_name, axis=axis, tiled=tiled, mesh=mesh)
    s_axis = min(axis_norm, scales.ndim - 1) if scales.ndim else 0
    s = all_gather(scales, axis_name, axis=s_axis, tiled=tiled, mesh=mesh)
    d_last = x.shape[-1] * (size if trailing else 1) if x.ndim else 1
    return _decode_wire((v, s), p, x.dtype, d_last)


def reduce_scatter_sum_q(
    x: torch.Tensor,
    axis_name,
    *,
    precision: Union[CommPrecision, str, None] = None,
    mesh=None,
) -> torch.Tensor:
    """Quantized reduce-scatter: rank ``i`` receives the sum of every
    rank's ``i``-th ``1/N`` slice of axis 0 (the shape of
    :func:`reduce_scatter_sum`), each input encoded once at its source and
    moved by an all-to-all, the ``N`` decoded slices summed in f32 in rank
    order. ``None`` / ``"off"`` is exactly :func:`reduce_scatter_sum`."""
    p = as_comm_precision(precision)
    if not p.enabled:
        return reduce_scatter_sum(x, axis_name, axis=0, mesh=mesh)
    group, n, _ = _group(axis_name, mesh)
    d0 = x.shape[0]
    if d0 % n:
        raise ValueError(
            f"reduce_scatter_sum_q needs x.shape[0] ({d0}) divisible by "
            f"the axis size ({n})"
        )
    rows = x.reshape(n, d0 // n, *x.shape[1:])
    if p.mode == "bf16":
        recv = _exchange(rows.to(torch.bfloat16), group, n, 0, 0)
        return torch.sum(recv.to(x.dtype), dim=0)
    values, scales = _encode_wire(rows, p)
    # a leading-axis exchange keeps each slice's trailing blocks (and s4's
    # packing) whole, so codes and scales stay aligned
    v = _exchange(values, group, n, 0, 0)
    s = _exchange(scales, group, n, 0, 0)
    recv = _decode_wire((v, s), p, torch.float32, rows.shape[-1] if rows.ndim > 1 else 1)
    return torch.sum(recv, dim=0).to(x.dtype)


def all_to_all_q(
    x: torch.Tensor,
    axis_name,
    *,
    split_axis: int,
    concat_axis: int,
    precision: Union[CommPrecision, str, None] = None,
    mesh=None,
) -> torch.Tensor:
    """:func:`all_to_all` with a compressed payload. The blocks run along
    the trailing axis, so a blockwise mode needs ``split_axis`` and
    ``concat_axis`` on leading axes; ``bf16`` takes any axes. ``None`` /
    ``"off"`` is exactly :func:`all_to_all`."""
    p = as_comm_precision(precision)
    group, n, _ = _group(axis_name, mesh)
    if not p.enabled:
        return _exchange(x, group, n, split_axis, concat_axis)
    if p.mode == "bf16":
        return _exchange(x.to(torch.bfloat16), group, n, split_axis, concat_axis).to(x.dtype)
    last = x.ndim - 1
    if split_axis % x.ndim == last or concat_axis % x.ndim == last:
        raise ValueError(
            f"{p.mode} all_to_all_q quantizes along the trailing axis; "
            "split/concat must use leading axes (reshape the operand first)"
        )
    values, scales = _encode_wire(x, p)
    v = _exchange(values, group, n, split_axis, concat_axis)
    s = _exchange(scales, group, n, split_axis, concat_axis)
    return _decode_wire((v, s), p, x.dtype, x.shape[-1])


# ---------------------------------------------------------------------------
# Layout moves (reshard)
# ---------------------------------------------------------------------------


Side = Tuple[Optional[int], Tuple[str, ...]]  # (tensor dim, its mesh axes, major first)


def _side(layout) -> Side:
    """The tensor dim a layout splits and the mesh axes it splits it over
    (``(None, ())``: whole)."""
    if layout is None:
        return None, ()
    split = [(dim, entry if isinstance(entry, tuple) else (entry,))
             for dim, entry in enumerate(layout.spec) if entry is not None]
    if len(split) > 1:
        raise NotImplementedError(
            f"a layout that splits two tensor dims ({layout.spec}) has no reshard")
    return split[0] if split else (None, ())


def _layouts(src, dst) -> Tuple[Any, Side, Side]:
    """The mesh of the two layouts and each one's split."""
    from .mesh import Sharding

    for layout in (src, dst):
        if layout is not None and not isinstance(layout, Sharding):
            raise TypeError(f"a layout is a parallel.mesh.Sharding or None, got {layout!r}")
    meshes = {id(s.mesh): s.mesh for s in (src, dst) if s is not None}
    if len(meshes) > 1:
        raise ValueError("reshard between layouts of two meshes")
    mesh = next(iter(meshes.values())) if meshes else None
    a, b = _side(src), _side(dst)
    if a[1] and b[1] and a[0] != b[0]:
        short, long_ = sorted((a[1], b[1]), key=len)
        if long_[:len(short)] != short:
            raise NotImplementedError(
                f"a reshard from axes {a[1]} to axes {b[1]}: one must lead the other")
    elif a[1] and b[1] and a[1] != b[1]:
        raise NotImplementedError(f"a reshard of dim {a[0]} from axes {a[1]} to axes {b[1]}")
    return mesh, a, b


def _shards(mesh, axes: Tuple[str, ...]) -> int:
    return axis_size(axes, mesh=mesh) if axes else 1


def _move(t: torch.Tensor, mesh, src: Side, dst: Side) -> torch.Tensor:
    """A local tensor split as ``src`` to the same tensor split as ``dst``."""
    (a, axes_a), (b, axes_b) = src, dst
    if (a, axes_a) == (b, axes_b) or (not axes_a and not axes_b):
        return t
    if not axes_b:
        group, size, _ = _group(axes_a, mesh)
        g = _gather(t, group, size)
        return torch.cat(list(g.unbind(0)), dim=a)
    if not axes_a:
        group, size, rank = _group(axes_b, mesh)
        if t.shape[b] % size:
            raise ValueError(f"cannot split dim {b} ({t.shape[b]}) over {size} ranks")
        return torch.chunk(t, size, dim=b)[rank].contiguous()
    if axes_a == axes_b:
        group, size, _ = _group(axes_a, mesh)
        return _exchange(t, group, size, b, a)
    if len(axes_a) < len(axes_b):
        # rows over A to columns over A + R: keep the column blocks of this
        # rank's place on R, then exchange them over A
        rest = axes_b[len(axes_a):]
        n_a, n_r = _shards(mesh, axes_a), _shards(mesh, rest)
        if t.shape[b] % (n_a * n_r):
            raise ValueError(f"cannot split dim {b} ({t.shape[b]}) over {n_a * n_r} ranks")
        r = axis_index(rest, mesh=mesh)
        blocks = t.unflatten(b, (n_a, n_r, t.shape[b] // (n_a * n_r))).select(b + 1, r)
        group, size, _ = _group(axes_a, mesh)
        return _exchange(blocks.flatten(b, b + 1), group, size, b, a)
    # columns over B + R back to rows over B: exchange over B, then gather
    # the column blocks over R and put them back in the flat order
    rest = axes_a[len(axes_b):]
    n_b, n_r = _shards(mesh, axes_b), _shards(mesh, rest)
    group, size, _ = _group(axes_b, mesh)
    part = _exchange(t, group, size, b, a)  # dim a: the blocks (i, r) of every i on B
    group_r, size_r, _ = _group(rest, mesh)
    g = _gather(part, group_r, size_r)  # (R, ...): dim a + 1 holds the blocks (i, r)
    g = g.unflatten(a + 1, (n_b, part.shape[a] // n_b)).movedim(0, a + 1)
    return g.flatten(a, a + 2)


def _trailing_shards(x: torch.Tensor, mesh, src: Side, dst: Side) -> Tuple[int, int]:
    """How many shards the trailing axis has before and after the move."""
    last = x.ndim - 1
    return (_shards(mesh, src[1]) if src[0] == last else 1,
            _shards(mesh, dst[1]) if dst[0] == last else 1)


def _check_blocks(x: torch.Tensor, p: CommPrecision, mesh, src: Side, dst: Side) -> None:
    """Blockwise codes must not straddle a shard of the trailing axis."""
    before, after = _trailing_shards(x, mesh, src, dst)
    if before > 1 and x.shape[-1] % p.block:
        raise ValueError(
            f"{p.mode} reshard: the source's trailing shard ({x.shape[-1]}) must be a multiple "
            f"of the quantization block ({p.block})")
    if after > 1 and (x.shape[-1] * before % after or (x.shape[-1] * before // after) % p.block):
        raise ValueError(
            f"{p.mode} reshard: the destination's trailing shard ({x.shape[-1] * before} / "
            f"{after}) must be a multiple of the quantization block ({p.block}); pad the "
            f"trailing axis to shards x block")


def _reshard_coded(q: QuantizedBlocks, p: CommPrecision, mesh, src: Side, dst: Side, dtype,
                   d_src: int) -> torch.Tensor:
    """Move the codes (fp8 as uint8 bit patterns) and the scales from
    layout ``src`` to ``dst`` and decode there."""
    v = q.values.view(torch.uint8) if p.mode in _FP8_MODES else q.values
    v = _move(v, mesh, src, dst)
    s = _move(q.scales, mesh, src, dst)
    if p.mode in _FP8_MODES:
        v = v.view(code_dtype(p.mode))
    before, after = _trailing_shards(q.values, mesh, src, dst)
    d_dst = d_src * before // after
    return dequantize_blockwise(
        QuantizedBlocks(v, s, q.block, q.orig_dtype, q.code, d_dst if q.code == "s4" else -1),
        dtype=dtype,
    )


def reshard_q(
    x: torch.Tensor,
    src=None,
    dst=None,
    *,
    precision: Union[CommPrecision, str, None] = None,
) -> torch.Tensor:
    """Move this rank's part of a tensor from layout ``src`` to layout
    ``dst`` (:class:`~byzpy_tpu_torch.parallel.mesh.Sharding`, ``None`` for
    no layout) with the payload compressed: off moves ``x`` itself, ``bf16``
    its bf16 cast, a blockwise mode its codes and scales, decoded at the
    destination in ``x``'s dtype. The collective follows from the layouts:
    shard dim ``a`` to shard dim ``b`` is an all-to-all, to whole an
    all-gather, whole to a shard a local slice; a dim split over axes ``A``
    to another split over ``A`` and more axes ``R`` slices over ``R`` and
    exchanges over ``A`` (and back: an exchange over ``A``, then a gather
    over ``R``). ``src = dst = None`` moves nothing: the encode -> decode
    round trip on one device."""
    p = as_comm_precision(precision)
    mesh, a, b = _layouts(src, dst)
    if not p.enabled:
        return _move(x, mesh, a, b)
    if p.mode == "bf16":
        return _move(x.to(torch.bfloat16), mesh, a, b).to(x.dtype)
    _check_blocks(x, p, mesh, a, b)
    q = encode_blockwise(x, p)
    return _reshard_coded(q, p, mesh, a, b, x.dtype, x.shape[-1] if x.ndim else 1)


def reshard_q_ef(
    x: torch.Tensor,
    residual: torch.Tensor,
    src=None,
    dst=None,
    *,
    precision: Union[CommPrecision, str, None] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`reshard_q` with per-round error feedback: the wire carries
    ``xc = x + residual`` and the new residual, this round's quantization
    error at the source layout, is ``xc - decode(encode(xc))``. Returns
    ``(decoded at dst, new residual at src)``; off returns the moved ``x``
    and ``residual`` unchanged."""
    p = as_comm_precision(precision)
    mesh, a, b = _layouts(src, dst)
    if not p.enabled:
        return _move(x, mesh, a, b), residual
    xc = x + residual.to(x.dtype)
    if p.mode == "bf16":
        dec_local = xc.to(torch.bfloat16).to(x.dtype)
        return _move(xc.to(torch.bfloat16), mesh, a, b).to(x.dtype), xc - dec_local
    _check_blocks(xc, p, mesh, a, b)
    q = encode_blockwise(xc, p)
    dec_local = dequantize_blockwise(q, dtype=x.dtype)
    if a == b or (not a[1] and not b[1]):
        # nothing moves: the codes decoded here are the ones decoded there
        return dec_local, xc - dec_local
    moved = _reshard_coded(q, p, mesh, a, b, x.dtype, xc.shape[-1] if xc.ndim else 1)
    return moved, xc - dec_local


# ---------------------------------------------------------------------------
# Per-shard functions over whole tensors
# ---------------------------------------------------------------------------

Spec = Sequence[Any]


def _names(axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def _block_of(t: torch.Tensor, spec: Spec, axis, size: int, rank: int) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        if entry is not None and _names(_axis(entry)) == _names(axis):
            if t.shape[dim] % size:
                raise ValueError(f"dim {dim} ({t.shape[dim]}) does not split over {size} ranks")
            return torch.chunk(t, size, dim=dim)[rank]
    return t


def _assemble(t: torch.Tensor, spec: Spec, axis, mesh) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        if entry is not None and _names(_axis(entry)) == _names(axis):
            return all_gather(t, axis, axis=dim, mesh=mesh)
    return t


def sharded_fn(
    mesh,
    axis_name,
    fn: Callable[..., torch.Tensor],
    *,
    in_spec: Any = None,
    out_spec: Optional[Spec] = None,
) -> Callable[..., torch.Tensor]:
    """``fn`` (which may call the collectives with ``axis_name``) run on
    every rank's block of whole tensors: the counterpart of the
    reference's ``jit(shard_map(fn, ...))`` on host-level arrays. Every
    rank passes the whole arguments; each takes its block along the
    dimensions its spec names ``axis_name`` for, runs ``fn`` with ``mesh``
    as the default mesh, and the result is gathered back along
    ``out_spec``'s sharded dimension (``()`` or ``[]``: replicated, the
    block is the result). A spec is a tuple of axis names or ``None`` a
    dimension (default ``(axis_name,)``); a list of specs gives one an
    argument."""
    axis = _axis(axis_name)
    in_specs = [in_spec] if not isinstance(in_spec, list) else in_spec
    in_specs = [(axis,) if s is None else tuple(s) for s in in_specs]
    out = tuple(in_specs[0] if out_spec is None else out_spec)

    def call(*args: torch.Tensor) -> torch.Tensor:
        from ..configs.mesh import use_mesh

        if len(args) != len(in_specs):
            raise ValueError(f"{len(in_specs)} in_specs for {len(args)} arguments")
        group, size, rank = _group(axis, mesh)
        blocks = [_block_of(t, s, axis, size, rank) for t, s in zip(args, in_specs)]
        with use_mesh(mesh):
            result = fn(*blocks)
        return _assemble(result, out, axis, mesh)

    return call


def allreduce_sharded(mesh, x: torch.Tensor, *, axis_name=None) -> torch.Tensor:
    """Sum a node-sharded ``(n, ...)`` tensor (every rank holding it
    whole) across its shards: each rank sums its rows, then one
    all-reduce. Replicated result of shape ``x.shape[1:]``."""
    axis = axis_name or mesh.mesh_dim_names[0]
    fn = sharded_fn(mesh, axis,
                    lambda s: all_reduce_sum(torch.sum(s, dim=0), axis, mesh=mesh),
                    in_spec=(axis,), out_spec=())
    return fn(x)


__all__ = [
    "CollectiveRecord",
    "all_gather",
    "all_gather_q",
    "all_reduce_mean",
    "all_reduce_sum",
    "all_to_all",
    "all_to_all_q",
    "allreduce_sharded",
    "axis_index",
    "axis_size",
    "neighbor_shift",
    "record_traffic",
    "refuse_gloo_capture",
    "reduce_scatter_sum",
    "reduce_scatter_sum_q",
    "reshard_q",
    "reshard_q_ef",
    "ring_all_reduce_sum",
    "sharded_fn",
]
