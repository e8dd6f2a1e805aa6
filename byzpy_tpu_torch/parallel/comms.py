"""Communication accounting: the collectives a round ran, and the wire-byte
laws.

Counterpart of ``byzpy_tpu/parallel/comms.py``. The laws are the
reference's, number for number: :func:`compression_factor`,
:func:`opt_state_bytes`, :func:`ps_round_wire_bytes`,
:func:`serving_ingress_bytes`, :func:`partial_fold_bytes`,
:func:`sharded_round_wire_bytes`, :func:`merge_tree_wire_bytes` and
:func:`scaling_model` (its defaults are an H100's: the data sheet's dense
bf16 peak and NVLink's 450 GB/s a direction). The serving-tier laws
price the JAX package's sharded frontend, which the port does not have
yet (ROADMAP A.6); they are kept so that the two packages' tables agree.

The measured side differs: the reference compiles a function and parses
the collectives out of its optimized HLO. The port's program is eager
SPMD, so :func:`collective_traffic` runs the function once under
``parallel.collectives.record_traffic`` and reads the record the port's
own collectives keep (opcode, payload dtype, bytes of the per-device
result, group size), with the reference's per-op wire laws
(:attr:`CollectiveOp.wire_bytes_per_device`). It counts the collectives
of ``parallel.collectives`` only: a bare ``torch.distributed`` call is not
seen.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .collectives import record_traffic
from .quantization import CommPrecision, as_comm_precision


@dataclass(frozen=True)
class CollectiveOp:
    """One collective a rank ran (its per-device view)."""

    opcode: str
    result_bytes: int  # bytes of the per-device result buffer
    group_size: int  # ranks in the group
    dtype: str = "float32"  # the payload's dtype
    in_entry: bool = True  # the reference's loop-body flag: an eager record is always in entry

    @property
    def wire_bytes_per_device(self) -> int:
        """Bytes each device puts on the interconnect for this op, under
        the ring schedules (the reference's laws):

        * all-gather: ``(g-1)/g`` of the result;
        * all-reduce: ``2 (g-1)/g`` of the buffer;
        * reduce-scatter: ``(g-1)`` times the result (``(g-1)/g`` of the input);
        * all-to-all: ``(g-1)/g`` of the result leaves the device;
        * collective-permute: the whole buffer moves to the neighbour.
        """
        g = max(self.group_size, 1)
        b = self.result_bytes
        if self.opcode == "all-gather":
            return b * (g - 1) // g
        if self.opcode == "all-reduce":
            return 2 * b * (g - 1) // g
        if self.opcode == "reduce-scatter":
            return b * (g - 1)
        if self.opcode == "all-to-all":
            return b * (g - 1) // g
        return b  # collective-permute


def collective_traffic(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and account the collectives it
    ran on this rank: ``{"ops": [...], "per_opcode_bytes": {...},
    "wire_bytes_per_device": N, "loop_body_bytes_per_iteration": 0}`` for
    one invocation (one training round when ``fn`` is a round step); each
    op carries its payload dtype. Every rank of the groups involved must
    run it (a collective needs them all)."""
    with record_traffic() as records:
        fn(*args, **kwargs)
    ops = [CollectiveOp(r.opcode, r.result_bytes, r.group_size, r.dtype) for r in records]
    per: Dict[str, int] = {}
    for op in ops:
        per[op.opcode] = per.get(op.opcode, 0) + op.wire_bytes_per_device
    return {
        "ops": ops,
        "per_opcode_bytes": per,
        "wire_bytes_per_device": sum(per.values()),
        # eager: no collective runs inside a compiled loop body
        "loop_body_bytes_per_iteration": 0,
    }


def _merge_levels(n_shards: int, fanout: Optional[int]) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
    """The internal combine levels of the JAX package's depth-N merge tree
    (``serving.sharded.MergeTopology.levels``): contiguous runs of
    ``fanout`` children combine until at most ``fanout`` face the root;
    ``None`` is the flat tier (no level)."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if fanout is not None and fanout < 2:
        raise ValueError("fanout must be >= 2 (or None for flat)")
    levels: List[Tuple[Tuple[int, ...], ...]] = []
    if fanout is not None:
        nodes: List[Tuple[int, ...]] = [(i,) for i in range(n_shards)]
        while len(nodes) > fanout:
            grouped = [tuple(leaf for node in nodes[i:i + fanout] for leaf in node)
                       for i in range(0, len(nodes), fanout)]
            levels.append(tuple(grouped))
            nodes = grouped
    return tuple(levels)


@dataclass(frozen=True)
class ScalingPoint:
    """One row of the analytic efficiency table."""

    n_chips: int
    compute_s: float
    comm_s: float

    @property
    def efficiency(self) -> float:
        """Fraction of perfect weak scaling: compute / (compute + exposed
        comm), assuming no compute/comm overlap (pessimistic)."""
        return self.compute_s / (self.compute_s + self.comm_s)


def compression_factor(
    precision: str = "off", *, block: int = 256, dtype_bytes: int = 4
) -> float:
    """Wire-byte multiplier of a compressed fabric relative to its
    full-precision baseline: 1.0 for ``"off"``, ``2/dtype_bytes`` for
    ``"bf16"``, ``(1 + 4/block)/dtype_bytes`` for ``"int8"`` and the
    fp8 formats (one byte per value is one byte per value), and
    ``(0.5 + 4/block)/dtype_bytes`` for packed ``"s4"``. The
    law itself lives on
    :meth:`~byzpy_tpu_torch.parallel.quantization.CommPrecision.wire_bytes_per_value`
    (single source of truth for the blockwise wire layout); this wrapper
    only normalizes it to a ratio."""
    p = as_comm_precision(precision or "off")
    if p.block != block:
        p = CommPrecision(mode=p.mode, block=block)
    return p.wire_bytes_per_value(dtype_bytes) / dtype_bytes


def opt_state_bytes(
    n_params: int,
    *,
    slots: int = 1,
    dtype_bytes: int = 4,
    update_sharded: bool = False,
    n_shards: int = 1,
) -> int:
    """Per-chip bytes of the round's carried weight-update state.

    A replicated update keeps ``slots`` full d-sized moment buffers on
    EVERY chip (SGD+momentum: 1; Adam: 2). The sharded update
    (``parallel.ps.ShardedUpdateConfig``) carries ``slots + 1`` buffers
    — every moment plus the chip's authoritative exact flat param shard
    — each split over the ``n_shards``-way feature grid (ceil: d pads to
    the grid): a ``slots·n/(slots+1)``× cut (4× at n=8 for momentum,
    5.3× for Adam; → n× as slots grow)."""
    if not update_sharded or n_shards <= 1:
        return slots * n_params * dtype_bytes
    per_shard = -(-n_params // n_shards)
    return (slots + 1) * per_shard * dtype_bytes


def measured_opt_state_bytes(opt_state: Any) -> int:
    """Bytes the carried update state occupies on this rank: the sum of
    every tensor leaf's bytes (an SPMD rank holds its own shard), the
    measured side of :func:`opt_state_bytes`."""
    total = 0
    stack = [opt_state]
    while stack:
        leaf = stack.pop()
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, dict):
            stack.extend(leaf.values())
        elif isinstance(leaf, (list, tuple)):
            stack.extend(leaf)
    return total


def ps_round_wire_bytes(
    n_params: int,
    n_chips: int,
    *,
    dtype_bytes: int = 4,
    update_sharded: bool = False,
    grad_precision: str = "off",
    param_precision: str = "off",
    quant_block: int = 256,
) -> float:
    """Closed-form per-device wire bytes of the fused PS round's two
    dominant collectives (the port's traffic record of a mesh round equals
    them, ``tests/test_torch_comms.py``):

    * the gradient transpose — an all-to-all moving ``d·dt·(n-1)/n``,
      compressible per ``grad_precision``;
    * the update move — an all-gather of ``d`` values with the same
      ``(n-1)/n`` law. Replicated update: the f32 *aggregated gradient*
      is gathered and must stay exact (it feeds every chip's optimizer
      state), so ``param_precision`` is ignored. Sharded update: only
      the *refreshed params* are gathered, each chip's exact shard stays
      in the carried opt state, and the gather compresses per
      ``param_precision`` without compounding error.

    Robust-aggregation traffic itself (a scalar or an (n, n) Gram psum)
    is negligible next to these at ``d >= 1e5``."""
    g = max(n_chips, 1)
    saturate = (g - 1) / g
    transpose = (
        n_params * dtype_bytes
        * compression_factor(grad_precision, block=quant_block, dtype_bytes=dtype_bytes)
        * saturate
    )
    pfac = (
        compression_factor(param_precision, block=quant_block, dtype_bytes=dtype_bytes)
        if update_sharded
        else 1.0
    )
    gather = n_params * dtype_bytes * pfac * saturate
    return transpose + gather


#: The JAX package's measured cloudpickle envelope of one serving submission frame (the
#: dict keys, tenant/client strings, numpy array header — everything
#: but the length prefix, HMAC tag, and gradient payload), per wire
#: precision: compressed frames carry a ``QuantizedWireArray`` header
#: (mode/block/shape/dtype + the scales array's own pickle framing).
#: Pinned within tolerance by the JAX package's serving tests.
_SERVING_ENVELOPE_BYTES = {
    "off": 224, "bf16": 368, "int8": 432,
    # sub-int8 frames carry the same QuantizedWireArray header as int8
    # (mode string length and scale-array framing shift it a few bytes)
    "fp8": 431, "fp8_e5m2": 436, "s4": 430,
}


def serving_ingress_bytes(
    n_params: int,
    *,
    precision: str = "off",
    quant_block: int = 256,
    signed: bool = False,
    dtype_bytes: int = 4,
    envelope_bytes: Optional[int] = None,
) -> float:
    """Analytic wire bytes of ONE client gradient submission entering
    the JAX package's serving tier: the 4-byte length prefix,
    the 32-byte HMAC tag when ``signed`` (``BYZPY_TPU_WIRE_KEY``), the
    cloudpickle envelope, and the gradient payload —
    ``n_params · dtype_bytes`` scaled by :func:`compression_factor` for
    the ``BYZPY_TPU_WIRE_PRECISION`` fabric the frame rides
    (``off``/``bf16``/``int8``/``fp8``/``fp8_e5m2``/``s4``). Multiply by sustained submissions/sec
    for the tier's ingress-bandwidth law.

    Known small bias: with telemetry ENABLED the client stamps each
    submit frame with its ``_trace_ctx`` trace context (~60 pickled
    bytes, ``engine.actor.wire``) which this law deliberately does not
    price — the measured side only exists with telemetry on, so the
    residual pins carry a systematic +0.4% at d=4096 f32 (~1.5% on the
    int8 fabric), well inside the 5% smoke tolerance; the <2% test
    pins measure telemetry-off frames."""
    mode = (precision or "off").lower()
    if envelope_bytes is None:
        envelope_bytes = _SERVING_ENVELOPE_BYTES.get(
            mode, _SERVING_ENVELOPE_BYTES["off"]
        )
    payload = (
        n_params
        * dtype_bytes
        * compression_factor(mode, block=quant_block, dtype_bytes=dtype_bytes)
    )
    return 4 + (32 if signed else 0) + envelope_bytes + payload


#: The JAX package's measured cloudpickle envelope of one PartialFold frame (dict keys,
#: tenant/digest strings, array headers — everything but the length
#: prefix, HMAC tag, per-row identity fields, row payload and extras)
#: and the per-row identity cost at the default ~6-char client ids
#: (pickled client string ≈ id + 7 framing bytes, seq/wal small ints).
#: Pinned within tolerance by the JAX package's sharded-serving tests.
_PARTIAL_FOLD_ENVELOPE_BYTES = 310
_PARTIAL_FOLD_ROW_FRAMING_BYTES = 7
#: Measured envelope of the root's merge-result broadcast frame.
_MERGE_BROADCAST_ENVELOPE_BYTES = 229


def partial_fold_bytes(
    m: int,
    n_params: int,
    *,
    signed: bool = False,
    extras_bytes: float = 0.0,
    client_id_bytes: int = 6,
    dtype_bytes: int = 4,
    envelope_bytes: Optional[int] = None,
) -> float:
    """Analytic wire bytes of ONE shard's ``PartialFold`` frame on the shard→root hop (the JAX package's ``serving.sharded``; not ported): the
    4-byte length prefix, the 32-byte HMAC tag when ``signed``, the
    frame envelope, ``m`` per-row identities (client id + seq + wal id
    pickle framing), the ``m · n_params`` float32 row payload — ALWAYS
    lossless: the rows' exact bits are load-bearing (digest cross-check
    + the hierarchical fold's bit-parity contract), so the submit
    fabric's ``BYZPY_TPU_WIRE_PRECISION`` compression never applies to
    this hop — and the family's streaming-accumulator ``extras_bytes``
    (trimmed mean ``(2f+1)·d·4``; Multi-Krum ``m²·4`` Gram block; CGE
    ``m·4`` norms; 0 for families without extras)."""
    per_row = client_id_bytes + _PARTIAL_FOLD_ROW_FRAMING_BYTES
    if envelope_bytes is None:
        envelope_bytes = _PARTIAL_FOLD_ENVELOPE_BYTES
    return (
        4
        + (32 if signed else 0)
        + envelope_bytes
        + m * per_row
        + m * n_params * dtype_bytes
        + extras_bytes
    )


def sharded_round_wire_bytes(
    n_shards: int,
    n_clients_round: int,
    n_params: int,
    *,
    precision: str = "off",
    signed: bool = False,
    quant_block: int = 256,
    extras_bytes_per_shard: float = 0.0,
    client_id_bytes: int = 6,
    dtype_bytes: int = 4,
) -> float:
    """Closed-form per-ROUND wire bytes of the sharded frontend tier
    (the JAX package's ``serving.sharded``; not ported), three hops:

    * **client → home shard**: ``n_clients_round`` submit frames, each
      priced by :func:`serving_ingress_bytes` (the ingress law — this hop
      rides the compressed fabric when configured);
    * **shard → root**: one :func:`partial_fold_bytes` frame per shard
      carrying its ``n_clients_round / n_shards`` rows LOSSLESS (the
      bit-parity hop; the aggregate per-round row payload is the same
      ``n · d · 4`` the single frontend would fold — sharding moves it
      across a wire once, it does not multiply it);
    * **root → shard**: the merge-result broadcast, one lossless
      ``(d,)`` aggregate frame per shard.

    Sub-laws are exposed separately."""
    submits = n_clients_round * serving_ingress_bytes(
        n_params,
        precision=precision,
        signed=signed,
        quant_block=quant_block,
        dtype_bytes=dtype_bytes,
    )
    per_shard_m = n_clients_round / max(n_shards, 1)
    partials = n_shards * partial_fold_bytes(
        per_shard_m,
        n_params,
        signed=signed,
        extras_bytes=extras_bytes_per_shard,
        client_id_bytes=client_id_bytes,
        dtype_bytes=dtype_bytes,
    )
    broadcast = n_shards * (
        4
        + (32 if signed else 0)
        + _MERGE_BROADCAST_ENVELOPE_BYTES
        + n_params * dtype_bytes
    )
    return submits + partials + broadcast


#: Measured per-segment pickle framing of a combined PartialFold's
#: ``segments`` list (one ``[shard, m]`` pair ≈ two small ints + list
#: envelope). Pinned alongside the partial-fold law.
_MERGE_SEGMENT_BYTES = 10


def merge_tree_wire_bytes(
    n_shards: int,
    fanout: Optional[int],
    n_clients_round: int,
    n_params: int,
    *,
    signed: bool = False,
    extras_bytes_per_row: float = 0.0,
    client_id_bytes: int = 6,
    dtype_bytes: int = 4,
) -> float:
    """Closed-form per-round bytes of the depth-N merge tree's FOLD
    hops (``serving.runner`` / ``MergeTopology``): at every tree level
    the partial-fold row payload crosses a wire once more — level 0
    ships ``n_shards`` flat frames (the flat shard→root hop), each
    internal level re-ships the combined rows up in fewer, larger
    frames (plus per-segment framing). ``fanout=None`` degenerates to
    the flat single-hop law, so
    ``sharded_round_wire_bytes(...) - flat fold hop + this`` prices a
    deep deployment. The per-row identity and extras costs repeat per
    level too (a combined frame carries its leaves' client ids and the
    family's recomputed accumulators).

    The structural point the law makes explicit: depth multiplies FOLD
    wire bytes by the level count while dividing the per-node frame
    COUNT — the trade pays when the root's verify+merge CPU, not the
    fabric, is the bottleneck."""
    levels = _merge_levels(n_shards, fanout)
    per_shard_m = n_clients_round / max(n_shards, 1)

    def frame(m_rows: float, segments: int) -> float:
        return partial_fold_bytes(
            m_rows,
            n_params,
            signed=signed,
            extras_bytes=extras_bytes_per_row * m_rows,
            client_id_bytes=client_id_bytes,
            dtype_bytes=dtype_bytes,
        ) + segments * _MERGE_SEGMENT_BYTES

    total = n_shards * frame(per_shard_m, 1)
    for level in levels:
        for group in level:
            total += frame(per_shard_m * len(group), len(group))
    return total


def scaling_model(
    *,
    flops_per_chip: float,
    wire_bytes_fn: Callable[[int], float],
    chip_flops: float = 989e12,  # H100 SXM dense bf16 peak (data sheet)
    ici_bytes_per_s: float = 4.5e11,  # H100 SXM NVLink: 450 GB/s per direction
    chips: Sequence[int] = (8, 16, 32, 64, 128),
    mfu: float = 0.4,
    precision: str = "off",
    quant_block: int = 256,
) -> List[ScalingPoint]:
    """Analytic weak-scaling table: per-chip compute stays constant
    (``flops_per_chip`` at ``mfu`` of peak), per-chip wire bytes follow
    ``wire_bytes_fn(n_chips)`` (use :func:`collective_traffic` at a small
    mesh and the collectives' (g-1)/g laws to extrapolate), and the link
    runs at ``ici_bytes_per_s``. Effiency ≥ target iff comm stays hidden
    under compute / (1 - target).

    ``precision`` extends the model to the compressed fabrics:
    ``wire_bytes_fn`` keeps describing the FULL-precision (f32) traffic
    and the comm term is scaled by :func:`compression_factor` — so one
    measured byte inventory predicts all three wire modes."""
    factor = compression_factor(precision, block=quant_block)
    points = []
    for n in chips:
        compute_s = flops_per_chip / (chip_flops * mfu)
        comm_s = wire_bytes_fn(n) * factor / ici_bytes_per_s
        points.append(ScalingPoint(n, compute_s, comm_s))
    return points


__all__ = [
    "CollectiveOp",
    "collective_traffic",
    "ScalingPoint",
    "compression_factor",
    "measured_opt_state_bytes",
    "merge_tree_wire_bytes",
    "opt_state_bytes",
    "partial_fold_bytes",
    "ps_round_wire_bytes",
    "scaling_model",
    "serving_ingress_bytes",
    "sharded_round_wire_bytes",
]
