"""Length-prefixed binary frames over asyncio streams, and the compressed
wire rows the serving tier's quantized cohorts read.

Counterpart of ``byzpy_tpu/engine/actor/wire.py``. A frame is a 4-byte
big-endian length followed by a ``pickle`` body. Tensors cross as host
tensors (:func:`host_view`): bulk tensor movement between cards never
goes through this wire.

The body is the standard library's ``pickle``, where the reference uses
cloudpickle: a callable crosses only if it pickles by reference (a
module-level function, a class, a ``functools.partial`` of one). Anything
else (a lambda, a nested function, a bound method of an unpicklable
object) raises a ``TypeError`` that names it.

.. warning:: **Trusted networks only.** Anyone who can reach the socket
   can execute code in the receiving process through a pickle. Bind
   servers to loopback or a private, firewalled fabric. Setting
   ``BYZPY_TPU_TORCH_WIRE_KEY`` (a shared secret, the same on every host)
   prepends an HMAC-SHA256 tag to every frame and refuses unsigned or
   forged ones. Signing authenticates the sender; it does not encrypt.

Compressed frames (``BYZPY_TPU_TORCH_WIRE_PRECISION``: ``bf16``,
``int8``, ``fp8``, ``fp8_e5m2``, ``s4``; ``BYZPY_TPU_TORCH_WIRE_BLOCK``
the block width, 256 by default) swap large finite float tensors for
:class:`QuantizedWireArray` envelopes: codes and per-block f32 scales,
computed on the host with the arithmetic of the reference's numpy codecs
(``_np_blockwise_encode``, ``_np_blockwise_decode``, ``_np_to_bf16``), bit
for bit. fp8 codes are torch's ``float8_e4m3fn`` / ``float8_e5m2`` casts
(round to nearest even from f32, as ``ml_dtypes``' are).
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import hmac
import os
import pickle
import struct
import warnings
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ...observability import metrics as _obs_metrics
from ...observability import runtime as _obs_runtime
from ...observability import tracing as _obs_tracing
from ...ops import codec_kernels as ck

_HEADER = struct.Struct(">I")
MAX_FRAME = 1 << 31
_SIG_LEN = hashlib.sha256().digest_size
_KEY_ENV = "BYZPY_TPU_TORCH_WIRE_KEY"
_WIRE_PRECISION_ENV = "BYZPY_TPU_TORCH_WIRE_PRECISION"
_WIRE_BLOCK_ENV = "BYZPY_TPU_TORCH_WIRE_BLOCK"
#: Every lossy wire mode, and the blockwise subset whose frames carry
#: per-block scale headers (pre-decode forensics apply to these).
WIRE_MODES = ("bf16", "int8", "fp8", "fp8_e5m2", "s4")
BLOCKWISE_WIRE_MODES = ("int8", "fp8", "fp8_e5m2", "s4")
#: Per-mode code maximum in the scaled domain: an honest blockwise encoder
#: maps each block's absmax to exactly this code magnitude, so the
#: pre-decode inflation ratio qmax / max|code| of every nonzero block is 1.0.
_WIRE_QMAX = {"int8": 127.0, "s4": 7.0, "fp8": 448.0, "fp8_e5m2": 57344.0}
#: Tensors below this element count always travel lossless.
WIRE_QUANT_MIN_SIZE = 1024
_WIRE_DEFAULT_BLOCK = 256
_F8 = {"fp8": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


def _wire_key() -> Optional[bytes]:
    key = os.environ.get(_KEY_ENV)
    return key.encode() if key else None


#: Keyed HMAC bases, one per key seen: cloning a keyed base skips the two
#: block compressions that absorb the padded key on every frame.
_HMAC_BASE: dict = {}


def _hmac_base(key: bytes) -> "hmac.HMAC":
    base = _HMAC_BASE.get(key)
    if base is None:
        if len(_HMAC_BASE) > 8:
            _HMAC_BASE.clear()
        base = _HMAC_BASE[key] = hmac.new(key, b"", hashlib.sha256)
    return base


def _sign(body, key: bytes) -> bytes:
    mac = _hmac_base(key).copy()
    mac.update(body)
    return mac.digest()


_LOOPBACK = {"127.0.0.1", "::1", "localhost"}  # "" binds every interface


def warn_untrusted_bind(host: str, component: str) -> None:
    """A ``RuntimeWarning`` when a pickle control-plane server binds beyond
    loopback, where decoding frames means code execution for anyone who
    can reach the port."""
    if host not in _LOOPBACK:
        warnings.warn(
            f"{component} binding to {host!r}: the control-plane wire "
            "decodes pickle frames, which allows arbitrary code execution by "
            "anyone able to reach this socket. Use only on trusted, "
            "firewalled networks (or keep to loopback).",
            RuntimeWarning,
            stacklevel=3,
        )


def wire_precision() -> str:
    """The ``BYZPY_TPU_TORCH_WIRE_PRECISION`` policy: ``"off"`` (default)
    or one of :data:`WIRE_MODES`; an unknown value reads as ``"off"``."""
    mode = os.environ.get(_WIRE_PRECISION_ENV, "off").lower()
    return mode if mode in WIRE_MODES else "off"


def _wire_block() -> int:
    try:
        block = int(os.environ.get(_WIRE_BLOCK_ENV, _WIRE_DEFAULT_BLOCK))
    except ValueError:
        return _WIRE_DEFAULT_BLOCK
    return block if block > 0 else _WIRE_DEFAULT_BLOCK


@dataclasses.dataclass(frozen=True)
class QuantizedWireArray:
    """One compressed tensor inside a wire frame: ``codes`` (int8 for
    ``int8``, int16 bf16 bit patterns for ``bf16``, uint8 fp8 bit patterns
    for ``fp8``/``fp8_e5m2``, block-padded packed nibbles for ``s4``), the
    per-block f32 ``scales`` (``None`` for bf16), the ``block`` width, the
    source ``shape`` and torch ``dtype`` name. It pickles with the rest of
    the payload, so the frame's HMAC covers codes and scales."""

    mode: str
    codes: torch.Tensor
    scales: Optional[torch.Tensor]
    block: int
    shape: Tuple[int, ...]
    dtype: str


def _dtype_of(name: str) -> torch.dtype:
    dtype = getattr(torch, str(name).removeprefix("torch."), None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"unknown torch dtype {name!r}")
    return dtype


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def flat_size(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


# ---------------------------------------------------------------------------
# The host codecs (the reference's numpy codecs, bit for bit)
# ---------------------------------------------------------------------------


def _blocks(t: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """``t`` flattened to f32 and zero-padded to ``(nb, block)``."""
    flat = t.detach().reshape(-1).to(torch.float32)
    n = flat.numel()
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nb, block), n


def _blockwise_encode(t: torch.Tensor, block: int, mode: str) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Blockwise encode of the flattened tensor: ``(codes, scales,
    finite)``; ``finite=False`` (a block's absmax is inf or NaN) means the
    frame must travel lossless. Codes are int8 for ``int8``, uint8 fp8
    bit patterns for ``fp8``/``fp8_e5m2``, block-padded packed nibbles
    (two codes a byte) for ``s4``."""
    xb, n = _blocks(t, block)
    absmax = xb.abs().amax(dim=1)  # keeps inf and NaN
    finite = bool(torch.isfinite(absmax).all())
    qmax = _WIRE_QMAX[mode]
    scales = torch.where(absmax > 0, absmax / qmax, torch.ones((), dtype=torch.float32))
    y = xb / scales[:, None]
    if not finite:
        y = torch.nan_to_num(y)  # the codes are never used: keep the casts defined
    if mode == "int8":
        codes = torch.clamp(torch.round(y), -127, 127).to(torch.int8).reshape(-1)[:n]
    elif mode == "s4":
        nib = (torch.clamp(torch.round(y), -7, 7).to(torch.int16) + 8).to(torch.uint8).reshape(-1)
        codes = nib[0::2] | (nib[1::2] << 4)  # padded: nb * block / 2 bytes
    else:
        codes = torch.clamp(y, -qmax, qmax).to(_F8[mode]).view(torch.uint8).reshape(-1)[:n]
    return codes, scales, finite


def _code_values_f32(codes: torch.Tensor, mode: str) -> torch.Tensor:
    """One frame's f32 code values before the per-block scales: s4 nibbles
    unpacked and recentred (``nibble - 8``), fp8 bit patterns reinterpreted
    (non-finite patterns stay non-finite), int8 codes cast."""
    return _rows_code_values(codes.reshape(1, -1), mode)[0]


def _dequant_values(values: torch.Tensor, scales: torch.Tensor, block: int, shape,
                    dtype) -> torch.Tensor:
    """Pad the f32 code values to whole blocks, apply the per-block scales,
    trim and reshape."""
    nb = scales.numel()
    n = flat_size(shape)
    pad = nb * block - values.numel()
    if pad > 0:
        values = torch.cat([values, values.new_zeros(pad)])
    out = (values.reshape(nb, block) * scales.reshape(nb, 1)).reshape(-1)[:n]
    return out.to(_dtype_of(dtype)).reshape(tuple(shape))


def _blockwise_decode(codes, scales, block: int, shape, dtype, mode: str) -> torch.Tensor:
    """Inverse of :func:`_blockwise_encode` (lossy)."""
    return _dequant_values(_code_values_f32(codes, mode), scales, block, shape, dtype)


def _to_bf16(t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """f32 -> bf16 bit patterns (int16) rounded to nearest even; ``False``
    when the frame must travel lossless: a non-finite input (checked on
    the source exponent bits) or a finite value that overflows bf16."""
    x = t.detach().to(torch.float32).contiguous()
    u = x.view(torch.int32)
    nonfinite_in = bool(((u & 0x7F800000) == 0x7F800000).any())
    codes = x.to(torch.bfloat16).view(torch.int16)
    overflow_out = bool(((codes & 0x7F80) == 0x7F80).any())
    return codes, not (nonfinite_in or overflow_out)


def _from_bf16(codes: torch.Tensor, shape, dtype) -> torch.Tensor:
    return codes.view(torch.bfloat16).to(torch.float32).to(_dtype_of(dtype)).reshape(tuple(shape))


def _quantizable(x: Any, min_size: int) -> bool:
    # lossless for what the blockwise codec cannot carry faithfully enough:
    # non-float dtypes, small tensors, anything off the host
    return (
        isinstance(x, torch.Tensor)
        and x.device.type == "cpu"
        and x.is_floating_point()
        and x.element_size() >= 4
        and x.numel() >= min_size
    )


def _map_payload_leaves(leaf_fn, obj: Any) -> Any:
    """Copy-on-write recursion over the payload containers (dataclasses,
    dicts, tuples / namedtuples, lists): ``leaf_fn`` maps a leaf to its
    replacement or returns it as it is. Untouched subtrees come back
    as they are; a :class:`QuantizedWireArray` is atomic."""

    def walk(x: Any) -> Any:
        out = leaf_fn(x)
        if out is not x:
            return out
        if isinstance(x, QuantizedWireArray):
            return x
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            new = {f.name: walk(getattr(x, f.name)) for f in dataclasses.fields(x)}
            if all(new[f.name] is getattr(x, f.name) for f in dataclasses.fields(x)):
                return x
            return dataclasses.replace(x, **new)
        if isinstance(x, dict):
            new = {k: walk(v) for k, v in x.items()}
            if all(new[k] is v for k, v in x.items()):
                return x
            return new
        if isinstance(x, (tuple, list)):
            vals = [walk(v) for v in x]
            if all(a is b for a, b in zip(vals, x, strict=True)):
                return x
            if isinstance(x, list):
                return vals
            if hasattr(x, "_fields"):
                return type(x)(*vals)
            return tuple(vals)
        return x

    return walk(obj)


def compress_payload(obj: Any, mode: str, *, block: Optional[int] = None,
                     min_size: int = WIRE_QUANT_MIN_SIZE) -> Any:
    """Swap large finite float host tensors in a payload tree for
    :class:`QuantizedWireArray` frames (``mode`` one of
    :data:`WIRE_MODES`; anything else returns ``obj`` as it is). Non-float,
    small and non-finite tensors pass through lossless, so attack vectors
    arrive verbatim."""
    if mode not in WIRE_MODES:
        return obj
    if type(obj) is dict and not any(
        isinstance(v, (torch.Tensor, QuantizedWireArray, dict, list, tuple))
        or dataclasses.is_dataclass(v)
        for v in obj.values()
    ):
        return obj  # a scalar-only frame (acks, control)
    block = block or _wire_block()

    def leaf(x: Any) -> Any:
        if isinstance(x, QuantizedWireArray) or not _quantizable(x, min_size):
            return x
        dtype = _dtype_name(x.dtype)
        if mode == "bf16":
            codes, ok = _to_bf16(x)
            return QuantizedWireArray("bf16", codes, None, block, tuple(x.shape), dtype) if ok else x
        codes, scales, finite = _blockwise_encode(x, block, mode)
        if not finite:
            return x
        return QuantizedWireArray(mode, codes, scales, block, tuple(x.shape), dtype)

    return _map_payload_leaves(leaf, obj)


def decompress_payload(obj: Any) -> Any:
    """Inverse of :func:`compress_payload`: every
    :class:`QuantizedWireArray` becomes a (lossy) tensor again."""

    def leaf(x: Any) -> Any:
        if isinstance(x, QuantizedWireArray):
            if x.mode == "bf16":
                return _from_bf16(x.codes, x.shape, x.dtype)
            return _blockwise_decode(x.codes, x.scales, x.block, x.shape, x.dtype, x.mode)
        return x

    return _map_payload_leaves(leaf, obj)


def frame_inflation(qwa: QuantizedWireArray, *, _values: Optional[torch.Tensor] = None
                    ) -> Optional[float]:
    """PRE-decode per-block inflation ratio of one blockwise frame: ``max
    over nonzero blocks of qmax / max|code|``.

    An honest blockwise encoder maps each block's absmax to exactly the
    code maximum (127 / 7 / the fp8 format max), so every nonzero block's
    ratio is 1.0; a residual-shaping client inflates its scales and its
    codes stay under qmax. Computed from the codes alone; ``None`` for
    frames without a scale header (bf16), 1.0 for all-zero payloads. An s4
    nibble 0 (-8, outside the honest encoder's [-7, 7]) is clamped to 7
    so that it cannot fake extra magnitude; a non-finite fp8 pattern
    counts as qmax."""
    if qwa.mode not in BLOCKWISE_WIRE_MODES or qwa.scales is None:
        return None
    qmax = _WIRE_QMAX[qwa.mode]
    block = qwa.block
    vals = _values if _values is not None else _code_values_f32(qwa.codes, qwa.mode)
    if qwa.mode == "s4":
        mags = torch.clamp_max(vals.abs(), qmax)
    elif qwa.mode == "int8":
        mags = vals.abs()
    else:
        mags = torch.clamp_max(torch.where(torch.isfinite(vals), vals, qmax).abs(), qmax)
    n = mags.numel()
    nb = qwa.scales.numel()
    pad = nb * block - n
    if pad > 0:
        mags = torch.cat([mags, mags.new_zeros(pad)])
    blockmax = mags[: nb * block].reshape(nb, block).amax(dim=1)
    nonzero = blockmax > 0
    if not bool(nonzero.any()):
        return 1.0
    # numpy's f32 scalar, so the division rounds as the reference's does
    return float(qmax / blockmax[nonzero].min().cpu().numpy().astype(np.float32))


def payload_block_stats(obj: Any) -> Optional[dict]:
    """Pre-decode wire forensics over a still-compressed payload: the worst
    :func:`frame_inflation` across every blockwise frame in the tree
    (``None`` when it carries none)."""
    worst: Optional[float] = None
    frames = 0

    def leaf(x: Any) -> Any:
        nonlocal worst, frames
        if isinstance(x, QuantizedWireArray):
            infl = frame_inflation(x)
            if infl is not None:
                frames += 1
                worst = infl if worst is None else max(worst, infl)
        return x

    _map_payload_leaves(leaf, obj)
    if worst is None:
        return None
    return {"max_inflation": worst, "frames": frames}


def _decompress_with_stats(raw: Any) -> Tuple[Any, Optional[dict]]:
    """:func:`payload_block_stats` and :func:`decompress_payload` in one
    walk, each frame's codes converted to f32 once."""
    worst: Optional[float] = None
    frames = 0

    def leaf(x: Any) -> Any:
        nonlocal worst, frames
        if not isinstance(x, QuantizedWireArray):
            return x
        if x.mode == "bf16":
            return _from_bf16(x.codes, x.shape, x.dtype)
        values = _code_values_f32(x.codes, x.mode)
        infl = frame_inflation(x, _values=values)
        if infl is not None:
            frames += 1
            worst = infl if worst is None else max(worst, infl)
        return _dequant_values(values, x.scales, x.block, x.shape, x.dtype)

    obj = _map_payload_leaves(leaf, raw)
    return obj, (None if worst is None else {"max_inflation": worst, "frames": frames})


def _rows_code_values(codes: torch.Tensor, mode: str) -> torch.Tensor:
    """``(R, nvals)`` f32 code values before scaling: s4 nibbles unpacked
    and recentred, fp8 bit patterns reinterpreted (non-finite patterns
    stay non-finite), int8 codes cast."""
    if mode == "s4":
        return ck.s4_values(ck.from_wire(codes, mode))
    if mode not in ("int8", *ck.FP8_FORMATS):
        raise ValueError(f"no wire row codec for mode {mode!r}")
    return ck.from_wire(codes, mode).float()


def decode_rows_np(codes, scales, *, mode: str, block: int, d: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``R`` stacked ``(d,)`` frames decoded at once on the host (the
    reference's ``decode_rows_np``): ``codes`` ``(R, ncodes)``, ``scales``
    ``(R, nb)`` f32; each output row is its frame's per-frame decode, bit
    for bit. ``parallel.quantization.dequantize_rows`` is the device form."""
    codes = torch.as_tensor(codes)
    scales = torch.as_tensor(scales)
    rows, nb = scales.shape
    flat = _rows_code_values(codes, mode)
    pad = nb * block - flat.shape[1]
    if pad > 0:
        flat = torch.cat([flat, flat.new_zeros((rows, pad))], dim=1)
    out = (flat.reshape(rows, nb, block) * scales[:, :, None]).reshape(rows, -1)[:, :d]
    return out.contiguous().to(dtype)


def rows_code_absmax(codes: torch.Tensor, *, mode: str, block: int, nb: int) -> torch.Tensor:
    """``(R, nb)`` f32: each block's largest code magnitude, unclamped (a
    hostile s4 nibble 0 reports 8, a non-finite fp8 pattern propagates).
    ``isfinite(absmax * scales)`` then says whether every decoded value is
    finite: an IEEE product is monotone in magnitude."""
    mags = _rows_code_values(codes, mode).abs()
    rows = mags.shape[0]
    pad = nb * block - mags.shape[1]
    if pad > 0:
        mags = torch.cat([mags, mags.new_zeros((rows, pad))], dim=1)
    return mags[:, :nb * block].reshape(rows, nb, block).amax(dim=2)


def ef_precompensate(
    arr: torch.Tensor,
    residual: Optional[torch.Tensor],
    mode: Optional[str] = None,
    *,
    block: Optional[int] = None,
    min_size: int = WIRE_QUANT_MIN_SIZE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Client-side error feedback for the lossy wire: fold the previous
    frame's quantization residual into ``arr`` and return ``(compensated,
    new_residual)``. The wire's own blockwise encode of ``compensated``
    then reproduces the encoding measured here, so ``new_residual`` is the
    error the receiver will see. Frames the wire ships lossless deliver
    the compensation exactly (residual 0). ``mode=None`` reads
    ``BYZPY_TPU_TORCH_WIRE_PRECISION``."""
    mode = wire_precision() if mode is None else mode
    arr = host_view(arr).to(torch.float32).contiguous()
    comp = arr if residual is None else arr + residual.to(torch.float32)
    zero = torch.zeros_like(comp)
    if mode not in BLOCKWISE_WIRE_MODES or not _quantizable(comp, min_size):
        return comp, zero
    block = block or _wire_block()
    codes, scales, finite = _blockwise_encode(comp, block, mode)
    if not finite:
        return comp, zero
    dec = _blockwise_decode(codes, scales, block, comp.shape, "float32", mode)
    return comp, comp - dec


#: (frames, bytes) counter pairs per direction, resolved once
_FRAME_COUNTER_CACHE: dict = {}


def _frame_counters(direction: str, nbytes: int) -> None:
    """Publish one wire frame into the process registry (telemetry on)."""
    pair = _FRAME_COUNTER_CACHE.get(direction)
    if pair is None:
        reg = _obs_metrics.registry()
        labels = {"direction": direction}
        pair = _FRAME_COUNTER_CACHE[direction] = (
            reg.counter("byzpy_wire_frames_total",
                        help="actor-wire frames encoded (tx) / decoded (rx)", labels=labels),
            reg.counter("byzpy_wire_bytes_total",
                        help="actor-wire frame bytes incl. length prefix and HMAC tag",
                        labels=labels),
        )
    frames, nbytes_counter = pair
    frames.inc()
    nbytes_counter.inc(nbytes)


#: Reserved frame key carrying the sender's ``(trace_id, span_id)``
#: across the boundary (dict frames only; popped on decode).
TRACE_CTX_KEY = "_trace_ctx"


def dumps(obj: Any) -> bytes:
    """``pickle.dumps`` of a frame body or a pipe message; a payload that
    does not pickle by reference raises a ``TypeError`` that names it."""
    try:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    except (pickle.PicklingError, AttributeError, TypeError) as exc:
        raise TypeError(
            f"cannot send this payload over the wire: {exc}. The wire pickles "
            "with the standard library: a callable crosses only by reference "
            "(a module-level function, a class, a functools.partial of one)"
        ) from exc


def encode(obj: Any, *, precision: Optional[str] = None) -> bytes:
    """Pickle ``obj`` into a length-prefixed (optionally HMAC-signed) frame.
    With ``BYZPY_TPU_TORCH_WIRE_PRECISION`` set, large finite float host
    tensors ship as compressed frames; the HMAC signs the whole body.
    ``precision`` overrides the policy for this frame (``"off"`` forces
    lossless). With telemetry on and a span open, a dict frame carries the
    sender's trace context under :data:`TRACE_CTX_KEY`."""
    mode = wire_precision() if precision is None else (
        precision if precision in WIRE_MODES else "off")
    if _obs_runtime.STATE.enabled and type(obj) is dict:
        ctx = _obs_tracing.wire_context()
        if ctx is not None and TRACE_CTX_KEY not in obj:
            obj = {**obj, TRACE_CTX_KEY: (ctx[0], ctx[1])}
    body = dumps(compress_payload(obj, mode))
    key = _wire_key()
    if key is not None:
        body = _sign(body, key) + body
    if _obs_runtime.STATE.enabled:
        _frame_counters("tx", _HEADER.size + len(body))
    return _HEADER.pack(len(body)) + body


def decode(body: bytes) -> Any:
    """Inverse of :func:`encode`: verify the HMAC when a key is set, then
    expand the compressed frames (a tampered code or scale byte fails
    verification before any decode). A trace stamp is popped and, with
    telemetry on, adopted as this task's trace position."""
    return _decode_impl(body, want_stats=False)[0]


def decode_with_stats(body: bytes) -> Tuple[Any, Optional[dict]]:
    """:func:`decode` plus the frame's PRE-decode
    :func:`payload_block_stats`, taken after the HMAC check."""
    return _decode_impl(body, want_stats=True)


def _verify(body, key: bytes, base=None):
    if len(body) < _SIG_LEN:
        raise ValueError("frame too short to carry an HMAC signature")
    sig, payload = body[:_SIG_LEN], body[_SIG_LEN:]
    if base is None:
        digest = _sign(payload, key)
    else:
        mac = base.copy()
        mac.update(payload)
        digest = mac.digest()
    if not hmac.compare_digest(bytes(sig), digest):
        raise ValueError(f"frame HMAC verification failed: wrong {_KEY_ENV} "
                         "or tampered/unsigned frame")
    return payload


def _decode_impl(body: bytes, *, want_stats: bool) -> Tuple[Any, Optional[dict]]:
    if _obs_runtime.STATE.enabled:
        _frame_counters("rx", _HEADER.size + len(body))
    key = _wire_key()
    if key is not None:
        body = _verify(body, key)
    raw = pickle.loads(body)
    if want_stats:
        obj, stats = _decompress_with_stats(raw)
    else:
        obj, stats = decompress_payload(raw), None
    if type(obj) is dict and TRACE_CTX_KEY in obj:
        ctx = obj.pop(TRACE_CTX_KEY)
        if _obs_runtime.STATE.enabled:
            _obs_tracing.adopt_context(ctx)
    return obj, stats


@dataclasses.dataclass
class DecodedFrame:
    """One :func:`decode_batch` result: the decoded payload and its
    pre-decode stats, or the exception the frame's verify / decode raised,
    with its popped trace stamp."""

    obj: Any = None
    stats: Optional[dict] = None
    error: Optional[BaseException] = None
    trace_ctx: Optional[Any] = None


def _qwa_group_key(q: QuantizedWireArray):
    codes, scales = q.codes, q.scales
    return (q.mode, q.block, codes.numel() if isinstance(codes, torch.Tensor) else -1,
            str(getattr(codes, "dtype", "?")),
            -1 if scales is None else getattr(scales, "numel", lambda: -1)())


def _qwa_honest_layout(q: QuantizedWireArray) -> bool:
    """True when the frame has exactly the layout the honest encoder
    emits, the precondition of the row-batched decode; anything else takes
    the per-frame codec, so a hostile frame fails or passes as it would
    alone."""
    try:
        n = flat_size(q.shape)
        codes = q.codes
        if not isinstance(codes, torch.Tensor):
            return False
        if q.mode == "bf16":
            return q.scales is None and codes.numel() == n
        scales = q.scales
        if not isinstance(scales, torch.Tensor) or q.block <= 0:
            return False
        nb = -(-n // q.block)
        if scales.numel() != nb:
            return False
        if q.mode == "s4":
            return codes.numel() * 2 == nb * q.block
        return codes.numel() == n
    except Exception:  # noqa: BLE001 - a hostile frame
        return False


def _batch_inflations(group: list) -> list:
    """:func:`frame_inflation` of a group of same-layout blockwise frames
    in one pass over the stacked codes (each frame's value as alone)."""
    q0 = group[0]
    qmax = _WIRE_QMAX[q0.mode]
    block = q0.block
    nb = q0.scales.numel()
    vals = _rows_code_values(torch.stack([q.codes.reshape(-1) for q in group]), q0.mode)
    if q0.mode == "s4":
        mags = torch.clamp_max(vals.abs(), qmax)
    elif q0.mode == "int8":
        mags = vals.abs()
    else:
        mags = torch.clamp_max(torch.where(torch.isfinite(vals), vals, qmax).abs(), qmax)
    pad = nb * block - mags.shape[1]
    if pad > 0:
        mags = torch.cat([mags, mags.new_zeros((len(group), pad))], dim=1)
    blockmax = mags[:, : nb * block].reshape(len(group), nb, block).amax(dim=2)
    mins = torch.where(blockmax > 0, blockmax, float("inf")).amin(dim=1).numpy()
    return [1.0 if not np.isfinite(mn) else float(qmax / mn) for mn in mins]


def _batch_decode_group(group: list) -> list:
    """The per-frame decode of a group of same-layout frames in one pass."""
    q0 = group[0]
    codes = torch.stack([q.codes.reshape(-1) for q in group])
    if q0.mode == "bf16":
        flat = codes.view(torch.bfloat16).to(torch.float32)
        return [flat[i].to(_dtype_of(q.dtype)).reshape(tuple(q.shape)) for i, q in enumerate(group)]
    scales = torch.stack([q.scales.reshape(-1) for q in group])
    rows = decode_rows_np(codes, scales, mode=q0.mode, block=q0.block, d=flat_size(q0.shape))
    return [rows[i].to(_dtype_of(q.dtype)).reshape(tuple(q.shape)) for i, q in enumerate(group)]


def decode_batch(bodies: Sequence, *, keep_quantized: bool = False) -> list:
    """:func:`decode_with_stats` over many frame bodies (length prefixes
    stripped): the HMAC rides a cloned keyed base, and the codecs and the
    pre-decode forensics run once over every same-layout compressed tensor
    of the batch. Each result equals the per-frame call's; frames that do
    not group take the per-frame codec in the same call.

    ``keep_quantized=True`` leaves a dict frame's top-level ``"gradient"``
    :class:`QuantizedWireArray` compressed when it is a well-formed 1-D
    blockwise float frame (its stats are still computed), for a decode on
    the device. Returns :class:`DecodedFrame`s, cut after the first error
    slot (the per-frame door drops a peer at its first bad frame). The
    first stamped frame's trace context is adopted for the batch; every
    stamp is popped."""
    telemetry = _obs_runtime.STATE.enabled
    key = _wire_key()
    base = _hmac_base(key) if key is not None else None
    out: list = []
    raws: list = []
    for body in bodies:
        if telemetry:
            _frame_counters("rx", _HEADER.size + len(body))
        try:
            payload = body if key is None else _verify(body, key, base)
            raw = pickle.loads(payload)
        except Exception as exc:  # noqa: BLE001 - a per-frame error slot
            out.append(DecodedFrame(error=exc))
            return out
        raws.append(raw)
        out.append(DecodedFrame(obj=raw))

    per_frame: list = []
    groups: dict = {}
    for raw in raws:
        qwas: list = []

        def collect(x, _q=qwas):
            if isinstance(x, QuantizedWireArray):
                _q.append(x)
            return x

        _map_payload_leaves(collect, raw)
        per_frame.append(qwas)
        for q in qwas:
            if _qwa_honest_layout(q):
                groups.setdefault(_qwa_group_key(q), []).append(q)

    infl: dict = {}
    dec: dict = {}
    keep: set = set()
    if keep_quantized:
        for raw in raws:
            g = raw.get("gradient") if type(raw) is dict else None
            if (isinstance(g, QuantizedWireArray) and g.mode in BLOCKWISE_WIRE_MODES
                    and len(g.shape) == 1 and _qwa_honest_layout(g)):
                try:
                    if _dtype_of(g.dtype).is_floating_point:
                        keep.add(id(g))
                except TypeError:
                    pass
    for gkey, group in groups.items():
        if gkey[0] in BLOCKWISE_WIRE_MODES:
            try:
                for q, r in zip(group, _batch_inflations(group)):
                    infl[id(q)] = r
            except Exception:  # noqa: BLE001 - per-frame fallback below
                pass
        to_decode = [q for q in group if id(q) not in keep]
        if not to_decode:
            continue
        try:
            for q, row in zip(to_decode, _batch_decode_group(to_decode)):
                dec[id(q)] = row
        except Exception:  # noqa: BLE001 - per-frame fallback below
            pass

    adopted = False
    for i, raw in enumerate(raws):
        qwas = per_frame[i]
        worst = None
        frames = 0
        try:
            for q in qwas:
                r = infl.get(id(q))
                if r is None:
                    r = frame_inflation(q)
                if r is not None:
                    frames += 1
                    worst = r if worst is None else max(worst, r)
            stats = None if worst is None else {"max_inflation": worst, "frames": frames}

            def leaf(x):
                if isinstance(x, QuantizedWireArray):
                    if id(x) in keep:
                        return x
                    row = dec.get(id(x))
                    if row is not None:
                        return row
                    if x.mode == "bf16":
                        return _from_bf16(x.codes, x.shape, x.dtype)
                    return _blockwise_decode(x.codes, x.scales, x.block, x.shape, x.dtype, x.mode)
                return x

            needs_map = any(id(q) not in keep for q in qwas)
            obj = _map_payload_leaves(leaf, raw) if needs_map else raw
        except Exception as exc:  # noqa: BLE001 - a per-frame error slot
            del out[i:]
            out.append(DecodedFrame(error=exc))
            return out
        ctx = None
        if type(obj) is dict and TRACE_CTX_KEY in obj:
            ctx = obj.pop(TRACE_CTX_KEY)
            if telemetry and not adopted:
                adopted = True
                _obs_tracing.adopt_context(ctx)
        out[i] = DecodedFrame(obj=obj, stats=stats, trace_ctx=ctx)
    return out


def host_view(obj: Any) -> Any:
    """The payload tree with every tensor off the host (a CUDA tensor)
    replaced by its host copy, before it crosses a process or network
    boundary. Dataclass envelopes are rebuilt field by field; dicts,
    lists, tuples and namedtuples are walked; a host tensor is returned
    as it is."""

    def conv(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return x.detach().cpu() if x.device.type != "cpu" else x
        return x

    def walk(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return conv(x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(
                x, **{f.name: walk(getattr(x, f.name)) for f in dataclasses.fields(x)
                      if f.init})
        if isinstance(x, dict):
            new = {k: walk(v) for k, v in x.items()}
            return new if type(x) is dict else type(x)(new)
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, tuple):
            vals = [walk(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return x

    return walk(obj)


async def send_obj(writer: asyncio.StreamWriter, obj: Any) -> None:
    """Write one encoded frame to the stream and drain."""
    writer.write(encode(obj))
    await writer.drain()


async def recv_obj(reader: asyncio.StreamReader) -> Any:
    """Read exactly one frame from the stream and decode it."""
    header = await reader.readexactly(_HEADER.size)
    (length,) = _HEADER.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    body = await reader.readexactly(length)
    return decode(body)


__all__ = [
    "BLOCKWISE_WIRE_MODES",
    "DecodedFrame",
    "QuantizedWireArray",
    "TRACE_CTX_KEY",
    "WIRE_MODES",
    "WIRE_QUANT_MIN_SIZE",
    "compress_payload",
    "decode",
    "decode_batch",
    "decode_rows_np",
    "decode_with_stats",
    "decompress_payload",
    "dumps",
    "ef_precompensate",
    "encode",
    "frame_inflation",
    "host_view",
    "payload_block_stats",
    "recv_obj",
    "rows_code_absmax",
    "send_obj",
    "warn_untrusted_bind",
    "wire_precision",
]
