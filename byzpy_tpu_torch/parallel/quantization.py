"""Blockwise quantization for the communication fabric.

Counterpart of ``byzpy_tpu/parallel/quantization.py``, with its names,
defaults, error contract and error messages:

* :class:`CommPrecision` — the ``off | bf16 | int8 | fp8 | fp8_e5m2 | s4``
  wire-precision switch plus the ``error_feedback`` flag, threaded
  through the PS round (:mod:`.ps`) and the gossip round (:mod:`.gossip`);
* :func:`quantize_blockwise` (int8, B13) and :func:`encode_blockwise`
  (int8 -> B13, fp8 / fp8_e5m2 -> B15, s4 -> B16): one f32 scale per
  ``block`` trailing-axis values, the codes in the input's shape (s4: two
  4-bit codes a byte over the block-padded trailing axis, ``orig_d`` the
  unpacked length);
* :func:`dequantize_blockwise` and :func:`dequantize_rows` (B14, int8
  codes or fp8 values; B17, packed s4);
* :func:`ef_encode` (error feedback) and :func:`quantization_error_bound`.

Dispatch goes by device: a CUDA tensor launches the kernels of
``ops/codec_kernels.py``, a CPU tensor takes their plain versions. The
reference's TPU knobs (``use_pallas``, ``tile``, ``interpret``, the
autotuned tile) have no counterpart. Stochastic rounding (int8 and s4)
is plain PyTorch on both devices, as it is XLA-only in the reference
(``use_pallas and not p.stochastic``); its uniform draws come from a
``torch.Generator`` (``generator=``) or are passed in (``u=``), since a
JAX ``key`` cannot be reproduced.

Error contract: round-to-nearest blockwise int8 reconstructs every value
within ``absmax(block) / 254``; stochastic rounding is unbiased.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import torch

from ..ops import codec_kernels as ck

#: Default trailing-axis block width: one f32 scale per 256 values.
DEFAULT_BLOCK = 256

_MODES = ("off", "bf16", "int8", "fp8", "fp8_e5m2", "s4")

#: The sub-int8 tier: fp8 at one byte per value with the block scale
#: centering the format's range, and 4-bit codes two to a byte.
SUB_INT8_MODES = ("fp8", "fp8_e5m2", "s4")

#: absmax divisor of the per-element worst-case reconstruction error of
#: each blockwise mode (the reference's table, :86-99): half a code step
#: for the integer codes; for fp8 the reference's divisors, which allow for
#: a double rounding through f16 that its f32 -> f8 convert no longer does
#: (the direct cast's bound, absmax / 28 and / 14, is tighter).
_ERROR_DIVISOR = {"int8": 254.0, "s4": 14.0, "fp8": 27.7, "fp8_e5m2": 13.9}


@dataclass(frozen=True)
class CommPrecision:
    """Wire-precision policy for one communication fabric.

    ``mode`` is ``"off"`` (f32 wire, bit-identical to the unquantized
    round), ``"bf16"`` (cast on send), ``"int8"`` (blockwise symmetric
    codes), ``"fp8"``/``"fp8_e5m2"`` (blockwise-scaled float8 e4m3fn /
    e5m2) or ``"s4"`` (4-bit codes, two a byte). ``block``
    is the trailing-axis quantization block; ``stochastic`` selects
    unbiased stochastic rounding (integer codes only; it needs a generator
    or explicit draws at the quantization site). ``error_feedback`` opts
    the fabric into per-round residual carry: the encoder adds the
    previous round's quantization residual to this round's payload and
    keeps the new residual beside the carried state.
    """

    mode: str = "off"
    block: int = DEFAULT_BLOCK
    stochastic: bool = False
    error_feedback: bool = False

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.block <= 0:
            raise ValueError(f"block must be positive, got {self.block}")
        if self.mode == "s4" and self.block % 2:
            raise ValueError(
                f"s4 packs two codes per byte: block must be even, "
                f"got {self.block}"
            )

    @property
    def enabled(self) -> bool:
        """True when any compression is active (mode != "off")."""
        return self.mode != "off"

    @property
    def blockwise(self) -> bool:
        """True for the blockwise-coded modes (codes + per-block scales
        ride the wire; bf16 is a bare cast)."""
        return self.mode in ("int8", *SUB_INT8_MODES)

    def wire_bytes_per_value(self, dtype_bytes: int = 4) -> float:
        """Effective wire bytes per transported value, the scale overhead
        amortized over the block."""
        if self.mode == "bf16":
            return 2.0
        if self.mode in ("int8", "fp8", "fp8_e5m2"):
            return 1.0 + 4.0 / self.block
        if self.mode == "s4":
            return 0.5 + 4.0 / self.block
        return float(dtype_bytes)

    def error_bound(self, absmax: float = 1.0) -> float:
        """Per-element worst-case round-to-nearest reconstruction error
        for a block of the given ``absmax``."""
        if self.mode in _ERROR_DIVISOR:
            return absmax / _ERROR_DIVISOR[self.mode]
        if self.mode == "bf16":
            return absmax * 2.0 ** -8
        return 0.0


def as_comm_precision(value: Union[CommPrecision, str, None]) -> CommPrecision:
    """Coerce a user-facing precision argument (``CommPrecision``, a mode
    string, or ``None``) into a :class:`CommPrecision`."""
    if value is None:
        return CommPrecision()
    if isinstance(value, CommPrecision):
        return value
    if isinstance(value, str):
        return CommPrecision(mode=value)
    raise TypeError(f"cannot interpret {value!r} as a CommPrecision")


@dataclass(frozen=True)
class QuantizedBlocks:
    """A blockwise-quantized tensor: coded ``values`` plus one f32 scale
    per ``block`` trailing-axis values (``scales.shape ==
    values.shape[:-1] + (n_blocks,)``). ``code`` is ``"int8"`` or
    ``"fp8"``/``"fp8_e5m2"`` (codes or fp8 values in the source tensor's
    shape) or ``"s4"`` (two 4-bit codes a uint8 byte: the trailing axis is
    half the block-padded source length, and ``orig_d`` records the
    unpacked trailing length so decode can trim the padding; ``-1`` for the
    unpacked codes). ``orig_dtype`` names the source dtype as the reference
    does (``"float32"``, ``"bfloat16"``, ``"float16"``)."""

    values: torch.Tensor
    scales: torch.Tensor
    block: int = DEFAULT_BLOCK
    orig_dtype: str = "float32"
    code: str = "int8"
    orig_d: int = -1

    def dequantize(self, dtype=None) -> torch.Tensor:
        """Reconstruct the (lossy) tensor; see :func:`dequantize_blockwise`."""
        return dequantize_blockwise(self, dtype=dtype)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def _rows_view(shape) -> Tuple[int, int]:
    """``(rows, d)`` of the 2-D view of ``shape`` (a 0-d tensor is one
    value, as in the reference :676-682)."""
    d = shape[-1] if shape else 1
    rows = 1
    for s in shape[:-1]:
        rows *= s
    return rows, d


def _stochastic_ratios(
    x2d: torch.Tensor,
    *,
    block: int,
    mode: str,
    generator: Optional[torch.Generator],
    u: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unbiased stochastic rounding (reference :368-373, :451-453):
    ``(floor(y + u), scales)`` with ``u`` uniform in [0, 1) over the padded
    ``(rows, nb, block)`` grid, plain PyTorch on either device."""
    y, scales = ck.block_scales_and_ratios(x2d, block=block, mode=mode)
    if u is None:
        u = torch.rand(y.shape, generator=generator, dtype=torch.float32,
                       device=generator.device if generator is not None else y.device)
    if u.numel() != y.numel():
        raise ValueError(
            f"u must hold one draw per padded block value ({tuple(y.shape)}), "
            f"got {tuple(u.shape)}"
        )
    return torch.floor(y + u.reshape(y.shape).to(device=y.device, dtype=torch.float32)), scales


def quantize_blockwise(
    x: torch.Tensor,
    *,
    block: int = DEFAULT_BLOCK,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> QuantizedBlocks:
    """Blockwise symmetric int8 quantization along the trailing axis (B13
    on the card).

    One f32 scale (``absmax / 127``) per ``block`` consecutive values;
    all-zero (and empty) blocks get scale 1. Non-finite coordinates never
    poison their block: the scale comes from the finite values only,
    ``+/-inf`` clips to ``+/-127`` and NaN encodes as 0. ``stochastic=True``
    rounds ``floor(y + u)``, ``u`` drawn from ``generator`` or given as
    ``u`` (``rows * nb * block`` draws over the zero-padded block grid);
    it is plain PyTorch on both devices, as in the reference."""
    if stochastic and generator is None and u is None:
        raise ValueError(
            "stochastic rounding needs an explicit PRNG key: pass generator= or u="
        )
    orig_shape = tuple(x.shape)
    orig_dtype = _dtype_name(x.dtype)
    rows, d = _rows_view(orig_shape)
    if d == 0 or rows == 0:
        return QuantizedBlocks(
            torch.zeros(orig_shape, dtype=torch.int8, device=x.device),
            torch.zeros((*orig_shape[:-1], 0), dtype=torch.float32, device=x.device),
            block,
            orig_dtype,
        )
    x2d = x.reshape(rows, d)
    if stochastic:
        q, scales = _stochastic_ratios(x2d, block=block, mode="int8", generator=generator, u=u)
        values = ck.codes_from_ratios(q, mode="int8", d=d, rounded=True)
    else:
        values, scales = ck.encode_rows(x2d.contiguous(), block=block, mode="int8")
    nb = scales.shape[-1]
    return QuantizedBlocks(
        values.reshape(orig_shape), scales.reshape(*orig_shape[:-1], nb), block, orig_dtype
    )


def dequantize_blockwise(q: QuantizedBlocks, *, dtype=None) -> torch.Tensor:
    """Reconstruct the tensor a :class:`QuantizedBlocks` approximates
    (``values * scale`` per trailing-axis block, B14 on the card; packed s4
    unpacks its nibbles first, B17), in ``dtype`` (default: the dtype
    recorded at quantization)."""
    out_dtype = _as_dtype(dtype if dtype is not None else q.orig_dtype)
    if q.code == "s4":
        return _dequantize_s4(q, out_dtype)
    shape = tuple(q.values.shape)
    rows, d = _rows_view(shape)
    if d == 0 or rows == 0:
        return torch.zeros(shape, dtype=out_dtype, device=q.values.device)
    v2d = q.values.reshape(rows, d).contiguous()
    s2d = q.scales.reshape(rows, -1).contiguous()
    return ck.decode_rows(v2d, s2d, block=q.block, dtype=out_dtype).reshape(shape)


def _dequantize_s4(q: QuantizedBlocks, dtype: torch.dtype) -> torch.Tensor:
    """Unpack and rescale an s4 :class:`QuantizedBlocks` (reference :780):
    ``q.orig_d`` is the unpacked trailing length."""
    lead = tuple(q.values.shape[:-1])
    packed_d = q.values.shape[-1] if q.values.ndim else 0
    d = q.orig_d if q.orig_d >= 0 else packed_d * 2
    rows, _ = _rows_view((*lead, packed_d))
    if d == 0 or rows == 0:
        return torch.zeros((*lead, d), dtype=dtype, device=q.values.device)
    v2d = q.values.reshape(rows, packed_d).contiguous()
    s2d = q.scales.reshape(rows, -1).contiguous()
    return ck.decode_rows_s4(v2d, s2d, block=q.block, d=d, dtype=dtype).reshape(*lead, d)


def encode_blockwise(
    x: torch.Tensor,
    precision: Union[CommPrecision, str],
    *,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> QuantizedBlocks:
    """Blockwise encode under any coded :class:`CommPrecision` mode:
    ``int8`` is :func:`quantize_blockwise` (B13), ``fp8``/``fp8_e5m2`` the
    blockwise-scaled fp8 codec (B15), ``s4`` the packed 4-bit codec (B16;
    a stochastic s4 encode is plain PyTorch on both devices, as in the
    reference). Same non-finite guards as int8."""
    p = as_comm_precision(precision)
    if not p.blockwise:
        raise ValueError(
            f"encode_blockwise needs a coded mode (int8/fp8/fp8_e5m2/s4), "
            f"got {p.mode!r}"
        )
    if p.mode == "int8":
        return quantize_blockwise(
            x, block=p.block, stochastic=p.stochastic, generator=generator, u=u
        )
    if p.stochastic and p.mode in ck.FP8_FORMATS:
        raise ValueError(
            "stochastic rounding is integer-code only (int8/s4); fp8 "
            "rounds to nearest in the format's own grid"
        )
    s4 = p.mode == "s4"
    if p.stochastic and generator is None and u is None:
        raise ValueError(
            "stochastic rounding needs an explicit PRNG key: pass generator= or u="
        )
    orig_shape = tuple(x.shape)
    orig_dtype = _dtype_name(x.dtype)
    rows, d = _rows_view(orig_shape)
    orig_d = d if s4 else -1
    if d == 0 or rows == 0:
        values = (torch.zeros((*orig_shape[:-1], 0), dtype=torch.uint8, device=x.device) if s4
                  else torch.zeros(orig_shape, dtype=ck.code_dtype(p.mode), device=x.device))
        return QuantizedBlocks(
            values,
            torch.zeros((*orig_shape[:-1], 0), dtype=torch.float32, device=x.device),
            p.block, orig_dtype, p.mode, orig_d,
        )
    x2d = x.reshape(rows, d).contiguous()
    if s4 and p.stochastic:
        q, scales = _stochastic_ratios(x2d, block=p.block, mode="s4", generator=generator, u=u)
        values = ck.pack_s4(q)
    elif s4:
        values, scales = ck.encode_rows_s4(x2d, block=p.block)
    else:
        values, scales = ck.encode_rows(x2d, block=p.block, mode=p.mode)
    # the reference's reshape (:904): a 0-d input keeps a trailing axis of 1
    return QuantizedBlocks(
        values.reshape(*orig_shape[:-1], values.shape[-1]),
        scales.reshape(*orig_shape[:-1], scales.shape[-1]),
        p.block,
        orig_dtype,
        p.mode,
        orig_d,
    )


def ef_encode(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    precision: Union[CommPrecision, str],
    **kwargs: Any,
) -> Tuple[QuantizedBlocks, torch.Tensor]:
    """Error-feedback encode: fold the previous round's quantization
    residual into this round's payload, encode, and return the NEW
    residual to carry forward: ``compensated = x + residual`` crosses the
    wire and ``new_residual = compensated - decode(encode(compensated))``,
    so over N rounds the decoded sum telescopes to the true sum plus one
    round's bounded error. ``residual=None`` starts the chain at zero."""
    xc = x if residual is None else x + residual.to(x.dtype)
    q = encode_blockwise(xc, precision, **kwargs)
    new_residual = xc - dequantize_blockwise(q, dtype=xc.dtype)
    return q, new_residual


def dequantize_rows(
    codes: torch.Tensor,
    scales: torch.Tensor,
    *,
    mode: str,
    block: int,
    d: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Row-batched dequantization of wire-layout codes: ``codes: (rows,
    ncodes)`` as the wire carries them (int8 codes for ``int8``, uint8 fp8
    bit patterns for ``fp8``/``fp8_e5m2``, packed nibbles, ``nb * block /
    2`` bytes, for ``s4``) and ``scales: (rows, nb)`` f32, through B14 (B17
    for s4) on the card. ``d`` is the decoded trailing length (packed s4
    needs it; it equals ``ncodes`` otherwise)."""
    if mode == "s4":
        return ck.decode_rows_s4(ck.from_wire(codes, mode), scales, block=block, d=d,
                                 dtype=_as_dtype(dtype))
    if mode not in ("int8", *ck.FP8_FORMATS):
        raise ValueError(f"no wire row codec for mode {mode!r}")
    return ck.decode_rows(ck.from_wire(codes, mode), scales, block=block, dtype=_as_dtype(dtype))


def quantization_error_bound(
    x: torch.Tensor, *, block: int = DEFAULT_BLOCK, mode: str = "int8"
) -> torch.Tensor:
    """Per-element worst-case reconstruction error of round-to-nearest
    blockwise coding, ``absmax(block) / divisor`` (int8 254, s4 14, fp8
    27.7, fp8_e5m2 13.9), broadcast back to ``x``'s shape."""
    if mode not in _ERROR_DIVISOR:
        raise ValueError(f"no blockwise error bound for mode {mode!r}")
    shape = tuple(x.shape)
    d = shape[-1]
    nb = -(-d // block)
    xf = x.float().abs()
    if nb * block != d:
        xf = torch.cat([xf, xf.new_zeros((*shape[:-1], nb * block - d))], dim=-1)
    absmax = xf.reshape(*shape[:-1], nb, block).amax(dim=-1)
    divisor = torch.full((), _ERROR_DIVISOR[mode], dtype=torch.float32, device=x.device)
    bound = torch.repeat_interleave(absmax / divisor, block, dim=-1)
    return bound[..., :d]


__all__ = [
    "DEFAULT_BLOCK",
    "SUB_INT8_MODES",
    "CommPrecision",
    "QuantizedBlocks",
    "as_comm_precision",
    "dequantize_blockwise",
    "dequantize_rows",
    "ef_encode",
    "encode_blockwise",
    "quantization_error_bound",
    "quantize_blockwise",
]
