"""Hand-written CUDA kernels of the compressed wire fabric's blockwise
codecs, with their plain PyTorch versions.

Counterpart of the Pallas kernels in ``byzpy_tpu/parallel/quantization.py``.
The public codec API (``QuantizedBlocks``, ``quantize_blockwise``,
``encode_blockwise``, ...) is :mod:`byzpy_tpu_torch.parallel.quantization`;
this module holds the row-level kernels under it. Each wrapper checks its
inputs, then computes the plain version on a CPU tensor, or launches its
kernel from ``csrc/quantize.cu`` on a CUDA tensor and adds one to its
entry in ``kernels.launch_counts`` right after the launch. It never falls
back to the plain version on the card.

Kernels (TPU kernel they replace -> launch counter):

* B13 :func:`encode_rows`, ``mode="int8"``: ``_quantize_kernel``
  (quantization.py:256) -> ``quantize:int8``;
* B15 :func:`encode_rows`, ``mode="fp8"`` / ``"fp8_e5m2"``:
  ``_quantize_fp8_kernel`` (:479) -> ``quantize:fp8`` /
  ``quantize:fp8_e5m2``;
* B14 :func:`decode_rows`: ``_dequantize_kernel`` (:279), int8 codes or
  fp8 values -> ``dequantize:int8`` / ``dequantize:fp8``;
* B16 :func:`encode_rows_s4`: ``_quantize_s4_kernel`` (:504) ->
  ``quantize:s4``;
* B17 :func:`decode_rows_s4`: ``_dequantize_s4_kernel`` (:525) ->
  ``dequantize:s4``.

Per ``(row, block)``: ``absmax`` of the finite values, ``scale = absmax *
(1 / qmax)`` or 1 for an all-zero (or all non-finite) block, ``y = x * (1 /
scale)``, NaN -> 0, clip to ``+-qmax``; int8 rounds half to even, fp8 takes
one direct round-to-nearest-even cast (the JAX package's f32 -> f8
convert rounds directly too). s4 (``qmax = 7``) rounds as int8 and packs
the nibbles ``q + 8`` two a byte, the even coordinate in the low nibble,
over the zero-padded block grid: ``nb * block / 2`` bytes a row, the
padding nibble 8. Inputs are f32, bf16 or f16, read as f32; decoded values
are written in f32, bf16 or f16 with NaN canonical.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .kernels import (
    _DTYPE_CODES,
    _call,
    _ceil_div,
    _check_float,
    _check_ndim,
    _on_cpu,
    _stream,
    canonical_nan,
    count_launch,
)

#: fp8 formats of the wire: mode -> (torch dtype, largest finite magnitude)
FP8_FORMATS = {
    "fp8": (torch.float8_e4m3fn, 448.0),
    "fp8_e5m2": (torch.float8_e5m2, 57344.0),
}
_QMAX = {"int8": 127.0, "s4": 7.0, **{m: fmax for m, (_, fmax) in FP8_FORMATS.items()}}
# code modes shared with csrc/codec.cuh (CodeMode)
_CODES = {"int8": 0, "fp8": 1, "fp8_e5m2": 2}
WIRE_CODES = {**_CODES, "s4": 3}
_CODE_OF_DTYPE = {torch.int8: "int8", torch.float8_e4m3fn: "fp8", torch.float8_e5m2: "fp8_e5m2"}


def code_dtype(mode: str) -> torch.dtype:
    """The dtype of ``mode``'s codes: int8, or the fp8 format."""
    if mode not in _CODES:
        raise ValueError(f"no blockwise code for mode {mode!r}")
    return torch.int8 if mode == "int8" else FP8_FORMATS[mode][0]


def _check_block(block: int) -> None:
    if not isinstance(block, int) or block <= 0:
        raise ValueError(f"block must be a positive int, got {block!r}")


# ---------------------------------------------------------------------------
# B13 / B15: encode
# ---------------------------------------------------------------------------


def encode_rows(x: torch.Tensor, *, block: int, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise encode of ``x: (rows, d)`` (f32, bf16 or f16) along its
    trailing axis: ``(codes (rows, d), scales (rows, ceil(d / block)))``,
    the codes int8 (``mode="int8"``, B13) or fp8 values (``"fp8"``,
    ``"fp8_e5m2"``, B15), the scales f32. A partial last block is allowed;
    an empty input launches nothing."""
    code = code_dtype(mode)
    _check_block(block)
    _check_ndim(x, 2, "x")
    _check_float(x)
    rows, d = x.shape
    if _on_cpu(x):
        return encode_rows_plain(x, block=block, mode=mode)
    if not x.is_contiguous():
        raise ValueError("CUDA kernels take contiguous tensors")
    nb = _ceil_div(d, block)
    codes = torch.empty((rows, d), dtype=torch.uint8, device=x.device)
    scales = torch.empty((rows, nb), dtype=torch.float32, device=x.device)
    if rows == 0 or d == 0:
        return codes.view(code), scales
    with torch.cuda.device(x.device):
        _call(
            "byz_quantize", x.data_ptr(), codes.data_ptr(), scales.data_ptr(), rows, d,
            block, nb, _CODES[mode], _DTYPE_CODES[x.dtype], _stream(x),
        )
    count_launch(f"quantize:{mode}")
    return codes.view(code), scales


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x: (rows, d)`` as f32 ``(rows, nb, block)``, the last block
    zero-padded."""
    rows, d = x.shape
    nb = _ceil_div(d, block)
    xf = x.float()
    if nb * block != d:
        xf = F.pad(xf, (0, nb * block - d))
    return xf.reshape(rows, nb, block)


def block_scales_and_ratios(
    x: torch.Tensor, *, block: int, mode: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoders' common first half: ``(y (rows, nb, block), scales
    (rows, nb))`` with ``y = x * (1 / scale)`` in f32, one IEEE operation a
    step (the reference's ``_quantize_xla`` :352-367)."""
    xb = _blocks(x, block)
    finite = torch.where(torch.isfinite(xb), xb, torch.zeros_like(xb))
    absmax = finite.abs().amax(dim=2)
    inv_qmax = torch.full((), 1.0 / _QMAX[mode], dtype=torch.float32, device=x.device)
    scales = torch.where(absmax > 0, absmax * inv_qmax, torch.ones_like(absmax))
    y = xb * (torch.ones_like(scales) / scales)[..., None]
    return y, scales


def codes_from_ratios(
    q: torch.Tensor, *, mode: str, d: int, rounded: bool = False
) -> torch.Tensor:
    """Codes ``(rows, d)`` from ``(rows, nb, block)`` ratios: NaN -> 0,
    clip to ``+-qmax``, then int8 codes (rounded half to even unless
    ``rounded``) or the direct fp8 cast."""
    qmax = _QMAX[mode]
    rows = q.shape[0]
    if mode == "int8" and not rounded:
        q = torch.round(q)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), torch.clamp(q, -qmax, qmax))
    return q.to(code_dtype(mode)).reshape(rows, -1)[:, :d].contiguous()


def encode_rows_plain(x: torch.Tensor, *, block: int, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`encode_rows` (the same IEEE steps)."""
    y, scales = block_scales_and_ratios(x, block=block, mode=mode)
    return codes_from_ratios(y, mode=mode, d=x.shape[1]), scales


# ---------------------------------------------------------------------------
# B14: decode
# ---------------------------------------------------------------------------


def _check_decode(codes: torch.Tensor, scales: torch.Tensor, block: int, dtype) -> str:
    _check_block(block)
    _check_ndim(codes, 2, "codes")
    _check_ndim(scales, 2, "scales")
    mode = _CODE_OF_DTYPE.get(codes.dtype)
    if mode is None:
        raise ValueError(f"codes must be int8 or fp8, got {codes.dtype}")
    if scales.dtype != torch.float32 or scales.shape[0] != codes.shape[0]:
        raise ValueError(
            f"scales must be float32 with one row per code row, got "
            f"{tuple(scales.shape)} {scales.dtype} for codes {tuple(codes.shape)}"
        )
    if codes.shape[1] and scales.shape[1] * block < codes.shape[1]:
        raise ValueError(
            f"{scales.shape[1]} scales of block {block} cover fewer than "
            f"{codes.shape[1]} values"
        )
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dtype}")
    return mode


def decode_rows(
    codes: torch.Tensor, scales: torch.Tensor, *, block: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """``codes * scale`` per trailing-axis block of ``codes: (rows, d)``
    (int8 codes or fp8 values) and ``scales: (rows, nb)`` f32 (B14), as
    ``(rows, d)`` in ``dtype`` (f32, bf16 or f16): the f32 product,
    rounded once to ``dtype``, NaN canonical. Scales past ``ceil(d /
    block)`` are not read; an empty input launches nothing."""
    mode = _check_decode(codes, scales, block, dtype)
    if _on_cpu(codes, scales):
        return decode_rows_plain(codes, scales, block=block, dtype=dtype)
    if not (codes.is_contiguous() and scales.is_contiguous()):
        raise ValueError("CUDA kernels take contiguous tensors")
    rows, d = codes.shape
    out = torch.empty((rows, d), dtype=dtype, device=codes.device)
    if rows == 0 or d == 0:
        return out
    with torch.cuda.device(codes.device):
        _call(
            "byz_dequantize", codes.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, d,
            block, scales.shape[1], _CODES[mode], _DTYPE_CODES[dtype], _stream(codes),
        )
    count_launch("dequantize:int8" if mode == "int8" else "dequantize:fp8")
    return out


def decode_rows_plain(
    codes: torch.Tensor, scales: torch.Tensor, *, block: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_rows` (the reference's
    ``_dequantize_xla`` :942)."""
    rows, d = codes.shape
    nb = scales.shape[1]
    vf = codes.float()
    if nb * block != d:
        vf = F.pad(vf, (0, nb * block - d))
    out = (vf.reshape(rows, nb, block) * scales[..., None]).reshape(rows, nb * block)
    return canonical_nan(out[:, :d].to(dtype))


def from_wire(codes: torch.Tensor, mode: str) -> torch.Tensor:
    """``mode``'s codes from the bytes a wire carries them as: int8 codes as
    they are, fp8 values as their dtype or as uint8 bit patterns, s4's
    packed nibbles as uint8."""
    if mode == "s4":
        if codes.dtype != torch.uint8:
            raise ValueError(f"wire codes of mode 's4' must be uint8, got {codes.dtype}")
        return codes
    want = code_dtype(mode)
    if codes.dtype == want:
        return codes
    if mode == "int8" or codes.dtype != torch.uint8:
        raise ValueError(f"wire codes of mode {mode!r} must be {want} or uint8, got {codes.dtype}")
    return codes.view(want)


# ---------------------------------------------------------------------------
# B16 / B17: the packed 4-bit codec
# ---------------------------------------------------------------------------


def _check_even_block(block: int) -> None:
    _check_block(block)
    if block % 2:
        raise ValueError(f"s4 packs two codes per byte: block must be even, got {block}")


def encode_rows_s4(x: torch.Tensor, *, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """s4 encode of ``x: (rows, d)`` (f32, bf16 or f16) along its trailing
    axis (B16): ``(packed (rows, nb * block / 2) uint8, scales (rows, nb)
    f32)`` with ``nb = ceil(d / block)`` and ``block`` even. An empty input
    launches nothing."""
    _check_even_block(block)
    _check_ndim(x, 2, "x")
    _check_float(x)
    if _on_cpu(x):
        return encode_rows_s4_plain(x, block=block)
    if not x.is_contiguous():
        raise ValueError("CUDA kernels take contiguous tensors")
    rows, d = x.shape
    nb = _ceil_div(d, block)
    packed = torch.empty((rows, nb * block // 2), dtype=torch.uint8, device=x.device)
    scales = torch.empty((rows, nb), dtype=torch.float32, device=x.device)
    if rows == 0 or d == 0:
        return packed, scales
    with torch.cuda.device(x.device):
        _call("byz_quantize_s4", x.data_ptr(), packed.data_ptr(), scales.data_ptr(), rows, d,
              block, nb, _DTYPE_CODES[x.dtype], _stream(x))
    count_launch("quantize:s4")
    return packed, scales


def pack_s4(q: torch.Tensor) -> torch.Tensor:
    """Packed s4 codes ``(rows, nb * block / 2)`` uint8 from rounded ratios
    ``(rows, nb, block)``: NaN -> 0, clip to +-7, nibble ``q + 8``, the even
    coordinate in the low nibble (the reference's ``_quantize_s4_xla``
    :448-457)."""
    q = torch.where(torch.isnan(q), torch.zeros_like(q), torch.clamp(q, -7.0, 7.0))
    nib = (q + 8.0).to(torch.uint8).reshape(q.shape[0], -1, 2)
    return nib[..., 0] | (nib[..., 1] << 4)


def encode_rows_s4_plain(x: torch.Tensor, *, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`encode_rows_s4` (the reference's
    ``_quantize_s4_xla``, round to nearest)."""
    y, scales = block_scales_and_ratios(x, block=block, mode="s4")
    return pack_s4(torch.round(y)), scales


def _check_decode_s4(packed: torch.Tensor, scales: torch.Tensor, block: int, d: int, dtype) -> None:
    _check_even_block(block)
    _check_ndim(packed, 2, "packed")
    _check_ndim(scales, 2, "scales")
    if packed.dtype != torch.uint8:
        raise ValueError(f"packed s4 codes must be uint8, got {packed.dtype}")
    if scales.dtype != torch.float32 or scales.shape[0] != packed.shape[0]:
        raise ValueError(
            f"scales must be float32 with one row per code row, got "
            f"{tuple(scales.shape)} {scales.dtype} for codes {tuple(packed.shape)}"
        )
    if d < 0 or (d and (2 * packed.shape[1] < d or scales.shape[1] * block < d)):
        raise ValueError(
            f"{packed.shape[1]} packed bytes and {scales.shape[1]} scales of block {block} "
            f"do not cover d={d}"
        )
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dtype}")


def decode_rows_s4(
    packed: torch.Tensor, scales: torch.Tensor, *, block: int, d: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Decode of packed s4 rows (B17): ``(nibble - 8) * scale`` per block of
    ``block`` coordinates, the first ``d`` of each row, as ``(rows, d)`` in
    ``dtype`` (f32, bf16 or f16): the f32 product rounded once, NaN
    canonical. A capacity row (zero bytes, zero scales) decodes to -0.0. An
    empty input launches nothing."""
    _check_decode_s4(packed, scales, block, d, dtype)
    if _on_cpu(packed, scales):
        return decode_rows_s4_plain(packed, scales, block=block, d=d, dtype=dtype)
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("CUDA kernels take contiguous tensors")
    rows = packed.shape[0]
    out = torch.empty((rows, d), dtype=dtype, device=packed.device)
    if rows == 0 or d == 0:
        return out
    with torch.cuda.device(packed.device):
        _call("byz_dequantize_s4", packed.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, d,
              packed.shape[1], block, scales.shape[1], _DTYPE_CODES[dtype], _stream(packed))
    count_launch("dequantize:s4")
    return out


def s4_values(packed: torch.Tensor) -> torch.Tensor:
    """The code values ``nibble - 8`` of packed s4 rows, ``(rows, 2 *
    ncodes)`` f32, before their scales."""
    nib = torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(packed.shape[0], -1)
    return nib.float() - 8.0


def decode_rows_s4_plain(
    packed: torch.Tensor, scales: torch.Tensor, *, block: int, d: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_rows_s4` (the reference's
    ``_dequantize_s4_xla``: the same one product a value)."""
    vals = s4_values(packed)[:, :d]
    scale = torch.repeat_interleave(scales, block, dim=1)[:, :d]
    return canonical_nan((vals * scale).to(dtype))


def decode_wire_rows_plain(
    codes: torch.Tensor, scales: torch.Tensor, *, mode: str, block: int, d: int
) -> torch.Tensor:
    """Plain f32 decode of wire rows in any coded mode (B14's or B17's
    plain version): the rows B12 contracts."""
    if mode == "s4":
        return decode_rows_s4_plain(codes, scales, block=block, d=d)
    return decode_rows_plain(from_wire(codes, mode), scales, block=block)[:, :d]


__all__ = [
    "FP8_FORMATS",
    "block_scales_and_ratios",
    "code_dtype",
    "codes_from_ratios",
    "decode_rows",
    "decode_rows_plain",
    "decode_rows_s4",
    "decode_rows_s4_plain",
    "decode_wire_rows_plain",
    "encode_rows",
    "encode_rows_plain",
    "encode_rows_s4",
    "encode_rows_s4_plain",
    "from_wire",
    "pack_s4",
    "s4_values",
]
