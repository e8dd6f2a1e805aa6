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
  fp8 values -> ``dequantize:int8`` / ``dequantize:fp8``.

Per ``(row, block)``: ``absmax`` of the finite values, ``scale = absmax *
(1 / qmax)`` or 1 for an all-zero (or all non-finite) block, ``y = x * (1 /
scale)``, NaN -> 0, clip to ``+-qmax``; int8 rounds half to even, fp8 takes
one direct round-to-nearest-even cast (the JAX package's f32 -> f8
convert rounds directly too). Inputs are f32, bf16 or f16, read as f32;
decoded values are written in f32, bf16 or f16 with NaN canonical.
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
    launch_counts,
)

#: fp8 formats of the wire: mode -> (torch dtype, largest finite magnitude)
FP8_FORMATS = {
    "fp8": (torch.float8_e4m3fn, 448.0),
    "fp8_e5m2": (torch.float8_e5m2, 57344.0),
}
_QMAX = {"int8": 127.0, **{m: fmax for m, (_, fmax) in FP8_FORMATS.items()}}
# code modes shared with csrc/quantize.cu (CodeMode)
_CODES = {"int8": 0, "fp8": 1, "fp8_e5m2": 2}
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
    launch_counts[f"quantize:{mode}"] += 1
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
    launch_counts["dequantize:int8" if mode == "int8" else "dequantize:fp8"] += 1
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
    they are, fp8 values as their dtype or as uint8 bit patterns."""
    want = code_dtype(mode)
    if codes.dtype == want:
        return codes
    if mode == "int8" or codes.dtype != torch.uint8:
        raise ValueError(f"wire codes of mode {mode!r} must be {want} or uint8, got {codes.dtype}")
    return codes.view(want)


__all__ = [
    "FP8_FORMATS",
    "block_scales_and_ratios",
    "code_dtype",
    "codes_from_ratios",
    "decode_rows",
    "decode_rows_plain",
    "encode_rows",
    "encode_rows_plain",
    "from_wire",
]
