"""Compressed wire rows, the part the serving tier's quantized cohorts read.

Counterpart of two pieces of ``byzpy_tpu/engine/actor/wire.py``:

* :class:`QuantizedWireArray` (ref :140), one compressed tensor of a
  frame: its codes, its per-block f32 scales and the metadata to rebuild
  it, here as tensors;
* :func:`rows_code_absmax` (ref :606): each block's largest code
  magnitude, which tells whether a decoded row is finite without decoding
  it.

The reference's ``decode_rows_np`` (:578), ``R`` stacked frames' codes
decoded at once, is ``parallel.quantization.dequantize_rows`` here (B14,
or B17 for s4, on the card). The frame format itself (length prefix,
cloudpickle body, HMAC, the per-frame encoders and the residual-shaping
forensics) is the actor engine's, and waits for it (ROADMAP A.4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ...ops import codec_kernels as ck


@dataclasses.dataclass(frozen=True)
class QuantizedWireArray:
    """One compressed tensor inside a wire frame: ``codes`` (int8 for
    ``int8``, uint16 bf16 bit patterns for ``bf16``, uint8 fp8 bit patterns
    for ``fp8``/``fp8_e5m2``, block-padded packed nibbles for ``s4``), the
    per-block f32 ``scales`` (``None`` for bf16), the ``block`` width, the
    source ``shape`` and ``dtype`` name."""

    mode: str
    codes: torch.Tensor
    scales: Optional[torch.Tensor]
    block: int
    shape: Tuple[int, ...]
    dtype: str


def _rows_code_values(codes: torch.Tensor, mode: str) -> torch.Tensor:
    """``(R, nvals)`` f32 code values before scaling: s4 nibbles unpacked
    and recentred, fp8 bit patterns reinterpreted (non-finite patterns
    stay non-finite), int8 codes cast."""
    if mode == "s4":
        return ck.s4_values(ck.from_wire(codes, mode))
    if mode not in ("int8", *ck.FP8_FORMATS):
        raise ValueError(f"no wire row codec for mode {mode!r}")
    return ck.from_wire(codes, mode).float()


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


__all__ = [
    "QuantizedWireArray",
    "rows_code_absmax",
]
