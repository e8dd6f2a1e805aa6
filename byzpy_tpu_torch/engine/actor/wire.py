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
or B17 for s4, on the card). The pre-decode inflation of one frame
(:func:`frame_inflation`, ref :422, with its tables ``_WIRE_QMAX`` :61 and
``BLOCKWISE_WIRE_MODES`` :56 and the code-value conversion :232) is here
for the residual-shaping attack (``attacks/adaptive.py``). The frame
format itself (length prefix, cloudpickle body, HMAC, the per-frame
encoders and the ingress forensics) is the actor engine's, and waits for
it (ROADMAP A.4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ...ops import codec_kernels as ck


#: The blockwise wire modes, whose frames carry per-block scale headers
#: (pre-decode forensics apply to these).
BLOCKWISE_WIRE_MODES = ("int8", "fp8", "fp8_e5m2", "s4")
#: Per-mode code maximum in the scaled domain: an honest blockwise encoder
#: maps each block's absmax to exactly this code magnitude, so the
#: pre-decode inflation ratio qmax / max|code| of every nonzero block is 1.0.
_WIRE_QMAX = {"int8": 127.0, "s4": 7.0, "fp8": 448.0, "fp8_e5m2": 57344.0}


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


def _code_values_f32(codes: torch.Tensor, mode: str) -> torch.Tensor:
    """One frame's f32 code values before the per-block scales: s4 nibbles
    unpacked and recentred (``nibble - 8``), fp8 bit patterns reinterpreted,
    int8 codes cast. Per-frame form of :func:`_rows_code_values`."""
    return _rows_code_values(codes.reshape(1, -1), mode)[0]


def frame_inflation(qwa: QuantizedWireArray) -> Optional[float]:
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
    vals = _code_values_f32(qwa.codes, qwa.mode)
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
    # numpy's f32 scalar, so the division rounds as the JAX package's does
    return float(qmax / blockmax[nonzero].min().cpu().numpy().astype(np.float32))


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
    "BLOCKWISE_WIRE_MODES",
    "QuantizedWireArray",
    "frame_inflation",
    "rows_code_absmax",
]
