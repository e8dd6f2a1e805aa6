"""The compressed wire hop of the collectives, single-card form.

Counterpart of the quantized part of ``byzpy_tpu/parallel/collectives.py``
(:172-392). There, :func:`reshard_q` pins a tensor to a ``src`` layout,
encodes it, lets XLA move the coded bytes to the ``dst`` layout and
decodes there. On one card (a one-device mesh in the reference) the
reshard moves nothing and only the encode -> decode round trip remains,
so this module takes ``src = dst = None`` and raises
``NotImplementedError`` for a layout: the collectives over
``torch.distributed`` are the mesh slice's (ROADMAP A.7).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .quantization import (
    CommPrecision,
    as_comm_precision,
    dequantize_blockwise,
    encode_blockwise,
)


def _single_card(src, dst) -> None:
    if src is not None or dst is not None:
        raise NotImplementedError(
            "byzpy_tpu_torch has no mesh yet: the compressed reshard runs on one "
            "card with src = dst = None (collectives over torch.distributed: ROADMAP A.7)"
        )


def _round_trip(x: torch.Tensor, p: CommPrecision) -> torch.Tensor:
    """``decode(encode(x))`` under an enabled policy, in ``x``'s dtype: the
    bf16 cast and back (reference :304-314), else the blockwise codec
    (reference ``_encode_wire`` :177 / ``_decode_wire`` :192). With no
    transport on one card, the codes go from encode to decode as they are;
    their wire-byte view comes with the collectives (ROADMAP A.7)."""
    if p.mode == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    return dequantize_blockwise(encode_blockwise(x, p), dtype=x.dtype)


def reshard_q(
    x: torch.Tensor,
    src=None,
    dst=None,
    *,
    precision: Union[CommPrecision, str, None] = None,
) -> torch.Tensor:
    """The compressed reshard on one card: ``x`` itself when ``precision``
    is off or ``None``, its bf16 round trip for ``bf16``, else
    ``decode(encode(x))`` of the blockwise codec (int8: B13 + B14; fp8:
    B15 + B14; s4: B16 + B17), in ``x``'s dtype. ``src`` and ``dst`` must be ``None``."""
    _single_card(src, dst)
    p = as_comm_precision(precision)
    if not p.enabled:
        return x
    return _round_trip(x, p)


def reshard_q_ef(
    x: torch.Tensor,
    residual: torch.Tensor,
    src=None,
    dst=None,
    *,
    precision: Union[CommPrecision, str, None] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`reshard_q` with per-round error feedback: the wire carries
    ``xc = x + residual`` and the new residual is ``xc - decode(encode(xc))``.
    Returns ``(decoded, new_residual)``; off or ``None`` returns ``(x,
    residual)`` unchanged.

    The reference decodes the same codes twice, once at the source layout
    for the residual and once after the hop (:388-391). On one card both
    decodes read the same codes and scales into the same dtype, so their
    bits are identical: the port decodes once and uses that result for
    both."""
    _single_card(src, dst)
    p = as_comm_precision(precision)
    if not p.enabled:
        return x, residual
    xc = x + residual.to(x.dtype)
    decoded = _round_trip(xc, p)
    return decoded, xc - decoded


__all__ = ["reshard_q", "reshard_q_ef"]
