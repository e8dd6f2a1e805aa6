"""Pipeline fusion: recognize (pre-aggregator, aggregator) pairs with a
Gram-collapse kernel.

Counterpart of ``byzpy_tpu/aggregators/pipelines.py``. Training code
spells a robust pipeline as two objects (ref:
``byzpy/engine/parameter_server/ps.py:127-137``); where the
pre-aggregation is a linear row operator with Gram-derivable
coefficients, the pair runs as one fused call (B9 or B10 on the card)
instead of two materialized steps. Callers use
:func:`fused_pipeline_matrix_fn` and run the two steps when it returns
``None``.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional

import torch


def fused_pipeline_matrix_fn(
    pre: Any, agg: Any
) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """A fused ``(n, d) -> (d,)`` function for the (pre, agg) pair, or
    ``None`` when no fused kernel exists."""
    from ..ops import robust
    from ..pre_aggregators.arc import ARC
    from ..pre_aggregators.clipping import Clipping
    from ..pre_aggregators.nnm import NearestNeighborMixing
    from .geometric_wise.krum import Krum, MultiKrum

    # exact-type matching on purpose: a subclass may override
    # _aggregate_matrix / _transform_matrix, and the fused kernel would
    # silently bypass the override. Krum only pins q=1.
    if type(agg) not in (MultiKrum, Krum):
        return None
    if type(pre) is NearestNeighborMixing:
        return partial(robust.nnm_multi_krum, f_nnm=pre.f, f=agg.f, q=agg.q)
    if type(pre) is Clipping and pre.threshold > 0:
        # threshold == 0 clips every row to zero; the two-step path's
        # semantics are the contract there
        return partial(robust.clipped_multi_krum, tau=pre.threshold, f=agg.f, q=agg.q)
    if type(pre) is ARC:
        return partial(robust.arc_multi_krum, f_arc=pre.f, f=agg.f, q=agg.q)
    return None


__all__ = ["fused_pipeline_matrix_fn"]
