"""The serving tier: continuous ingestion of ragged, variable-size cohorts.

Counterpart of ``byzpy_tpu/serving``. Clients stream gradient submissions
(the actor wire's HMAC-signed, optionally quantized frames) into bounded
per-tenant admission queues; a cohort scheduler closes rounds on a
window/size trigger; each round aggregates whoever arrived, through the
ragged door (one program a tenant group, :mod:`.ragged`) or the bucket
ladder (:mod:`.buckets`, the masked finalize at a padded shape). Pieces:
:mod:`.credits` (per-client token buckets and rejection stats),
:mod:`.queue` (the admission queue), :mod:`.staleness` (round-lag
discounts), :mod:`.cohort` (cohort assembly on the aggregator's device),
:mod:`.ragged` and :mod:`.frontend` (the multi-tenant asyncio front end
and its client). Self-healing (:class:`DurabilityConfig`,
:class:`BreakerPolicy`, :class:`RetryPolicy`) and forensics
(:class:`ForensicsConfig`) attach per tenant.

The update steps are ``parallel.ps.build_serving_ps_step`` and
``parallel.ps.build_ragged_serving_ps_step``. The reference's sharded tier
(``ShardFrontend``, ``ShardedCoordinator``, the process-per-shard
``Runner``, ...) waits for ROADMAP A.6(c): its names raise
``NotImplementedError`` here.
"""

from ..forensics.plane import ForensicsConfig
from ..resilience.breaker import BreakerPolicy
from ..resilience.durable import DurabilityConfig
from ..resilience.retry import RetryPolicy
from .buckets import BucketLadder
from .cohort import Cohort, CohortAggregator, build_cohort
from .credits import CreditLedger, CreditPolicy, TokenBucket
from .frontend import ServingClient, ServingFrontend, TenantConfig, serve_frame
from .queue import AdmissionQueue, Submission
from .ragged import RaggedBatcher, RaggedExecutor, RaggedRuntime, RaggedView, ragged_enabled
from .staleness import StalenessPolicy

#: the reference's sharded-tier names (``serving/sharded.py``,
#: ``serving/runner.py``), not ported yet
_SHARDED = frozenset({
    "MergeTopology", "PartialFold", "ShardFrontend", "ShardRouter", "ShardedCoordinator",
    "audit_sharded_exactly_once", "combine_partials", "Runner", "RunnerClient", "RunnerSpec",
})


def __getattr__(name: str):
    if name in _SHARDED:
        raise NotImplementedError(
            f"byzpy_tpu_torch.serving.{name} is part of the sharded serving tier, which is not "
            "ported yet (ROADMAP A.6(c))")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionQueue",
    "BreakerPolicy",
    "BucketLadder",
    "Cohort",
    "CohortAggregator",
    "CreditLedger",
    "CreditPolicy",
    "DurabilityConfig",
    "ForensicsConfig",
    "RaggedBatcher",
    "RaggedExecutor",
    "RaggedRuntime",
    "RaggedView",
    "RetryPolicy",
    "ServingClient",
    "ServingFrontend",
    "StalenessPolicy",
    "Submission",
    "TenantConfig",
    "TokenBucket",
    "build_cohort",
    "ragged_enabled",
    "serve_frame",
]
