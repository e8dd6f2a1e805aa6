"""Multi-tenant serving front end: wire ingress -> admission -> cohorts.

Counterpart of ``byzpy_tpu/serving/frontend.py``. One
:class:`ServingFrontend` hosts several tenants (models) on one device. Each tenant owns an independent bounded admission queue, credit
ledger, bucket ladder, staleness policy, and round counter — isolation
is per-tenant by construction — while a shared device lock serializes
the actual aggregation dispatches so cohorts from different models
interleave cleanly on the same card (thousands of cheap producers, one
device consumer).

Client transport reuses the actor wire (``engine.actor.wire``)
verbatim: length-prefixed pickle frames, HMAC-signed when
``BYZPY_TPU_TORCH_WIRE_KEY`` is set, gradient payloads blockwise-compressed
when ``BYZPY_TPU_TORCH_WIRE_PRECISION`` is ``bf16``/``int8``/``fp8``/``s4``.
A submission frame is a dict::

    {"kind": "submit", "tenant": str, "client": str,
     "round": int, "gradient": (d,) float tensor, "seq": int | None}

answered by ``{"kind": "ack", "accepted": bool, "reason": str,
"round": int}``; ``{"kind": "stats", "tenant": str}`` returns the
tenant's accounting snapshot and ``{"kind": "close_round", "tenant":
str}`` drives the synchronous round closer (operator/drill door). The
optional ``seq`` is the per-client monotonic idempotency key — a
replayed ``(client, seq)`` acks accepted without re-folding. The
analytic per-frame ingress cost is
``parallel.comms.serving_ingress_bytes``.

Resilience (:mod:`byzpy_tpu_torch.resilience`): with a
``durability=`` config every accept is write-ahead logged before its
ack and tenants recover across SIGKILL via :meth:`ServingFrontend.
recover`; a per-tenant ``breaker=`` policy quarantines crash-looping
tenants; :class:`ServingClient` reconnects and resends under a
``RetryPolicy``.

The admission path (``submit``) is synchronous and cheap — shape gate,
staleness gate, token-bucket spend, bounded enqueue — so the asyncio
loop never blocks on it; aggregation runs through
``loop.run_in_executor`` to keep ingress responsive during a round's
device work.

Devices: admitted rows stay on the host (numpy, or the wire's codes and
scales) until a round closes; ``build_cohort`` assembles them on the
tenant aggregator's device (the card unless the aggregator was built
with ``device="cpu"``), and the round's aggregate stays there. Every
round's device work, on the event loop's thread or an executor's, runs on
the device's default stream, so a reader of an aggregate (its digest, a
snapshot, a broadcast) is ordered after the program that wrote it;
snapshots hand host copies to their executor save. No frontend path
replays a captured CUDA graph. The reference's sharded tier
(``serving/sharded.py``, ``serving/runner.py``) waits for ROADMAP
A.6(c); the ``shard=`` argument only tags telemetry.
"""

from __future__ import annotations

import asyncio
import os
import random
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..analysis import sanitize
from ..engine.actor import wire
from ..forensics.evidence import evidence_digest, host_array
from ..forensics.plane import ForensicsConfig, ForensicsPlane
from ..observability import jitstats as obs_jitstats
from ..observability import metrics as obs_metrics
from ..observability import runtime as obs_runtime
from ..observability import tracing as obs_tracing
from ..resilience.breaker import BreakerPolicy, CircuitBreaker
from ..resilience.durable import DurabilityConfig, TenantDurability
from ..resilience.retry import RetryPolicy, connect_with_retry, retry_async
from ..utils.checkpoint import CheckpointNotFoundError
from .buckets import BucketLadder
from .cohort import Cohort, CohortAggregator, build_cohort
from .ragged import RaggedRuntime, RaggedView, ragged_enabled
from .credits import (
    ACCEPTED,
    REJECTED_FULL,
    REJECTED_RATE,
    REJECTED_SHAPE,
    REJECTED_STALE,
    REJECTED_TENANT,
    CreditLedger,
    CreditPolicy,
    RoundStats,
)
from .queue import AdmissionQueue, Submission
from .staleness import StalenessPolicy

#: Called after every closed round: ``(tenant_name, round_id, cohort,
#: aggregate)``. Keep it light — it runs on the scheduler task.
RoundCallback = Callable[[str, int, Cohort, Any], None]

#: A decoded (HMAC-valid) request whose fields are type-nonsense —
#: distinct from a forged frame (peer dropped) and from every admission
#: rejection (all of which name a well-formed submission).
REJECTED_MALFORMED = "rejected_malformed"

#: A replayed ``(client, seq)`` the tenant already accepted: answered
#: ``accepted=True`` (the retrying client must stop resending) but NOT
#: re-enqueued — the original copy folds exactly once.
DUPLICATE = "duplicate"

#: Tenant quarantined by its circuit breaker (consecutive failed
#: rounds): an explicit per-submission rejection, never a crash loop.
REJECTED_QUARANTINED = "rejected_quarantined"

#: The write-ahead append failed (disk full/unwritable): the ack could
#: not be made a durable promise, so the submission is refused outright
#: — retrying the SAME seq later is legitimate (nothing was enqueued).
REJECTED_UNDURABLE = "rejected_not_durable"

#: Client quarantined by the tenant's forensics trust ledger (opt-in
#: ``ForensicsConfig(quarantine=True)``): an explicit per-submission
#: rejection, WAL-recorded at the transition — never a silent drop.
REJECTED_UNTRUSTED = "rejected_untrusted"

#: 16-hex-char fingerprint of an aggregate's exact bits — what the WAL
#: round records carry, so recovery can prove digest continuity. ONE
#: rule, shared with the forensics evidence records: the audit's
#: evidence-vs-round cross-check depends on the two never drifting.
_agg_digest = evidence_digest

#: First 4 bytes of an HTTP GET — the ingress sniffs them where the
#: wire length prefix would sit and serves a Prometheus scrape instead.
_HTTP_GET_PREFIX = b"GET "

#: Pop-key a ``request_hook`` response sets truthy to force its reply
#: frame LOSSLESS (``wire.encode(..., precision="off")``) — replies
#: whose float bits are load-bearing (a shard's ``PartialFold`` rows)
#: must not ride a lossy ``BYZPY_TPU_TORCH_WIRE_PRECISION`` fabric.
LOSSLESS_REPLY = "_lossless"
_HTTP_MAX_REQUEST = 8192

#: Socket read size of the batched ingress loop — large enough that one
#: event-loop wakeup drains many queued frames into one decode batch,
#: small enough to keep per-connection memory bounded.
_INGRESS_READ_CHUNK = 1 << 18


def _publish_wire_info() -> None:
    """Refresh the ``byzpy_wire_info`` marker gauge (wire precision +
    HMAC signing in effect) so exported metrics carry the parameters
    the ingress-bytes law needs; reflects the env at the last scrape."""
    precision = wire.wire_precision() or "off"
    signed = "1" if os.environ.get(wire._KEY_ENV) else "0"
    obs_metrics.registry().gauge(
        "byzpy_wire_info",
        help="wire precision/signing marker (value is always 1)",
        labels={"precision": precision, "signed": signed},
    ).set(1)


@dataclass(frozen=True)
class TenantConfig:
    """One model's serving parameters.

    ``dim`` is the flattened gradient length the tenant accepts (the
    shape gate at admission); ``window_s``/``cohort_cap`` the round
    close triggers; ``queue_capacity`` the admission bound;
    ``min_bucket`` the bottom of the power-of-two bucket ladder."""

    name: str
    aggregator: Any
    dim: int
    window_s: float = 0.02
    cohort_cap: int = 256
    min_cohort: int = 1
    min_bucket: int = 2
    queue_capacity: int = 1024
    credit: CreditPolicy = field(default_factory=CreditPolicy)
    staleness: StalenessPolicy = field(default_factory=StalenessPolicy)
    #: optional degraded-mode policy: ``threshold`` CONSECUTIVE failed
    #: rounds quarantine the tenant (queue drained with accounting, new
    #: submissions rejected with ``rejected_quarantined``) until a
    #: ``cooldown_s`` probe round succeeds. ``None`` = pre-existing
    #: behavior (failed rounds count, serving continues unconditionally).
    breaker: Optional[BreakerPolicy] = None
    #: optional per-client forensics plane (:mod:`byzpy_tpu_torch.forensics`):
    #: every closed round yields an evidence record (features +
    #: aggregator score view + detector flags) feeding a trust ledger,
    #: Prometheus metrics, the WAL audit trail, and flight-recorder
    #: dumps. Host-side and bit-effect-free: round aggregates are
    #: digest-identical with this on or off. ``None`` = no forensics.
    forensics: Optional[ForensicsConfig] = None

    def __post_init__(self) -> None:
        if self.dim <= 0:
            raise ValueError("dim must be >= 1")
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")
        if self.cohort_cap <= 0:
            raise ValueError("cohort_cap must be >= 1")
        if not 1 <= self.min_cohort <= self.cohort_cap:
            raise ValueError(
                "min_cohort must satisfy 1 <= min_cohort <= cohort_cap "
                f"(got {self.min_cohort}/{self.cohort_cap}); the tenant "
                "raises it to the aggregator's smallest admissible n "
                "automatically (validate_n probe), so set it only to hold "
                "rounds open BEYOND that floor"
            )


class _TenantTelemetry:
    """One tenant's registry instruments, created ONCE at tenant
    construction so the per-submission path never pays a get-or-create
    lookup — hot paths touch these only behind the telemetry flag
    (``observability.runtime.STATE.enabled``). The instruments mirror
    the tenant's pre-existing stats dict (``ServingFrontend.stats()``
    stays the back-compat view); a Prometheus scrape of the TCP ingress
    renders them in exposition format."""

    __slots__ = (
        "labels", "outcomes", "rounds", "failed", "ingress_bytes",
        "submit_frames", "queue_depth", "outstanding", "latency_s",
        "cohort_m", "overlap_ratio",
    )

    def __init__(self, name: str, dim: int) -> None:
        reg = obs_metrics.registry()
        self.labels = {"tenant": name}
        self.outcomes: Dict[str, obs_metrics.Counter] = {}
        for reason in (
            ACCEPTED, REJECTED_RATE, REJECTED_FULL, REJECTED_STALE,
            REJECTED_SHAPE, REJECTED_MALFORMED,
        ):
            self.outcomes[reason] = reg.counter(
                "byzpy_serving_submissions_total",
                help="serving admissions by outcome",
                labels={"tenant": name, "outcome": reason},
            )
        self.rounds = reg.counter(
            "byzpy_serving_rounds_total",
            help="closed serving rounds", labels=self.labels,
        )
        self.failed = reg.counter(
            "byzpy_serving_failed_rounds_total",
            help="crash-guarded (dropped) serving rounds", labels=self.labels,
        )
        self.ingress_bytes = reg.counter(
            "byzpy_serving_ingress_bytes_total",
            help="wire bytes of submit frames (length prefix included)",
            labels=self.labels,
        )
        self.submit_frames = reg.counter(
            "byzpy_serving_submit_frames_total",
            help="submit frames received on the TCP ingress",
            labels=self.labels,
        )
        self.queue_depth = reg.gauge(
            "byzpy_serving_queue_depth",
            help="admission queue depth", labels=self.labels,
        )
        self.outstanding = reg.gauge(
            "byzpy_serving_outstanding",
            help="admitted-but-not-aggregated submissions", labels=self.labels,
        )
        self.latency_s = reg.histogram(
            "byzpy_serving_round_latency_seconds",
            help="first-arrival-to-close latency of closed rounds",
            labels=self.labels,
        )
        self.cohort_m = reg.histogram(
            "byzpy_serving_cohort_size",
            help="closed-round cohort sizes", labels=self.labels,
            buckets=obs_metrics.SIZE_BUCKETS,
        )
        self.overlap_ratio = reg.gauge(
            "byzpy_round_overlap_ratio",
            help="fraction of the previous round's fold+device time that "
                 "ran hidden under the next window's admission "
                 "(cross-round pipelining; 0 = fully serial)",
            labels=self.labels,
        )
        reg.gauge(
            "byzpy_serving_tenant_dim",
            help="tenant gradient dimension (for the ingress-bytes law)",
            labels=self.labels,
        ).set(dim)

    def outcome(self, reason: str) -> None:
        """Count one admission outcome (unknown reasons get their
        counter on first sight)."""
        c = self.outcomes.get(reason)
        if c is None:
            c = self.outcomes[reason] = obs_metrics.registry().counter(
                "byzpy_serving_submissions_total",
                help="serving admissions by outcome",
                labels={**self.labels, "outcome": reason},
            )
        c.inc()


class _Tenant:
    """Runtime state behind one :class:`TenantConfig`."""

    __slots__ = (
        "cfg", "queue", "ledger", "ladder", "executor", "stats",
        "round_id", "ingress_bytes", "last_aggregate", "min_cohort",
        "outstanding", "round_done", "failed_rounds",
        "last_cohort_clients", "held", "telemetry", "track",
        "seqs", "duplicates", "durability", "breaker", "next_wal_id",
        "quarantine_drops", "recovered", "forensics", "compile_site",
        "ef_residual",
    )

    def __init__(
        self,
        cfg: TenantConfig,
        *,
        clock: Callable[[], float] = time.monotonic,
        track_prefix: str = "",
    ) -> None:
        self.cfg = cfg
        self.queue = AdmissionQueue(cfg.queue_capacity)
        self.ledger = CreditLedger(cfg.credit)
        self.ladder = BucketLadder(cfg.cohort_cap, min_bucket=cfg.min_bucket)
        #: telemetry track (trace row) this tenant's spans land on —
        #: shard-qualified (``shard:<i>/tenant:<name>``) when the
        #: frontend is one shard of the sharded tier, so a merged
        #: multi-shard trace keeps one lane per (shard, tenant)
        self.track = f"{track_prefix}tenant:{cfg.name}"
        self.executor = CohortAggregator(
            cfg.aggregator, tenant=cfg.name, track=self.track
        )
        # effective round floor: the operator's min_cohort raised to the
        # aggregator's smallest admissible n (probed via validate_n), so
        # the out-of-the-box config can never close a cohort the crash
        # guard would have to discard — accepted submissions must
        # aggregate, not vanish as failed rounds
        floor = cfg.min_cohort
        probe = getattr(cfg.aggregator, "validate_n", None)
        if callable(probe):
            for m in range(1, cfg.cohort_cap + 1):
                try:
                    probe(m)
                except ValueError:
                    continue
                floor = max(floor, m)
                break
            else:
                raise ValueError(
                    f"aggregator {cfg.aggregator!r} admits no cohort size "
                    f"<= cohort_cap={cfg.cohort_cap}"
                )
        self.min_cohort = floor
        self.stats = RoundStats()
        self.round_id = 0
        self.ingress_bytes = 0
        self.last_aggregate: Any = None
        #: admitted-but-not-yet-aggregated submissions (drain watches it)
        self.outstanding = 0
        self.round_done = asyncio.Event()
        #: rounds dropped by the crash guard (inadmissible cohort, OOM…)
        self.failed_rounds = 0
        #: the most recent closed round's cohort membership — the public
        #: acceptance record adaptive clients may observe
        self.last_cohort_clients: Tuple[str, ...] = ()
        #: under-strength submissions held open by the SYNCHRONOUS round
        #: closer (:meth:`ServingFrontend.close_round_nowait`); the async
        #: scheduler keeps its own held list
        self.held: list = []
        #: per-client highest ACCEPTED idempotency key (LRU-bounded like
        #: the credit ledger): a replayed ``(client, seq)`` at or below
        #: it is a duplicate — acked accepted, never re-folded
        self.seqs: "OrderedDict[str, int]" = OrderedDict()
        self.duplicates = 0
        #: write-ahead log + snapshots (attached by the frontend when a
        #: DurabilityConfig is given); ``next_wal_id`` is the per-tenant
        #: accept-record identity counter
        self.durability: Optional[TenantDurability] = None
        self.next_wal_id = 0
        self.breaker: Optional[CircuitBreaker] = (
            CircuitBreaker(cfg.breaker, clock=clock)
            if cfg.breaker is not None
            else None
        )
        #: queued submissions dropped (with accounting) when the breaker
        #: opened
        self.quarantine_drops = 0
        #: recovery provenance (``RecoveredTenant``), None on fresh start
        self.recovered: Any = None
        #: per-client forensics plane (None = not configured)
        self.forensics: Optional[ForensicsPlane] = (
            ForensicsPlane(cfg.name, cfg.forensics)
            if cfg.forensics is not None
            else None
        )
        #: program-build observability: the jitstats site this tenant
        #: reports its built programs into (the reference's name)
        self.compile_site = f"serving.masked_aggregate:{cfg.name}"
        #: downlink error-feedback residual (``(dim,)`` f32, lazily
        #: zeros on the first compressed broadcast): what the sub-int8
        #: broadcast fabric lost last round and re-injects this round
        #: (:meth:`ServingFrontend.broadcast_frame`). ROUND STATE —
        #: captured in durable snapshots; a WAL-tail recovery resets it
        #: to None, which is SAFE: any residual start point only shifts
        #: the telescoped stream by one round's bounded quantization
        #: error (pinned by the extended SIGKILL drill)
        self.ef_residual: Optional[np.ndarray] = None
        self.telemetry = _TenantTelemetry(cfg.name, cfg.dim)

    def note_seq(self, client: str, seq: int) -> None:
        """Record an accepted idempotency key (LRU-bounded)."""
        prev = self.seqs.get(client, -1)
        self.seqs[client] = max(prev, int(seq))
        self.seqs.move_to_end(client)
        if len(self.seqs) > self.cfg.credit.max_tracked_clients:
            self.seqs.popitem(last=False)

    def is_duplicate(self, client: str, seq: int) -> bool:
        return self.seqs.get(client, -1) >= int(seq)


class ServingFrontend:
    """The serving tier's front door (see module docstring)."""

    def __init__(
        self,
        tenants: Sequence[TenantConfig],
        *,
        clock: Callable[[], float] = time.monotonic,
        on_round: Optional[RoundCallback] = None,
        durability: Optional[DurabilityConfig] = None,
        shard: Optional[int] = None,
        pipeline_depth: int = 1,
    ) -> None:
        if not tenants:
            raise ValueError("at least one tenant is required")
        if pipeline_depth not in (0, 1):
            raise ValueError("pipeline_depth must be 0 or 1")
        #: cross-round pipelining depth for the async scheduler: 1
        #: (default) lets round N's fold + device step run on the
        #: executor while the NEXT window collects — the settle happens
        #: before the next cohort is built, so round ids, staleness
        #: judgments and aggregate bits are identical to the barrier
        #: path (depth 0). Ragged tenants always run barrier (their
        #: dispatch plane batches across tenants already).
        self.pipeline_depth = int(pipeline_depth)
        #: ingress-shard index when this frontend is one shard of a
        #: sharded tier (``serving.sharded``): stamps a ``shard`` dim
        #: onto the serving spans so a merged trace attributes
        #: admission/round work to the owning shard. None = the classic
        #: single-frontend deployment (no extra span arg).
        self.shard = shard
        self._shard_tag: Dict[str, Any] = (
            {} if shard is None else {"shard": int(shard)}
        )
        # shard-qualified telemetry tracks: every tenant row of a
        # sharded-tier frontend is named shard:<i>/tenant:<name>, so a
        # stitched multi-shard trace renders one lane per (shard,
        # tenant) instead of piling N shards onto one tenant row
        track_prefix = "" if shard is None else f"shard:{int(shard)}/"
        self._tenants: Dict[str, _Tenant] = {}
        for cfg in tenants:
            if cfg.name in self._tenants:
                raise ValueError(f"duplicate tenant {cfg.name!r}")
            self._tenants[cfg.name] = _Tenant(
                cfg, clock=clock, track_prefix=track_prefix
            )
        self._clock = clock
        self._on_round = on_round
        #: the ragged dispatch plane (``serving.ragged``): grouped
        #: one-program-per-tenant-group executors + the cross-tenant batcher.
        #: ``BYZPY_TPU_TORCH_RAGGED=0`` (read HERE, at construction) keeps
        #: every tenant on the bucket ladder; tenants whose aggregator
        #: has no masked program fall back to the ladder automatically.
        self._ragged: Optional[RaggedRuntime] = (
            RaggedRuntime(tenants) if ragged_enabled() else None
        )
        self._device_lock: Optional[asyncio.Lock] = None
        self._tasks: list = []
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._running = False
        #: optional first-look request handler (see
        #: :meth:`handle_request`) — the process-per-shard runner
        #: mounts its shard control plane here
        self.request_hook: Optional[Callable[[dict], Optional[dict]]] = None
        #: request kinds the mounted hook PROMISES to pass through
        #: (return ``None`` for, with no side effects). The batched
        #: ingress only admits a run of submit frames in one pass when
        #: ``"submit"`` is declared here (the shard runner's control
        #: hook qualifies); otherwise every frame still routes through
        #: :meth:`handle_request` so the hook sees it first.
        self.request_hook_passthrough: frozenset = frozenset()
        self._durability = durability
        #: per-tenant recovery provenance (RecoveredTenant or None) —
        #: populated when a DurabilityConfig points at a directory with
        #: prior life; a fresh directory leaves every value None
        self.recovered: Dict[str, Any] = {}
        #: strong refs to in-flight off-loop snapshot saves
        self._snapshot_futs: list = []
        if durability is not None:
            for name, t in self._tenants.items():
                self._attach_durability(t, durability)
        #: frames that failed HMAC verification / deserialization (the
        #: peer is dropped; no tenant can be trusted off a forged frame)
        self.bad_frames = 0
        #: decoded-but-nonsense requests (bad field types from a buggy
        #: client): answered with ``rejected_malformed``, peer kept
        self.malformed_requests = 0
        #: exceptions swallowed from the user's ``on_round`` callback
        #: (an observer bug must not kill a tenant's scheduler)
        self.callback_errors = 0
        # frontend-global registry mirrors of the three counters above
        # (+ unknown-tenant rejections, which name no tenant) — created
        # once; incremented only behind the telemetry flag
        reg = obs_metrics.registry()
        self._m_bad_frames = reg.counter(
            "byzpy_serving_bad_frames_total",
            help="frames dropped at the ingress (HMAC/decode/oversize)",
        )
        self._m_malformed = reg.counter(
            "byzpy_serving_malformed_requests_total",
            help="decoded frames with nonsense fields (peer kept)",
        )
        self._m_callback_errors = reg.counter(
            "byzpy_serving_callback_errors_total",
            help="exceptions swallowed from on_round observers",
        )
        self._m_unknown_tenant = reg.counter(
            "byzpy_serving_unknown_tenant_total",
            help="submissions naming no configured tenant",
        )
        #: batched-door accounting: every :meth:`serve_frames` call is
        #: one batch (the TCP ingress passes everything a wakeup
        #: drained); ``ingress_max_batch > 1`` is the smoke test's
        #: proof that the door actually amortizes
        self.ingress_batches = 0
        self.ingress_frames_batched = 0
        self.ingress_max_batch = 0
        self._m_batch_size = reg.histogram(
            "byzpy_ingress_batch_size",
            help="frames decoded per ingress batch (serve_frames call)",
            buckets=obs_metrics.SIZE_BUCKETS,
        )

    # -- durability / recovery -------------------------------------------

    @classmethod
    def recover(
        cls,
        tenants: Sequence[TenantConfig],
        durability: DurabilityConfig,
        *,
        clock: Callable[[], float] = time.monotonic,
        on_round: Optional[RoundCallback] = None,
    ) -> "ServingFrontend":
        """Reconstruct a frontend from durable state: every tenant is
        restored from its latest VALID snapshot generation (corrupt ones
        fall back) plus write-ahead-log replay — round numbering resumes
        monotonically, accepted-but-unfolded submissions re-enter the
        queue, and the dedup table rejects stale ``(client, seq)``
        replays. Raises :class:`~byzpy_tpu_torch.utils.checkpoint.
        CheckpointNotFoundError` when NO tenant has prior state (use the
        plain constructor for a maybe-fresh start: it recovers when
        state exists and starts clean when it doesn't)."""
        fe = cls(
            tenants, clock=clock, on_round=on_round, durability=durability
        )
        if not any(r is not None for r in fe.recovered.values()):
            raise CheckpointNotFoundError(
                f"no durable tenant state under {durability.directory} — "
                "nothing to recover"
            )
        return fe

    def _attach_durability(self, t: _Tenant, cfg: DurabilityConfig) -> None:
        t.durability = TenantDurability(cfg, t.cfg.name)
        rec = t.durability.recovered
        self.recovered[t.cfg.name] = rec
        if rec is None:
            return
        t.round_id = rec.round_id
        t.last_aggregate = rec.last_aggregate
        t.seqs = OrderedDict(rec.seqs)
        t.next_wal_id = rec.next_wal_id
        t.ledger.totals = dict(rec.ledger_totals)
        t.failed_rounds = rec.failed_rounds
        t.ingress_bytes = rec.ingress_bytes
        t.stats.rounds = rec.stats_rounds
        # downlink EF residual: bit-exact from the snapshot; rounds the
        # WAL replayed PAST the snapshot make it stale, which error
        # feedback self-corrects within one round's quantization bound
        # (safe-to-reset contract — see _Tenant.ef_residual)
        t.ef_residual = rec.ef_residual
        # accepted-before-death, never folded: back into the queue (the
        # arrival stamp is re-issued on THIS process's clock — monotonic
        # time does not survive a process boundary)
        now = self._clock()
        pending = [
            Submission(
                client=p["c"], round_submitted=int(p["r"]),
                gradient=p["g"], arrived_s=now,
                seq=p["q"], wal_id=int(p["w"]),
                # the ingress-measured pre-decode block ratio survives
                # the crash with its accept record: a shaped frame
                # admitted just before the kill still reaches the
                # residual_shaping detector when its replay folds
                wire_inflation=p.get("wi"),
            )
            for p in rec.pending
        ]
        t.queue.restore(pending)
        t.outstanding = len(pending)
        t.recovered = rec
        obs_metrics.registry().counter(
            "byzpy_recoveries_total",
            help="tenant recoveries from durable round state",
            labels={"tenant": t.cfg.name},
        ).inc()

    def _write_ahead(self, t: _Tenant, sub: Submission) -> None:
        """Append the accept record BEFORE the ack is returned — the ack
        must be a durable promise (module contract)."""
        assert t.durability is not None and sub.wal_id is not None
        t.durability.record_accept(
            sub.wal_id, sub.client, sub.seq, sub.round_submitted,
            sub.arrived_s, sub.gradient,
            wire_inflation=sub.wire_inflation,
        )

    def _maybe_snapshot(self, t: _Tenant) -> None:
        """Periodic durable snapshot: capture state synchronously (no
        awaits — consistent with the WAL rotation), persist off the
        event loop when one is running, inline otherwise. A save that
        never completes is safe: recovery falls back to the previous
        generation and replays one segment more."""
        d = t.durability
        if d is None or not d.snapshot_due():
            return
        # host copies, taken here on the loop: the save runs on an
        # executor thread and must not read device memory the next round
        # may reuse
        state = {
            "round_id": t.round_id,
            "last_aggregate": (
                np.array(host_array(t.last_aggregate))
                if t.last_aggregate is not None
                else None
            ),
            "seqs": dict(t.seqs),
            "next_wal_id": t.next_wal_id,
            "ledger_totals": dict(t.ledger.totals),
            "failed_rounds": t.failed_rounds,
            "ingress_bytes": t.ingress_bytes,
            "stats_rounds": t.stats.rounds,
            "ef_residual": (
                None if t.ef_residual is None else np.array(host_array(t.ef_residual))
            ),
            "pending": [
                {
                    "w": s.wal_id, "c": s.client, "q": s.seq,
                    "r": s.round_submitted, "t": s.arrived_s,
                    "g": s.gradient, "wi": s.wire_inflation,
                }
                for s in (*t.queue.snapshot_items(), *t.held)
            ],
        }
        save = d.rotate_and_capture(t.round_id, state)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            save()
            return
        fut = loop.run_in_executor(None, save)
        self._snapshot_futs.append(fut)
        fut.add_done_callback(self._snapshot_done)

    def _snapshot_done(self, fut) -> None:
        try:
            self._snapshot_futs.remove(fut)
        except ValueError:  # pragma: no cover
            pass
        if not fut.cancelled() and fut.exception() is not None:
            # a failed snapshot is a degraded-durability event, not a
            # serving outage: the WAL still has everything
            obs_metrics.registry().counter(
                "byzpy_snapshot_failures_total",
                help="snapshot saves that raised (WAL still authoritative)",
            ).inc()

    def _quarantine_drain(self, t: _Tenant, opened: bool) -> None:
        """On a breaker OPEN transition, drain the admission queue with
        accounting: clients see rejections (and, with durability, the
        WAL records the drop) instead of acks destined for the floor."""
        if not opened:
            return
        dropped = t.queue.drain_nowait(t.queue.capacity + t.cfg.cohort_cap)
        if dropped:
            t.outstanding -= len(dropped)
            t.quarantine_drops += len(dropped)
            t.round_done.set()
            if t.durability is not None:
                t.durability.record_dropped(
                    t.round_id,
                    tuple(
                        s.wal_id for s in dropped if s.wal_id is not None
                    ),
                    "quarantine",
                )
        obs_metrics.registry().counter(
            "byzpy_serving_quarantines_total",
            help="circuit-breaker open transitions (tenant quarantined)",
            labels={"tenant": t.cfg.name},
        ).inc()

    # -- admission (synchronous, cheap) ----------------------------------

    def submit(
        self,
        tenant: str,
        client: str,
        round_submitted: int,
        gradient: Any,
        *,
        seq: Optional[int] = None,
        wire_inflation: Optional[float] = None,
        _now: Optional[float] = None,
    ) -> Tuple[bool, str]:
        """Admit one submission: ``(accepted, reason)``.

        Gates, in order: tenant exists; not a replayed idempotency key
        (a duplicate ``(client, seq)`` answers ``(True, "duplicate")``
        WITHOUT re-enqueuing — the original folds exactly once, so a
        client retrying an ack the wire lost cannot double-fold);
        tenant not quarantined by its circuit breaker; gradient is a
        ``(dim,)`` float row (non-finite VALUES pass — adversarial
        payloads are the aggregators' job, shape abuse is the tier's);
        within the staleness cutoff; client has rate credit; queue has
        capacity. With durability attached, the accept record hits the
        write-ahead log before this returns — the ack is a durable
        promise. ``seq`` keys must be per-client monotonic (the
        :class:`ServingClient` auto-assigns them); only definitively
        un-acked submissions should be retried under the same key.
        ``wire_inflation`` (stamped by the TCP ingress from the
        still-compressed frame) is the pre-decode block-inflation ratio
        the forensics plane's residual-shaping detector screens.

        ``gradient`` may arrive STILL COMPRESSED (a blockwise
        :class:`~byzpy_tpu_torch.engine.actor.wire.QuantizedWireArray` kept
        by the batched ingress): the shape gate reads the codec's
        declared ``(dim,)`` float shape and the row stays codes+scales
        through the queue — dequantization happens in the fold (device-
        side on the ragged door, bit-identical host decode otherwise).
        ``_now`` lets the batched admission stamp one clock read across
        a drained batch (arrival order is preserved; the rows were all
        on the socket at the same wakeup)."""
        t = self._tenants.get(tenant)
        if t is None:
            if obs_runtime.STATE.enabled:
                self._m_unknown_tenant.inc()
            return False, REJECTED_TENANT
        telemetry = obs_runtime.STATE.enabled
        now = self._clock() if _now is None else _now
        if seq is not None and t.is_duplicate(client, seq):
            t.duplicates += 1
            t.ledger.record(DUPLICATE, client)
            if telemetry:
                t.telemetry.outcome(DUPLICATE)
            return True, DUPLICATE
        if t.breaker is not None and not t.breaker.allow():
            t.ledger.record(REJECTED_QUARANTINED, client)
            if telemetry:
                t.telemetry.outcome(REJECTED_QUARANTINED)
            return False, REJECTED_QUARANTINED
        if t.forensics is not None and not t.forensics.allows(
            client, t.round_id
        ):
            # per-CLIENT quarantine (trust ledger), distinct from the
            # breaker's per-TENANT quarantine above; the transition
            # itself is WAL-recorded at round close (never silent)
            t.ledger.record(REJECTED_UNTRUSTED, client)
            if telemetry:
                t.telemetry.outcome(REJECTED_UNTRUSTED)
            return False, REJECTED_UNTRUSTED
        if isinstance(gradient, wire.QuantizedWireArray):
            # still-compressed row: the codec's declared shape/dtype is
            # what the gate judges (the codes were already validated
            # against the honest-encoder layout at decode_batch time)
            row: Any = gradient
            if not (
                gradient.mode in wire.BLOCKWISE_WIRE_MODES
                and len(gradient.shape) == 1
                and int(gradient.shape[0]) == t.cfg.dim
                and _float_dtype_name(gradient.dtype)
            ):
                t.ledger.record(REJECTED_SHAPE, client)
                if telemetry:
                    t.telemetry.outcome(REJECTED_SHAPE)
                return False, REJECTED_SHAPE
        else:
            # a tensor (a card tensor in process, a host tensor off the
            # wire) is kept as a host numpy row, as the reference keeps it
            row = _host_row(gradient)
            if (
                row is None
                or row.ndim != 1
                or row.shape[0] != t.cfg.dim
                or row.dtype.kind != "f"
            ):
                t.ledger.record(REJECTED_SHAPE, client)
                if telemetry:
                    t.telemetry.outcome(REJECTED_SHAPE)
                return False, REJECTED_SHAPE
        delta = t.round_id - int(round_submitted)
        if not t.cfg.staleness.admits(delta):
            t.ledger.record(REJECTED_STALE, client)
            if telemetry:
                t.telemetry.outcome(REJECTED_STALE)
            return False, REJECTED_STALE
        rate_scale = (
            t.forensics.rate_scale(client) if t.forensics is not None else 1.0
        )
        if not t.ledger.admit(client, now, rate_scale=rate_scale):
            t.ledger.record(REJECTED_RATE, client)
            if telemetry:
                t.telemetry.outcome(REJECTED_RATE)
            return False, REJECTED_RATE
        sub = Submission(
            client=client,
            round_submitted=int(round_submitted),
            gradient=row,
            arrived_s=now,
            seq=None if seq is None else int(seq),
            wal_id=(t.next_wal_id if t.durability is not None else None),
            wire_inflation=(
                None if wire_inflation is None else float(wire_inflation)
            ),
        )
        if t.durability is not None:
            # capacity gate BEFORE the write-ahead append, so a row is
            # only ever logged if it will actually enqueue (a logged-
            # then-rejected row would resurrect on recovery); then the
            # append BEFORE the enqueue, so a row is only ever queued if
            # it is durable (an enqueued-but-unlogged row would fold
            # while its failed ack invites a replay — double fold).
            # Admission is single-threaded on the owning loop, so the
            # pre-check cannot race the offer below.
            if t.queue.depth() >= t.queue.capacity:
                t.queue.rejected_full += 1
                t.ledger.record(REJECTED_FULL, client)
                if telemetry:
                    t.telemetry.outcome(REJECTED_FULL)
                return False, REJECTED_FULL
            try:
                self._write_ahead(t, sub)
            except Exception:  # noqa: BLE001 — ENOSPC etc.: the ack
                # cannot be a durable promise, so refuse it outright
                # (nothing was enqueued; a retry under the same seq is
                # NOT a duplicate and may succeed once the disk heals)
                t.ledger.record(REJECTED_UNDURABLE, client)
                if telemetry:
                    t.telemetry.outcome(REJECTED_UNDURABLE)
                return False, REJECTED_UNDURABLE
            t.next_wal_id += 1
        ok = t.queue.offer(sub)
        if not ok:
            t.ledger.record(REJECTED_FULL, client)
            if telemetry:
                t.telemetry.outcome(REJECTED_FULL)
            return False, REJECTED_FULL
        if seq is not None:
            t.note_seq(client, seq)
        t.outstanding += 1
        t.ledger.record(ACCEPTED, client)
        if telemetry:
            t.telemetry.outcome(ACCEPTED)
            t.telemetry.queue_depth.set(t.queue.depth())
            t.telemetry.outstanding.set(t.outstanding)
        return True, ACCEPTED

    def handle_request(self, request: Any) -> dict:
        """Serve one decoded wire request (``submit``/``stats``).

        A frame that decodes (HMAC-valid) but carries nonsense fields —
        a non-numeric round, an unhashable tenant — is a buggy client,
        not a forged peer: it gets a ``rejected_malformed`` ack and the
        connection stays up, rather than an exception tearing down the
        handler with no accounting.

        ``request_hook`` (when set) sees every dict request FIRST and
        may claim it by returning a response dict (``None`` falls
        through to the built-in kinds) — the process-per-shard runner
        mounts its coordinator control plane (``shard_close``/
        ``confirm``/``requeue``/…) on the existing ingress this way,
        one port per shard for submissions and round control both. A
        hook response carrying ``LOSSLESS_REPLY: True`` is encoded with
        ``precision="off"`` (partial-fold rows must not ride a lossy
        ``BYZPY_TPU_TORCH_WIRE_PRECISION`` fabric)."""
        if not isinstance(request, dict):
            return {"kind": "ack", "accepted": False, "reason": "bad_frame"}
        if self.request_hook is not None:
            try:
                hooked = self.request_hook(request)
            except Exception:  # noqa: BLE001 — a hook bug is a
                # malformed-op ack, never a torn-down connection
                self.malformed_requests += 1
                if obs_runtime.STATE.enabled:
                    self._m_malformed.inc()
                return {
                    "kind": "ack",
                    "accepted": False,
                    "reason": REJECTED_MALFORMED,
                }
            if hooked is not None:
                return hooked
        kind = request.get("kind")
        if kind == "submit":
            tenant = request.get("tenant", "")
            try:
                seq = request.get("seq")
                wi = request.get("_wire_inflation")
                with obs_tracing.span(
                    "serving.admission",
                    tenant=tenant if isinstance(tenant, str) else "?",
                    **self._shard_tag,
                ):
                    accepted, reason = self.submit(
                        tenant if isinstance(tenant, str) else "",
                        str(request.get("client", "")),
                        int(request.get("round", 0)),
                        request.get("gradient"),
                        seq=None if seq is None else int(seq),
                        wire_inflation=None if wi is None else float(wi),
                    )
            except Exception:  # noqa: BLE001 — client bug, not ours
                self.malformed_requests += 1
                if obs_runtime.STATE.enabled:
                    self._m_malformed.inc()
                return {
                    "kind": "ack",
                    "accepted": False,
                    "reason": REJECTED_MALFORMED,
                    "round": -1,
                }
            t = (
                self._tenants.get(tenant)
                if isinstance(tenant, str)
                else None
            )
            return {
                "kind": "ack",
                "accepted": accepted,
                "reason": reason,
                "round": t.round_id if t is not None else -1,
            }
        if kind == "stats":
            name = request.get("tenant", "")
            t = self._tenants.get(name) if isinstance(name, str) else None
            if t is not None:
                # snapshot ONLY the requested tenant: a stats poll runs
                # on the admission loop, and each snapshot sorts the
                # latency window + top-ks the rejection map
                return {"kind": "stats", "stats": self._tenant_stats(t)}
            return {"kind": "ack", "accepted": False, "reason": REJECTED_TENANT}
        if kind == "close_round":
            # operator/drill door: drive the synchronous round closer
            # over the wire — deterministic round boundaries for the
            # kill-and-recover drill and virtual-clock deployments. Same
            # exclusivity contract as close_round_nowait (errors if the
            # async scheduler owns the rounds).
            name = request.get("tenant", "")
            t = self._tenants.get(name) if isinstance(name, str) else None
            if t is None:
                return {
                    "kind": "ack", "accepted": False,
                    "reason": REJECTED_TENANT,
                }
            try:
                closed = self.close_round_nowait(name)
            except RuntimeError as exc:
                return {
                    "kind": "ack", "accepted": False,
                    "reason": f"close_round_unavailable: {exc}",
                }
            return {
                "kind": "round",
                "closed": None if closed is None else closed[0],
                "digest": None if closed is None else _agg_digest(closed[2]),
                "round": t.round_id,
            }
        return {"kind": "ack", "accepted": False, "reason": "bad_frame"}

    # -- batched ingress -------------------------------------------------

    def serve_frames(
        self, bodies: Sequence[Any]
    ) -> Tuple[List[bytes], int, Optional[BaseException]]:
        """Serve a BATCH of wire frame bodies (bytes or memoryviews,
        length prefixes stripped) through one decode pass — the batched
        front door shared by the TCP ingress (everything one wakeup
        drained) and :func:`serve_frame` (a batch of one).

        HMAC verification, codec decode, and the pre-decode block-
        inflation forensics run vectorized across the whole batch
        (:func:`wire.decode_batch`); quantized gradient rows stay
        codes+scales through admission (``keep_quantized``). Admission
        itself still walks every frame IN ARRIVAL ORDER — consecutive
        submit frames ride one clock read and one span through
        :meth:`_handle_submit_batch`, anything else (stats polls, hook
        control frames, close_round) flushes the run and routes through
        :meth:`handle_request` exactly as before — so acks, ledger
        outcomes, and WAL-before-ack semantics are bit-identical to
        serving the frames one at a time.

        Returns ``(replies, served, error)``: encoded reply frames for
        the ``served`` leading bodies, and the decode/HMAC failure that
        stopped the batch (``None`` when every frame served). Frames
        past a failure are NOT decoded or served — the TCP ingress
        drops the peer there, exactly like the per-frame path."""
        nb = len(bodies)
        self.ingress_batches += 1
        self.ingress_frames_batched += nb
        if nb > self.ingress_max_batch:
            self.ingress_max_batch = nb
        if obs_runtime.STATE.enabled:
            self._m_batch_size.observe(float(nb))
        # same span name as the historical per-frame door — dashboards
        # and the observability smoke key on it; `frames` says how much
        # one decode pass amortized
        with obs_tracing.span(
            "serving.ingress.decode",
            bytes=sum(len(b) for b in bodies), frames=nb,
        ):
            recs = wire.decode_batch(bodies, keep_quantized=True)
        batch_submits = (
            self.request_hook is None
            or "submit" in self.request_hook_passthrough
        )
        replies: List[bytes] = []
        error: Optional[BaseException] = None
        pending: List[Tuple[dict, int, Any]] = []
        telemetry = obs_runtime.STATE.enabled

        def flush() -> None:
            if pending:
                replies.extend(self._handle_submit_batch(pending))
                pending.clear()

        for i, rec in enumerate(recs):
            if rec.error is not None:
                # a frame that fails HMAC/unpickle names no trustable
                # tenant: counted HERE (shared by the TCP and in-process
                # doors), frames behind it not served
                self._count_bad_frame()
                error = rec.error
                break
            request = rec.obj
            if isinstance(request, dict):
                # the ingress is the ONLY author of this key: a client-
                # stamped value is discarded, then the measured pre-
                # decode ratio — when the frame carried a blockwise
                # payload — is stamped fresh (same rule as per-frame)
                request.pop("_wire_inflation", None)
                if rec.stats is not None and request.get("kind") == "submit":
                    request["_wire_inflation"] = rec.stats["max_inflation"]
                if batch_submits and request.get("kind") == "submit":
                    pending.append((request, len(bodies[i]), rec.trace_ctx))
                    continue
            flush()
            # non-submit (or hook-owned) frames keep the per-frame
            # contract exactly: hook first, built-in kinds after —
            # with the frame's own trace context adopted and ingress-
            # bytes accounting mirroring the per-frame read loop
            if telemetry and rec.trace_ctx is not None:
                obs_tracing.adopt_context(rec.trace_ctx)
            if (
                isinstance(request, dict)
                and request.get("kind") == "submit"
            ):
                self._account_submit_bytes(request, len(bodies[i]))
            replies.append(encode_reply(self.handle_request(request)))
        flush()
        return replies, len(replies), error

    def _account_submit_bytes(self, request: dict, length: int) -> None:
        """Ingress accounting for ONE submit frame — mirrors the
        serving_ingress_bytes law (submission frames only; stats polls
        would skew the measured side)."""
        name = request.get("tenant")
        t = self._tenants.get(name) if isinstance(name, str) else None
        if t is None:
            return
        t.ingress_bytes += wire._HEADER.size + length
        if obs_runtime.STATE.enabled:
            t.telemetry.ingress_bytes.inc(wire._HEADER.size + length)
            t.telemetry.submit_frames.inc()

    def _handle_submit_batch(
        self, items: Sequence[Tuple[dict, int, Any]]
    ) -> List[bytes]:
        """Admit a run of consecutive decoded submit frames in one
        pass: one clock read across the run (the frames were all on
        the socket at the same wakeup) and per-tenant ingress-byte
        counters bumped once per run instead of once per frame. Every
        frame still walks the FULL per-frame gate order (dedup →
        breaker → trust → shape → staleness → credit → WAL-before-ack
        → enqueue) in arrival order under its own ``serving.admission``
        span (child of the sending client's stamped context), with the
        same malformed-field guard as :meth:`handle_request` — acks
        are bit-identical to the per-frame door."""
        telemetry = obs_runtime.STATE.enabled
        now = self._clock()
        # bytes first (the per-frame loop counts a frame's bytes before
        # computing its ack), summed per tenant in one pass
        per_tenant: Dict[str, Tuple[int, int]] = {}
        for request, length, _ctx in items:
            name = request.get("tenant")
            if isinstance(name, str) and name in self._tenants:
                nbytes, frames = per_tenant.get(name, (0, 0))
                per_tenant[name] = (
                    nbytes + wire._HEADER.size + length, frames + 1
                )
        for name, (nbytes, frames) in per_tenant.items():
            t = self._tenants[name]
            t.ingress_bytes += nbytes
            if telemetry:
                t.telemetry.ingress_bytes.inc(nbytes)
                t.telemetry.submit_frames.inc(frames)
        replies: List[bytes] = []
        for request, _length, ctx in items:
            tenant = request.get("tenant", "")
            if telemetry and ctx is not None:
                obs_tracing.adopt_context(ctx)
            try:
                seq = request.get("seq")
                wi = request.get("_wire_inflation")
                with obs_tracing.span(
                    "serving.admission",
                    tenant=tenant if isinstance(tenant, str) else "?",
                    **self._shard_tag,
                ):
                    accepted, reason = self.submit(
                        tenant if isinstance(tenant, str) else "",
                        str(request.get("client", "")),
                        int(request.get("round", 0)),
                        request.get("gradient"),
                        seq=None if seq is None else int(seq),
                        wire_inflation=None if wi is None else float(wi),
                        _now=now,
                    )
            except Exception:  # noqa: BLE001 — client bug, not ours
                self.malformed_requests += 1
                if telemetry:
                    self._m_malformed.inc()
                replies.append(encode_reply({
                    "kind": "ack",
                    "accepted": False,
                    "reason": REJECTED_MALFORMED,
                    "round": -1,
                }))
                continue
            t = (
                self._tenants.get(tenant)
                if isinstance(tenant, str)
                else None
            )
            replies.append(encode_reply({
                "kind": "ack",
                "accepted": accepted,
                "reason": reason,
                "round": t.round_id if t is not None else -1,
            }))
        return replies

    # -- scheduling ------------------------------------------------------

    async def start(self) -> None:
        """Launch one cohort-scheduler task per tenant."""
        if self._running:
            return
        self._running = True
        self._device_lock = asyncio.Lock()
        if self._ragged is not None:
            await self._ragged.start(self._device_lock)
        self._tasks = [
            asyncio.create_task(
                self._tenant_loop(t), name=f"serving-{name}"
            )
            for name, t in self._tenants.items()
        ]

    async def close(self) -> None:
        """Stop schedulers and the TCP server (idempotent); settle any
        in-flight snapshot saves and close the WAL segments."""
        self._running = False
        for task in self._tasks:
            task.cancel()
        for task in self._tasks:
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._tasks = []
        if self._ragged is not None:
            await self._ragged.close()
        if self._server is not None:
            self._server.close()
            # drop live ingress connections too: a closed frontend must
            # not keep admitting on old sockets (its WAL is about to
            # close, and clients must fail over to the recovered
            # process — same policy as RemoteActorServer.close)
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
            self._server = None
        if self._snapshot_futs:
            await asyncio.gather(
                *list(self._snapshot_futs), return_exceptions=True
            )
        for t in self._tenants.values():
            if t.durability is not None:
                t.durability.close()

    def _fail_round(
        self, t: _Tenant, cohort: Cohort, subs: Sequence[Submission] = ()
    ) -> None:
        """Round-drop bookkeeping shared by both round closers: a
        poisoned cohort counts a ``failed_round`` and releases its
        outstanding rows — never silent, never fatal. With durability,
        the drop is WAL-recorded (recovery must not resurrect it); with
        a breaker, the failure counts toward quarantine and an OPEN
        transition drains the queue."""
        t.failed_rounds += 1
        t.outstanding -= cohort.m
        t.round_done.set()
        if t.durability is not None:
            t.durability.record_dropped(
                t.round_id,
                tuple(s.wal_id for s in subs if s.wal_id is not None),
                "failed_round",
            )
        if t.breaker is not None:
            self._quarantine_drain(t, t.breaker.record_failure())
        if obs_runtime.STATE.enabled:
            t.telemetry.failed.inc()
            t.telemetry.outstanding.set(t.outstanding)

    def _finish_round(
        self,
        t: _Tenant,
        cohort: Cohort,
        vec: Any,
        subs: Sequence[Submission] = (),
        forensics_prep: Optional[dict] = None,
    ) -> int:
        """Round-close bookkeeping shared by the async scheduler and
        :meth:`close_round_nowait` (ONE copy, so the async and
        virtual-time paths cannot drift): publish the aggregate and
        cohort membership, persist the round record (+ periodic
        snapshot) when durability is attached, record telemetry, advance
        the round counter, release outstanding rows, fire the
        (crash-guarded) observer. Returns the closed round id."""
        if t.durability is not None:
            t.durability.record_round(
                t.round_id,
                tuple(s.wal_id for s in subs if s.wal_id is not None),
                _agg_digest(vec),
                cohort.m,
            )
            t.durability.note_round_closed()
        if t.breaker is not None:
            t.breaker.record_success()
        if t.forensics is not None:
            self._observe_forensics(t, cohort, vec, subs, forensics_prep)
        self._note_compiles(t)
        t.last_aggregate = vec
        t.last_cohort_clients = cohort.clients
        latency_s = self._clock() - cohort.first_arrival_s
        t.stats.record(latency_s, cohort.m)
        closed = t.round_id
        t.round_id += 1
        t.outstanding -= cohort.m
        t.round_done.set()
        self._maybe_snapshot(t)
        if sanitize.enabled():
            # exactly-once fold audit: both close paths (async scheduler
            # and close_round_nowait) funnel through here, so a repeated
            # round id or a twice-folded idempotency key IS a double fold
            sanitize.audit_fold(
                t.cfg.name, closed, [(s.client, s.seq) for s in subs]
            )
        if obs_runtime.STATE.enabled:
            t.telemetry.rounds.inc()
            t.telemetry.latency_s.observe(latency_s)
            t.telemetry.cohort_m.observe(cohort.m)
            t.telemetry.queue_depth.set(t.queue.depth())
            t.telemetry.outstanding.set(t.outstanding)
        with obs_tracing.span(
            "serving.broadcast",
            track=t.track,
            tenant=t.cfg.name,
            round=closed,
        ):
            if self._on_round is not None:
                try:
                    self._on_round(t.cfg.name, closed, cohort, vec)
                except Exception:  # noqa: BLE001 — an observer bug must
                    # not kill the scheduler any more than a poisoned
                    # cohort may; counted, never silent
                    self.callback_errors += 1
                    if obs_runtime.STATE.enabled:
                        self._m_callback_errors.inc()
        return closed

    def _forensics_prepare(
        self,
        t: _Tenant,
        cohort: Cohort,
        vec: Any,
        subs: Sequence[Submission],
        precomputed: Optional[dict] = None,
    ) -> Optional[dict]:
        """The plane's HEAVY stage (features + the aggregator's score
        view) for one closed round — pure, so the async scheduler runs
        it on the fold executor, off the event loop (the O(m²·d) Krum
        score pass must not stall ingress any more than the fold
        itself would). On the ragged path ``precomputed`` carries the
        score view that rode the aggregation kernel
        (``RaggedView.precomputed``) and the host score pass is
        skipped entirely. Returns None on failure (counted)."""
        assert t.forensics is not None
        try:
            deltas = (
                [t.round_id - s.round_submitted for s in subs]
                if len(subs) == cohort.m
                else None
            )
            wire_inflations = (
                [s.wire_inflation for s in subs]
                if len(subs) == cohort.m
                else None
            )
            return t.forensics.prepare(
                t.round_id,
                cohort.matrix,
                cohort.valid,
                cohort.clients,
                vec,
                aggregator=t.executor.aggregator,
                weights=cohort.weights,
                deltas=deltas,
                bucket=cohort.bucket,
                precomputed=precomputed,
                wire_inflations=wire_inflations,
            )
        except Exception:  # noqa: BLE001 — attribution is an observer,
            # not a round participant
            self.callback_errors += 1
            if obs_runtime.STATE.enabled:
                self._m_callback_errors.inc()
            return None

    def _observe_forensics(
        self,
        t: _Tenant,
        cohort: Cohort,
        vec: Any,
        subs: Sequence[Submission],
        prep: Optional[dict] = None,
    ) -> None:
        """Feed one closed round to the tenant's forensics plane and
        persist the evidence + any quarantine/readmit transitions to
        the WAL (when durability is attached). Host-side work on data
        the round already produced — the aggregate bits are untouched,
        and a plane failure must never fail a round that already
        aggregated (crash-guarded, counted via callback_errors).
        ``prep`` is a precomputed :meth:`ForensicsPlane.prepare` result
        (the async scheduler computes it on the fold executor); without
        one the heavy stage runs inline (sync round closer)."""
        assert t.forensics is not None
        if prep is None:
            prep = self._forensics_prepare(t, cohort, vec, subs)
            if prep is None:
                return
        try:
            ev = t.forensics.apply(prep)
        except Exception:  # noqa: BLE001 — same stance as prepare
            self.callback_errors += 1
            if obs_runtime.STATE.enabled:
                self._m_callback_errors.inc()
            return
        # drain transitions unconditionally (they must not pile up when
        # durability is off); persist them when it is on. A failed
        # append RE-QUEUES the unpersisted transitions — they are
        # one-shot events the audit trail promises to carry, so the
        # next round's close retries them (the round's evidence record
        # itself is not retried: every round produces a fresh one)
        transitions = t.forensics.pop_transitions()
        if t.durability is None or not t.forensics.cfg.wal_evidence:
            return
        try:
            t.durability.record_evidence(t.round_id, ev.to_wire())
            while transitions:
                t.durability.record_evidence(t.round_id, transitions[0])
                transitions.pop(0)
        except Exception:  # noqa: BLE001 — degraded durability, not a
            # serving outage (same stance as snapshot failures)
            t.forensics.requeue_transitions(transitions)
            self.callback_errors += 1
            if obs_runtime.STATE.enabled:
                self._m_callback_errors.inc()

    def _note_compiles(self, t: _Tenant) -> None:
        """Program-build observability: report the programs the tenant's
        round path built to its jitstats site (``byzpy_jit_compiles_total``,
        ``observability.jitstats``). The reference counts its masked
        aggregate's jit cache here and warns past the ladder's shapes; the
        port's masked aggregate runs eagerly and builds nothing, so a
        bucketed tenant reports nothing, and a ragged-served tenant reports
        its group executor's programs (one dense, one a wire spec: never
        more than expected, so no alarm)."""
        ex = self._ragged.executor_for(t.cfg.name) if self._ragged is not None else None
        size = obs_jitstats.programs_built(ex)
        if size is not None:
            obs_jitstats.note_cache_size(t.compile_site, size)

    async def _tenant_loop(self, t: _Tenant) -> None:
        loop = asyncio.get_running_loop()
        ragged_served = (
            self._ragged is not None and self._ragged.serves(t.cfg.name)
        )
        # cross-round pipelining only applies to the in-process fold
        # path: ragged tenants hand their rounds to the shared dispatch
        # thread (which already overlaps tenants against each other), so
        # they stay on the barrier path regardless of pipeline_depth
        pipelined = self.pipeline_depth > 0 and not ragged_served
        # adopt anything a prior synchronous round closer parked in
        # t.held (sequential sync -> async handover): those rows were
        # admitted and count in `outstanding`, so abandoning them would
        # lose submissions and deadlock drain()
        held: list = list(t.held)
        t.held.clear()
        # the one in-flight (dispatched, unsettled) round when
        # pipelining: settled after the NEXT window's collect returns and
        # BEFORE its cohort is built, so round ids, staleness judgments
        # and aggregate bits are identical to the barrier path — only
        # the admission window overlaps the fold + device step
        pending: Optional[dict] = None

        async def settle() -> None:
            nonlocal pending
            if pending is None:
                return
            p, pending = pending, None
            wait_start = self._clock()
            try:
                vec, prep = await p["fut"]
            except Exception:  # noqa: BLE001 — poisoned cohort: drop
                # the round, keep serving (same contract as the barrier
                # path's crash guard)
                self._fail_round(t, p["cohort"], p["subs"])
                obs_tracing.end_span(p["span"])
                return
            # finish under the round's context so the broadcast span
            # stays a child of the (still-open) round span
            with obs_tracing.context_scope(
                getattr(p["span"], "context", None)
            ):
                self._finish_round(t, p["cohort"], vec, p["subs"], prep)
            obs_tracing.end_span(p["span"])
            done_s = p["done_s"] or wait_start
            span_s = done_s - p["kicked"]
            if obs_runtime.STATE.enabled and span_s > 0:
                hidden = max(0.0, min(done_s, wait_start) - p["kicked"])
                t.telemetry.overlap_ratio.set(
                    max(0.0, min(1.0, hidden / span_s))
                )

        while self._running:
            # stall watchdog: a gap far beyond the admission window
            # means a blocking call rode this loop (threshold generous —
            # collect legitimately waits the full window, folds overlap)
            sanitize.loop_tick(
                f"serving.tenant_loop.{t.cfg.name}",
                threshold_s=max(30.0, 10.0 * t.cfg.window_s),
            )
            more = await t.queue.collect(
                t.cfg.cohort_cap - len(held), t.cfg.window_s
            )
            held.extend(more)
            # settle the overlapped round FIRST: its _finish_round must
            # advance round_id and release outstanding rows before the
            # next cohort is built (bit-identity with the barrier path),
            # and it must settle even on an under-strength window so
            # drain() cannot hang on an already-folded round
            await settle()
            if len(held) < t.min_cohort:
                # under-strength window: hold the round open until the
                # cohort reaches the tenant's floor (the aggregator's
                # smallest admissible n) — the window restarts on the
                # next arrival
                continue
            subs, held = held, []
            track = t.track
            if pipelined:
                sp = obs_tracing.begin_span(
                    "serving.round", track=track, tenant=t.cfg.name,
                    round=t.round_id, m=len(subs), pipelined=True,
                    **self._shard_tag,
                )
                with obs_tracing.context_scope(
                    getattr(sp, "context", None)
                ):
                    with obs_tracing.span(
                        "serving.cohort_close", track=track,
                        round=t.round_id, m=len(subs),
                    ):
                        cohort = build_cohort(
                            subs, t.round_id, t.ladder,
                            t.cfg.staleness, device=t.executor.aggregator.device, tenant=t.cfg.name,
                            track=track,
                        )
                    sp.set(bucket=cohort.bucket)
                    assert self._device_lock is not None
                    # hold the device lock across the dispatch: other
                    # tenants' rounds queue behind this fold exactly as
                    # on the barrier path; released by the future's done
                    # callback (which runs on this loop)
                    await self._device_lock.acquire()
                    entry: dict = {
                        "subs": subs, "cohort": cohort, "span": sp,
                        "kicked": self._clock(), "done_s": None,
                    }

                    def fold_and_prepare(
                        subs=subs, cohort=cohort, entry=entry
                    ):
                        try:
                            v = t.executor.aggregate(cohort)
                            p = (
                                self._forensics_prepare(t, cohort, v, subs)
                                if t.forensics is not None
                                else None
                            )
                            return v, p
                        finally:
                            # fold-complete timestamp feeds the
                            # overlap-ratio gauge at settle
                            entry["done_s"] = self._clock()

                    fut = loop.run_in_executor(
                        None,
                        obs_tracing.carry_context(fold_and_prepare),
                    )
                    fut.add_done_callback(
                        lambda _f: self._device_lock.release()
                    )
                    entry["fut"] = fut
                    pending = entry
                continue
            with obs_tracing.span(
                "serving.round", track=track, tenant=t.cfg.name,
                round=t.round_id, m=len(subs), **self._shard_tag,
            ) as round_span:
                with obs_tracing.span(
                    "serving.cohort_close", track=track,
                    round=t.round_id, m=len(subs),
                ):
                    # ragged tenants pack at the EXACT cohort size (the
                    # program's shape lives in the flat batch); ladder
                    # tenants pad to their bucket as before
                    # ragged rounds keep wire-quantized rows compressed
                    # (codes+scales) all the way into the fold — the
                    # executor dequantizes device-side
                    cohort = build_cohort(
                        subs, t.round_id,
                        None if ragged_served else t.ladder,
                        t.cfg.staleness, device=t.executor.aggregator.device, tenant=t.cfg.name, track=track,
                        quantized=ragged_served,
                    )
                round_span.set(bucket=cohort.bucket)
                assert self._device_lock is not None

                if ragged_served:
                    assert self._ragged is not None
                    try:
                        # ONE awaited hop: the batcher's dispatch thread
                        # gates finiteness, runs the ragged program (or
                        # the exact fallback for a non-finite cohort),
                        # and coalesces other tenants' pending cohorts
                        # into the same device call
                        view = await self._ragged.aggregate_async(
                            t.cfg.name, cohort, t.executor
                        )
                        prep = None
                        if t.forensics is not None:
                            # host features still run off-loop; the
                            # O(m²·d) score pass rode the kernel
                            prep = await loop.run_in_executor(
                                None,
                                obs_tracing.carry_context(
                                    lambda v=view, c=cohort, s=subs:
                                    self._forensics_prepare(
                                        t, c, v.vector, s,
                                        precomputed=v.precomputed(),
                                    )
                                ),
                            )
                    except Exception:  # noqa: BLE001 — poisoned
                        # batch/round: drop it, keep serving
                        self._fail_round(t, cohort, subs)
                        continue
                    self._finish_round(
                        t, cohort, view.vector, subs, prep
                    )
                    continue

                def fold_and_prepare(subs=subs, cohort=cohort):
                    # device work AND the forensics heavy stage (the
                    # O(m²·d) score pass) both off the event loop:
                    # ingress keeps admitting while this tenant's
                    # round aggregates and attributes
                    v = t.executor.aggregate(cohort)
                    p = (
                        self._forensics_prepare(t, cohort, v, subs)
                        if t.forensics is not None
                        else None
                    )
                    return v, p

                try:
                    async with self._device_lock:
                        # context carried across the executor hop: the
                        # fold/device-step spans stay children of this
                        # round's span, not orphan roots
                        vec, prep = await loop.run_in_executor(
                            None,
                            obs_tracing.carry_context(fold_and_prepare),
                        )
                except Exception:  # noqa: BLE001 — a poisoned cohort must
                    # never kill the scheduler: drop the round, keep serving
                    self._fail_round(t, cohort, subs)
                    continue
                self._finish_round(t, cohort, vec, subs, prep)
        # graceful stop (close() flips _running before cancelling): an
        # already-folded in-flight round is published, not lost
        await settle()

    async def drain(self, tenant: str) -> int:
        """Wait until every ADMISSIBLE submission of ``tenant`` has been
        aggregated (queued AND in-flight rounds); returns the tenant's
        round counter (test and shutdown helper).

        Leftovers below ``min_cohort`` are NOT waited for: they cannot
        form an admissible round until more arrive, so waiting on them
        would deadlock the caller against a window the scheduler is
        holding open on purpose — ``stats()``'s ``outstanding`` gauge
        still reports them (the scheduler may have already popped them
        off the queue into its held cohort, so ``queue_depth`` alone
        can read 0 while submissions are pending)."""
        t = self._tenants[tenant]
        while t.outstanding >= t.min_cohort:
            t.round_done.clear()
            await t.round_done.wait()
        return t.round_id

    # -- virtual-time round closing (chaos harness) ----------------------

    def close_round_nowait(self, tenant: str) -> Optional[Tuple[int, Any, Any]]:
        """Synchronously close one round of ``tenant`` from whatever is
        queued — the virtual-clock twin of the async scheduler, used by
        the reference's chaos harness to replay the REAL
        admission + cohort + masked-aggregate path deterministically.

        Drains the admission queue into the tenant's held list; when the
        held cohort reaches the ``min_cohort`` floor, builds the padded
        cohort, aggregates it (crash-guarded exactly like the scheduler:
        a poisoned cohort counts a ``failed_round`` and is dropped), and
        advances the round counter. Returns ``(closed_round_id, cohort,
        aggregate)``, or ``None`` while the window stays open (or the
        round failed). One round closer per deployment: mixing with the
        async scheduler would split submissions across two held lists
        and double-drive the round counter, so a running scheduler is a
        checked error."""
        if self._tasks:
            raise RuntimeError(
                "close_round_nowait cannot run next to the async cohort "
                "scheduler (start() was called) — use one round closer"
            )
        t = self._tenants[tenant]
        t.held.extend(t.queue.drain_nowait(t.cfg.cohort_cap - len(t.held)))
        if len(t.held) < t.min_cohort:
            return None
        subs, t.held = t.held, []
        ragged_served = (
            self._ragged is not None and self._ragged.serves(t.cfg.name)
        )
        track = t.track
        with obs_tracing.span(
            "serving.round", track=track, tenant=t.cfg.name,
            round=t.round_id, m=len(subs), **self._shard_tag,
        ):
            with obs_tracing.span(
                "serving.cohort_close", track=track,
                round=t.round_id, m=len(subs),
            ):
                cohort = build_cohort(
                    subs, t.round_id,
                    None if ragged_served else t.ladder,
                    t.cfg.staleness, device=t.executor.aggregator.device, tenant=t.cfg.name, track=track,
                    quantized=ragged_served,
                )
            try:
                view: Optional[RaggedView] = None
                # cohort.finite() judges a quantized cohort from its
                # codes+scales without materializing host f32 rows —
                # exactly np.isfinite(cohort.matrix).all()
                if ragged_served and cohort.finite():
                    assert self._ragged is not None
                    view = self._ragged.aggregate_sync(t.cfg.name, cohort)
                if view is not None:
                    vec = view.vector
                    prep = (
                        self._forensics_prepare(
                            t, cohort, vec, subs,
                            precomputed=view.precomputed(),
                        )
                        if t.forensics is not None
                        else None
                    )
                else:
                    vec = t.executor.aggregate(cohort)
                    prep = None
            except Exception:  # noqa: BLE001 — same contract as the scheduler
                self._fail_round(t, cohort, subs)
                return None
            return (
                self._finish_round(t, cohort, vec, subs, prep), cohort, vec
            )

    def public_state(self, tenant: str) -> Any:
        """The tenant's public per-round feed, as any client —
        including an adaptive adversary — legitimately sees it: the
        broadcast aggregate, the round counter, and the last closed
        round's cohort membership (acceptance record). Per-client
        admission verdicts are NOT included: each client only ever
        learns its own ack reasons (returns a
        :class:`~byzpy_tpu_torch.attacks.adaptive.PublicRoundState` with
        empty ``verdicts``; callers merge their own acks). Raises
        ``ValueError`` before the first round has closed — there is no
        broadcast yet for anyone to observe."""
        from ..attacks.adaptive import PublicRoundState

        t = self._tenants[tenant]
        if t.last_aggregate is None:
            raise ValueError(
                f"tenant {tenant!r} has not closed a round yet — "
                "there is no public state to observe"
            )
        return PublicRoundState(
            round_id=t.round_id - 1,
            aggregate=t.last_aggregate,
            accepted={cid: True for cid in t.last_cohort_clients},
            verdicts={},
            server_round=t.round_id,
        )

    # -- wire transport --------------------------------------------------

    async def serve(self, host: str = "127.0.0.1", port: int = 0) -> tuple:
        """Start the TCP ingress speaking actor wire frames; returns the
        bound ``(host, port)``. Call :meth:`start` first (or after —
        admission only needs the queues)."""
        wire.warn_untrusted_bind(host, "ServingFrontend")
        self._server = await asyncio.start_server(
            self._handle_conn, host=host, port=port
        )
        sock = self._server.sockets[0].getsockname()
        return sock[0], sock[1]

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """Batched TCP read loop: each wakeup drains EVERY complete
        frame queued on the socket into zero-copy memoryview slices
        over one growable receive buffer and serves them as ONE
        :meth:`serve_frames` batch — no per-frame ``readexactly``
        round-trips, no per-frame ``bytes`` copies, one reply write +
        drain per wakeup. Replies stay in arrival order.

        Framing faults resynchronize instead of tearing down the
        queue: an oversized length prefix counts a bad frame and the
        parser discards exactly the declared payload (streaming — the
        buffer never grows past the declared bytes) before resuming at
        the next length prefix, so frames queued behind it still
        serve; a frame torn by EOF (partial header or payload) counts
        a bad frame at close. Only a frame that FAILS decode (forged
        HMAC / tampered pickle) still drops the peer — it names no
        trustable tenant."""
        self._conns.add(writer)
        hdr = wire._HEADER.size
        buf = bytearray()
        skip = 0  # bytes of an oversized frame's payload still to discard
        try:
            while True:
                chunk = await reader.read(_INGRESS_READ_CHUNK)
                at_eof = not chunk
                if chunk and skip:
                    if len(chunk) <= skip:
                        skip -= len(chunk)
                        continue
                    chunk = chunk[skip:]
                    skip = 0
                if chunk:
                    buf += chunk
                pos = 0
                http = False
                drop = False
                mv = memoryview(buf)
                try:
                    bodies: List[Any] = []
                    while len(buf) - pos >= hdr:
                        if bytes(mv[pos:pos + hdr]) == _HTTP_GET_PREFIX:
                            # the same TCP ingress doubles as the
                            # Prometheus scrape endpoint: a peer whose
                            # next frame opens with "GET " is an HTTP
                            # scraper, not a wire client (as a length
                            # prefix those 4 bytes would name a ~1.2 GB
                            # frame no serving client sends)
                            http = True
                            break
                        (length,) = wire._HEADER.unpack(mv[pos:pos + hdr])
                        if length > wire.MAX_FRAME:
                            # oversized prefix: as hostile as a tampered
                            # frame — count it, discard exactly the
                            # declared payload, resync at the next
                            # length prefix (frames queued behind it
                            # still serve)
                            self._count_bad_frame()
                            avail = len(buf) - pos - hdr
                            if avail >= length:
                                pos += hdr + int(length)
                                continue
                            skip = int(length) - avail
                            pos = len(buf)
                            break
                        if len(buf) - pos - hdr < length:
                            break  # incomplete frame: wait for more bytes
                        bodies.append(mv[pos + hdr: pos + hdr + length])
                        pos += hdr + length
                    if bodies:
                        replies, _served, err = self.serve_frames(bodies)
                        if replies:
                            writer.write(b"".join(replies))
                            await writer.drain()
                        if err is not None:
                            drop = True
                finally:
                    # the memoryview slices must die before the buffer
                    # compaction below — bytearray refuses to resize
                    # while exports are live
                    del bodies
                    mv.release()
                del buf[:pos]
                if drop:
                    break
                if http:
                    await self._serve_http_metrics(
                        reader, writer, initial=bytes(buf)
                    )
                    break
                if at_eof:
                    if buf:
                        # torn frame: a partial header or payload cut
                        # off by the close — count it, never silent
                        # (an oversized frame torn mid-discard was
                        # already counted at its header)
                        self._count_bad_frame()
                    break
        finally:
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001 — peer already gone
                pass

    def _count_bad_frame(self) -> None:
        self.bad_frames += 1
        if obs_runtime.STATE.enabled:
            self._m_bad_frames.inc()

    async def _serve_http_metrics(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        *,
        initial: bytes = b"",
    ) -> None:
        """Answer one HTTP GET on the wire ingress with the process
        metrics registry in Prometheus text exposition format (0.0.4).
        The request is drained up to its blank line (bounded) so the
        scraper sees a clean close; rendering is an in-memory string
        build, safe on the admission loop. ``initial`` is whatever the
        batched read loop already pulled off the socket past the "GET "
        sniff (the request may have arrived whole in one chunk)."""
        data = initial
        while b"\r\n\r\n" not in data and len(data) < _HTTP_MAX_REQUEST:
            chunk = await reader.read(1024)
            if not chunk:
                break
            data += chunk
        _publish_wire_info()
        body = obs_metrics.registry().prometheus_text().encode()
        writer.write(
            b"HTTP/1.0 200 OK\r\n"
            b"Content-Type: text/plain; version=0.0.4; charset=utf-8\r\n"
            + f"Content-Length: {len(body)}\r\n".encode()
            + b"Connection: close\r\n\r\n"
            + body
        )
        await writer.drain()

    # -- introspection ---------------------------------------------------

    def round_of(self, tenant: str) -> int:
        """Current server round of ``tenant``."""
        return self._tenants[tenant].round_id

    def broadcast_frame(
        self, tenant: str, *, precision: Optional[str] = None
    ) -> bytes:
        """Encode the tenant's latest broadcast aggregate as a model
        frame for the client downlink — the frontend→client half of the
        million-client wire, compressed per ``precision`` (default: the
        ``BYZPY_TPU_TORCH_WIRE_PRECISION`` fabric) with per-round **error
        feedback** on the blockwise modes: the residual the compressed
        broadcast lost last round is folded into this round's payload
        before encoding, so a client integrating the stream sees the
        true aggregate trajectory plus ONE round's bounded error. The
        residual is tenant round state: durable snapshots capture it
        bit-exact; a WAL-tail recovery restarts it at zero (safe —
        documented at ``_Tenant.ef_residual``, drilled by
        ``resilience.drill``). Raises ``ValueError`` for an unknown
        tenant, ``RuntimeError`` before the first closed round."""
        t = self._tenants.get(tenant)
        if t is None:
            raise ValueError(f"unknown tenant {tenant!r}")
        if t.last_aggregate is None:
            raise RuntimeError(
                f"tenant {tenant!r} has not closed a round yet — no "
                "aggregate to broadcast"
            )
        mode = wire.wire_precision() if precision is None else (
            precision if precision in wire.WIRE_MODES else "off"
        )
        agg = torch.as_tensor(
            np.asarray(host_array(t.last_aggregate), np.float32).reshape(-1)
        )
        if mode in wire.BLOCKWISE_WIRE_MODES:
            payload, t.ef_residual = wire.ef_precompensate(
                agg,
                None if t.ef_residual is None else torch.as_tensor(t.ef_residual),
                mode,
            )
        else:
            payload = agg
        return wire.encode(
            {
                "kind": "model",
                "tenant": tenant,
                "round": t.round_id - 1,
                "aggregate": payload,
            },
            precision=mode,
        )

    def reset_round_stats(self) -> None:
        """Zero every tenant's round-latency/cohort statistics window —
        the warmup→measure boundary for benchmarks (first-round
        latencies must not pollute the measured p99). Accounting state
        (ledgers, round counters, ingress bytes, dedup tables) is
        untouched."""
        for t in self._tenants.values():
            t.stats = RoundStats()

    def last_aggregate(self, tenant: str) -> Any:
        """Most recent round's aggregated vector (None before round 0)."""
        return self._tenants[tenant].last_aggregate

    def _tenant_stats(self, t: _Tenant) -> dict:
        p50, p99 = t.stats.latency_percentiles_s(50, 99)
        return {
            "rounds": t.stats.rounds,
            "round_id": t.round_id,
            "ledger": t.ledger.snapshot(),
            "queue_depth": t.queue.depth(),
            "queue_high_water": t.queue.depth_high_water,
            "queue_capacity": t.queue.capacity,
            "rejected_queue_full": t.queue.rejected_full,
            # the effective round floor (config min_cohort raised to the
            # aggregator's smallest admissible n)
            "min_cohort": t.min_cohort,
            # admitted but not yet aggregated — includes rows the
            # scheduler already popped into its held cohort, which
            # queue_depth no longer sees (min_cohort holds them there)
            "outstanding": t.outstanding,
            "p50_round_latency_s": p50,
            "p99_round_latency_s": p99,
            "mean_cohort": (
                float(np.mean(t.stats.cohort_sizes))
                if t.stats.cohort_sizes
                else 0.0
            ),
            "ingress_bytes": t.ingress_bytes,
            "failed_rounds": t.failed_rounds,
            # resilience accounting: duplicate replays absorbed by the
            # idempotency layer, breaker state (None = no breaker),
            # recovery provenance (round the tenant resumed from)
            "duplicates": t.duplicates,
            "quarantine_drops": t.quarantine_drops,
            # forensics attribution (None = no plane configured): trust
            # summary, per-client quarantine state, rejected_untrusted
            "forensics": (
                t.forensics.snapshot() if t.forensics is not None else None
            ),
            "breaker": (
                t.breaker.snapshot() if t.breaker is not None else None
            ),
            "recovered_from": (
                {
                    "snapshot": t.recovered.from_snapshot,
                    "round_id": t.recovered.round_id,
                    "replayed_pending": len(t.recovered.pending),
                    "skipped_corrupt": list(t.recovered.skipped_corrupt),
                }
                if t.recovered is not None
                else None
            ),
            # downlink error-feedback residual energy (None = no
            # compressed broadcast yet / reset on WAL-tail recovery) —
            # the SIGKILL drill reads this to prove the residual was
            # either restored bit-exact from the snapshot or safely
            # reset (bounded, non-divergent) after recovery
            "ef_residual_norm": (
                None
                if t.ef_residual is None
                else float(np.linalg.norm(host_array(t.ef_residual)))
            ),
            # which door serves this tenant's rounds (False = bucket
            # ladder: ragged disabled, or no masked program)
            "ragged_served": (
                self._ragged is not None
                and self._ragged.serves(t.cfg.name)
            ),
            # FRONTEND-GLOBAL counters (not per-tenant — a forged frame
            # names no trustable tenant): nested so a dashboard summing
            # tenant blocks doesn't double-count them
            "frontend": {
                "bad_frames": self.bad_frames,
                "malformed_requests": self.malformed_requests,
                "callback_errors": self.callback_errors,
                # batched-door accounting: serve_frames calls, frames
                # they carried, and the largest single batch (the
                # smoke's proof the ingress actually amortizes)
                "ingress_batches": self.ingress_batches,
                "ingress_frames": self.ingress_frames_batched,
                "ingress_max_batch": self.ingress_max_batch,
                # ragged dispatch accounting (None = escape hatch on):
                # groups/executors, device calls, batch coalescing
                "ragged": (
                    self._ragged.snapshot()
                    if self._ragged is not None
                    else None
                ),
            },
        }

    def stats(self) -> dict:
        """Per-tenant accounting: admission ledger, rounds, cohort and
        latency telemetry, queue depth high-water, outstanding gauge,
        ingress bytes."""
        return {
            name: self._tenant_stats(t) for name, t in self._tenants.items()
        }


def _float_dtype_name(name: Any) -> bool:
    """Whether a wire row's declared dtype name is a floating dtype."""
    try:
        return wire._dtype_of(name).is_floating_point
    except TypeError:
        return False


def _host_row(gradient: Any) -> Optional[np.ndarray]:
    """One submitted dense row as host numpy (a tensor read to the host
    once), or ``None`` for a tensor numpy cannot hold (bfloat16): the
    shape gate then rejects it."""
    if isinstance(gradient, torch.Tensor):
        t = gradient.detach().cpu()
        if t.dtype == torch.bfloat16:
            return None
        return t.numpy()
    return np.asarray(gradient)


def encode_reply(reply: dict) -> bytes:
    """Encode one ``handle_request`` reply, honoring (and stripping)
    the ``LOSSLESS_REPLY`` pop-key — the ONE place the rule lives, so
    the TCP read loop and the in-process :func:`serve_frame` path
    cannot drift (a hook reply's partial rows must never ride a lossy
    ``BYZPY_TPU_TORCH_WIRE_PRECISION`` fabric, on either path)."""
    if isinstance(reply, dict) and reply.pop(LOSSLESS_REPLY, False):
        return wire.encode(reply, precision="off")
    return wire.encode(reply)


def serve_frame(frontend: ServingFrontend, frame_body: bytes) -> bytes:
    """In-process wire path: decode one frame body, serve it, encode the
    reply — the exact codec/HMAC round the TCP ingress runs, minus the
    socket (the bench's 10k-client swarm exercises the wire cost this
    way without 10k TCP connections). Routed through the SAME batched
    door as the TCP read loop (:meth:`ServingFrontend.serve_frames`,
    batch of one), so inflation-stamp ownership, quantized-row
    admission, and accounting cannot drift between the two paths; a
    frame that fails HMAC/decode counts in ``bad_frames`` and
    re-raises, mirroring the dropped-peer contract."""
    replies, _served, err = frontend.serve_frames([frame_body])
    if err is not None:
        raise err
    return replies[0]


class ServingClient:
    """Asyncio client for the wire ingress (tests, examples, swarm
    simulators): one connection, frame-per-call submissions.

    Resilience (all opt-out): every submission carries a per-client
    monotonic ``seq`` idempotency key, so with a
    :class:`~byzpy_tpu_torch.resilience.retry.RetryPolicy` attached the client
    may safely reconnect and RESEND after a dropped connection — the
    frontend dedupes replayed ``(client, seq)`` frames instead of
    double-folding them (a replay of an ack the wire lost answers
    ``accepted=True, reason="duplicate"``). Use as an async context
    manager so the writer cannot leak when a test raises between
    ``connect`` and teardown::

        async with ServingClient(retry=RetryPolicy()) as c:
            await c.connect(host, port)
            ack = await c.submit("m0", "client-7", round_id, grad)
    """

    def __init__(
        self,
        *,
        retry: Optional[RetryPolicy] = None,
        rng: Optional[random.Random] = None,
        error_feedback: bool = False,
    ) -> None:
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._addr: Optional[Tuple[str, int]] = None
        self._retry = retry
        self._rng = rng
        self._seq = 0
        #: reconnects performed by the retry driver (introspection)
        self.reconnects = 0
        #: uplink error feedback over the lossy submit fabric: with a
        #: blockwise ``BYZPY_TPU_TORCH_WIRE_PRECISION`` active, each (tenant,
        #: client) keeps the residual its last frame's quantization
        #: lost and folds it into the next submission BEFORE the wire
        #: encode (``wire.ef_precompensate``) — the client-side half of
        #: the sub-int8 fabric. Off by default: an EF client's payload
        #: deliberately differs from its raw gradient, which a
        #: bit-parity test must opt into.
        self.error_feedback = bool(error_feedback)
        self._ef_residuals: Dict[Tuple[str, str], torch.Tensor] = {}

    async def __aenter__(self) -> "ServingClient":
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()

    async def connect(self, host: str, port: int) -> None:
        """Open the connection (dial retried under the policy, so a
        frontend restart window is ridden out)."""
        self._addr = (host, port)
        await self._dial()

    async def _dial(self) -> None:
        assert self._addr is not None, "connect() first"
        host, port = self._addr
        if self._retry is not None:
            self._reader, self._writer = await connect_with_retry(
                host, port, policy=self._retry,
                component="serving_client", rng=self._rng,
            )
        else:
            self._reader, self._writer = await asyncio.open_connection(
                host, port
            )

    def _drop_connection(self) -> None:
        if self._writer is not None:
            self._writer.close()  # no wait: the peer is already gone
        self._writer = None
        self._reader = None

    async def _call(self, payload: dict, *, resend: bool = True) -> dict:
        """One request/reply round-trip; with a policy, wire failures
        drop the dead connection, redial, and RESEND the same frame —
        safe for submissions (idempotency key) and stats (read-only).
        ``resend=False`` is for NON-idempotent requests (close_round):
        the dial still retries, but once the frame may have left this
        process an ambiguous wire death raises instead of resending —
        a lost ack must not close two rounds."""
        if self._retry is None:
            assert self._writer is not None and self._reader is not None
            await wire.send_obj(self._writer, payload)
            return await wire.recv_obj(self._reader)

        class _Ambiguous(RuntimeError):
            """Sent (maybe) but no ack — unlisted type, so fatal."""

        async def attempt(n: int) -> dict:
            if n > 0:
                self.reconnects += 1
            if self._writer is None:
                await self._dial()
            try:
                await wire.send_obj(self._writer, payload)
                return await wire.recv_obj(self._reader)
            except Exception as exc:
                # whatever happened mid-round-trip, this connection is
                # no longer trustworthy for framing
                self._drop_connection()
                if not resend:
                    raise _Ambiguous(
                        "connection died mid-request; the request may "
                        "or may not have taken effect — refusing to "
                        "resend a non-idempotent frame"
                    ) from exc
                raise

        return await retry_async(
            attempt, policy=self._retry, component="serving_client",
            rng=self._rng,
        )

    async def submit(
        self,
        tenant: str,
        client: str,
        round_submitted: int,
        gradient: Any,
        *,
        seq: Optional[int] = None,
    ) -> dict:
        """Send one submission frame; returns the decoded ack. ``seq``
        defaults to this client object's own monotonic counter (shared
        across all logical client ids it submits for — still per-client
        monotonic, which is all the dedup layer needs). An explicit
        ``seq`` — e.g. replaying ambiguous submissions after a frontend
        restart — advances the counter past it, so later auto-assigned
        keys can never collide with the server's recovered high-water
        mark and be silently absorbed as duplicates. A client reborn
        WITHOUT its counter must adopt a fresh client id."""
        if seq is None:
            seq = self._seq
            self._seq += 1
        else:
            self._seq = max(self._seq, int(seq) + 1)
        # a host float tensor: the wire compresses host tensors only
        gradient = wire.host_view(torch.as_tensor(gradient))
        if self.error_feedback and wire.wire_precision() in (
            wire.BLOCKWISE_WIRE_MODES
        ):
            gradient, self._ef_residuals[(tenant, client)] = (
                wire.ef_precompensate(
                    gradient, self._ef_residuals.get((tenant, client))
                )
            )
        # the round-causality chain starts HERE: the submit span's
        # context is stamped onto the frame by wire.encode, so the
        # frontend's admission span (possibly another process) links
        # as this span's child
        with obs_tracing.span(
            "serving.client.submit", track="client",
            tenant=tenant, client=client,
        ):
            return await self._call(
                {
                    "kind": "submit",
                    "tenant": tenant,
                    "client": client,
                    "round": int(round_submitted),
                    "gradient": gradient,
                    "seq": int(seq),
                }
            )

    async def stats(self, tenant: str) -> dict:
        """Fetch the tenant's stats snapshot."""
        return await self._call({"kind": "stats", "tenant": tenant})

    async def close_round(self, tenant: str) -> dict:
        """Drive the synchronous round closer over the wire (the drill/
        operator door; errors if the async scheduler owns rounds). NOT
        idempotent — an ambiguous wire failure raises rather than
        resending (a lost ack must not close two rounds)."""
        return await self._call(
            {"kind": "close_round", "tenant": tenant}, resend=False
        )

    async def close(self) -> None:
        """Close the connection (idempotent; safe mid-failure)."""
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:  # noqa: BLE001 — server already gone
                pass
            self._writer = None
            self._reader = None


__all__ = [
    "DUPLICATE",
    "REJECTED_MALFORMED",
    "REJECTED_QUARANTINED",
    "REJECTED_UNTRUSTED",
    "RoundCallback",
    "ServingClient",
    "ServingFrontend",
    "TenantConfig",
    "serve_frame",
]
