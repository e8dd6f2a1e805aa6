"""The forensics plane: one per-tenant attribution pipeline.

Counterpart of ``byzpy_tpu/forensics/plane.py``. The features are host
numpy (the cohort is read to the host once); the aggregator's score view
runs on the cohort matrix's device, through the aggregator's
``round_evidence`` (the port's score programs, one host read a view).

A :class:`ForensicsPlane` sits beside a production round path (the
serving frontend owns one per tenant with a ``forensics=`` config; the
chaos harness owns one per run when asked) and, for every closed round,
turns the cohort + broadcast aggregate into a
:class:`~byzpy_tpu_torch.forensics.evidence.RoundEvidence` record:

1. model-free features per submission (pre-discount norm z-score,
   cosine-to-aggregate, staleness-inflation ratio, echo ratio vs the
   previous broadcast) — :func:`~byzpy_tpu_torch.forensics.evidence.
   row_features`;
2. the aggregator's own per-row score/selection view
   (:meth:`~byzpy_tpu_torch.aggregators.base.Aggregator.round_evidence` — no
   second aggregation pass, the scores are recomputed host-side from
   the published score programs, bit-effect-free on the aggregate);
3. detector flags (instant detectors + the cross-round ``echo``
   persistence gate + the trust ledger's ``low_trust`` flag);
4. a trust-ledger update per submission, with optional quarantine.

Everything runs on data the round already produced; the aggregate bits
are never touched (digest-identical with the plane on or off). Prometheus instruments
(``byzpy_client_excluded_total``, ``byzpy_anomaly_flags_total``,
``byzpy_trust_score`` band gauges, quarantine counters) publish
unconditionally while a plane is active — forensics is itself the
opt-in — and the last ``recent_rounds`` records per plane ride along in
flight-recorder dumps (:func:`recent_evidence`).
"""

from __future__ import annotations

import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..observability import metrics as obs_metrics
from .evidence import (
    DetectorConfig,
    RoundEvidence,
    SubmissionEvidence,
    evidence_digest,
    host_array,
    instant_flags,
    row_features,
)
from .trust import TrustLedger, TrustPolicy

#: Active planes (weak — a closed frontend's planes vanish with it);
#: the flight recorder snapshots their recent evidence through this.
_PLANES: "weakref.WeakSet[ForensicsPlane]" = weakref.WeakSet()


@dataclass(frozen=True)
class ForensicsConfig:
    """Per-tenant forensics knobs.

    ``quarantine`` opts the trust ledger's quarantine gate into the
    admission path (``rejected_untrusted`` acks; off by default — the
    plane then only *observes*). ``credit_weighting`` scales the
    tenant's credit refill by the client's trust
    (:meth:`~byzpy_tpu_torch.forensics.trust.TrustLedger.rate_scale`; a
    client at healthy trust refills at exactly the configured rate —
    bit-identical arithmetic). ``wal_evidence`` appends every round's
    evidence record (and quarantine/readmit transitions) to the
    tenant's write-ahead log when durability is attached — the
    auditable exclusion trail :func:`~byzpy_tpu_torch.forensics.audit.
    wal_timeline` replays. ``recent_rounds`` bounds the in-memory tail carried in
    flight-recorder dumps."""

    detectors: DetectorConfig = field(default_factory=DetectorConfig)
    trust: TrustPolicy = field(default_factory=TrustPolicy)
    quarantine: bool = False
    credit_weighting: bool = True
    wal_evidence: bool = True
    recent_rounds: int = 32

    def __post_init__(self) -> None:
        if self.recent_rounds < 1:
            raise ValueError("recent_rounds must be >= 1")


class ForensicsPlane:
    """One tenant's online attribution pipeline (module docstring)."""

    def __init__(self, tenant: str, cfg: Optional[ForensicsConfig] = None) -> None:
        self.tenant = tenant
        self.cfg = cfg or ForensicsConfig()
        self.ledger = TrustLedger(self.cfg.trust)
        #: previous round's broadcast aggregate (the echo reference)
        self._prev_aggregate: Optional[np.ndarray] = None
        #: per-client consecutive-round streaks, keyed per detector
        #: (value = (last_round_seen, streak); LRU-bounded like the
        #: ledger). One bump per client per round — a client with
        #: several rows in one round must not double-count.
        self._echo_streaks: "OrderedDict[str, tuple]" = OrderedDict()
        self._stale_streaks: "OrderedDict[str, tuple]" = OrderedDict()
        #: quarantine/readmit transitions since the last drain — the
        #: frontend appends these to the WAL (never silent)
        self._transitions: List[dict] = []
        self.recent: "deque[RoundEvidence]" = deque(maxlen=self.cfg.recent_rounds)
        self.rounds_observed = 0
        self.rejected_untrusted = 0
        reg = obs_metrics.registry()
        labels = {"tenant": tenant}
        self._m_excluded = reg.counter(
            "byzpy_client_excluded_total",
            help="client-rounds de-selected by the aggregator's published selection",
            labels=labels,
        )
        self._m_quarantines = reg.counter(
            "byzpy_client_quarantines_total",
            help="trust-ledger quarantine transitions", labels=labels,
        )
        self._m_readmits = reg.counter(
            "byzpy_client_readmits_total",
            help="quarantined clients readmitted on probation", labels=labels,
        )
        self._m_quarantined = reg.gauge(
            "byzpy_quarantined_clients",
            help="clients currently quarantined by the trust ledger",
            labels=labels,
        )
        self._m_flags: Dict[str, obs_metrics.Counter] = {}
        self._m_bands = {
            band: reg.gauge(
                "byzpy_trust_score",
                help="tracked clients per trust band",
                labels={**labels, "band": band},
            )
            for band, _ in self.ledger.distribution()
        }
        _PLANES.add(self)

    # -- admission-side hooks ---------------------------------------------

    def allows(self, client: str, round_id: int) -> bool:
        """Admission gate (only consulted when ``cfg.quarantine``):
        False while the client is quarantined. Readmission transitions
        happen here and are queued for the WAL."""
        if not self.cfg.quarantine:
            return True
        was = self.ledger.is_quarantined(client)
        ok = self.ledger.allows(client, round_id)
        if ok and was:
            self._transitions.append(
                {"event": "readmit", "client": client, "round": int(round_id)}
            )
            self._m_readmits.inc()
            self._m_quarantined.set(len(self.ledger.quarantined()))
        if not ok:
            self.rejected_untrusted += 1
        return ok

    def rate_scale(self, client: str) -> float:
        """Trust-weighted credit-refill multiplier (1.0 when credit
        weighting is disabled or trust is healthy)."""
        if not self.cfg.credit_weighting:
            return 1.0
        return self.ledger.rate_scale(client)

    def pop_transitions(self) -> List[dict]:
        """Drain queued quarantine/readmit transition events (the
        frontend WAL-records them)."""
        out, self._transitions = self._transitions, []
        return out

    def requeue_transitions(self, items: Sequence[dict]) -> None:
        """Put popped-but-unpersisted transitions back at the FRONT of
        the queue (a failed WAL append must not lose them — they are
        one-shot events the audit trail promises to carry; the next
        round's close retries the write)."""
        self._transitions[:0] = list(items)

    # -- round-close hook --------------------------------------------------

    def _flag_counter(self, detector: str) -> obs_metrics.Counter:
        c = self._m_flags.get(detector)
        if c is None:
            c = self._m_flags[detector] = obs_metrics.registry().counter(
                "byzpy_anomaly_flags_total",
                help="anomaly-detector flags on submissions",
                labels={"tenant": self.tenant, "detector": detector},
            )
        return c

    def _bump_streak(
        self,
        streaks: "OrderedDict[str, tuple]",
        client: str,
        round_id: int,
        hit: bool,
    ) -> int:
        """Advance a per-client CONSECUTIVE-round streak (at most once
        per round; LRU-bounded); returns the streak after this round.
        A gap — the client absent for one or more rounds — breaks the
        streak (an intermittent client's occasional hits must not
        accumulate into a "N rounds running" detector firing)."""
        last_round, streak = streaks.get(client, (None, 0))
        if last_round != round_id:
            if not hit:
                streak = 0
            elif last_round is not None and round_id - last_round == 1:
                streak = streak + 1
            else:
                streak = 1  # first sighting, or continuity broken by a gap
        streaks[client] = (round_id, streak)
        streaks.move_to_end(client)
        if len(streaks) > self.cfg.trust.max_tracked_clients:
            streaks.popitem(last=False)
        return streak

    def prepare(
        self,
        round_id: int,
        matrix: Any,
        valid: Any,
        clients: Sequence[str],
        aggregate: Any,
        *,
        aggregator: Any = None,
        weights: Any = None,
        deltas: Optional[Sequence[int]] = None,
        bucket: Optional[int] = None,
        precomputed: Optional[Mapping[str, Any]] = None,
        wire_inflations: Optional[Sequence[Optional[float]]] = None,
    ) -> dict:
        """The HEAVY half of :meth:`observe_round`: features + the
        aggregator's score view (the O(m²·d) Krum distances / O(m·d)
        reductions). Mutates NO plane state — safe to run on an
        executor thread next to the fold, under the same contract the
        per-tenant scheduler already provides (one round in flight per
        tenant; it reads the previous round's broadcast, which
        :meth:`apply` for the prior round has already published).

        ``matrix`` is the PRE-discount padded cohort, ``valid`` its row
        mask, ``clients`` the valid rows' client ids (slot order),
        ``aggregate`` the round's broadcast. ``weights`` (optional) the
        per-slot staleness discounts; ``deltas`` (optional) per valid
        row staleness in rounds (−1 recorded when unknown).

        ``precomputed`` (optional) is a ``{"kind", "scores", "keep"}``
        score view that already rode the aggregation kernel (the
        serving ragged door's fused evidence outputs,
        ``serving.ragged.RaggedView.precomputed``): the aggregator's
        host score pass — the expensive O(m²·d) half of this stage —
        is skipped entirely, the kernel having computed the same
        quantities on the same discounted rows the fold aggregated.
        ``scores``/``keep`` are indexed by VALID-row order and
        scattered to padded slots here."""
        valid_arr = np.asarray(host_array(valid), bool)
        idx = np.flatnonzero(valid_arr)
        feats = row_features(
            matrix, valid_arr, aggregate,
            prev_aggregate=self._prev_aggregate, weights=weights,
        )
        flags = instant_flags(feats, self.cfg.detectors)
        score_kind = ""
        scores = keep = None
        if precomputed is not None:
            score_kind = str(precomputed.get("kind", ""))
            n_slots = int(valid_arr.shape[0])
            pre_scores = precomputed.get("scores")
            if pre_scores is not None:
                scores = np.full((n_slots,), np.nan, np.float32)
                scores[idx] = np.asarray(host_array(pre_scores), np.float32)
            pre_keep = precomputed.get("keep")
            if pre_keep is not None:
                keep = np.zeros((n_slots,), bool)
                keep[idx] = np.asarray(host_array(pre_keep), bool)
        elif aggregator is not None:
            # score what the aggregator actually judged: the serving
            # fold scales stale rows by their discount BEFORE the
            # robust aggregate, so the selection verdict must be
            # computed on the DISCOUNTED matrix (the pre-discount bits
            # stay in the features above — that's where the abuse is
            # visible; a verdict from the raw matrix would claim the
            # staleness abuser was de-selected in exactly the rounds
            # its discounted, cohort-central row was folded in)
            # (on the matrix's device when it is a tensor)
            scored = matrix
            if weights is not None:
                w = np.asarray(weights, np.float32)
                if bool((w[idx] != 1.0).any()):
                    if hasattr(matrix, "device") and hasattr(matrix, "detach"):
                        import torch

                        scored = matrix.float() * torch.from_numpy(w).to(matrix.device)[:, None]
                    else:
                        scored = np.asarray(matrix, np.float32) * w[:, None]
            view = aggregator.round_evidence(
                scored, valid_arr, aggregate=aggregate
            )
            if view is not None:
                score_kind = view["kind"]
                scores, keep = view["scores"], view["keep"]
        return {
            "round_id": int(round_id),
            "idx": idx,
            "n_slots": int(valid_arr.shape[0]),
            "feats": feats,
            "flags": flags,
            "score_kind": score_kind,
            "scores": scores,
            "keep": keep,
            "clients": [str(c) for c in clients],
            "weights": (
                np.asarray(weights, np.float32).reshape(-1)
                if weights is not None
                else None
            ),
            "deltas": None if deltas is None else [int(d) for d in deltas],
            "wire_inflations": (
                None
                if wire_inflations is None
                else [
                    None if w is None else float(w) for w in wire_inflations
                ]
            ),
            "bucket": bucket,
            "aggregate": aggregate,
        }

    def apply(self, prep: Mapping[str, Any]) -> RoundEvidence:
        """The CHEAP, state-mutating half of :meth:`observe_round`
        (dict/ledger/metric updates — run it on the owning loop):
        folds a :meth:`prepare` result into the trust ledger, streaks,
        metrics and the recent-evidence ring; returns the
        :class:`RoundEvidence` record."""
        round_id = prep["round_id"]
        idx = prep["idx"]
        feats = prep["feats"]
        flags = prep["flags"]
        scores, keep = prep["scores"], prep["keep"]
        weights, deltas = prep["weights"], prep["deltas"]
        wire_inflations = prep.get("wire_inflations")
        clients = prep["clients"]
        aggregate = prep["aggregate"]
        m = int(idx.size)
        records: List[SubmissionEvidence] = []
        flag_counts: Dict[str, int] = {}
        for i in range(m):
            slot = int(idx[i])
            client = str(clients[i])
            row_flags = list(flags[i])
            echo_val = float(feats["echo"][i])
            has_echo = not np.isnan(echo_val)
            if has_echo:
                streak = self._bump_streak(
                    self._echo_streaks, client, round_id,
                    echo_val < self.cfg.detectors.echo_ratio,
                )
                if streak >= self.cfg.detectors.echo_rounds:
                    row_flags.append("echo")
            stale_streak = self._bump_streak(
                self._stale_streaks, client, round_id,
                bool(feats["stale"][i]),
            )
            if stale_streak >= self.cfg.detectors.pinned_rounds:
                row_flags.append("staleness_pinned")
            wi = (
                wire_inflations[i]
                if wire_inflations is not None and i < len(wire_inflations)
                else None
            )
            if (
                wi is not None
                and wi > self.cfg.detectors.wire_inflation_threshold
            ):
                # pre-decode grid shaping: the frame's per-block scales
                # claim far more magnitude than its codes use — the
                # residual-shaping signature (an honest encoder's
                # ratio is exactly 1.0)
                row_flags.append("residual_shaping")
            selected = None if keep is None else bool(keep[slot])
            trust = self.ledger.observe(
                client, round_id, selected=selected, flags=row_flags,
                # quarantine entry only when an admission gate will
                # consult allows(): in observe-only mode the state
                # could never be lifted and would pin gauges/audit
                quarantine=self.cfg.quarantine,
            )
            if trust < self.cfg.trust.flag_below:
                row_flags.append("low_trust")
            for fl in row_flags:
                flag_counts[fl] = flag_counts.get(fl, 0) + 1
                self._flag_counter(fl).inc()
            if selected is False:
                self._m_excluded.inc()
            records.append(
                SubmissionEvidence(
                    client=client,
                    slot=slot,
                    norm=float(feats["norm"][i]),
                    norm_z=float(feats["norm_z"][i]),
                    cos_to_agg=float(feats["cos"][i]),
                    echo_ratio=echo_val if has_echo else None,
                    weight=(
                        float(weights[slot]) if weights is not None else 1.0
                    ),
                    delta=deltas[i] if deltas is not None else -1,
                    inflation=float(feats["inflation"][i]),
                    score=(
                        float(scores[slot])
                        if scores is not None and np.isfinite(scores[slot])
                        else None
                    ),
                    selected=selected,
                    flags=tuple(row_flags),
                    trust=float(trust),
                    wire_inflation=wi,
                )
            )
        quarantined_now = self.ledger.quarantined()
        for client, since in quarantined_now.items():
            if since == round_id:
                self._transitions.append(
                    {"event": "quarantine", "client": client, "round": int(round_id)}
                )
                self._m_quarantines.inc()
        self._m_quarantined.set(len(quarantined_now))
        for band, count in self.ledger.distribution():
            self._m_bands[band].set(count)
        bucket = prep["bucket"]
        ev = RoundEvidence(
            tenant=self.tenant,
            round_id=round_id,
            m=m,
            bucket=int(bucket) if bucket is not None else prep["n_slots"],
            agg_digest=evidence_digest(aggregate),
            score_kind=prep["score_kind"],
            records=tuple(records),
            flag_counts=flag_counts,
        )
        self.recent.append(ev)
        self.rounds_observed += 1
        self._prev_aggregate = np.asarray(host_array(aggregate), np.float32).reshape(-1).copy()
        return ev

    def observe_round(
        self,
        round_id: int,
        matrix: Any,
        valid: Any,
        clients: Sequence[str],
        aggregate: Any,
        *,
        aggregator: Any = None,
        weights: Any = None,
        deltas: Optional[Sequence[int]] = None,
        bucket: Optional[int] = None,
        wire_inflations: Optional[Sequence[Optional[float]]] = None,
    ) -> RoundEvidence:
        """Digest one closed round: :meth:`prepare` + :meth:`apply` in
        one synchronous call (the chaos harness and the sync round
        closer use this; the async serving scheduler runs ``prepare``
        on the fold executor and ``apply`` on the loop)."""
        return self.apply(
            self.prepare(
                round_id, matrix, valid, clients, aggregate,
                aggregator=aggregator, weights=weights,
                deltas=deltas, bucket=bucket,
                wire_inflations=wire_inflations,
            )
        )

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready plane summary for ``ServingFrontend.stats()``."""
        return {
            "rounds_observed": self.rounds_observed,
            "rejected_untrusted": self.rejected_untrusted,
            "quarantine_enabled": self.cfg.quarantine,
            "trust": self.ledger.snapshot(),
            "recent_flags": (
                dict(self.recent[-1].flag_counts) if self.recent else {}
            ),
        }


def recent_evidence() -> Dict[str, List[dict]]:
    """The last-N rounds' evidence of every ACTIVE plane, keyed by
    tenant (wire-compact dicts) — the flight recorder embeds this in
    crash dumps so "who was excluded in the final rounds" survives the
    incident."""
    out: Dict[str, List[dict]] = {}
    for plane in list(_PLANES):
        if plane.recent:
            out[plane.tenant] = [ev.to_wire() for ev in plane.recent]
    return out


__all__ = ["ForensicsConfig", "ForensicsPlane", "recent_evidence"]
