"""Per-client trust ledger: EWMA reputation fed by round evidence.

Counterpart of ``byzpy_tpu/forensics/trust.py``.

FLTrust/Martian-style trust scoring adapted to the serving tier's
constraints: the server holds no root dataset, so reputation is built
from what every round already produces — the aggregator's own
selection/exclusion verdicts and the model-free anomaly flags of
:mod:`~byzpy_tpu_torch.forensics.evidence`. Each observed submission folds
one observation into the client's exponentially-weighted trust score:

* flagged by any detector → ``flagged_obs`` (0.0 by default — the
  strongest signal);
* de-selected by a selection aggregator → ``excluded_obs`` (0.5 — mild,
  because honest clients of a Multi-Krum ``q`` ≪ ``m`` tenant are
  legitimately de-selected most rounds);
* selected / no selection published → ``selected_obs`` (1.0).

State is LRU-bounded exactly like
:class:`~byzpy_tpu_torch.serving.credits.CreditLedger` (client-id churn costs
bounded memory, evictions are counted), and the same sybil caveat
applies: trust keys off the CLAIMED client id, so a fresh id starts at
``initial`` trust — the ledger is an attribution/fairness mechanism,
the bounded admission queue remains the flood backstop.

Quarantine (opt-in via the plane): a client whose trust falls below
``quarantine_below`` is refused admission (``rejected_untrusted`` acks,
WAL-recorded transitions, never silent) for ``readmit_after_rounds``
server rounds, then readmitted on probation at ``probation_trust`` —
the closed → open → half-open shape of the PR-9 circuit breaker,
applied per client instead of per tenant.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: Trust-band edges for the ``byzpy_trust_score`` bucket gauges.
TRUST_BANDS = ((0.0, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.01))


@dataclass(frozen=True)
class TrustPolicy:
    """Knobs for the EWMA reputation and the quarantine state machine.

    ``alpha`` is the EWMA weight of the newest observation (higher =
    faster to react, noisier); ``initial`` the trust assigned to a
    first-seen client; ``flag_below`` the score under which the ledger
    itself raises a ``low_trust`` flag; ``quarantine_below`` the score
    that (with quarantine enabled on the plane) refuses admission;
    ``readmit_after_rounds`` the quarantine length in server rounds;
    ``probation_trust`` the score a readmitted client restarts at
    (above ``quarantine_below``, below ``initial`` — one more bad round
    re-quarantines quickly). ``max_tracked_clients`` bounds the
    ledger's memory (LRU eviction, counted)."""

    alpha: float = 0.25
    initial: float = 0.6
    selected_obs: float = 1.0
    excluded_obs: float = 0.5
    flagged_obs: float = 0.0
    flag_below: float = 0.3
    quarantine_below: float = 0.2
    readmit_after_rounds: int = 16
    probation_trust: float = 0.45
    max_tracked_clients: int = 65536

    def __post_init__(self) -> None:
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if not 0.0 < self.initial <= 1.0:
            raise ValueError("initial must be in (0, 1]")
        if not 0.0 <= self.quarantine_below < self.probation_trust:
            raise ValueError(
                "need 0 <= quarantine_below < probation_trust (a readmitted "
                "client must start above the quarantine line)"
            )
        if self.readmit_after_rounds < 1:
            raise ValueError("readmit_after_rounds must be >= 1")
        if self.max_tracked_clients < 1:
            raise ValueError("max_tracked_clients must be >= 1")


class _TrustState:
    """One client's ledger entry."""

    __slots__ = ("trust", "quarantined_since", "quarantines", "observations")

    def __init__(self, trust: float) -> None:
        self.trust = trust
        self.quarantined_since: Optional[int] = None
        self.quarantines = 0
        self.observations = 0


class TrustLedger:
    """EWMA trust per client + the quarantine state machine (module
    docstring). All methods are synchronous and cheap (dict ops) — safe
    on the serving admission loop."""

    def __init__(self, policy: TrustPolicy) -> None:
        self.policy = policy
        self._clients: "OrderedDict[str, _TrustState]" = OrderedDict()
        #: ledger entries dropped past the tracking cap (an evicted
        #: client re-appears at ``initial`` trust — visible, not silent)
        self.evicted = 0
        #: lifetime quarantine transitions (all clients)
        self.quarantines_total = 0
        self.readmits_total = 0

    # -- observation ------------------------------------------------------

    def _get_or_create(self, client: str) -> _TrustState:
        st = self._clients.get(client)
        if st is None:
            st = self._clients[client] = _TrustState(self.policy.initial)
            if len(self._clients) > self.policy.max_tracked_clients:
                self._clients.popitem(last=False)
                self.evicted += 1
        else:
            self._clients.move_to_end(client)
        return st

    def observe(
        self,
        client: str,
        round_id: int,
        *,
        selected: Optional[bool],
        flags: Sequence[str],
        quarantine: bool = True,
    ) -> float:
        """Fold one submission's evidence into ``client``'s trust;
        returns the updated score. With ``quarantine`` (default), also
        runs the quarantine-ENTRY check (readmission happens at
        admission time, see :meth:`allows`). Pass ``quarantine=False``
        when no admission gate will ever consult :meth:`allows` (the
        plane's observe-only mode): entering a state only ``allows``
        can exit would pin the client as "quarantined" forever in
        gauges and the audit trail while gating nothing."""
        p = self.policy
        st = self._get_or_create(client)
        if flags:
            obs = p.flagged_obs
        elif selected is False:
            obs = p.excluded_obs
        else:
            obs = p.selected_obs
        st.trust = (1.0 - p.alpha) * st.trust + p.alpha * obs
        st.observations += 1
        if (
            quarantine
            and st.quarantined_since is None
            and st.trust < p.quarantine_below
        ):
            st.quarantined_since = int(round_id)
            st.quarantines += 1
            self.quarantines_total += 1
        return st.trust

    # -- admission-side queries -------------------------------------------

    def score(self, client: str) -> float:
        """Current trust (``initial`` for a never-seen client; does not
        create state)."""
        st = self._clients.get(client)
        return self.policy.initial if st is None else st.trust

    def is_quarantined(self, client: str) -> bool:
        """Whether the client is currently quarantined (no transition)."""
        st = self._clients.get(client)
        return st is not None and st.quarantined_since is not None

    def allows(self, client: str, round_id: int) -> bool:
        """Admission gate: True unless the client is quarantined. A
        quarantine older than ``readmit_after_rounds`` server rounds is
        lifted HERE — the client re-enters on probation trust (the
        half-open probe: one more flagged round re-quarantines it)."""
        st = self._clients.get(client)
        if st is None or st.quarantined_since is None:
            return True
        if int(round_id) - st.quarantined_since >= self.policy.readmit_after_rounds:
            st.quarantined_since = None
            st.trust = self.policy.probation_trust
            self.readmits_total += 1
            self._clients.move_to_end(client)
            return True
        return False

    def rate_scale(self, client: str) -> float:
        """Trust-weighted credit-refill multiplier in ``(0, 1]``: a
        client at or above ``initial`` trust refills at the configured
        rate (scale exactly 1.0 — bit-identical admission arithmetic),
        a degraded client proportionally slower (floor 0.05 so trust
        alone can never fully zero a client's rate — that is
        quarantine's job, which is explicit and audited)."""
        trust = self.score(client)
        if trust >= self.policy.initial:
            return 1.0
        return max(0.05, trust / self.policy.initial)

    # -- introspection ----------------------------------------------------

    def quarantined(self) -> Dict[str, int]:
        """Currently-quarantined clients → quarantine-entry round."""
        return {
            c: st.quarantined_since
            for c, st in self._clients.items()
            if st.quarantined_since is not None
        }

    def distribution(self) -> List[Tuple[str, int]]:
        """Tracked-client counts per trust band (the
        ``byzpy_trust_score`` bucket gauges' source)."""
        counts = [0] * len(TRUST_BANDS)
        for st in self._clients.values():
            for i, (lo, hi) in enumerate(TRUST_BANDS):
                if lo <= st.trust < hi:
                    counts[i] += 1
                    break
        return [
            (f"{lo:g}-{min(hi, 1.0):g}", counts[i])
            for i, (lo, hi) in enumerate(TRUST_BANDS)
        ]

    def snapshot(self) -> dict:
        """JSON-ready ledger summary for stats/audit exporters."""
        worst = sorted(
            ((c, st.trust) for c, st in self._clients.items()),
            key=lambda kv: kv[1],
        )[:8]
        return {
            "clients_tracked": len(self._clients),
            "evicted": self.evicted,
            "quarantines_total": self.quarantines_total,
            "readmits_total": self.readmits_total,
            "quarantined": self.quarantined(),
            "bands": dict(self.distribution()),
            "lowest_trust_clients": [
                (c, round(t, 4)) for c, t in worst
            ],
        }


__all__ = ["TRUST_BANDS", "TrustLedger", "TrustPolicy"]
