"""Byzantine forensics plane: per-client attribution, trust, audit.

Counterpart of ``byzpy_tpu/forensics``. Three layers, threaded through the
serving frontend's round path:

* **Evidence** (:mod:`.evidence`): one schema of per-submission records —
  cheap model-free features (pre-discount norm z-score, cosine to the
  aggregate, staleness-inflation ratio, echo ratio against the previous
  broadcast) plus each aggregator's own per-row score view
  (:meth:`~byzpy_tpu_torch.aggregators.base.Aggregator.round_evidence`:
  Krum distances, CGE norms, MoNNA reference distances, trimmed-mean clip
  fractions, geometric-median and clipping center distances). Aggregates
  are digest-identical with forensics on or off.
* **Trust** (:mod:`.trust`): per-client EWMA reputation fed by
  exclusion/selection evidence and anomaly flags, LRU-bounded like the
  credit ledger, with admission hooks — trust-weighted credit refill and
  an opt-in quarantine (``rejected_untrusted`` acks, WAL-recorded
  transitions).
* **Audit** (:mod:`.audit`): evidence rides the per-tenant write-ahead
  log and the metrics registry; :func:`.audit.wal_timeline` reconstructs
  who-was-excluded-when from a WAL directory.

Attach to a serving tenant with ``TenantConfig(forensics=
ForensicsConfig(...))``.
"""

from .evidence import (
    DETECTORS,
    DetectorConfig,
    RoundEvidence,
    SubmissionEvidence,
)
from .plane import ForensicsConfig, ForensicsPlane, recent_evidence
from .trust import TrustLedger, TrustPolicy

__all__ = [
    "DETECTORS",
    "DetectorConfig",
    "ForensicsConfig",
    "ForensicsPlane",
    "RoundEvidence",
    "SubmissionEvidence",
    "TrustLedger",
    "TrustPolicy",
    "recent_evidence",
]
