"""Per-client evidence: the one schema online forensics and offline
influence studies share.

Counterpart of ``byzpy_tpu/forensics/evidence.py``; the features are host
numpy, as the reference's, and :func:`evidence_digest` takes a tensor on
any device (read to the host once) as well as an array.

Every closed production round yields one :class:`RoundEvidence`: a
per-submission record of cheap, model-free features (pre-discount norm,
robust norm z-score vs the cohort, cosine to the broadcast aggregate,
distance-to-previous-broadcast "echo" ratio, staleness weight/δ and the
pre-discount inflation ratio — exactly the signal ``docs/serving.md``'s
threat model says to screen for) plus the aggregator's own per-row
score view (:meth:`~byzpy_tpu_torch.aggregators.base.Aggregator.
round_evidence`: Krum distances, CGE norms, MoNNA reference distances,
trimmed-mean clip fractions, geomed/clipping center distances) and the
detector flags those features tripped.

Everything here is **host-side and bit-effect-free**: features are
computed from the already-assembled cohort matrix and the already-
published aggregate, never inside the aggregation program — round
aggregates are digest-identical with forensics on or off. The same
records are produced by the serving frontend (online), appended to the
per-tenant write-ahead log (``resilience.durable``) and read back by
:mod:`.audit`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

#: Detector names emitted by :func:`instant_flags` (plus ``"echo"`` —
#: persistence-gated by the plane — and ``"low_trust"`` from the trust
#: ledger). The vocabulary is open: dashboards key
#: ``byzpy_anomaly_flags_total{detector=...}`` off these.
DETECTORS = (
    "staleness_inflation",
    "staleness_pinned",
    "norm_outlier",
    "sign_anomaly",
    "echo",
    "low_trust",
    "residual_shaping",
)


@dataclass(frozen=True)
class DetectorConfig:
    """Thresholds for the model-free anomaly detectors.

    ``norm_z_threshold``: robust z-score (median/MAD with a relative
    floor on the denominator, so homogeneous cohorts cannot divide by
    ~0) above which a row's pre-discount norm is an outlier.
    ``inflation_threshold``: a STALE row (discount weight < 1) whose
    pre-discount norm exceeds this multiple of the cohort's fresh-row
    median norm is staleness-window abuse (the abuser pre-inflates by
    ``1/discount(δ)`` so the discount cancels — the inflation is only
    visible pre-discount). ``sign_cos_threshold``/``sign_norm_ratio``/
    ``sign_coherence``: a row anti-aligned with the broadcast aggregate
    AND larger than ``sign_norm_ratio`` × the cohort median norm is a
    sign-flip shape — but ONLY while at least ``sign_coherence`` of the
    cohort is aligned (cos > 0.5) with the aggregate; past convergence
    honest gradients legitimately disagree, coherence drops, and the
    detector disarms itself (without the gate the honest client with
    the most extreme target is indistinguishable from a mild sign
    flip). ``echo_ratio``/``echo_rounds``: a row whose distance to
    the PREVIOUS broadcast is under ``echo_ratio`` × the cohort median
    distance is mimicking the public feed rather than computing a
    gradient; the flag fires after ``echo_rounds`` consecutive rounds
    (one lucky central client must not trip it). ``pinned_rounds``: a
    client whose EVERY submission has been stale for this many
    consecutive rounds is pinned to the staleness window — the
    docs/serving.md signal ("a client always at the cutoff is a
    signal, not a coincidence"): the abuse pattern maximizes δ every
    round to buy inflation headroom, while an honest client's lag
    varies. A genuinely always-slow honest client also trips this; in
    a deployment that is still worth operator attention (raise the
    threshold to tolerate it). ``wire_inflation_threshold``: a
    submission whose PRE-decode per-block wire inflation ratio
    (``engine.actor.wire.frame_inflation`` — qmax over the largest
    code magnitude among nonzero blocks) exceeds this is shaping its
    quantization grid: an honest blockwise encoder maps each block's
    absmax to exactly the code maximum (ratio 1.0; stochastic
    rounding dips one code step), while a residual-shaping client
    inflates its scales to buy a coarse grid whose "error" it steers
    through error feedback — invisible post-decode, unmistakable
    pre-decode."""

    norm_z_threshold: float = 12.0
    inflation_threshold: float = 3.0
    sign_cos_threshold: float = -0.5
    sign_norm_ratio: float = 3.0
    sign_coherence: float = 0.7
    echo_ratio: float = 0.05
    echo_rounds: int = 2
    pinned_rounds: int = 4
    wire_inflation_threshold: float = 2.0

    def __post_init__(self) -> None:
        if self.norm_z_threshold <= 0:
            raise ValueError("norm_z_threshold must be > 0")
        if self.inflation_threshold <= 1.0:
            raise ValueError("inflation_threshold must be > 1")
        if not 0.0 < self.echo_ratio < 1.0:
            raise ValueError("echo_ratio must be in (0, 1)")
        if self.echo_rounds < 1:
            raise ValueError("echo_rounds must be >= 1")
        if self.pinned_rounds < 1:
            raise ValueError("pinned_rounds must be >= 1")
        if self.wire_inflation_threshold <= 1.0:
            raise ValueError(
                "wire_inflation_threshold must be > 1 (an honest "
                "blockwise encoder sits at exactly 1.0)"
            )


@dataclass(frozen=True)
class SubmissionEvidence:
    """One submission's evidence record inside a round.

    ``norm`` is the PRE-discount row norm (the bits on the wire);
    ``norm_z`` the robust z-score vs the cohort; ``cos_to_agg`` cosine
    to this round's broadcast aggregate; ``echo_ratio`` the row's
    distance to the PREVIOUS broadcast over the cohort median distance
    (None before any broadcast); ``weight`` the staleness discount the
    fold applied; ``delta`` the staleness in rounds (−1 = unknown, the
    producer only saw weights); ``inflation`` the pre-discount norm
    over the fresh-row median norm; ``score`` the aggregator's per-row
    score (None when it publishes none); ``selected`` the aggregator's
    selection verdict (None for non-selection aggregators); ``flags``
    the detector names this row tripped; ``trust`` the client's trust
    score AFTER this round folded into the ledger."""

    client: str
    slot: int
    norm: float
    norm_z: float
    cos_to_agg: float
    echo_ratio: Optional[float]
    weight: float
    delta: int
    inflation: float
    score: Optional[float]
    selected: Optional[bool]
    flags: Tuple[str, ...] = ()
    trust: Optional[float] = None
    #: pre-decode wire block-inflation ratio (None when the submission
    #: arrived lossless/in-process — the residual-shaping feature)
    wire_inflation: Optional[float] = None

    def to_wire(self) -> dict:
        """Compact dict for WAL/flight-recorder serialization."""
        return {
            "c": self.client, "i": self.slot,
            "n": round(self.norm, 6), "z": round(self.norm_z, 4),
            "cos": round(self.cos_to_agg, 6),
            "e": None if self.echo_ratio is None else round(self.echo_ratio, 6),
            "w": round(self.weight, 6), "d": self.delta,
            "inf": round(self.inflation, 4),
            "s": None if self.score is None else round(self.score, 6),
            "sel": self.selected,
            "f": list(self.flags),
            "t": None if self.trust is None else round(self.trust, 4),
            "wi": (
                None if self.wire_inflation is None
                else round(self.wire_inflation, 4)
            ),
        }

    @classmethod
    def from_wire(cls, d: Mapping[str, Any]) -> "SubmissionEvidence":
        """Inverse of :meth:`to_wire`."""
        return cls(
            client=str(d["c"]), slot=int(d["i"]),
            norm=float(d["n"]), norm_z=float(d["z"]),
            cos_to_agg=float(d["cos"]),
            echo_ratio=None if d.get("e") is None else float(d["e"]),
            weight=float(d["w"]), delta=int(d["d"]),
            inflation=float(d["inf"]),
            score=None if d.get("s") is None else float(d["s"]),
            selected=d.get("sel"),
            flags=tuple(d.get("f", ())),
            trust=None if d.get("t") is None else float(d["t"]),
            wire_inflation=(
                None if d.get("wi") is None else float(d["wi"])
            ),
        )


@dataclass(frozen=True)
class RoundEvidence:
    """One closed round's complete evidence view.

    ``agg_digest`` is the broadcast aggregate's bit digest (the same
    16-hex fingerprint the WAL round records carry, so an audit can
    join evidence to rounds); ``score_kind`` names the aggregator's
    score semantics (``krum_distance``/``norm``/…, empty when none);
    ``records`` one :class:`SubmissionEvidence` per valid cohort row."""

    tenant: str
    round_id: int
    m: int
    bucket: int
    agg_digest: str
    score_kind: str
    records: Tuple[SubmissionEvidence, ...]
    flag_counts: Mapping[str, int] = field(default_factory=dict)

    @property
    def excluded_clients(self) -> Tuple[str, ...]:
        """Clients whose every row this round was de-selected."""
        by_client: Dict[str, bool] = {}
        for r in self.records:
            if r.selected is None:
                continue
            by_client[r.client] = by_client.get(r.client, False) or r.selected
        return tuple(c for c, kept in sorted(by_client.items()) if not kept)

    @property
    def flagged_clients(self) -> Tuple[str, ...]:
        """Clients with at least one detector flag this round."""
        return tuple(sorted({r.client for r in self.records if r.flags}))

    def to_wire(self) -> dict:
        """Compact dict for WAL/flight-recorder serialization."""
        return {
            "tenant": self.tenant, "round": self.round_id,
            "m": self.m, "bucket": self.bucket,
            "digest": self.agg_digest, "kind": self.score_kind,
            "rows": [r.to_wire() for r in self.records],
            "flags": dict(self.flag_counts),
        }

    @classmethod
    def from_wire(cls, d: Mapping[str, Any]) -> "RoundEvidence":
        """Inverse of :meth:`to_wire`."""
        return cls(
            tenant=str(d.get("tenant", "")),
            round_id=int(d["round"]),
            m=int(d["m"]), bucket=int(d["bucket"]),
            agg_digest=str(d.get("digest", "")),
            score_kind=str(d.get("kind", "")),
            records=tuple(
                SubmissionEvidence.from_wire(r) for r in d.get("rows", ())
            ),
            flag_counts=dict(d.get("flags", {})),
        )


_EPS = 1e-12


def row_features(
    matrix: Any,
    valid: Any,
    aggregate: Any,
    *,
    prev_aggregate: Any = None,
    weights: Any = None,
) -> Dict[str, np.ndarray]:
    """Model-free per-row features over the VALID rows of a padded
    cohort (host numpy; the producer passes the PRE-discount matrix).

    Returns arrays of length ``m`` (compacted valid rows, in slot
    order): ``norm``, ``norm_z`` (median/MAD with a 5 %-of-median floor
    on the denominator), ``cos`` (cosine to ``aggregate``),
    ``inflation`` (norm over the fresh-row median norm), ``echo``
    (distance to ``prev_aggregate`` over the cohort median such
    distance; all-NaN when there is no previous broadcast), and
    ``stale`` (bool: discount weight < 1)."""
    valid = np.asarray(host_array(valid), bool)
    idx = np.flatnonzero(valid)
    rows = np.asarray(host_array(matrix), np.float32)[idx]
    m = rows.shape[0]
    norms = np.linalg.norm(rows, axis=1)
    med = float(np.median(norms)) if m else 0.0
    mad = float(np.median(np.abs(norms - med))) if m else 0.0
    denom = max(1.4826 * mad, 0.05 * med, _EPS)
    norm_z = (norms - med) / denom
    agg = np.asarray(host_array(aggregate), np.float32).reshape(-1)
    agg_norm = float(np.linalg.norm(agg))
    cos = rows @ agg / (norms * agg_norm + _EPS)
    if weights is None:
        stale = np.zeros((m,), bool)
    else:
        stale = np.asarray(weights, np.float32)[idx] < 1.0
    fresh_norms = norms[~stale]
    fresh_med = float(np.median(fresh_norms)) if fresh_norms.size else med
    inflation = norms / max(fresh_med, _EPS)
    if prev_aggregate is None:
        echo = np.full((m,), np.nan, np.float64)
    else:
        prev = np.asarray(host_array(prev_aggregate), np.float32).reshape(-1)
        dists = np.linalg.norm(rows - prev[None, :], axis=1)
        med_d = float(np.median(dists)) if m else 0.0
        echo = dists / max(med_d, _EPS)
    return {
        "norm": norms,
        "norm_z": norm_z,
        "cos": cos,
        "inflation": inflation,
        "echo": echo,
        "stale": stale,
    }


def instant_flags(
    features: Mapping[str, np.ndarray], cfg: DetectorConfig
) -> List[List[str]]:
    """Per-row detector flags that need no cross-round state (the
    ``echo`` persistence gate and the trust-fed ``low_trust`` flag are
    applied by the plane). Returns one flag list per valid row."""
    m = len(features["norm"])
    med = float(np.median(features["norm"])) if m else 0.0
    # cohort coherence: the sign detector is only meaningful while the
    # honest majority visibly agrees with the broadcast direction
    coherent = (
        m > 0 and float(np.mean(features["cos"] > 0.5)) >= cfg.sign_coherence
    )
    out: List[List[str]] = []
    for i in range(m):
        flags: List[str] = []
        if (
            bool(features["stale"][i])
            and float(features["inflation"][i]) > cfg.inflation_threshold
        ):
            flags.append("staleness_inflation")
        if float(features["norm_z"][i]) > cfg.norm_z_threshold:
            flags.append("norm_outlier")
        if (
            coherent
            and float(features["cos"][i]) < cfg.sign_cos_threshold
            and float(features["norm"][i]) > cfg.sign_norm_ratio * med
        ):
            flags.append("sign_anomaly")
        out.append(flags)
    return out


def evidence_digest(vec: Any) -> str:
    """16-hex-char fingerprint of an aggregate's exact bits — the same
    rule the serving WAL round records use, so evidence and round
    records join on equal digests."""
    import hashlib

    a = np.ascontiguousarray(np.asarray(host_array(vec), np.float32))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def host_array(x: Any) -> Any:
    """``x`` as a host numpy array when it is a tensor (one read of a card
    tensor to the host; a bfloat16 or float16 tensor widens to float32
    first, exactly), else ``x`` unchanged."""
    if type(x).__module__.startswith("torch") and hasattr(x, "detach"):
        t = x.detach()
        if t.dtype.is_floating_point and t.element_size() < 4:
            t = t.float()
        return t.cpu().numpy()
    return x


__all__ = [
    "DETECTORS",
    "DetectorConfig",
    "RoundEvidence",
    "SubmissionEvidence",
    "evidence_digest",
    "host_array",
    "instant_flags",
    "row_features",
]
