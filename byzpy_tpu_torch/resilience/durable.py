"""Durable round state: per-tenant write-ahead log + periodic snapshots.

Counterpart of ``byzpy_tpu/resilience/durable.py``; the records and
snapshot payloads are the reference's, with every array a host numpy
array (the frontend reads device aggregates to the host before it hands
them here) and wire rows as the ingress decoded them.

The contract this module exists to keep: **a submission acked
``accepted`` is never lost and never folded twice**, even across a
SIGKILL of the serving process. Mechanics:

* **Write-ahead accept records.** The frontend appends an accept record
  (client, seq, round stamp, the gradient bytes) to the tenant's WAL
  segment BEFORE the ack leaves the process, so the ack is a durable
  promise (buffered-write durability by default — survives process
  death; set ``fsync=True`` to survive host death too).
* **Round records.** Every closed round appends which accept records
  folded (by write id) plus the aggregate's bit digest; failed/quarantine
  drops append an explicit drop record so recovery never resurrects
  rows the crash guard already accounted as dropped.
* **Periodic snapshots.** Every ``snapshot_every`` closed rounds the
  tenant's state (round counter = the staleness clock, last aggregate,
  dedup table, credit-ledger summary, the still-pending accepts) is
  captured synchronously, the WAL rotates to a fresh segment, and the
  capture persists through :class:`~byzpy_tpu_torch.utils.checkpoint.
  SnapshotStore` — atomic rename + integrity digest, saved off the
  event loop on the async scheduler path.
* **Recovery** (:meth:`TenantDurability.load`) restores the newest
  snapshot generation that verifies (corrupt generations fall back),
  then replays WAL segments: accepts newer than the snapshot re-enter
  the pending set, round records past the snapshot advance the round
  counter and retire their rows. A torn record at a segment tail (the
  normal shape of a SIGKILL mid-append) truncates replay of that
  segment cleanly — everything before the tear is used.

Write ids (``wal_id``) are a per-tenant monotonic counter assigned at
accept time; they are the identity that round/drop records reference, so
exactly-once accounting works even for legacy submissions that carry no
client ``seq``.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import re
import struct
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..observability import metrics as _obs_metrics
from ..observability import runtime as _obs_runtime
from ..utils.checkpoint import (
    CheckpointCorruptError,
    CheckpointNotFoundError,
    SnapshotStore,
)

_LEN = struct.Struct(">I")
_DIGEST_LEN = 8  # sha256 prefix per record
_SEG_RE = re.compile(r"^wal-(\d{12})\.log$")

ACCEPT = "a"
ROUND = "r"
DROP = "f"
#: Forensics evidence / trust-transition records
#: (:mod:`byzpy_tpu_torch.forensics`): appended per closed round (and per quarantine/readmit
#: transition) when the tenant has a forensics plane and durability.
#: Recovery replay IGNORES them (they carry no round state) — they are
#: the auditable who-was-excluded-when trail the forensics CLI reads.
EVIDENCE = "e"
#: Speculative-close repair records (the reference's sharded tier,
#: ``byzpy_tpu/serving/sharded.py``, ROADMAP A.6(c)):
#: appended when a late partial folds into an ALREADY-CLOSED round
#: within the repair horizon. The payload carries the repaired round,
#: the covered shards, the folded ``(client, seq)`` pairs, and the
#: pre-repair / post-repair / delta aggregate digests — the
#: bit-auditable trail ``audit_sharded_exactly_once`` joins against
#: merge evidence so a row can never fold in both. Recovery replay
#: IGNORES them (the shard-side confirm writes the authoritative
#: per-shard round record, exactly like a barrier close).
REPAIR = "p"


@dataclass(frozen=True)
class DurabilityConfig:
    """Durability knobs for one :class:`~byzpy_tpu_torch.serving.ServingFrontend`.

    ``directory`` holds one subdirectory per tenant. ``snapshot_every``
    closed rounds between snapshots (the WAL rotates with each);
    ``max_to_keep`` snapshot generations retained; ``fsync`` upgrades
    process-death durability to host-death durability at the cost of one
    fsync per accept."""

    directory: str
    snapshot_every: int = 8
    max_to_keep: int = 3
    fsync: bool = False
    #: keep WAL segments already covered by every retained snapshot?
    #: False retains the full forensic history (the kill drill's
    #: exactly-once audit reads it); True (default) bounds disk use.
    prune: bool = True

    def __post_init__(self) -> None:
        if self.snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1 (got {self.snapshot_every})"
            )


class RoundLog:
    """One WAL segment: length-prefixed, digest-guarded pickle records.

    Record layout: ``>I`` payload length, 8-byte SHA-256 prefix of the
    payload, payload. :meth:`read` stops at the first torn or corrupt
    record (a SIGKILL mid-append leaves exactly that shape) and reports
    whether the segment ended cleanly."""

    def __init__(self, path: str, *, fsync: bool = False) -> None:
        self.path = path
        self.fsync = fsync
        # append mode: recovery never reopens an old segment for writing
        # (a torn tail would orphan everything appended after it), so a
        # fresh RoundLog always targets a fresh file — enforced by
        # TenantDurability's rotation
        self._fh = open(path, "ab")
        # appends may race across threads (the sharded root's async
        # close runs failure accounting on an executor while the loop
        # keeps appending accepts): each record must hit the file as
        # one atomic unit or a torn record eats the segment tail
        self._lock = threading.Lock()

    def append(self, record: Any) -> None:
        """Durably append one record (flushed; fsync'd per policy).
        Thread-safe: concurrent appends interleave between records,
        never inside one."""
        payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        digest = hashlib.sha256(payload).digest()[:_DIGEST_LEN]
        with self._lock:
            self._fh.write(_LEN.pack(len(payload)) + digest + payload)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def read(path: str) -> Tuple[List[Any], bool]:
        """Every intact record in ``path`` plus a clean-tail flag."""
        records: List[Any] = []
        with open(path, "rb") as fh:
            blob = fh.read()
        off = 0
        while off < len(blob):
            if off + _LEN.size + _DIGEST_LEN > len(blob):
                return records, False  # torn header
            (length,) = _LEN.unpack_from(blob, off)
            start = off + _LEN.size + _DIGEST_LEN
            if start + length > len(blob):
                return records, False  # torn payload
            digest = blob[off + _LEN.size: start]
            payload = blob[start: start + length]
            if hashlib.sha256(payload).digest()[:_DIGEST_LEN] != digest:
                return records, False  # corrupt record: stop trusting
            try:
                records.append(pickle.loads(payload))
            except Exception:  # noqa: BLE001 — digest ok, decode not: stop
                return records, False
            off = start + length
        return records, True


@dataclass
class RecoveredTenant:
    """What :meth:`TenantDurability.load` reconstructed for one tenant."""

    round_id: int = 0
    last_aggregate: Any = None
    seqs: Dict[str, int] = field(default_factory=dict)
    #: accept records admitted (and possibly acked) but never folded or
    #: dropped — recovery re-enqueues these
    pending: List[dict] = field(default_factory=list)
    next_wal_id: int = 0
    #: (round_id, aggregate_digest) of every folded round seen, ascending
    #: — the drill's digest-continuity check reads this
    rounds: List[Tuple[int, str]] = field(default_factory=list)
    ledger_totals: Dict[str, int] = field(default_factory=dict)
    failed_rounds: int = 0
    ingress_bytes: int = 0
    stats_rounds: int = 0
    #: downlink error-feedback residual captured by the snapshot (the
    #: sub-int8 broadcast fabric's carried state); None when the tenant
    #: never broadcast compressed or recovery had no snapshot — the
    #: frontend resets to zero then (documented safe: EF self-corrects
    #: within one round's quantization bound)
    ef_residual: Any = None
    from_snapshot: Optional[int] = None
    skipped_corrupt: List[int] = field(default_factory=list)
    torn_segments: int = 0


class TenantDurability:
    """One tenant's WAL segments + snapshot generations (module docstring).

    Layout under ``<cfg.directory>/<tenant>/``: ``wal-<index:012d>.log``
    segments (monotonic index; one rotation per snapshot or recovery)
    and ``snaps/`` (:class:`~byzpy_tpu_torch.utils.checkpoint.SnapshotStore`).
    """

    def __init__(self, cfg: DurabilityConfig, tenant: str) -> None:
        self.cfg = cfg
        self.tenant = tenant
        self.directory = os.path.join(os.path.abspath(cfg.directory), tenant)
        os.makedirs(self.directory, exist_ok=True)
        self.snaps = SnapshotStore(
            os.path.join(self.directory, "snaps"),
            max_to_keep=cfg.max_to_keep,
            fsync=cfg.fsync,
        )
        #: segment index at which each known snapshot step rotated —
        #: drives segment pruning (segments older than the oldest
        #: retained snapshot's rotation are dead weight)
        self._snap_segments: Dict[int, int] = {}
        self.recovered: Optional[RecoveredTenant] = self._load()
        existing = self._segment_indices()
        self._segment_index = (existing[-1] + 1) if existing else 0
        # the write segment opens LAZILY on the first append/rotation: a
        # constructed-then-discarded TenantDurability (e.g. a recover()
        # attempt on the wrong directory, or a read-only audit) must
        # leave no empty segment behind — an empty segment would make
        # the next recover() "find" prior life and silently serve empty
        # state instead of raising
        self._log: Optional[RoundLog] = None
        self._rounds_since_snapshot = 0
        self._m_records = _obs_metrics.registry().counter(
            "byzpy_wal_records_total",
            help="write-ahead log records appended",
            labels={"tenant": tenant},
        )

    # -- segments ------------------------------------------------------------

    def _segment_path(self, index: int) -> str:
        return os.path.join(self.directory, f"wal-{index:012d}.log")

    def _segment_indices(self) -> List[int]:
        return [idx for idx, _ in _segment_files(self.directory)]

    # -- write side ----------------------------------------------------------

    def _append(self, record: tuple) -> None:
        if self._log is None:
            self._log = RoundLog(
                self._segment_path(self._segment_index), fsync=self.cfg.fsync
            )
        self._log.append(record)
        if _obs_runtime.STATE.enabled:
            self._m_records.inc()

    def record_accept(
        self,
        wal_id: int,
        client: str,
        seq: Optional[int],
        round_submitted: int,
        arrived_s: float,
        gradient: Any,
        wire_inflation: Optional[float] = None,
    ) -> None:
        """WRITE-AHEAD: called before the accept ack is returned.
        ``wire_inflation`` (the ingress-measured pre-decode block
        ratio) persists WITH the accept: a shaped frame admitted just
        before a crash must still reach the forensics detector when
        its replayed row folds after recovery."""
        self._append(
            (
                ACCEPT, wal_id, client, seq, round_submitted, arrived_s,
                gradient, wire_inflation,
            )
        )

    def record_round(
        self, round_id: int, wal_ids: Tuple[int, ...], agg_digest: str, m: int
    ) -> None:
        """One folded round: which accepts folded, and the aggregate's
        bit digest (the recovery continuity pin)."""
        self._append((ROUND, round_id, tuple(wal_ids), agg_digest, m))

    def record_dropped(
        self, round_id: int, wal_ids: Tuple[int, ...], reason: str
    ) -> None:
        """Accepts dropped WITH accounting (crash-guarded round,
        quarantine drain) — recovery must not resurrect them."""
        self._append((DROP, round_id, tuple(wal_ids), reason))

    def record_evidence(self, round_id: int, payload: dict) -> None:
        """Append one forensics record (a round's evidence, or a
        quarantine/readmit transition event) to the audit trail.
        Ignored by recovery replay; read back by
        :func:`byzpy_tpu_torch.forensics.audit.wal_timeline`."""
        self._append((EVIDENCE, int(round_id), payload))

    def record_repair(self, round_id: int, payload: dict) -> None:
        """Append one speculative-close repair record: a late partial
        folded into closed round ``round_id`` within the repair
        horizon. ``payload`` carries the shards covered, the folded
        ``(client, seq)`` pairs, and the old/new/delta aggregate
        digests (the bit-audit trail). Ignored by recovery replay."""
        self._append((REPAIR, int(round_id), payload))

    def snapshot_due(self) -> bool:
        """Whether the periodic snapshot cadence has come round."""
        return self._rounds_since_snapshot >= self.cfg.snapshot_every

    def note_round_closed(self) -> None:
        self._rounds_since_snapshot += 1

    def rotate_and_capture(
        self, step: int, state: dict
    ) -> Callable[[], str]:
        """Rotate to a fresh WAL segment NOW (synchronously — appends
        after this land in the new segment) and return the closure that
        persists ``state`` as snapshot generation ``step``. The caller
        runs the closure inline (sync round closer) or on an executor
        (async scheduler): if the save never happens, recovery simply
        falls back to the previous snapshot and replays one segment
        more."""
        if self._log is not None:
            self._log.close()
        self._segment_index += 1
        self._log = None  # next append opens the fresh segment
        self._rounds_since_snapshot = 0
        state = dict(state)
        state["segment_index"] = self._segment_index
        my_index = self._segment_index

        def save() -> str:
            path = self.snaps.save(step, state)
            self._snap_segments[step] = my_index
            self._prune_segments()
            return path

        return save

    def _prune_segments(self) -> None:
        """Drop segments wholly covered by every RETAINED snapshot:
        anything older than the oldest retained generation's rotation
        point can never be replayed again."""
        if not self.cfg.prune:
            return
        retained = self.snaps.all_steps()
        known = [
            self._snap_segments[s] for s in retained if s in self._snap_segments
        ]
        if len(known) != len(retained) or not known:
            return  # a retained snapshot has an unknown rotation: keep all
        floor = min(known)
        for idx in self._segment_indices():
            if idx < floor and idx != self._segment_index:
                try:
                    os.remove(self._segment_path(idx))
                except OSError:  # pragma: no cover — already gone
                    pass

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
            self._log = None

    # -- read side (recovery) -----------------------------------------------

    def _load(self) -> Optional[RecoveredTenant]:
        """Reconstruct tenant state from disk; ``None`` when the
        directory holds no prior life (fresh start)."""
        rec = RecoveredTenant()
        have_snapshot = False
        try:
            step, state, skipped = self.snaps.restore_latest()
            have_snapshot = True
            rec.from_snapshot = step
            rec.skipped_corrupt = skipped
            rec.round_id = int(state["round_id"])
            rec.last_aggregate = state.get("last_aggregate")
            rec.seqs = dict(state.get("seqs", {}))
            rec.next_wal_id = int(state.get("next_wal_id", 0))
            rec.ledger_totals = dict(state.get("ledger_totals", {}))
            rec.failed_rounds = int(state.get("failed_rounds", 0))
            rec.ingress_bytes = int(state.get("ingress_bytes", 0))
            rec.stats_rounds = int(state.get("stats_rounds", 0))
            rec.ef_residual = state.get("ef_residual")
            if "segment_index" in state:
                self._snap_segments[step] = int(state["segment_index"])
            pending: Dict[int, dict] = {
                int(p["w"]): dict(p) for p in state.get("pending", ())
            }
        except CheckpointNotFoundError:
            pending = {}
        except CheckpointCorruptError:
            # every generation corrupt: recover from the WAL alone —
            # strictly better than refusing to start
            pending = {}
            rec.skipped_corrupt = self.snaps.all_steps()
        segments = self._segment_indices()
        if not have_snapshot and not segments:
            return None
        snap_round = rec.round_id if have_snapshot else -1
        for idx in segments:
            records, clean = RoundLog.read(self._segment_path(idx))
            if not clean:
                rec.torn_segments += 1
            for r in records:
                kind = r[0]
                if kind == ACCEPT:
                    # pre-round-15 segments carry 7 fields (no wire
                    # inflation); read both shapes so an upgrade can
                    # recover an old directory
                    _, wal_id, client, seq, round_sub, arrived_s, grad = r[:7]
                    wi = r[7] if len(r) > 7 else None
                    if wal_id < rec.next_wal_id and wal_id not in pending:
                        # predates the snapshot: already folded, dropped,
                        # or carried in the snapshot's pending set
                        continue
                    pending[wal_id] = {
                        "w": wal_id, "c": client, "q": seq,
                        "r": round_sub, "t": arrived_s, "g": grad,
                        "wi": wi,
                    }
                    rec.next_wal_id = max(rec.next_wal_id, wal_id + 1)
                    if seq is not None:
                        rec.seqs[client] = max(
                            rec.seqs.get(client, -1), int(seq)
                        )
                elif kind == ROUND:
                    _, round_id, wal_ids, digest, _m = r
                    if round_id <= snap_round - 1:
                        continue  # folded before the snapshot captured
                    for w in wal_ids:
                        pending.pop(w, None)
                    rec.rounds.append((int(round_id), digest))
                    rec.round_id = max(rec.round_id, int(round_id) + 1)
                    rec.stats_rounds += 1
                elif kind == DROP:
                    _, _round_id, wal_ids, _reason = r
                    for w in wal_ids:
                        pending.pop(w, None)
        rec.rounds.sort()
        rec.pending = [pending[w] for w in sorted(pending)]
        return rec


def _segment_files(directory: str) -> List[Tuple[int, str]]:
    """The ONE WAL-segment discovery rule: every ``wal-<idx>.log`` in
    ``directory`` as sorted ``(index, path)`` pairs — shared by the
    write side's rotation bookkeeping and the read-only audit door, so
    a naming-scheme change cannot leave one of them scanning a stale
    subset."""
    out = []
    for name in os.listdir(directory):
        m = _SEG_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def read_wal(tenant_directory: str) -> Tuple[List[Any], int]:
    """Every intact record across one tenant's WAL segments, in append
    order, plus the torn-segment count — the read-only audit door
    (:mod:`byzpy_tpu_torch.forensics.audit` reads through this; it opens
    nothing for writing and leaves no trace on disk)."""
    records: List[Any] = []
    torn = 0
    for _, path in _segment_files(tenant_directory):
        recs, clean = RoundLog.read(path)
        records.extend(recs)
        if not clean:
            torn += 1
    return records, torn


__all__ = [
    "DurabilityConfig",
    "RecoveredTenant",
    "RoundLog",
    "TenantDurability",
    "read_wal",
]
