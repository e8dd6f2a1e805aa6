"""Auditable exclusion evidence: reconstruct who-was-excluded-when.

Counterpart of ``byzpy_tpu/forensics/audit.py``.

Two evidence sources, one report shape:

* :func:`wal_timeline` — replays a tenant's write-ahead log
  (``resilience.durable``): accept records give per-client submission
  identity, round records give what actually folded (plus the
  aggregate digest), drop records give accounted losses, and the
  forensics EVIDENCE records give per-round per-client features,
  selection verdicts, detector flags, trust trajectory, and
  quarantine/readmit transitions. The report cross-checks evidence
  against round records (``digest_mismatches`` — an evidence record
  whose aggregate digest disagrees with the round record it claims to
  describe is itself evidence of tampering or a bug).
* :func:`trace_timeline` — the offline twin: replays a chaos event-trace
  JSONL dump (``exclude``/``reject``/``submit``/``round_close`` events,
  the format of the reference's ``chaos.events.EventTrace``) into the
  same per-client/per-round shape, so a chaos cell's exclusions and a
  production WAL audit read identically.

The reference's CLI over both (``forensics/__main__.py``) and its chaos
harness wait for ROADMAP A.6(c).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..resilience import durable
from .evidence import RoundEvidence


def _client_entry(clients: Dict[str, dict], cid: str) -> dict:
    entry = clients.get(cid)
    if entry is None:
        entry = clients[cid] = {
            "folded_rounds": [],
            "excluded_rounds": [],
            "flagged_rounds": [],
            "flags": {},
            "last_trust": None,
            "quarantined_rounds": [],
            "readmitted_rounds": [],
        }
    return entry


def wal_timeline(tenant_directory: str) -> dict:
    """Reconstruct one tenant's exclusion/audit timeline from its WAL
    directory (``<durability-dir>/<tenant>``). Read-only. Returns a
    JSON-ready report: per-round fold/exclusion records, per-client
    histories, quarantine transitions, and consistency cross-checks."""
    records, torn = durable.read_wal(tenant_directory)
    accepts: Dict[int, str] = {}
    rounds: Dict[int, dict] = {}
    clients: Dict[str, dict] = {}
    transitions: List[dict] = []
    evidence_rounds = 0
    digest_mismatches: List[int] = []
    for rec in records:
        kind = rec[0]
        if kind == durable.ACCEPT:
            # round-15 accepts carry an 8th field (the ingress-measured
            # wire inflation); older segments carry 7 — read both
            _, wal_id, client = rec[:3]
            accepts[int(wal_id)] = str(client)
        elif kind == durable.ROUND:
            _, round_id, wal_ids, digest, m = rec
            folded = sorted({accepts.get(int(w), f"wal:{w}") for w in wal_ids})
            info = rounds.setdefault(int(round_id), {})
            info.update({"digest": digest, "m": int(m), "folded": folded})
            for cid in folded:
                _client_entry(clients, cid)["folded_rounds"].append(int(round_id))
        elif kind == durable.DROP:
            _, round_id, wal_ids, reason = rec
            dropped = sorted({accepts.get(int(w), f"wal:{w}") for w in wal_ids})
            info = rounds.setdefault(int(round_id), {})
            info.setdefault("drops", []).append(
                {"reason": reason, "clients": dropped}
            )
        elif kind == durable.EVIDENCE:
            _, round_id, payload = rec
            if not isinstance(payload, dict):
                continue
            if "event" in payload:
                transitions.append(dict(payload))
                entry = _client_entry(clients, str(payload.get("client", "?")))
                key = (
                    "quarantined_rounds"
                    if payload["event"] == "quarantine"
                    else "readmitted_rounds"
                )
                entry[key].append(int(payload.get("round", round_id)))
                continue
            ev = RoundEvidence.from_wire(payload)
            evidence_rounds += 1
            info = rounds.setdefault(ev.round_id, {})
            info["flags"] = dict(ev.flag_counts)
            info["excluded"] = list(ev.excluded_clients)
            round_digest = info.get("digest")
            if round_digest is not None and ev.agg_digest != round_digest:
                digest_mismatches.append(ev.round_id)
            for r in ev.records:
                entry = _client_entry(clients, r.client)
                if r.selected is False:
                    entry["excluded_rounds"].append(ev.round_id)
                if r.flags:
                    entry["flagged_rounds"].append(ev.round_id)
                for fl in r.flags:
                    entry["flags"][fl] = entry["flags"].get(fl, 0) + 1
                if r.trust is not None:
                    entry["last_trust"] = r.trust
    exclusions = {
        rid: info["excluded"]
        for rid, info in sorted(rounds.items())
        if info.get("excluded")
    }
    return {
        "source": "wal",
        "directory": tenant_directory,
        "records": len(records),
        "torn_segments": torn,
        "rounds": {str(k): rounds[k] for k in sorted(rounds)},
        "exclusions_by_round": {str(k): v for k, v in exclusions.items()},
        "clients": clients,
        "transitions": transitions,
        "evidence_rounds": evidence_rounds,
        "digest_mismatches": digest_mismatches,
    }


def trace_timeline(path: str) -> dict:
    """Reconstruct the same report shape from a chaos
    ``EventTrace.to_jsonl`` dump: ``exclude`` events become per-round
    exclusions, ``reject`` events per-client rejection histories,
    ``round_close`` details the round ledger."""
    rounds: Dict[int, dict] = {}
    clients: Dict[str, dict] = {}
    events = 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            events += 1
            kind = ev.get("kind")
            rid = int(ev.get("round", -1))
            who = str(ev.get("who", ""))
            if kind == "exclude":
                info = rounds.setdefault(rid, {})
                info.setdefault("excluded", []).append(who)
                _client_entry(clients, who)["excluded_rounds"].append(rid)
            elif kind == "reject":
                entry = _client_entry(clients, who)
                reason = str(ev.get("detail", "rejected"))
                entry["flags"][reason] = entry["flags"].get(reason, 0) + 1
            elif kind == "submit":
                _client_entry(clients, who)["folded_rounds"].append(rid)
            elif kind == "round_close":
                rounds.setdefault(rid, {})["detail"] = str(ev.get("detail", ""))
    exclusions = {
        rid: info["excluded"]
        for rid, info in sorted(rounds.items())
        if info.get("excluded")
    }
    return {
        "source": "trace",
        "path": path,
        "events": events,
        "rounds": {str(k): rounds[k] for k in sorted(rounds)},
        "exclusions_by_round": {str(k): v for k, v in exclusions.items()},
        "clients": clients,
        "transitions": [],
        "digest_mismatches": [],
    }


def render_text(report: dict, *, top: int = 16) -> str:
    """Human-readable rendering of a timeline report: the exclusion
    ledger (round → excluded clients), the most-flagged clients with
    their trust, and the quarantine transitions."""
    lines: List[str] = []
    src = report.get("source", "?")
    where = report.get("directory") or report.get("path") or ""
    lines.append(f"forensics audit [{src}] {where}")
    lines.append(
        f"  rounds={len(report.get('rounds', {}))} "
        f"clients={len(report.get('clients', {}))} "
        f"evidence_rounds={report.get('evidence_rounds', 0)} "
        f"torn_segments={report.get('torn_segments', 0)}"
    )
    mism = report.get("digest_mismatches", [])
    if mism:
        lines.append(f"  !! digest mismatches in rounds: {mism}")
    excl = report.get("exclusions_by_round", {})
    lines.append(f"  exclusions ({len(excl)} rounds):")
    for rid, who in list(excl.items())[:top]:
        lines.append(f"    round {rid}: {', '.join(who)}")
    if len(excl) > top:
        lines.append(f"    ... {len(excl) - top} more rounds")
    scored = sorted(
        report.get("clients", {}).items(),
        key=lambda kv: -sum(kv[1]["flags"].values()),
    )
    flagged = [(c, e) for c, e in scored if e["flags"]]
    lines.append(f"  flagged clients ({len(flagged)}):")
    for cid, entry in flagged[:top]:
        trust = entry.get("last_trust")
        trust_s = "?" if trust is None else f"{trust:.3f}"
        flags = ", ".join(f"{k}×{v}" for k, v in sorted(entry["flags"].items()))
        lines.append(
            f"    {cid}: trust={trust_s} "
            f"excluded×{len(entry['excluded_rounds'])} [{flags}]"
        )
    transitions = report.get("transitions", [])
    if transitions:
        lines.append(f"  quarantine transitions ({len(transitions)}):")
        for t in transitions[:top]:
            lines.append(
                f"    round {t.get('round')}: {t.get('event')} {t.get('client')}"
            )
    return "\n".join(lines)


def first_flag_rounds(report: dict, prefix: Optional[str] = None) -> Dict[str, int]:
    """Per-client first round carrying any detector flag (detection
    latency). ``prefix`` filters client ids (the chaos simulator names
    byzantine clients ``byz…``)."""
    out: Dict[str, int] = {}
    for cid, entry in report.get("clients", {}).items():
        if prefix is not None and not cid.startswith(prefix):
            continue
        if entry.get("flagged_rounds"):
            out[cid] = min(entry["flagged_rounds"])
    return out


__all__ = [
    "first_flag_rounds",
    "render_text",
    "trace_timeline",
    "wal_timeline",
]
