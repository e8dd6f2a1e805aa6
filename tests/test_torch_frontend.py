"""The port's serving frontend (``byzpy_tpu_torch.serving.ServingFrontend``,
``ServingClient``, ``serve_frame``) against the JAX package's, on the CPU.

One seeded stream of submissions (numpy, made from a seed) goes to both
frontends under one fake clock, and rounds close with
``close_round_nowait`` so their composition never depends on timing. The
stream holds fresh and stale rows, rows past the staleness cutoff, a
replayed ``seq``, a client that outruns its credit, a row of the wrong
shape, an unknown tenant and, on the forensics tenant, sign-flipped rows
whose trust falls below the quarantine line. Replies (status and
reason), round ids, cohort sizes and the ``stats()`` fields that do not
depend on time must be equal; the aggregates of the median and the
trimmed mean (order-free, cohorts below bucket 64) digest-equal; Multi-Krum,
CGE and the geometric median within ``rtol=1e-5, atol=1e-6`` with equal
selections (their digests are compared too where the bits agree). Each
case runs with the ragged door on and off (``BYZPY_TPU_TORCH_RAGGED`` for
the port; the reference frontend, which reads its own variable at
construction, has its ragged runtime dropped after it is built, so no
test sets a variable of the JAX package).
"""

import asyncio

import numpy as np
import pytest
import torch

from byzpy_tpu import aggregators as J
from byzpy_tpu import serving as jserving
from byzpy_tpu.forensics import ForensicsConfig as JForensicsConfig
from byzpy_tpu.forensics import TrustPolicy as JTrustPolicy
from byzpy_tpu.forensics.evidence import evidence_digest as jdigest
from byzpy_tpu_torch import aggregators as T
from byzpy_tpu_torch import serving
from byzpy_tpu_torch.engine.actor import wire
from byzpy_tpu_torch.forensics import ForensicsConfig, TrustPolicy
from byzpy_tpu_torch.forensics.evidence import evidence_digest

D = 48
ROUNDS = 4
COHORT = 9
ORDER_FREE = ("median", "trimmed_mean")
FAMILIES = {
    "median": (lambda: T.CoordinateWiseMedian(device="cpu"), lambda: J.CoordinateWiseMedian()),
    "trimmed_mean": (lambda: T.CoordinateWiseTrimmedMean(2, device="cpu"),
                     lambda: J.CoordinateWiseTrimmedMean(f=2)),
    "multi_krum": (lambda: T.MultiKrum(2, 4, device="cpu"), lambda: J.MultiKrum(f=2, q=4)),
    "cge": (lambda: T.ComparativeGradientElimination(2, device="cpu"),
            lambda: J.ComparativeGradientElimination(f=2)),
    "geometric_median": (lambda: T.GeometricMedian(device="cpu"), lambda: J.GeometricMedian()),
}
#: the stats() fields that do not read the clock
STATS_KEYS = ("rounds", "round_id", "ledger", "queue_depth", "queue_high_water", "queue_capacity",
              "rejected_queue_full", "min_cohort", "outstanding", "mean_cohort", "ingress_bytes",
              "failed_rounds", "duplicates", "quarantine_drops", "breaker", "recovered_from",
              "ef_residual_norm", "ragged_served")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small torch operations: one intra-op thread (a thread a core
    spins against the other workers of a parallel run)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(params=["ragged", "bucketed"])
def door(request, monkeypatch):
    monkeypatch.setenv("BYZPY_TPU_TORCH_RAGGED", "1" if request.param == "ragged" else "0")
    return request.param


def _reference(tenants, door, **kw):
    """The JAX frontend with its ragged door as ``door`` says (its runtime
    is built at construction, on by default)."""
    fe = jserving.ServingFrontend(tenants, **kw)
    if door == "bucketed":
        fe._ragged = None
    return fe


def _trust():
    # one excluded round drops a client below the quarantine line
    return dict(alpha=1.0, excluded_obs=0.1, quarantine_below=0.2, readmit_after_rounds=2)


def _tenants(port: bool, families, *, forensics: bool = False, **kw):
    mod = serving if port else jserving
    out = []
    for name in families:
        agg = FAMILIES[name][0 if port else 1]()
        extra = dict(kw)
        if forensics:
            extra["forensics"] = (ForensicsConfig(trust=TrustPolicy(**_trust()), quarantine=True)
                                  if port else
                                  JForensicsConfig(trust=JTrustPolicy(**_trust()), quarantine=True))
        out.append(mod.TenantConfig(
            name, agg, dim=D, cohort_cap=16, min_bucket=2,
            staleness=(serving.StalenessPolicy if port else jserving.StalenessPolicy)(
                "exponential", gamma=0.5, cutoff=2),
            credit=(serving.CreditPolicy if port else jserving.CreditPolicy)(rate_per_s=1.0, burst=3.0),
            **extra))
    return out


def _stream(rnd: int, seed: int):
    """One round's submissions: ``(client, round_submitted, row, seq)``.
    Clients 0-6 honest (every third one round stale), 7-8 sign-flipped and
    scaled; client 2 replays its seq; client 5 sends a row past the
    staleness cutoff; client 4 resubmits three times (its fourth submission
    in one instant outruns its credit of 3); client 6 sends a short row."""
    rng = np.random.default_rng(seed + 97 * rnd)
    base = rng.normal(size=D).astype(np.float32)
    out = []
    for i in range(COHORT):
        row = (base + 0.3 * rng.normal(size=D)).astype(np.float32)
        if i >= 7:
            row = (-4.0 * base).astype(np.float32)
        stale = 1 if i % 3 == 1 else 0
        out.append((f"c{i}", rnd - stale, row, 10 * rnd))
    out.append(("c2", rnd, out[2][2], 10 * rnd))                      # duplicate seq
    out.append(("c5", rnd - 3, out[5][2], 10 * rnd + 1))              # past the cutoff
    out.append(("c4", rnd, out[4][2] * 0.5, 10 * rnd + 2))
    out.append(("c4", rnd, out[4][2] * 0.25, 10 * rnd + 3))
    out.append(("c4", rnd, out[4][2] * 0.125, 10 * rnd + 5))         # credit refused
    out.append(("c6", rnd, out[6][2][: D - 1], 10 * rnd + 4))       # wrong shape
    out.append(("c0", rnd, out[0][2], None))                          # no seq: accepted
    return out


def _run(fe, families, seed, clock):
    """Feed ROUNDS rounds to ``fe``; returns ``(replies, rounds)``."""
    replies, rounds = [], []
    for rnd in range(ROUNDS):
        clock[0] = 10.0 * rnd
        for name in families:
            for client, r_sub, row, seq in _stream(rnd, seed):
                replies.append((name, client, fe.submit(name, client, r_sub, row, seq=seq)))
            replies.append((name, "nobody", fe.submit("no-such-tenant", "x", rnd, row)))
            closed = fe.close_round_nowait(name)
            rounds.append(None if closed is None else (name, closed[0], closed[1].m, closed[2]))
    return replies, rounds


def _compare_rounds(ours, ref, families):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert (o is None) == (r is None)
        if o is None:
            continue
        name, rid, m, vec = o
        assert (name, rid, m) == r[:3]
        ref_vec = np.asarray(r[3])
        if name in ORDER_FREE:
            assert evidence_digest(vec) == jdigest(ref_vec), (name, rid)
        else:
            np.testing.assert_allclose(vec.numpy(), ref_vec, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_frontend_rounds_match_jax(family, door):
    """Replies, round ids, cohort sizes, aggregates and the clock-free stats
    of one seeded stream through both frontends, door on and off."""
    clock = [0.0]
    ours = serving.ServingFrontend(_tenants(True, [family]), clock=lambda: clock[0])
    ref = _reference(_tenants(False, [family]), door, clock=lambda: clock[0])
    our_replies, our_rounds = _run(ours, [family], 11, clock)
    ref_replies, ref_rounds = _run(ref, [family], 11, clock)
    assert our_replies == ref_replies
    reasons = {reply[1] for _, _, reply in our_replies}
    assert {"accepted", "duplicate", "rejected_too_stale", "rejected_rate", "rejected_bad_shape",
            "rejected_unknown_tenant"} <= reasons, reasons
    _compare_rounds(our_rounds, ref_rounds, [family])
    assert all(r is not None for r in our_rounds)
    ours_stats, ref_stats = ours.stats()[family], ref.stats()[family]
    for key in STATS_KEYS:
        assert ours_stats[key] == ref_stats[key], key
    assert ours_stats["ragged_served"] == (door == "ragged")
    for key in ("bad_frames", "malformed_requests", "callback_errors"):
        assert ours_stats["frontend"][key] == ref_stats["frontend"][key]
    if door == "ragged":
        ragged_ours, ragged_ref = ours_stats["frontend"]["ragged"], ref_stats["frontend"]["ragged"]
        for key in ("groups", "tenants", "dispatches", "cohorts_dispatched", "quantized_dispatches",
                    "max_batch"):
            assert ragged_ours[key] == ragged_ref[key], key


@pytest.mark.parametrize("family", ["multi_krum", "cge"])
def test_forensics_quarantine_matches_jax(family, door):
    """With forensics and its quarantine on, the sign-flipped clients are
    excluded, quarantined and refused (``rejected_untrusted``) in the same
    rounds as in the reference; the trust snapshot is the reference's."""
    clock = [0.0]
    ours = serving.ServingFrontend(_tenants(True, [family], forensics=True), clock=lambda: clock[0])
    ref = _reference(_tenants(False, [family], forensics=True), door, clock=lambda: clock[0])
    our_replies, our_rounds = _run(ours, [family], 5, clock)
    ref_replies, ref_rounds = _run(ref, [family], 5, clock)
    assert our_replies == ref_replies
    assert any(reply == (False, "rejected_untrusted") for _, _, reply in our_replies)
    _compare_rounds(our_rounds, ref_rounds, [family])
    snap, ref_snap = ours.stats()[family]["forensics"], ref.stats()[family]["forensics"]
    # quarantined clients hold later windows open below the floor
    assert snap["rounds_observed"] == ref_snap["rounds_observed"] >= 2
    assert snap["rejected_untrusted"] == ref_snap["rejected_untrusted"] > 0
    assert snap["trust"]["quarantined"] == ref_snap["trust"]["quarantined"]
    assert snap["trust"]["bands"] == ref_snap["trust"]["bands"]
    assert snap["recent_flags"] == ref_snap["recent_flags"]
    for (c, s), (rc, rs) in zip(snap["trust"]["lowest_trust_clients"],
                                ref_snap["trust"]["lowest_trust_clients"]):
        assert c == rc and s == pytest.approx(rs, abs=1e-12)


def test_public_state_broadcast_and_misuse():
    """``public_state`` and ``broadcast_frame`` before and after the first
    round, as the reference; an unknown tenant; ``close_round_nowait``
    next to a running scheduler raises."""
    clock = [0.0]
    fe = serving.ServingFrontend(_tenants(True, ["median"]), clock=lambda: clock[0])
    with pytest.raises(ValueError):
        fe.public_state("median")
    with pytest.raises(RuntimeError):
        fe.broadcast_frame("median")
    with pytest.raises(ValueError):
        fe.broadcast_frame("nope")
    for client, r_sub, row, seq in _stream(0, 3)[:COHORT]:
        fe.submit("median", client, r_sub, row, seq=seq)
    rid, cohort, vec = fe.close_round_nowait("median")
    state = fe.public_state("median")
    assert state.round_id == rid == 0 and state.server_round == 1
    assert set(state.accepted) == set(cohort.clients)
    frame = fe.broadcast_frame("median", precision="int8")
    (length,) = wire._HEADER.unpack(frame[:wire._HEADER.size])
    model = wire.decode(frame[wire._HEADER.size:])
    assert model["kind"] == "model" and model["round"] == 0
    assert fe.stats()["median"]["ef_residual_norm"] is not None
    np.testing.assert_allclose(torch.as_tensor(model["aggregate"]).numpy(), vec.numpy(), atol=0.05)
    with pytest.raises(NotImplementedError, match="A.6"):
        serving.ShardFrontend  # noqa: B018 - the attribute access raises


def test_serve_frame_in_process_matches_submit():
    """``serve_frame`` (the wire's codec and HMAC round minus the socket)
    acks as ``submit`` does and counts ingress bytes; a tampered frame
    raises and counts a bad frame."""
    fe = serving.ServingFrontend(_tenants(True, ["median"]), clock=lambda: 0.0)
    row = np.arange(D, dtype=np.float32)
    frame = wire.encode({"kind": "submit", "tenant": "median", "client": "a", "round": 0,
                         "gradient": torch.from_numpy(row), "seq": 0})
    reply = wire.decode(serving.serve_frame(fe, frame[wire._HEADER.size:])[wire._HEADER.size:])
    assert reply == {"kind": "ack", "accepted": True, "reason": "accepted", "round": 0}
    assert fe.stats()["median"]["ingress_bytes"] == len(frame)
    stats = wire.decode(serving.serve_frame(
        fe, wire.encode({"kind": "stats", "tenant": "median"})[wire._HEADER.size:])[wire._HEADER.size:])
    assert stats["stats"]["outstanding"] == 1
    with pytest.raises(Exception):
        serving.serve_frame(fe, b"\x00garbage")
    assert fe.bad_frames == 1


async def _tcp_round(precision, monkeypatch):
    if precision is None:
        monkeypatch.delenv("BYZPY_TPU_TORCH_WIRE_PRECISION", raising=False)
    else:
        monkeypatch.setenv("BYZPY_TPU_TORCH_WIRE_PRECISION", precision)
    d = 2048  # above the wire's quantization floor
    rng = np.random.default_rng(7)
    rows = [rng.normal(size=d).astype(np.float32) for _ in range(6)]
    cfg = [serving.TenantConfig("tm", T.CoordinateWiseTrimmedMean(1, device="cpu"), dim=d,
                                cohort_cap=6, window_s=30.0)]
    fe = serving.ServingFrontend(cfg)
    await fe.start()
    try:
        host, port = await fe.serve()
        async with serving.ServingClient() as client:
            await client.connect(host, port)
            acks = [await client.submit("tm", f"c{i}", 0, rows[i]) for i in range(6)]
            replay = await client.submit("tm", "c0", 0, rows[0], seq=0)
            stats = await client.stats("tm")
        rid = await asyncio.wait_for(fe.drain("tm"), 60)
        vec = fe.last_aggregate("tm")
    finally:
        await fe.close()
    return acks, replay, stats, rid, vec, rows


@pytest.mark.parametrize("precision", [None, "int8", "s4"])
def test_tcp_round_trip_against_itself(precision, monkeypatch):
    """``serve()`` + ``ServingClient`` over loopback, the async scheduler
    closing the round: every ack accepted, a replayed seq a duplicate, the
    aggregate bit for bit the same frontend's synchronous round on the
    rows the wire delivered (decoded exactly as the ingress decodes
    them)."""
    acks, replay, stats, rid, vec, rows = asyncio.run(_tcp_round(precision, monkeypatch))
    assert all(a["accepted"] and a["reason"] == "accepted" for a in acks)
    assert replay == {"kind": "ack", "accepted": True, "reason": "duplicate", "round": replay["round"]}
    assert stats["kind"] == "stats" and stats["stats"]["ledger"]["totals"]["accepted"] == 6
    assert rid == 1
    sent = [wire.decompress_payload(wire.compress_payload({"g": torch.from_numpy(r)},
                                                          precision or "off"))["g"] for r in rows]
    fe = serving.ServingFrontend([serving.TenantConfig(
        "tm", T.CoordinateWiseTrimmedMean(1, device="cpu"), dim=rows[0].shape[0], cohort_cap=6)])
    for i, g in enumerate(sent):
        fe.submit("tm", f"c{i}", 0, g)
    assert evidence_digest(fe.close_round_nowait("tm")[2]) == evidence_digest(vec)


@pytest.mark.parametrize("depth", [0, 1])
def test_async_scheduler_equals_the_synchronous_closer(door, depth):
    """The async scheduler closes a full cohort (the size trigger) to the
    same bits as ``close_round_nowait`` on the same rows, barrier
    (``pipeline_depth=0``) and pipelined (``1``: a round settles when the
    next window collects, so a second cohort is sent)."""
    rows = [r for _, _, r, _ in _stream(0, 21)[:COHORT]]

    async def scheduled():
        captured = []
        fe = serving.ServingFrontend(
            [serving.TenantConfig("mk", T.MultiKrum(2, 4, device="cpu"), dim=D, cohort_cap=COHORT,
                                  window_s=30.0, credit=serving.CreditPolicy(rate_per_s=0.0))],
            pipeline_depth=depth, on_round=lambda _t, rid, _c, vec: captured.append((rid, vec)))
        await fe.start()
        try:
            for rnd in range(2):
                for i, r in enumerate(rows):
                    assert fe.submit("mk", f"c{i}", rnd, r) == (True, "accepted")
            for _ in range(2000):
                if captured:
                    break
                await asyncio.sleep(0.005)
            return captured[0]
        finally:
            await fe.close()

    rid, vec = asyncio.run(scheduled())
    fe = serving.ServingFrontend([serving.TenantConfig(
        "mk", T.MultiKrum(2, 4, device="cpu"), dim=D, cohort_cap=COHORT)])
    for i, r in enumerate(rows):
        fe.submit("mk", f"c{i}", 0, r)
    assert rid == 0
    assert evidence_digest(fe.close_round_nowait("mk")[2]) == evidence_digest(vec)


def test_cohorts_are_built_on_the_aggregators_device(monkeypatch):
    """``build_cohort`` is handed the tenant aggregator's device (the card
    unless the class was built for the CPU): no tenant quietly aggregates
    elsewhere."""
    seen = []
    real = serving.frontend.build_cohort

    def spy(*args, **kw):
        seen.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(serving.frontend, "build_cohort", spy)
    fe = serving.ServingFrontend(_tenants(True, ["cge"]), clock=lambda: 0.0)
    for client, r_sub, row, seq in _stream(0, 3)[:COHORT]:
        fe.submit("cge", client, r_sub, row, seq=seq)
    fe.close_round_nowait("cge")
    assert seen == [torch.device("cpu")]
