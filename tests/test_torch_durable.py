"""The port's resilience planes (``byzpy_tpu_torch.resilience.breaker``,
``.durable``) and checkpoints (``utils.checkpoint``) against the JAX
package, on the CPU.

The breaker's states follow the reference's under one sequence of events;
a write-ahead log and its snapshots round-trip, a torn tail and a corrupt
newest snapshot fall back as in the reference; a port frontend stopped
after k rounds and restored by ``recover`` gives the later digests of an
uninterrupted port run and, for the order-free families (the median and
the trimmed mean, cohorts below bucket 64), of the JAX frontend's
uninterrupted run; a tenant whose rounds fail is quarantined by its
breaker in the same rounds as in the reference.
"""

import os

import numpy as np
import pytest
import torch

from byzpy_tpu import aggregators as J
from byzpy_tpu import serving as jserving
from byzpy_tpu.forensics.evidence import evidence_digest as jdigest
from byzpy_tpu.resilience import breaker as jbreaker
from byzpy_tpu.resilience import durable as jdurable
from byzpy_tpu_torch import aggregators as T
from byzpy_tpu_torch import serving
from byzpy_tpu_torch.forensics.evidence import evidence_digest
from byzpy_tpu_torch.resilience import breaker, durable
from byzpy_tpu_torch.utils import checkpoint

D = 40


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


EVENTS = ["f", "f", "a", "s", "f", "f", "f", "a", "t5", "a", "f", "a", "t40", "a", "s", "a",
          "f", "f", "f", "t100", "a", "s"]


def test_breaker_states_follow_the_reference():
    """``allow`` / ``record_failure`` / ``record_success`` and clock steps:
    the same returns, states and snapshots as the reference's breaker."""
    now = [0.0]
    ours = breaker.CircuitBreaker(breaker.BreakerPolicy(threshold=3, cooldown_s=30.0),
                                  clock=lambda: now[0])
    ref = jbreaker.CircuitBreaker(jbreaker.BreakerPolicy(threshold=3, cooldown_s=30.0),
                                  clock=lambda: now[0])
    for ev in EVENTS:
        if ev == "f":
            assert ours.record_failure("boom") == ref.record_failure("boom")
        elif ev == "s":
            ours.record_success()
            ref.record_success()
        elif ev == "a":
            assert ours.allow() == ref.allow()
        else:
            now[0] += float(ev[1:])
        assert ours.snapshot() == ref.snapshot()
    assert ours.opens == ref.opens == 2
    with pytest.raises(ValueError):
        breaker.BreakerPolicy(threshold=0)


def test_wal_and_snapshot_round_trip(tmp_path):
    """Accept, round and drop records read back as written; a snapshot
    restores its state; a torn tail truncates replay cleanly; a corrupt
    newest snapshot falls back to the previous generation."""
    cfg = durable.DurabilityConfig(directory=str(tmp_path), snapshot_every=1, max_to_keep=3)
    td = durable.TenantDurability(cfg, "t")
    assert td.recovered is None
    rows = np.random.default_rng(0).normal(size=(4, D)).astype(np.float32)
    for w in range(4):
        td.record_accept(w, f"c{w}", w, 0, 0.0, rows[w], wire_inflation=None if w else 1.5)
    td.record_round(0, (0, 1), "00ff", 2)
    td.record_dropped(0, (2,), "failed_round")
    records, torn = durable.read_wal(td.directory)
    assert torn == 0 and [r[0] for r in records] == ["a"] * 4 + ["r", "f"]
    np.testing.assert_array_equal(records[3][6], rows[3])
    td.note_round_closed()
    assert td.snapshot_due()
    save = td.rotate_and_capture(1, {"round_id": 1, "last_aggregate": rows[0], "seqs": {"c0": 0},
                                     "next_wal_id": 4, "pending": [
                                         {"w": 3, "c": "c3", "q": 3, "r": 0, "t": 0.0,
                                          "g": rows[3], "wi": None}]})
    save()
    td.record_accept(4, "c4", 4, 1, 0.0, rows[0])
    td.close()
    rec = durable.TenantDurability(cfg, "t").recovered
    assert rec.round_id == 1 and rec.from_snapshot == 1
    assert [p["w"] for p in rec.pending] == [3, 4]
    np.testing.assert_array_equal(rec.last_aggregate, rows[0])
    # the reference recovers the port's directory to the same state
    jrec = jdurable.TenantDurability(jdurable.DurabilityConfig(directory=str(tmp_path)), "t").recovered
    assert (jrec.round_id, [p["w"] for p in jrec.pending], jrec.seqs) == \
        (rec.round_id, [p["w"] for p in rec.pending], rec.seqs)
    # a torn tail: the last record cut in half
    seg = sorted(p for p in os.listdir(td.directory) if p.startswith("wal-"))[-1]
    path = os.path.join(td.directory, seg)
    with open(path, "rb+") as fh:
        size = fh.seek(0, 2)
        fh.truncate(size - 7)
    rec = durable.TenantDurability(cfg, "t").recovered
    assert rec.torn_segments == 1 and [p["w"] for p in rec.pending] == [3]
    # a corrupt newest snapshot generation falls back to the previous one
    store = checkpoint.SnapshotStore(str(tmp_path / "s"), max_to_keep=3)
    store.save(1, {"v": 1})
    store.save(2, {"v": 2})
    with open(store._path(2), "rb+") as fh:
        fh.seek(-1, 2)
        fh.write(b"\x00")
    step, state, skipped = store.restore_latest()
    assert (step, state, skipped) == (1, {"v": 1}, [2])
    with pytest.raises(checkpoint.CheckpointNotFoundError):
        checkpoint.SnapshotStore(str(tmp_path / "empty")).restore_latest()


def test_checkpoint_manager_round_trip(tmp_path):
    """``CheckpointManager`` over ``torch.save``: latest and named steps,
    pruning past ``max_to_keep``, ``like=`` placing tensors, and the typed
    errors."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    with pytest.raises(checkpoint.CheckpointNotFoundError):
        mgr.restore()
    for step in range(3):
        mgr.save(step, {"params": {"w": torch.full((3,), float(step))}, "round": step})
    assert mgr.all_steps() == [1, 2] and mgr.latest_step() == 2
    state = mgr.restore()
    assert state["round"] == 2 and torch.equal(state["params"]["w"], torch.full((3,), 2.0))
    like = {"params": {"w": torch.zeros((3,), dtype=torch.float64)}, "round": 0}
    assert mgr.restore(1, like=like)["params"]["w"].dtype == torch.float64
    with pytest.raises(checkpoint.CheckpointNotFoundError):
        mgr.restore(0)
    with pytest.raises(checkpoint.CheckpointCorruptError):
        mgr.restore(1, like={"params": {"w": torch.zeros(4)}, "round": 0})
    with open(os.path.join(str(tmp_path), "step-000000000002.pt"), "wb") as fh:
        fh.write(b"not a checkpoint")
    with pytest.raises(checkpoint.CheckpointCorruptError):
        mgr.restore()
    with checkpoint.CheckpointManager(str(tmp_path / "one")) as m2:
        checkpoint.save_checkpoint(m2.directory, 5, {"x": 1})
    assert checkpoint.restore_checkpoint(str(tmp_path / "one")) == {"x": 1}


FAMILIES = {
    "median": (lambda: T.CoordinateWiseMedian(device="cpu"), lambda: J.CoordinateWiseMedian()),
    "trimmed_mean": (lambda: T.CoordinateWiseTrimmedMean(1, device="cpu"),
                     lambda: J.CoordinateWiseTrimmedMean(f=1)),
    "multi_krum": (lambda: T.MultiKrum(1, 3, device="cpu"), lambda: J.MultiKrum(f=1, q=3)),
}


def _frontend(port, family, directory=None, recover=False):
    mod = serving if port else jserving
    cfg = [mod.TenantConfig(family, FAMILIES[family][0 if port else 1](), dim=D, cohort_cap=16,
                            credit=mod.CreditPolicy(rate_per_s=0.0))]
    if directory is None:
        return mod.ServingFrontend(cfg, clock=lambda: 0.0)
    dur = mod.DurabilityConfig(directory=directory, snapshot_every=2)
    if recover:
        return mod.ServingFrontend.recover(cfg, dur, clock=lambda: 0.0)
    return mod.ServingFrontend(cfg, clock=lambda: 0.0, durability=dur)


def _feed(fe, family, rnd, *, extra=0):
    rng = np.random.default_rng(100 + rnd)
    for i in range(6 + extra):
        fe.submit(family, f"c{i}", rnd, rng.normal(size=D).astype(np.float32), seq=rnd)


def _close_fe(fe):
    for t in fe._tenants.values():
        if t.durability is not None:
            t.durability.close()


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("k", [1, 3])
def test_recovered_frontend_continues_the_uninterrupted_digests(family, k, tmp_path):
    """Stop after ``k`` rounds (two rows admitted but not folded), recover,
    and run on: every later round's digest equals an uninterrupted port
    run's (the recovered round ids and pending rows included) and, for the
    order-free families, the JAX frontend's."""
    rounds = 5

    def run(fe, start=0, stop=rounds):
        out = []
        for rnd in range(start, stop):
            if rnd != k or start == k:
                _feed(fe, family, rnd)
            out.append(fe.close_round_nowait(family))
        return out

    whole = _frontend(True, family)
    straight = []
    for rnd in range(rounds):
        _feed(whole, family, rnd, extra=2 if rnd == k else 0)
        straight.append(whole.close_round_nowait(family))
    directory = str(tmp_path / "wal")
    first = _frontend(True, family, directory)
    for rnd in range(k):
        _feed(first, family, rnd)
        first.close_round_nowait(family)
    _feed(first, family, k, extra=2)  # admitted (WAL-logged), not folded
    _close_fe(first)
    again = _frontend(True, family, directory, recover=True)
    assert again.round_of(family) == k
    assert again.stats()[family]["recovered_from"]["replayed_pending"] == 8
    later = run(again, start=k)
    _close_fe(again)
    for got, want in zip(later, straight[k:]):
        assert got[0] == want[0] and got[1].m == want[1].m
        assert evidence_digest(got[2]) == evidence_digest(want[2])
    if family in ("median", "trimmed_mean"):
        ref = _frontend(False, family)
        for rnd in range(rounds):
            _feed(ref, family, rnd, extra=2 if rnd == k else 0)
            closed = ref.close_round_nowait(family)
            assert jdigest(np.asarray(closed[2])) == evidence_digest(straight[rnd][2])


class _FailingMedian(T.CoordinateWiseMedian):
    supports_masked_finalize = False

    def _aggregate_matrix(self, x):
        raise RuntimeError("poisoned")


class _JFailingMedian(J.CoordinateWiseMedian):
    supports_masked_finalize = False

    def _aggregate_matrix(self, x):
        raise RuntimeError("poisoned")


def test_breaker_quarantines_a_failing_tenant_like_the_reference(tmp_path):
    """Failed rounds count, the breaker opens at its threshold, the queue
    drains with accounting and submissions are refused
    (``rejected_quarantined``) until the cooldown's probe, in both
    packages; the WAL records the drops."""
    now = [0.0]

    def build(port):
        mod = serving if port else jserving
        cfg = [mod.TenantConfig("t", (_FailingMedian(device="cpu") if port else _JFailingMedian()),
                                dim=D, cohort_cap=8, credit=mod.CreditPolicy(rate_per_s=0.0),
                                breaker=mod.BreakerPolicy(threshold=2, cooldown_s=5.0))]
        return mod.ServingFrontend(cfg, clock=lambda: now[0], durability=mod.DurabilityConfig(
            directory=str(tmp_path / ("p" if port else "j"))))

    fes = [build(True), build(False)]
    log = [[], []]
    for step in range(6):
        now[0] = 3.0 * step
        for j, fe in enumerate(fes):
            rng = np.random.default_rng(step)
            for i in range(3):
                log[j].append(fe.submit("t", f"c{i}", fe.round_of("t"),
                                        rng.normal(size=D).astype(np.float32), seq=step))
            log[j].append(fe.close_round_nowait("t"))
    assert log[0] == log[1]
    assert (False, "rejected_quarantined") in log[0]
    s0, s1 = fes[0].stats()["t"], fes[1].stats()["t"]
    for key in ("failed_rounds", "quarantine_drops", "breaker", "ledger", "outstanding"):
        assert s0[key] == s1[key], key
    _close_fe(fes[0])
    _close_fe(fes[1])
    drops = [r for r in durable.read_wal(str(tmp_path / "p" / "t"))[0] if r[0] == "f"]
    jdrops = [r for r in jdurable.read_wal(str(tmp_path / "j" / "t"))[0] if r[0] == "f"]
    assert drops == jdrops and drops
