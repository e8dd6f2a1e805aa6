"""The port's forensics plane (``byzpy_tpu_torch.forensics``) and the
classes' evidence members against the JAX package, on the CPU.

Inputs are numpy, made from a seed. ``row_features`` and ``instant_flags``
are host numpy in both packages and must be equal. The six
``round_evidence`` views score on the rows' device in the port (Krum's
Gram, ``row_sq_dists``): scores within ``rtol=1e-5, atol=1e-5`` of the
reference's, keep sets equal. The trust ledger after a scripted sequence
of rounds, and the audit of one write-ahead log, must be the reference's.
"""

import os

import numpy as np
import pytest
import torch

from byzpy_tpu import aggregators as J
from byzpy_tpu import serving as jserving
from byzpy_tpu.forensics import ForensicsConfig as JForensicsConfig
from byzpy_tpu.forensics import ForensicsPlane as JForensicsPlane
from byzpy_tpu.forensics import audit as jaudit
from byzpy_tpu.forensics import evidence as jevidence
from byzpy_tpu_torch import aggregators as T
from byzpy_tpu_torch import serving
from byzpy_tpu_torch.forensics import DetectorConfig, ForensicsConfig, ForensicsPlane, audit, evidence

D = 64


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cohort(n: int, m: int, d: int, seed: int, *, byz: int = 2):
    """A padded cohort: ``m`` valid rows of ``n`` (honest around one mean,
    ``byz`` sign-flipped and scaled), a stale weight on every third."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=d).astype(np.float32)
    rows = np.zeros((n, d), np.float32)
    for i in range(m):
        rows[i] = base + 0.2 * rng.normal(size=d)
    rows[m - byz:m] = -5.0 * base
    valid = np.zeros((n,), bool)
    valid[:m] = True
    weights = np.where(valid, np.where(np.arange(n) % 3 == 1, 0.5, 1.0), 0.0).astype(np.float32)
    return rows, valid, weights, base


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("with_prev", [False, True])
def test_row_features_and_instant_flags_equal_the_reference(seed, with_prev):
    rows, valid, weights, base = _cohort(16, 11, D, seed)
    agg = base * 0.9
    prev = base * 0.7 if with_prev else None
    ours = evidence.row_features(torch.from_numpy(rows), valid, torch.from_numpy(agg),
                                 prev_aggregate=prev, weights=weights)
    ref = jevidence.row_features(rows, valid, agg, prev_aggregate=prev, weights=weights)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    cfg = DetectorConfig(norm_z_threshold=3.0)
    jcfg = jevidence.DetectorConfig(norm_z_threshold=3.0)
    flags = evidence.instant_flags(ours, cfg)
    assert flags == jevidence.instant_flags(ref, jcfg)
    assert any(flags)


def test_evidence_digest_takes_tensors_and_hashes_the_f32_bits():
    v = np.random.default_rng(0).normal(size=37).astype(np.float32)
    want = jevidence.evidence_digest(v)
    assert evidence.evidence_digest(v) == want
    assert evidence.evidence_digest(torch.from_numpy(v)) == want
    assert evidence.evidence_digest(torch.from_numpy(v).to(torch.bfloat16)) == \
        jevidence.evidence_digest(torch.from_numpy(v).to(torch.bfloat16).float().numpy())


VIEWS = {
    "multi_krum": (lambda: T.MultiKrum(2, 4, device="cpu"), lambda: J.MultiKrum(f=2, q=4), False),
    "krum": (lambda: T.Krum(2, device="cpu"), lambda: J.Krum(f=2), False),
    "cge": (lambda: T.ComparativeGradientElimination(2, device="cpu"),
            lambda: J.ComparativeGradientElimination(f=2), False),
    "monna": (lambda: T.MoNNA(2, reference_index=1, device="cpu"),
              lambda: J.MoNNA(f=2, reference_index=1), False),
    "trimmed_mean": (lambda: T.CoordinateWiseTrimmedMean(2, device="cpu"),
                     lambda: J.CoordinateWiseTrimmedMean(f=2), False),
    "geometric_median": (lambda: T.GeometricMedian(device="cpu"), lambda: J.GeometricMedian(), True),
    "centered_clipping": (lambda: T.CenteredClipping(c_tau=2.0, device="cpu"),
                          lambda: J.CenteredClipping(c_tau=2.0), True),
    "median": (lambda: T.CoordinateWiseMedian(device="cpu"), lambda: J.CoordinateWiseMedian(), False),
}


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("name", sorted(VIEWS))
def test_round_evidence_views_match_the_reference(name, as_tensor):
    """Scores within tolerance and equal keep sets on a padded cohort, the
    matrix numpy or a tensor; the centre-seeking views need the aggregate
    (``None`` without it); an inadmissible cohort has no view."""
    ours_agg, ref_agg, needs_center = VIEWS[name][0](), VIEWS[name][1](), VIEWS[name][2]
    rows, valid, _, base = _cohort(16, 11, D, 4)
    center = (base * 0.8).astype(np.float32)
    matrix = torch.from_numpy(rows) if as_tensor else rows
    ours = ours_agg.round_evidence(matrix, valid, aggregate=center)
    ref = ref_agg.round_evidence(rows, valid, aggregate=center)
    assert ours_agg.evidence_selects == ref_agg.evidence_selects
    assert (ours is None) == (ref is None)
    if ref is None:
        return
    assert ours["kind"] == ref["kind"]
    np.testing.assert_allclose(ours["scores"], np.asarray(ref["scores"]), rtol=1e-5, atol=1e-5)
    assert (ours["keep"] is None) == (ref["keep"] is None)
    if ref["keep"] is not None:
        np.testing.assert_array_equal(ours["keep"], np.asarray(ref["keep"]))
    if needs_center:
        assert ours_agg.round_evidence(matrix, valid) is None
    small = np.zeros((16,), bool)
    small[:1] = True
    assert (ours_agg.round_evidence(matrix, small, aggregate=center) is None) == \
        (ref_agg.round_evidence(rows, small, aggregate=center) is None)
    merged = ours_agg.merged_score_view({"rows": torch.from_numpy(rows[:11])}, aggregate=center)
    np.testing.assert_allclose(merged["scores"], ours["scores"][:11], rtol=1e-6)


def test_trimmed_mean_view_samples_wide_rows_like_the_reference():
    rows, valid, _, _ = _cohort(8, 7, 70_001, 9)
    ours = T.CoordinateWiseTrimmedMean(2, device="cpu").round_evidence(torch.from_numpy(rows), valid)
    ref = J.CoordinateWiseTrimmedMean(f=2).round_evidence(rows, valid)
    np.testing.assert_array_equal(ours["scores"], np.asarray(ref["scores"]))


def _observe(plane, agg, rounds, seed, port):
    out = []
    for r in range(rounds):
        rows, valid, weights, base = _cohort(16, 12, D, seed + r)
        vec = agg.aggregate_masked(torch.from_numpy(rows) if port else rows, valid)
        clients = [f"c{i}" for i in range(12)]
        ev = plane.observe_round(r, torch.from_numpy(rows) if port else rows, valid, clients,
                                 vec, aggregator=agg, weights=weights,
                                 deltas=[int(w < 1) for w in weights[:12]], bucket=16)
        out.append(ev)
    return out


@pytest.mark.parametrize("name", ["multi_krum", "cge", "monna", "trimmed_mean"])
def test_trust_ledger_after_scripted_rounds_matches_the_reference(name):
    """Six rounds through ``ForensicsPlane.observe_round`` in both packages:
    each round's evidence record (selections, flags, trust) and the plane's
    snapshot afterwards are the reference's."""
    cfg = dict(detectors=dict(norm_z_threshold=3.0))
    ours = ForensicsPlane("t", ForensicsConfig(detectors=DetectorConfig(**cfg["detectors"])))
    ref = JForensicsPlane("t", JForensicsConfig(detectors=jevidence.DetectorConfig(**cfg["detectors"])))
    our_ev = _observe(ours, VIEWS[name][0](), 6, 30, True)
    ref_ev = _observe(ref, VIEWS[name][1](), 6, 30, False)
    for o, r in zip(our_ev, ref_ev):
        assert o.agg_digest == r.agg_digest or name != "trimmed_mean"
        assert o.excluded_clients == r.excluded_clients
        assert o.flagged_clients == r.flagged_clients
        for a, b in zip(o.records, r.records):
            assert (a.client, a.selected, tuple(a.flags)) == (b.client, b.selected, tuple(b.flags))
            assert a.trust == pytest.approx(b.trust, abs=1e-12)
            if b.score is not None:
                assert a.score == pytest.approx(b.score, rel=1e-5, abs=1e-5)
    snap, ref_snap = ours.snapshot(), ref.snapshot()
    assert snap["trust"]["bands"] == ref_snap["trust"]["bands"]
    assert snap["trust"]["quarantined"] == ref_snap["trust"]["quarantined"]
    assert snap["recent_flags"] == ref_snap["recent_flags"]
    for client in (f"c{i}" for i in range(12)):
        assert ours.ledger.score(client) == pytest.approx(ref.ledger.score(client), abs=1e-12)


def _wal_run(port: bool, directory: str):
    mod = serving if port else jserving
    agg = T.CoordinateWiseTrimmedMean(2, device="cpu") if port else J.CoordinateWiseTrimmedMean(f=2)
    fcfg = (ForensicsConfig(detectors=DetectorConfig(norm_z_threshold=3.0)) if port else
            JForensicsConfig(detectors=jevidence.DetectorConfig(norm_z_threshold=3.0)))
    fe = mod.ServingFrontend(
        [mod.TenantConfig("tm", agg, dim=D, cohort_cap=16, forensics=fcfg)],
        clock=lambda: 0.0,
        durability=mod.DurabilityConfig(directory=directory, snapshot_every=100),
    )
    for r in range(4):
        rows, valid, _, _ = _cohort(16, 12, D, 50 + r)
        for i in range(12):
            fe.submit("tm", f"c{i}", r, rows[i], seq=r)
        fe.close_round_nowait("tm")
    for t in fe._tenants.values():
        t.durability.close()
    return os.path.join(directory, "tm")


def test_audit_gives_the_reference_verdicts(tmp_path):
    """The port's frontend and the JAX frontend write a WAL each for one
    stream (trimmed mean: order-free, so the digests agree): the port's
    ``wal_timeline`` of its own WAL equals the reference's of its own, and
    the reference's audit reads the port's WAL to the same report."""
    ours = _wal_run(True, str(tmp_path / "port"))
    ref = _wal_run(False, str(tmp_path / "ref"))
    rep, ref_rep = audit.wal_timeline(ours), jaudit.wal_timeline(ref)
    cross = jaudit.wal_timeline(ours)
    for key in ("records", "torn_segments", "rounds", "exclusions_by_round", "clients",
                "transitions", "evidence_rounds", "digest_mismatches"):
        assert rep[key] == ref_rep[key] == cross[key], key
    assert rep["evidence_rounds"] == 4 and not rep["digest_mismatches"]
    assert audit.first_flag_rounds(rep) == jaudit.first_flag_rounds(ref_rep)
    text = audit.render_text(rep)
    assert text.replace(ours, "X") == jaudit.render_text(ref_rep).replace(ref, "X")
