"""The port's ragged serving door (``ops.ragged``, ``serving.ragged``,
``build_cohort(quantized=True)``, ``parallel.ps.build_ragged_serving_ps_step``)
and B12 (``kernels.segment_sum_dequant``) against the JAX package and
against the port's own masked aggregates, on the CPU.

Batches mix 1-4 cohorts of different sizes and magnitudes in a row
capacity with spare rows. Tolerances: bit for bit wherever the order of
every sum is the same (sorts, ranks, the row contractions, which are one
FMA chain over rows in index order on both sides at d a multiple of 8);
where the JAX package sums a row in another order (its Gram, its
``jnp.sum`` norms) the scores are held within rtol 1e-6 and the
aggregates bit for bit as long as the selections agree. The reference's
opt-in Pallas path (``BYZPY_TPU_RAGGED_PALLAS=1``) is ulp-level by its
own account and is held within rtol 2e-6, atol 1e-6, as the reference's
``test_pallas_segment_sum_opt_in_parity`` holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu import aggregators as J
from byzpy_tpu.engine.actor import wire as jwire
from byzpy_tpu.ops import pallas_kernels as jpk
from byzpy_tpu.ops import ragged as jragged
from byzpy_tpu.parallel import ps as jps
from byzpy_tpu.parallel import quantization as jq
from byzpy_tpu.serving import cohort as jcohort
from byzpy_tpu.serving import queue as jqueue
from byzpy_tpu.serving import ragged as jserving_ragged
from byzpy_tpu_torch import aggregators as T
from byzpy_tpu_torch.engine.actor import wire
from byzpy_tpu_torch.models import ModelBundle
from byzpy_tpu_torch.ops import codec_kernels as ck
from byzpy_tpu_torch.ops import kernels, ragged
from byzpy_tpu_torch.parallel import build_ragged_serving_ps_step, build_serving_ps_step, dequantize_rows
from byzpy_tpu_torch.serving import (
    RaggedExecutor,
    StalenessPolicy,
    Submission,
    build_cohort,
)

D = 96  # a multiple of 8: XLA:CPU's row einsum is one FMA chain there
WIRE = ("int8", "fp8", "fp8_e5m2", "s4")
BATCHES = {"one": [7], "two": [5, 8], "three": [3, 9, 6], "four": [8, 4, 7, 5]}

CLASSES = {
    "trimmed": (lambda: T.CoordinateWiseTrimmedMean(1, device="cpu"), lambda: J.CoordinateWiseTrimmedMean(f=1)),
    "median": (lambda: T.CoordinateWiseMedian(device="cpu"), lambda: J.CoordinateWiseMedian()),
    "multikrum": (lambda: T.MultiKrum(1, 2, device="cpu"), lambda: J.MultiKrum(f=1, q=2)),
    "krum": (lambda: T.Krum(1, device="cpu"), lambda: J.Krum(f=1)),
    "cge": (lambda: T.ComparativeGradientElimination(1, device="cpu"),
            lambda: J.ComparativeGradientElimination(f=1)),
    "meamed": (lambda: T.MeanOfMedians(1, device="cpu"), lambda: J.MeanOfMedians(f=1)),
    "monna": (lambda: T.MoNNA(1, device="cpu"), lambda: J.MoNNA(f=1)),
    "geomed": (lambda: T.GeometricMedian(device="cpu"), lambda: J.GeometricMedian()),
    "clip": (lambda: T.CenteredClipping(c_tau=10.0, device="cpu"), lambda: J.CenteredClipping(c_tau=10.0)),
}
EXECUTOR = ("trimmed", "median", "multikrum", "cge")


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _tbits(t):
    return _bits(t.detach().contiguous().numpy())


def _rows(m, seed, d=D, scale=1.0):
    """``m`` normal rows at per-row scales 0.1-50 (sums cancel and round)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, d)) * rng.uniform(0.1, 50.0, size=(m, 1)) * scale).astype(np.float32)


def _batch(sizes, spare=5, n_cohorts=None, seed=0, d=D):
    """The flat-rows layout of one batch: ``(flat, seg, offsets, lengths,
    cohort rows)`` as numpy; cohort ``c`` of ``sizes[c]`` rows, ``spare``
    capacity rows and, with ``n_cohorts``, padding cohorts of length 0."""
    C = n_cohorts or len(sizes)
    cap = sum(sizes) + spare
    flat = np.zeros((cap, d), np.float32)
    seg = np.full(cap, C, np.int32)
    offsets = np.full(C, sum(sizes), np.int32)
    lengths = np.zeros(C, np.int32)
    cohorts, off = [], 0
    for c, m in enumerate(sizes):
        rows = _rows(m, seed + c, d, scale=(0.3, 1.0, 20.0, 5.0)[c % 4])
        flat[off:off + m], seg[off:off + m] = rows, c
        offsets[c], lengths[c] = off, m
        cohorts.append(rows)
        off += m
    return flat, seg, offsets, lengths, cohorts


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# ---------------------------------------------------------------------------
# ops.ragged against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_segment_ids_positions_and_sort_match_jax_exactly(batch):
    flat, seg, offsets, lengths, _ = _batch(BATCHES[batch], n_cohorts=len(BATCHES[batch]) + 1)
    C = len(offsets)
    got = ragged.segment_ids(*_t(offsets, lengths), flat.shape[0], C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jragged.segment_ids(*_j(offsets, lengths),
                                                                              flat.shape[0], C)))
    np.testing.assert_array_equal(got.numpy(), seg)
    flat[0, 3], flat[1, 4], flat[2, 5] = -0.0, np.inf, -np.inf
    s = ragged.segmented_sort(*_t(flat, seg))
    np.testing.assert_array_equal(_tbits(s), _bits(jragged.segmented_sort(*_j(flat, seg))))
    pos = ragged._segment_positions(*_t(seg, offsets), C)
    want = jragged._segment_positions(*_j(seg, offsets), C)
    live = seg < C
    np.testing.assert_array_equal(pos.numpy()[live], np.asarray(want)[live])


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_ragged_trimmed_mean_and_median_match_jax(batch):
    """The segmented programs equal the JAX ones bit for bit (sorted values
    are exact; the window contraction is one FMA chain on both sides), a
    padding cohort included."""
    sizes = BATCHES[batch]
    flat, seg, offsets, lengths, _ = _batch(sizes, n_cohorts=len(sizes) + 1, seed=3)
    tm = ragged.ragged_trimmed_mean(*_t(flat, seg, offsets, lengths), f=1, n_cohorts=len(offsets))
    jtm = jragged.ragged_trimmed_mean(*_j(flat, seg, offsets, lengths), f=1, n_cohorts=len(offsets))
    np.testing.assert_array_equal(_tbits(tm[:len(sizes)]), _bits(jtm)[:len(sizes)])
    med = ragged.ragged_median(*_t(flat, seg, offsets, lengths), n_cohorts=len(offsets))
    jmed = jragged.ragged_median(*_j(flat, seg, offsets, lengths), n_cohorts=len(offsets))
    np.testing.assert_array_equal(_tbits(med[:len(sizes)]), _bits(jmed)[:len(sizes)])


@pytest.mark.parametrize("seed", range(4))
def test_ragged_segment_ranks_match_jax_exactly(seed):
    """Ranks within each cohort under (NaN last, score, index), with ties,
    -0.0 against +0.0 and NaN scores, capacity rows ranking R."""
    flat, seg, offsets, lengths, _ = _batch([6, 3, 7], spare=4, seed=seed)
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 4, size=flat.shape[0]).astype(np.float32)
    scores[rng.random(flat.shape[0]) < 0.2] = np.nan
    scores[rng.random(flat.shape[0]) < 0.2] = -0.0
    got = ragged.ragged_segment_ranks(*_t(scores, seg), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jragged.ragged_segment_ranks(*_j(scores, seg), 3)))


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_ragged_selection_families_match_jax(batch):
    """CGE and Multi-Krum: scores within rtol 1e-6 (the JAX package sums
    norms and its Gram in another order), keep sets equal, aggregates bit
    for bit; the selection mean on given scores bit for bit."""
    sizes = BATCHES[batch]
    flat, seg, offsets, lengths, _ = _batch(sizes, seed=5)
    C, live = len(sizes), seg < len(sizes)
    aggs, score, keep = ragged.ragged_cge(*_t(flat, seg, lengths), f=1, n_cohorts=C)
    jaggs, jscore, jkeep = jragged.ragged_cge(*_j(flat, seg, lengths), f=1, n_cohorts=C)
    np.testing.assert_allclose(score.numpy()[live], np.asarray(jscore)[live], rtol=1e-6)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(_tbits(aggs), _bits(jaggs))
    aggs, score, keep = ragged.ragged_multi_krum(*_t(flat, seg, lengths), f=1, q=2, n_cohorts=C)
    jaggs, jscore, jkeep = jragged.ragged_multi_krum(*_j(flat, seg, lengths), f=1, q=2, n_cohorts=C)
    np.testing.assert_allclose(score.numpy()[live], np.asarray(jscore)[live], rtol=1e-6)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(_tbits(aggs), _bits(jaggs))
    scores = np.random.default_rng(1).normal(size=flat.shape[0]).astype(np.float32)
    counts = np.maximum(lengths - 1, 1).astype(np.int32)
    means, keep = ragged.ragged_selection_mean(*_t(flat, seg, scores, counts), n_cohorts=C)
    jmeans, jkeep = jragged.ragged_selection_mean(*_j(flat, seg, scores, counts), n_cohorts=C,
                                                  any_bad=jnp.asarray(False))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(_tbits(means), _bits(jmeans))


@pytest.mark.parametrize("name", ["meamed", "monna", "clip"])
def test_ragged_via_masked_and_evidence_match_jax(name):
    """The generic door runs each class's masked program per cohort: equal
    to the JAX door within the masked family's tolerance
    (``tests/test_torch_masked.py``: rtol 1e-5, atol 1e-6 for the
    iterative ones, bit for bit for MeaMed and MoNNA's selection);
    ``ragged_evidence`` within rtol 1e-5, capacity rows 0."""
    flat, seg, offsets, lengths, _ = _batch([5, 8, 6], seed=7)
    agg, jagg = CLASSES[name][0](), CLASSES[name][1]()
    got = ragged.ragged_via_masked(agg._aggregate_matrix_masked, *_t(flat, seg), n_cohorts=3)
    want = jragged.ragged_via_masked(jagg._aggregate_matrix_masked, *_j(flat, seg), n_cohorts=3)
    if name == "clip":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(_tbits(got), _bits(want))
    norm, cos = ragged.ragged_evidence(*_t(flat, seg), got, n_cohorts=3)
    jnorm, jcos = jragged.ragged_evidence(*_j(flat, seg), want, n_cohorts=3)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), rtol=1e-5)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-5, atol=1e-6)
    assert not norm[seg == 3].any() and not cos[seg == 3].any()


# ---------------------------------------------------------------------------
# wire rows: the batch decode and B12
# ---------------------------------------------------------------------------


def _wire_rows(x, mode, block):
    """Wire-layout codes and scales of the rows ``x`` from the JAX codec:
    int8 codes, fp8 bit patterns as uint8, packed s4 nibbles."""
    enc = jq.encode_blockwise(jnp.asarray(x), jq.CommPrecision(mode, block=block))
    codes = np.asarray(enc.values)
    if mode in ("fp8", "fp8_e5m2"):
        codes = codes.view(np.uint8)
    return np.ascontiguousarray(codes), np.asarray(enc.scales)


@pytest.mark.parametrize("block", [32, 100])
@pytest.mark.parametrize("mode", WIRE)
def test_batch_decode_matches_jax_flat_dequantize_and_the_wire_codec(mode, block):
    """``dequantize_rows``, the quantized door's first operation, equals the
    JAX ``flat_dequantize`` and the host wire codec ``decode_rows_np`` bit
    for bit, capacity rows (zero codes and scales) included: +0.0 for int8
    / fp8, -0.0 for s4."""
    x = _rows(10, 2, d=200)
    codes, scales = _wire_rows(x, mode, block)
    codes = np.concatenate([codes, np.zeros((3, codes.shape[1]), codes.dtype)])
    scales = np.concatenate([scales, np.zeros((3, scales.shape[1]), np.float32)])
    got = dequantize_rows(*_t(codes, scales), mode=mode, block=block, d=200)
    np.testing.assert_array_equal(_tbits(got), _bits(jragged.flat_dequantize(
        *_j(codes, scales), mode=mode, block=block, d=200)))
    np.testing.assert_array_equal(_tbits(got), _bits(jwire.decode_rows_np(
        codes, scales, mode=mode, block=block, d=200)))
    assert bool(torch.signbit(got[-1]).all()) == (mode == "s4") and not got[-1].any()


@pytest.mark.parametrize("C", [1, 3, 5, 9, 17])
@pytest.mark.parametrize("R,d,block", [(12, 1024, 256), (40, 512, 128), (128, 264, 8)])
@pytest.mark.parametrize("mode", WIRE)
def test_b12_plain_matches_the_pallas_kernel_in_interpret_mode(mode, R, d, block, C):
    """The plain B12 (``row_weights=None``) equals
    ``ragged_segment_sum_dequant_pallas`` in interpret mode bit for bit at
    R <= 128 (one row tile: one FMA chain over the rows), with weights 1.0
    and 0.5 as the ragged programs hand it and a block past ``d``."""
    x = _rows(R, R + d, d=d)
    codes, scales = _wire_rows(x, mode, block)
    rng = np.random.default_rng(C)
    w = np.where(rng.random((C, R)) < 0.5, 1.0, 0.5).astype(np.float32)
    got = kernels.segment_sum_dequant(*_t(codes, scales, w), mode=mode, block=block, d=d)
    want = jpk.ragged_segment_sum_dequant_pallas(*_j(codes, scales, w), mode=mode, block=block, d=d,
                                                 interpret=True)
    np.testing.assert_array_equal(_tbits(got), _bits(want))


@pytest.mark.parametrize("mode", WIRE)
def test_b12_is_b11_over_the_decoded_and_discounted_rows(mode):
    """With ``row_weights`` the rows are ``(code * scale) * omega`` before
    the chain, so B12 equals B11 over ``decode(codes) * omega`` bit for
    bit; a fill (an int or an int32 tensor) skips the rows past it, and
    nothing is counted on the CPU."""
    before = dict(kernels.launch_counts)
    x = _rows(24, 9, d=200)
    codes, scales = _wire_rows(x, mode, 64)
    tc, ts = _t(codes, scales)
    w = torch.randn((4, 24), generator=torch.Generator().manual_seed(0))
    omega = torch.where(torch.arange(24) % 4 == 1, 0.5, 1.0)
    rows = ck.decode_wire_rows_plain(tc, ts, mode=mode, block=64, d=200)
    got = kernels.segment_sum_dequant(tc, ts, w, mode=mode, block=64, d=200, row_weights=omega)
    assert torch.equal(got, kernels.segment_sum(rows * omega[:, None], w))
    wz = w.clone()
    wz[:, 17:] = 0
    want = kernels.segment_sum(rows, wz)
    for fill in (17, torch.tensor([17], dtype=torch.int32)):
        assert torch.equal(kernels.segment_sum_dequant(tc, ts, w, mode=mode, block=64, d=200,
                                                       fill=fill), want)
    assert kernels.launch_counts == before
    with pytest.raises(ValueError, match="do not cover"):
        kernels.segment_sum_dequant(tc, ts, w, mode=mode, block=64, d=201 if mode != "s4" else 257)
    with pytest.raises(ValueError, match="w must be"):
        kernels.segment_sum_dequant(tc, ts, w[:, :5], mode=mode, block=64, d=200)
    with pytest.raises(ValueError, match="no wire row codec"):
        kernels.segment_sum_dequant(tc, ts, w, mode="bf16", block=64, d=200)


# ---------------------------------------------------------------------------
# classes: ragged members, and every cohort against its own aggregates
# ---------------------------------------------------------------------------


def test_ragged_members_match_the_reference():
    for name, (make, jmake) in CLASSES.items():
        agg, jagg = make(), jmake()
        assert agg.supports_ragged and agg.ragged_score_kind == jagg.ragged_score_kind, name
        assert agg.ragged_coalesce == jagg.ragged_coalesce, name
        assert agg.ragged_group_key() == make().ragged_group_key(), name
    assert T.MultiKrum(1, 2, device="cpu").ragged_group_key() != T.MultiKrum(1, 3, device="cpu").ragged_group_key()
    assert T.MultiKrum(1, 2, device="cpu").ragged_group_key() != T.Krum(1, device="cpu").ragged_group_key()
    assert T.CAF(1, device="cpu").ragged_matrix_fn() is None and not T.CAF(1, device="cpu").supports_ragged


@pytest.mark.parametrize("batch", ["two", "four"])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_every_cohort_equals_its_masked_and_exact_aggregate(name, batch):
    """Each cohort's ragged aggregate equals, bit for bit, the class's
    masked aggregate of that cohort padded into a bucket of 16, and its
    exact aggregate of the compacted rows within the rounding of a sum in
    another order (the barrier kernels'), ``m * 2**-22`` of the cohort's
    largest value; one dispatch for the batch."""
    agg = CLASSES[name][0]()
    sizes = BATCHES[batch]
    ex = RaggedExecutor(agg, D, row_capacity=sum(sizes) + 5, max_cohorts=len(sizes) + 1,
                        with_evidence=False)
    cohorts = [build_cohort([Submission(f"c{i}", 0, torch.from_numpy(r), float(i))
                             for i, r in enumerate(rows)], 0, None, StalenessPolicy(), device="cpu")
               for rows in _batch(sizes, seed=11)[4]]
    views = ex.aggregate(cohorts, [f"t{c}" for c in range(len(sizes))])
    assert ex.dispatches == 1 and ex.cohorts_dispatched == len(sizes) and ex.max_batch == len(sizes)
    for view, cohort in zip(views, cohorts):
        m = cohort.m
        padded = torch.zeros((16, D))
        padded[:m] = cohort.matrix
        masked = agg.aggregate_masked(padded, np.arange(16) < m)
        np.testing.assert_array_equal(_tbits(view.vector), _tbits(masked), err_msg=name)
        exact = agg.aggregate([cohort.matrix[i] for i in range(m)])
        atol = m * 2.0 ** -22 * float(cohort.matrix.abs().max())
        np.testing.assert_allclose(view.vector.numpy(), exact.numpy(), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the executor against the JAX executor, dense and quantized
# ---------------------------------------------------------------------------


def _wire_submissions(rows, mode, block, rounds, make_wire, make_sub, to_array):
    codes, scales = _wire_rows(rows, mode, block)
    return [make_sub(client=f"c{i}", round_submitted=rounds[i], arrived_s=float(i),
                     gradient=make_wire(mode=mode, codes=to_array(codes[i].copy()),
                                        scales=to_array(scales[i].copy()), block=block,
                                        shape=(rows.shape[1],), dtype="float32"))
            for i in range(len(rows))]


def _cohorts(mode, sizes, seed=13, block=32, d=D):
    """Port and JAX cohorts of one batch (exact size, the ragged layout),
    every fourth client one round stale (gamma 0.5), wire rows for a coded
    ``mode``, dense rows for ``"dense"``."""
    pol, jpol = StalenessPolicy("exponential", gamma=0.5), jcohort.StalenessPolicy("exponential", gamma=0.5)
    ours, ref = [], []
    for rows in _batch(sizes, seed=seed, d=d)[4]:
        rounds = [4 if i % 4 == 1 else 5 for i in range(len(rows))]
        if mode == "dense":
            subs = [Submission(f"c{i}", rounds[i], torch.from_numpy(r), float(i)) for i, r in enumerate(rows)]
            jsubs = [jqueue.Submission(f"c{i}", rounds[i], r, float(i)) for i, r in enumerate(rows)]
        else:
            subs = _wire_submissions(rows, mode, block, rounds, wire.QuantizedWireArray, Submission,
                                     torch.from_numpy)
            jsubs = _wire_submissions(rows, mode, block, rounds, jwire.QuantizedWireArray,
                                      jqueue.Submission, lambda a: a)
        ours.append(build_cohort(subs, 5, None, pol, quantized=True, device="cpu"))
        ref.append(jcohort.build_cohort(jsubs, 5, None, jpol, quantized=True))
    return ours, ref


@pytest.mark.parametrize("pallas", ["unset", "1"])
@pytest.mark.parametrize("mode", ["dense", *WIRE])
@pytest.mark.parametrize("name", EXECUTOR)
def test_executor_matches_jax_executor(name, mode, pallas, monkeypatch):
    """One dispatch of three cohorts (5, 8, 6 rows; every fourth row stale)
    through the port's executor and the JAX executor, dense or from wire
    rows: every cohort's vector bit for bit with the reference's
    authoritative program (env unset), within rtol 2e-6, atol 1e-6 of its
    opt-in Pallas one (``BYZPY_TPU_RAGGED_PALLAS=1``, which folds the
    discount into the weights); the selection families' keep sets equal;
    a quantized batch counted as one."""
    if pallas == "1":
        monkeypatch.setenv("BYZPY_TPU_RAGGED_PALLAS", "1")
    else:
        monkeypatch.delenv("BYZPY_TPU_RAGGED_PALLAS", raising=False)
    ours, ref = _cohorts(mode, [5, 8, 6])
    assert all(c.quantized == (mode != "dense") for c in ours + ref)
    ex = RaggedExecutor(CLASSES[name][0](), D, row_capacity=24, max_cohorts=4)
    jex = jserving_ragged.RaggedExecutor(CLASSES[name][1](), D, row_capacity=24, max_cohorts=4)
    views = ex.aggregate(ours, ["a", "b", "c"])
    jviews = jex.aggregate(ref, ["a", "b", "c"])
    assert ex.quantized_dispatches == jex.quantized_dispatches == (mode != "dense")
    assert ex.expected_compiles() == jex.expected_compiles()
    for v, jv in zip(views, jviews):
        if pallas == "1":
            np.testing.assert_allclose(v.vector.numpy(), jv.vector, rtol=2e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(_tbits(v.vector), _bits(jv.vector))
        assert (v.keep is None) == (jv.keep is None) and v.score_kind == jv.score_kind
        if v.keep is not None:
            np.testing.assert_array_equal(v.keep.numpy(), jv.keep)
            np.testing.assert_allclose(v.scores.numpy(), jv.scores, rtol=1e-6)
        np.testing.assert_allclose(v.norms.numpy(), jv.norms, rtol=1e-5)
        np.testing.assert_allclose(v.cos.numpy(), jv.cos, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", WIRE)
@pytest.mark.parametrize("name", EXECUTOR)
def test_quantized_dispatch_is_the_dense_program_on_the_decoded_rows(name, mode, monkeypatch):
    """A quantized batch gives the dense program's bits on the decoded
    rows and ``CohortAggregator``'s on each cohort, stale rows included;
    the contraction over the scaled rows (CGE and Multi-Krum) reads the
    codes through B12 with the discounts as its row weights, every other
    contraction is B11."""
    from byzpy_tpu_torch.serving import CohortAggregator

    calls = []
    real = kernels.segment_sum_dequant
    monkeypatch.setattr(kernels, "segment_sum_dequant",
                        lambda *a, **k: calls.append(k["row_weights"]) or real(*a, **k))
    ours, _ = _cohorts(mode, [5, 8, 6], seed=17)
    agg = CLASSES[name][0]()
    q_views = RaggedExecutor(agg, D, row_capacity=24, max_cohorts=4).aggregate(ours, ["a", "b", "c"])
    assert len(calls) == (name in ("cge", "multikrum"))
    if calls:
        assert bool((calls[0][:19] != 1.0).any())
    dense = [build_cohort([Submission(f"c{i}", 5, c.matrix[i], float(i)) for i in range(c.m)], 5, None,
                          StalenessPolicy(), device="cpu") for c in ours]
    for c, dc in zip(ours, dense):
        object.__setattr__(dc, "weights", c.weights)
    d_views = RaggedExecutor(agg, D, row_capacity=24, max_cohorts=4).aggregate(dense, ["a", "b", "c"])
    for q, dv, c in zip(q_views, d_views, ours):
        assert torch.equal(q.vector, dv.vector)
        assert torch.equal(q.vector, CohortAggregator(agg).aggregate(c))


def test_executor_rejects_oversized_batches_and_programless_classes():
    ours, _ = _cohorts("dense", [5, 8, 6])
    ex = RaggedExecutor(T.CoordinateWiseMedian(device="cpu"), D, row_capacity=12, max_cohorts=2)
    with pytest.raises(ValueError, match="max_cohorts"):
        ex.aggregate(ours, ["a", "b", "c"])
    with pytest.raises(ValueError, match="row capacity"):
        ex.aggregate(ours[1:], ["b", "c"])
    with pytest.raises(ValueError, match="no ragged program"):
        RaggedExecutor(T.CAF(1, device="cpu"), D, row_capacity=16, max_cohorts=2)


def test_mixed_wire_specs_take_the_dense_program(monkeypatch):
    """A batch whose cohorts carry different wire specs is decoded and
    takes the dense program, bit for bit its quantized twins."""
    int8, _ = _cohorts("int8", [5, 8])
    s4, _ = _cohorts("s4", [6])
    agg = T.MultiKrum(1, 2, device="cpu")
    ex = RaggedExecutor(agg, D, row_capacity=24, max_cohorts=4)
    views = ex.aggregate(int8 + s4, ["a", "b", "c"])
    assert ex.quantized_dispatches == 0 and ex.expected_compiles() == 1
    for view, c in zip(views, int8 + s4):
        (alone,) = RaggedExecutor(agg, D, row_capacity=24, max_cohorts=4).aggregate([c], ["x"])
        assert torch.equal(view.vector, alone.vector)


@pytest.mark.parametrize("mode", ["dense", "int8", "s4"])
def test_executor_rejects_a_cohort_of_another_dimension(mode):
    """A cohort whose rows are not the executor's dimension raises, dense
    or still coded. At d = 90 an s4 cohort packs into the width of d = 96
    (three blocks of 32), which would otherwise decode at d = 96."""
    narrow, _ = _cohorts(mode, [5, 8], d=D - 6)
    wide, _ = _cohorts(mode, [6], seed=3)
    if mode == "s4":
        assert narrow[0].qcodes.shape == wide[0].qcodes[:5].shape
    ex = RaggedExecutor(T.MultiKrum(1, 2, device="cpu"), D, row_capacity=24, max_cohorts=4)
    with pytest.raises(ValueError, match=f"dimension {D - 6} in an executor of dimension {D}"):
        ex.aggregate(narrow, ["a", "b"])
    with pytest.raises(ValueError, match="dimension"):
        ex.aggregate(wide + narrow[:1], ["a", "b"])
    assert ex.dispatches == 0
    assert len(ex.aggregate(wide, ["a"])) == 1


# ---------------------------------------------------------------------------
# quantized cohorts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", WIRE)
def test_quantized_cohort_matches_jax(mode):
    """Codes, scales, spec, weights and the lazily decoded matrix (padding
    rows +0.0) equal the reference's quantized cohort; ``finite`` agrees."""
    ours, ref = _cohorts(mode, [7])
    c, jc = ours[0], ref[0]
    assert c.quantized and jc.quantized and (c.qmode, c.qblock, c.qdim) == (jc.qmode, jc.qblock, jc.qdim)
    np.testing.assert_array_equal(_tbits(c.qcodes), _bits(jc.qcodes))
    np.testing.assert_array_equal(_tbits(c.qscales), _bits(jc.qscales))
    np.testing.assert_array_equal(c.weights, jc.weights)
    assert c.finite() == jc.finite() is True
    np.testing.assert_array_equal(_tbits(c.matrix), _bits(jc.matrix))
    assert not c.quantized or c.dense is not None


def test_quantized_cohort_mixed_specs_fall_back_to_dense_and_finite_sees_hostile_codes():
    """Mixed wire specs (or a dense row) fall back to the dense layout,
    decoded as the reference decodes; ``finite`` reports a hostile fp8 NaN
    pattern and an inf scale without decoding, as the reference's does."""
    rows = _rows(4, 3)
    c8 = _wire_submissions(rows[:2], "int8", 32, [0, 0], wire.QuantizedWireArray, Submission, torch.from_numpy)
    c4 = _wire_submissions(rows[2:], "s4", 32, [0, 0], wire.QuantizedWireArray, Submission, torch.from_numpy)
    j8 = _wire_submissions(rows[:2], "int8", 32, [0, 0], jwire.QuantizedWireArray, jqueue.Submission, np.asarray)
    j4 = _wire_submissions(rows[2:], "s4", 32, [0, 0], jwire.QuantizedWireArray, jqueue.Submission, np.asarray)
    mixed = build_cohort(c8 + c4, 0, None, StalenessPolicy(), quantized=True, device="cpu")
    jmixed = jcohort.build_cohort(j8 + j4, 0, None, jcohort.StalenessPolicy(), quantized=True)
    assert not mixed.quantized and not jmixed.quantized
    np.testing.assert_array_equal(_tbits(mixed.matrix), _bits(jmixed.matrix))
    dense_row = [Submission("d", 0, torch.from_numpy(rows[0]), 0.0)]
    assert not build_cohort(c8 + dense_row, 0, None, StalenessPolicy(), quantized=True, device="cpu").quantized
    hostile = _wire_submissions(rows[:2], "fp8", 32, [0, 0], wire.QuantizedWireArray, Submission,
                                torch.from_numpy)
    jhostile = _wire_submissions(rows[:2], "fp8", 32, [0, 0], jwire.QuantizedWireArray, jqueue.Submission,
                                 np.asarray)
    hostile[1].gradient.codes[3] = 0x7F  # e4m3fn NaN
    jhostile[1].gradient.codes[3] = 0x7F
    c = build_cohort(hostile, 0, None, StalenessPolicy(), quantized=True, device="cpu")
    jc = jcohort.build_cohort(jhostile, 0, None, jcohort.StalenessPolicy(), quantized=True)
    assert c.finite() is jc.finite() is False and c.dense is None
    s4 = build_cohort(c4, 0, None, StalenessPolicy(), quantized=True, device="cpu")
    s4.qscales[1, 0] = float("inf")
    assert s4.finite() is False
    np.testing.assert_array_equal(
        wire.rows_code_absmax(s4.qcodes, mode="s4", block=32, nb=3).numpy(),
        jwire.rows_code_absmax(s4.qcodes.numpy(), mode="s4", block=32, nb=3))


# ---------------------------------------------------------------------------
# the ragged serving step
# ---------------------------------------------------------------------------


def _linear_bundles(seed=0):
    """A single-leaf linear model in both packages (d = 12 x 8 = 96)."""
    from byzpy_tpu.models.bundle import ModelBundle as JBundle

    w = (np.random.default_rng(seed).normal(size=(12, 8)) * 0.1).astype(np.float32)
    ours = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)},
                       loss_fn=lambda p, x, y: torch.mean((x @ p["w"] - y) ** 2))
    ref = JBundle(apply_fn=lambda p, x: x @ p["w"], params={"w": jnp.asarray(w)},
                  loss_fn=lambda p, x, y: jnp.mean((x @ p["w"] - y) ** 2))
    return ours, ref


@pytest.mark.parametrize("name", ["trimmed", "median", "multikrum", "cge", "meamed"])
def test_ragged_serving_step_matches_the_bucketed_step_and_jax(name):
    """Four steps over cohorts of 5, 3, 9 and 16 rows in a capacity of 16,
    one row in four stale: the parameters, momentum and metrics equal the
    port's bucketed step on the same cohort in its bucket bit for bit, and
    the JAX ragged step's within one ulp of the largest parameter a step
    (jit fuses the momentum update into an FMA, as
    ``test_serving_step_matches_jax_on_the_linear_bundle`` allows)."""
    ours_b, ref_b = _linear_bundles()
    agg, jagg = CLASSES[name][0](), CLASSES[name][1]()
    step, opt = build_ragged_serving_ps_step(ours_b, agg.ragged_matrix_fn(), row_capacity=16)
    bstep, bopt = build_serving_ps_step(ours_b, agg.masked_matrix_fn())
    jstep, jopt = jps.jit_ragged_serving_ps_step(ref_b, jagg.ragged_matrix_fn(), row_capacity=16)
    params = bparams = ours_b.params
    jparams = ref_b.params
    for s, (m, bucket) in enumerate(((5, 8), (3, 8), (9, 16), (16, 16))):
        rows = _rows(m, 40 + s)
        flat = np.zeros((16, D), np.float32)
        flat[:m] = rows
        w = np.zeros(16, np.float32)
        w[:m] = np.where(np.arange(m) % 4 == 1, 0.5, 1.0)
        offsets, lengths = np.zeros(1, np.int32), np.asarray([m], np.int32)
        params, opt, metrics = step(params, opt, *_t(flat, offsets, lengths, w))
        bparams, bopt, bmetrics = bstep(bparams, bopt, *_t(flat[:bucket], np.arange(bucket) < m, w[:bucket]))
        assert torch.equal(params["w"], bparams["w"]) and torch.equal(opt["trace"], bopt["trace"])
        assert torch.equal(metrics["agg_grad_norm"], bmetrics["agg_grad_norm"])
        assert int(metrics["cohort_m"]) == m
        jparams, jopt, _ = jstep(jparams, jopt, *_j(flat, offsets, lengths, w))
        want = np.asarray(jparams["w"])
        np.testing.assert_allclose(params["w"].numpy(), want, rtol=0,
                                   atol=(s + 1) * float(np.spacing(np.abs(want).max())))


def test_ragged_serving_step_rejects_what_is_not_ported():
    ours_b, _ = _linear_bundles()
    fn = T.CoordinateWiseMedian(device="cpu").ragged_matrix_fn()
    with pytest.raises(TypeError, match="init"):
        build_ragged_serving_ps_step(ours_b, fn, row_capacity=8, optimizer=object())
    with pytest.raises(NotImplementedError):
        build_ragged_serving_ps_step(ours_b, fn, row_capacity=8, mesh=object())


@pytest.mark.parametrize("batch", ["one", "three", "four"])
def test_segmented_programs_equal_the_classes_masked_door(batch):
    """The sort family takes the generic masked door on the CPU and the
    segmented programs (``ragged_trimmed_mean``, ``ragged_median``: one
    segmented sort-reduce of the whole batch) on the card; both give the
    same bits on finite rows."""
    sizes = BATCHES[batch]
    flat, seg, offsets, lengths, _ = _batch(sizes, seed=21)
    args = _t(flat, seg, offsets, lengths)
    C = len(sizes)
    tm = T.CoordinateWiseTrimmedMean(1, device="cpu").ragged_matrix_fn()(*args, n_cohorts=C)[0]
    assert torch.equal(ragged.ragged_trimmed_mean(*args, f=1, n_cohorts=C), tm)
    med = T.CoordinateWiseMedian(device="cpu").ragged_matrix_fn()(*args, n_cohorts=C)[0]
    assert torch.equal(ragged.ragged_median(*args, n_cohorts=C), med)
