"""The port's masked aggregators (``byzpy_tpu_torch.ops.robust``'s masked
section) and the classes' masked finalize against the JAX package, on the
CPU.

Inputs are made with numpy from a seed and handed to both packages. A
cohort of ``m`` rows padded into a bucket of ``n`` must give, in the port,
the bits of the compacted cohort (the serving tier's contract), and the
JAX masked function's result: bit for bit where the reference's value is
the port's order (sorts, selections, XLA:CPU's row einsum on the columns
it vectorizes), within a stated tolerance where it is not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu import aggregators as J
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu_torch import aggregators as T
from byzpy_tpu_torch.ops import kernels
from byzpy_tpu_torch.ops import robust

N = 16
# A multiple of 8: XLA:CPU's row einsum is the port's FMA chain on every
# column it vectorizes, 8 wide; D_TAIL leaves a tail of 1 column, which
# XLA sums in a loop of its own (within 2 ulp of the chain).
D, D_TAIL = 200, 193


def _grads(n=N, d=D, seed=0):
    """Normal rows at scales 0.1-50: well separated, so no two selection
    scores tie within an ulp."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * rng.uniform(0.1, 50.0, size=(n, 1))).astype(np.float32)


def _padded(x, m, bucket):
    out = np.zeros((bucket, x.shape[1]), np.float32)
    out[:m] = x[:m]
    valid = np.zeros(bucket, bool)
    valid[:m] = True
    return out, valid


def _ord(a) -> np.ndarray:
    """Monotone integer image of f32 values (adjacent floats differ by 1)."""
    b = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)


def _assert_close(out, ref, kind, rows=None):
    """``exact``: bit for bit. ``chain``: bit for bit on the columns XLA:CPU
    vectorizes, within 2 ulp on the last d mod 8. ``ulp4``: within 4 ulp.
    ``sum``: within the recursive-summation bound n u max|x| (u = 2^-24,
    ``rows`` the (n, d) input), for two sums of the same rows that round
    differently (an FMA chain against a multiply-then-add sweep, which can
    cancel to a value whose own ulp is small). ``tol``: the iterative
    aggregators, within rtol 1e-5 and 4e-4 absolute (2e-6 of the rows'
    largest entry, 200: their distances sum in another order, and the
    Weiszfeld / clipping steps carry it on)."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    if kind == "exact":
        np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    elif kind == "chain":
        cut = out.shape[-1] - out.shape[-1] % 8
        np.testing.assert_array_equal(out[:cut].view(np.uint32), ref[:cut].view(np.uint32))
        assert (np.abs(_ord(out[cut:]) - _ord(ref[cut:])) <= 2).all()
    elif kind == "ulp4":
        assert (np.abs(_ord(out) - _ord(ref)) <= 4).all()
    elif kind == "sum":
        bound = rows.shape[0] * 2.0 ** -24 * float(np.abs(rows).max())
        np.testing.assert_allclose(out, ref, rtol=0, atol=bound)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6 * 200.0)


# name -> (port function, JAX function, comparison on a d = D input, least
# admissible m)
FUNCTIONS = {
    "mean": (robust.masked_mean, jrobust.masked_mean, "chain", 1),
    "median": (robust.masked_coordinate_median, jrobust.masked_coordinate_median, "exact", 1),
    "trimmed": (lambda x, v: robust.masked_trimmed_mean(x, v, f=1),
                lambda x, v: jrobust.masked_trimmed_mean(x, v, f=1), "chain", 3),
    "meamed": (lambda x, v: robust.masked_mean_of_medians(x, v, f=2),
               lambda x, v: jrobust.masked_mean_of_medians(x, v, f=2), "chain", 3),
    "multikrum": (lambda x, v: robust.masked_multi_krum(x, v, f=1, q=2),
                  lambda x, v: jrobust.masked_multi_krum(x, v, f=1, q=2), "ulp4", 3),
    "cge": (lambda x, v: robust.masked_cge(x, v, f=1),
            lambda x, v: jrobust.masked_cge(x, v, f=1), "ulp4", 2),
    "monna": (lambda x, v: robust.masked_monna(x, v, f=1),
              lambda x, v: jrobust.masked_monna(x, v, f=1), "ulp4", 3),
    "geomed": (robust.masked_geometric_median, jrobust.masked_geometric_median, "tol", 1),
    "clip": (lambda x, v: robust.masked_centered_clipping(x, v, c_tau=1.0),
             lambda x, v: jrobust.masked_centered_clipping(x, v, c_tau=1.0), "tol", 1),
}


@pytest.mark.parametrize("d", [D, D_TAIL])
@pytest.mark.parametrize("m", [1, N // 2, N - 1, N])
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_masked_function_matches_jax(name, m, d):
    """Each masked function at m in {1, n/2, n - 1, n} of a bucket of 16
    against its JAX counterpart (jitted, as the serving step runs it), and
    the port's padded result against its own compacted one, bit for bit."""
    ours, ref_fn, kind, least = FUNCTIONS[name]
    if m < least:
        pytest.skip(f"m={m} is not admissible for {name}")
    x, valid = _padded(_grads(d=d, seed=m), m, N)
    out = ours(torch.from_numpy(x), torch.from_numpy(valid))
    ref = np.asarray(jax.jit(ref_fn)(jnp.asarray(x), jnp.asarray(valid)))
    if kind == "chain" and d % 8 == 0:
        kind = "exact"
    _assert_close(out.numpy(), ref, kind)
    compact = ours(torch.from_numpy(x[:m].copy()), torch.ones(m, dtype=torch.bool))
    assert torch.equal(out.view(torch.int32), compact.view(torch.int32))


@pytest.mark.parametrize("n", [1, 8, 13])
def test_masked_mean_of_all_valid_rows_is_the_row_mean_einsum(n):
    """All rows valid: ``masked_mean`` is the padding-stable mean
    ``_row_mean_einsum`` (a row chain times the rounded reciprocal of n)
    bit for bit, and that mean is the reference's within 2 ulp."""
    x = _grads(n=n, seed=n)
    out = robust.masked_mean(torch.from_numpy(x), torch.ones(n, dtype=torch.bool))
    mean = robust._row_mean_einsum(torch.from_numpy(x))
    assert torch.equal(out.view(torch.int32), mean.view(torch.int32))
    ref = np.asarray(jax.jit(jrobust._row_mean_einsum)(jnp.asarray(x)))
    assert (np.abs(_ord(mean.numpy()) - _ord(ref)) <= 2).all()


def test_masked_median_keeps_nan_columns():
    """The masked median alone keeps the column-wide NaN of the unpadded
    median: a NaN in a valid row makes its column NaN, a NaN-free padding
    row changes nothing."""
    x, valid = _padded(_grads(seed=3), 11, N)
    x[2, 7] = np.nan
    x[4, 9] = np.inf
    out = robust.masked_coordinate_median(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    ref = np.asarray(jrobust.masked_coordinate_median(jnp.asarray(x), jnp.asarray(valid)))
    _assert_close(out, ref, "exact")
    assert np.isnan(out[7]) and np.isnan(out).sum() == 1


@pytest.mark.parametrize("seed", range(6))
def test_masked_nan_last_ranks_match_jax_exactly(seed):
    """Ranks over valid competitors only, under (NaN last, score, index),
    -0.0 tying +0.0: exact against the reference on tie-heavy scores with
    NaN and +-inf; invalid rows rank n."""
    rng = np.random.default_rng(seed)
    n = 16
    scores = rng.integers(-3, 4, size=n).astype(np.float32)
    scores[rng.random(n) < 0.15] = np.nan
    scores[rng.random(n) < 0.1] = np.inf
    scores[scores == 0] = np.where(rng.random(int((scores == 0).sum())) < 0.5, -0.0, 0.0)
    valid = rng.random(n) < 0.7
    valid[0] = True
    ours = robust._masked_nan_last_ranks(torch.from_numpy(scores), torch.from_numpy(valid))
    ref = jrobust._masked_nan_last_ranks(jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("m", [4, 9, 16])
def test_masked_krum_scores_from_gram_match_jax(m):
    """Krum scores from one padded Gram: the same window of the same sorted
    rows; the reference's window sum ``einsum("nk,k->n")`` is XLA's
    matrix-vector product, the port's a row chain over the sorted
    positions, so they agree within 4 ulp; invalid rows score +inf in
    both."""
    x, valid = _padded(_grads(seed=m), m, N)
    g = (x.astype(np.float64) @ x.T.astype(np.float64)).astype(np.float32)
    ours = robust.masked_krum_scores_from_gram(torch.from_numpy(g), torch.from_numpy(valid), f=1)
    ref = jrobust.masked_krum_scores_from_gram(jnp.asarray(g), jnp.asarray(valid), f=1)
    _assert_close(ours.numpy(), np.asarray(ref), "ulp4")
    assert np.isinf(ours.numpy()[m:]).all()


# name -> (port class factory, JAX class factory): the masked classes, and
# CAF, whose fallback is the exact subset path
CLASSES = {
    "median": (lambda: T.CoordinateWiseMedian(device="cpu"), lambda: J.CoordinateWiseMedian()),
    "trimmed-f0": (lambda: T.CoordinateWiseTrimmedMean(0, device="cpu"),
                   lambda: J.CoordinateWiseTrimmedMean(f=0)),
    "trimmed-f1": (lambda: T.CoordinateWiseTrimmedMean(1, device="cpu"),
                   lambda: J.CoordinateWiseTrimmedMean(f=1)),
    "meamed-f0": (lambda: T.MeanOfMedians(0, device="cpu"), lambda: J.MeanOfMedians(f=0)),
    "meamed-f2": (lambda: T.MeanOfMedians(2, device="cpu"), lambda: J.MeanOfMedians(f=2)),
    "multikrum": (lambda: T.MultiKrum(1, 2, device="cpu"), lambda: J.MultiKrum(f=1, q=2)),
    "krum": (lambda: T.Krum(1, device="cpu"), lambda: J.Krum(f=1)),
    "cge-f0": (lambda: T.ComparativeGradientElimination(0, device="cpu"),
               lambda: J.ComparativeGradientElimination(f=0)),
    "cge-f1": (lambda: T.ComparativeGradientElimination(1, device="cpu"),
               lambda: J.ComparativeGradientElimination(f=1)),
    "monna": (lambda: T.MoNNA(1, device="cpu"), lambda: J.MoNNA(f=1)),
    "geomed": (lambda: T.GeometricMedian(device="cpu"), lambda: J.GeometricMedian()),
    "clip": (lambda: T.CenteredClipping(c_tau=1.0, device="cpu"),
             lambda: J.CenteredClipping(c_tau=1.0)),
}
MASKED_KIND = {"median": "exact", "multikrum": "ulp4", "krum": "ulp4", "cge-f0": "ulp4",
               "cge-f1": "ulp4", "monna": "ulp4", "geomed": "tol", "clip": "tol"}


def _admissible(agg, m):
    try:
        agg.validate_n(m)
        return True
    except ValueError:
        return False


@pytest.mark.parametrize("m", [1, N // 2, N - 1, N])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_aggregate_masked_matches_jax(name, m):
    """``aggregate_masked`` of each class against the JAX class's on one
    padded cohort (d = 200: every column is one XLA:CPU chain), at m in {1,
    n/2, n - 1, n}; an inadmissible m raises ValueError in both."""
    ours, ref = CLASSES[name][0](), CLASSES[name][1]()
    assert ours.supports_masked_finalize and ref.supports_masked_finalize
    x, valid = _padded(_grads(seed=m + 20), m, N)
    if not _admissible(ref, m):
        with pytest.raises(ValueError):
            ours.aggregate_masked(x, valid)
        with pytest.raises(ValueError):
            ref.aggregate_masked(x, valid)
        return
    out = ours.aggregate_masked(x, valid)
    _assert_close(out.numpy(), np.asarray(ref.aggregate_masked(x, valid)),
                  MASKED_KIND.get(name, "exact"))


@pytest.mark.parametrize("bucket,m", [(8, 5), (16, 13), (32, 29), (64, 21), (64, 40), (64, 63),
                                      (64, 64)])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_padded_equals_compacted_bitwise(name, bucket, m):
    """The serving contract in the port: a cohort of m rows padded into a
    bucket gives the bits of the same cohort at bucket == m, all valid,
    for every masked class, up to the bench's bucket of 64 (where the
    reference's own trimmed mean and clipping drift, ROADMAP C)."""
    agg = CLASSES[name][0]()
    if not _admissible(agg, m):
        pytest.skip(f"m={m} is not admissible for {name}")
    x, valid = _padded(_grads(n=bucket, d=257, seed=bucket + m), m, bucket)
    out = agg.aggregate_masked(x, valid)
    compact = agg.aggregate_masked(x[:m].copy(), np.ones(m, bool))
    assert torch.equal(out.view(torch.int32), compact.view(torch.int32))


# the masked program against the unmasked one on the same rows: the
# coordinate-wise ones sum the same sorted rows in the same order, and B1
# and B6 divide (or multiply) where the masked form multiplies by the
# rounded reciprocal: within 4 ulp; the selections sum the same rows, B4's
# sweep multiplying then adding where B11 fuses: the summation bound; the
# iterative ones step through B7: the f32 tolerance
UNMASKED_KIND = {"multikrum": "sum", "krum": "sum", "cge-f0": "sum", "cge-f1": "sum",
                 "monna": "sum", "geomed": "tol", "clip": "tol"}


@pytest.mark.parametrize("m", [3, N // 2, N - 1])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_fold_finalize_masked_matches_aggregate(name, m):
    """``fold_finalize_masked`` of a fold declared for a bucket of 16, the m
    rows folded in a shuffled order: close to ``aggregate`` on the same
    rows (``UNMASKED_KIND``), and bit for bit what ``aggregate_masked``
    gives on the same padded matrix."""
    agg = CLASSES[name][0]()
    if not _admissible(agg, m):
        pytest.skip(f"m={m} is not admissible for {name}")
    x, valid = _padded(_grads(seed=40 + m), m, N)
    state = agg.fold_init(N)
    for i in np.random.default_rng(m).permutation(m):
        agg.fold(state, int(i), x[i])
    out = agg.fold_finalize_masked(state)
    ref = agg.aggregate([x[i] for i in range(m)])
    _assert_close(out.numpy(), ref.numpy(), UNMASKED_KIND.get(name, "ulp4"), rows=x[:m])
    batch = agg.aggregate_masked(x, valid)
    assert torch.equal(out.view(torch.int32), batch.view(torch.int32))


@pytest.mark.parametrize("name", ["median", "trimmed-f1", "multikrum"])
def test_nonfinite_cohort_takes_the_exact_path(name):
    """A NaN or inf row sorts differently against the padding, so both
    doors take the exact subset path: bit for bit ``aggregate`` on the
    valid rows, NaN placement included, and no masked kernel runs."""
    agg = CLASSES[name][0]()
    x, valid = _padded(_grads(seed=13), 6, N)
    x[1, ::7] = np.inf
    x[2, 3] = np.nan
    ref = agg.aggregate([x[i] for i in range(6)]).numpy()
    _assert_close(agg.aggregate_masked(x, valid).numpy(), ref, "exact")
    state = agg.fold_init(N)
    for i in range(6):
        agg.fold(state, i, x[i])
    _assert_close(agg.fold_finalize_masked(state).numpy(), ref, "exact")


def test_caf_has_no_masked_program_and_falls_back():
    """CAF has no masked program, as in the reference: ``masked_matrix_fn``
    is None and both doors give ``aggregate`` on the valid rows, bit for
    bit."""
    agg = T.CAF(1, device="cpu")
    assert not agg.supports_masked_finalize and agg.masked_matrix_fn() is None
    assert not J.CAF(f=1).supports_masked_finalize
    x, valid = _padded(_grads(seed=2), 7, N)
    ref = agg.aggregate([x[i] for i in range(7)])
    assert torch.equal(agg.aggregate_masked(x, valid), ref)
    state = agg.fold_init(N)
    for i in range(7):
        agg.fold(state, i, x[i])
    assert torch.equal(agg.fold_finalize_masked(state), ref)


def test_empty_and_inadmissible_cohorts_raise():
    agg = T.CoordinateWiseMedian(device="cpu")
    with pytest.raises(ValueError, match="at least one valid row"):
        agg.aggregate_masked(np.zeros((4, 3), np.float32), np.zeros(4, bool))
    with pytest.raises(ValueError, match="before any gradient"):
        agg.fold_finalize_masked(agg.fold_init(N))
    trimmed = T.CoordinateWiseTrimmedMean(2, device="cpu")
    x, valid = _padded(_grads(seed=1), 4, 8)
    with pytest.raises(ValueError, match="2f < n"):
        trimmed.aggregate_masked(x, valid)
    state = trimmed.fold_init(8)
    for i in range(4):
        trimmed.fold(state, i, x[i])
    with pytest.raises(ValueError, match="2f < n"):
        trimmed.fold_finalize_masked(state)


def test_masked_matrix_fn_is_the_masked_program():
    agg = T.MultiKrum(1, 2, device="cpu")
    x, valid = _padded(_grads(seed=5), 9, N)
    fn = agg.masked_matrix_fn()
    out = fn(torch.from_numpy(x), torch.from_numpy(valid))
    assert torch.equal(out, agg.aggregate_masked(x, valid))


def test_masked_family_runs_no_b1_b4_b6_b7_on_the_cpu_either(monkeypatch):
    """The masked programs reach B2 (sort_columns), B3 (gram), B11
    (segment_sum), the row reduction and B7's masked modes (Weiszfeld and
    centred clipping), never B1, B4, B6 or B7's unmasked modes: their
    wrappers are replaced by a trap here (B7's loop passes its masked modes
    through)."""
    def trap(*a, **k):
        raise AssertionError("the masked family reached an unmasked kernel")

    center_loop = kernels.center_loop

    def masked_only(*a, **k):
        if k.get("mode") not in ("masked_weiszfeld", "masked_clip"):
            trap()
        return center_loop(*a, **k)

    for fn in ("sorted_reduce_stream", "selection_mean_stream", "weighted_rows",
               "meamed_stream", "weighted_center_step", "center_weights", "center_sweep"):
        monkeypatch.setattr(kernels, fn, trap)
    monkeypatch.setattr(kernels, "center_loop", masked_only)
    x, valid = _padded(_grads(seed=8), 11, N)
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    for name, (ours, _, _, least) in FUNCTIONS.items():
        assert ours(xt, vt).shape == (D,), name
