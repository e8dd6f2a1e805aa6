"""The port's subset-search aggregators (``byzpy_tpu_torch``: the
combinatorics, ``ops.robust``'s subset scorers, ``MinimumDiameterAveraging``
and ``SMEA``) against the JAX package's, on the CPU, same numpy inputs.

Tolerances, stated per test: the combinatorics, the Jacobi schedule, the
diameters, the greedy bound, the branch-and-bound and every selected
subset are exact; the eigenvalue scores are held within f32 rounding of
the largest score (``SCORE_RTOL``: the centering products and the 88
Jacobi rounds of ``(16, 5)`` round in another order, and XLA contracts
the rotations into FMAs); the winners' means within f32 rounding
(``MEAN_RTOL`` / ``MEAN_ATOL``: a mean of the same rows summed in
another order).
"""

import math
import types
from itertools import combinations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import byzpy_tpu.aggregators as J
from byzpy_tpu.aggregators.geometric_wise import minimum_diameter_average as jmda
from byzpy_tpu.aggregators.geometric_wise import smea as jsmea
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu.utils import combinatorics as jcomb
import byzpy_tpu_torch.aggregators as P
from byzpy_tpu_torch.aggregators.geometric_wise import minimum_diameter_average as pmda
from byzpy_tpu_torch.aggregators.geometric_wise import smea as psmea
from byzpy_tpu_torch.ops import robust
from byzpy_tpu_torch.utils import combinatorics as pcomb

SCORE_RTOL = 2e-5
MEAN_RTOL, MEAN_ATOL = 1e-6, 1e-6
CPU = "cpu"


def _rows(n, d, seed, *, outliers=0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    for i in range(outliers):
        x[n - 1 - i] *= 4.0 + i
    return x


def _combos(n, m):
    return np.asarray(list(combinations(range(n), m)), np.int32).reshape(math.comb(n, m), m)


def _assert_scores_close(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(ours), finite)
    np.testing.assert_array_equal(ours[~finite], ref[~finite])
    if finite.any():
        scale = np.abs(ref[finite]).max()
        np.testing.assert_allclose(ours[finite], ref[finite], rtol=0,
                                   atol=SCORE_RTOL * max(scale, 1e-30))


def _assert_same_winner(ours, ref):
    """The same argmin, and a runner-up far enough from the winner that
    f32 rounding cannot reorder them (the data is not a near tie)."""
    ref = np.asarray(ref, np.float64)
    assert int(np.argmin(np.asarray(ours))) == int(np.argmin(ref))
    order = np.sort(ref[np.isfinite(ref)])
    if order.size > 1:
        assert order[1] - order[0] > SCORE_RTOL * max(abs(order).max(), 1e-30)


# ---------------------------------------------------------------------------
# combinatorics and the schedule: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(11))
def test_combinatorics_all_ranks_equal(n):
    for m in range(n + 1):
        total = math.comb(n, m)
        for rank in range(total):
            assert pcomb.unrank_combination(n, m, rank) == jcomb.unrank_combination(n, m, rank)
        for start in sorted({0, total // 3, total - 1, total}):
            assert list(pcomb.iter_combinations(n, m, start)) == list(
                jcomb.iter_combinations(n, m, start))
        with pytest.raises(ValueError, match="rank must be"):
            pcomb.unrank_combination(n, m, total)


@pytest.mark.parametrize("m", range(2, 13))
def test_parallel_jacobi_schedule_equal(m):
    for ours, ref in zip(robust._parallel_jacobi_schedule(m), jrobust._parallel_jacobi_schedule(m)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# the scorers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m", [(9, 3), (8, 6), (12, 9)])
def test_subset_diameters_exact(n, m):
    x = _rows(n, 40, seed=n * m)
    d2 = pmda._dists_for_search(torch.from_numpy(x))
    d2[1, 4] = d2[4, 1] = np.nan  # a NaN distance poisons its subsets in both
    combos = _combos(n, m)
    ours = robust.subset_diameters(torch.from_numpy(d2), torch.from_numpy(combos)).numpy()
    ref = np.asarray(jrobust.subset_diameters(jnp.asarray(d2), jnp.asarray(combos)))
    np.testing.assert_array_equal(ours, ref)


JACOBI_CASES = {
    "f32_9_3": (9, 3, np.float32, 0),
    "f32_16_11": (16, 11, np.float32, 0),
    "f32_8_6_outliers": (8, 6, np.float32, 2),
    "bf16_9_6": (9, 6, "bfloat16", 0),
    "f16_9_6": (9, 6, np.float16, 0),
}


def _gram_pair(x, dtype):
    """The same Gram in both packages' tensors, in ``dtype`` (16-bit Grams
    of rows whose norms stay under 256, ROADMAP C's f16 rule)."""
    g = (x.astype(np.float64) @ x.T.astype(np.float64)).astype(np.float32)
    if dtype == "bfloat16":
        t = torch.from_numpy(g).to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return torch.from_numpy(g.astype(dtype)), jnp.asarray(g.astype(dtype))


@pytest.mark.parametrize("case", sorted(JACOBI_CASES))
def test_subset_max_eigvals_within_f32(case):
    n, m, dtype, outliers = JACOBI_CASES[case]
    x = _rows(n, 24, seed=n + m, outliers=outliers)
    g, jg = _gram_pair(x, dtype)
    combos = _combos(n, m)
    ours = robust.subset_max_eigvals_jacobi(g, torch.from_numpy(combos))
    ref = jrobust.subset_max_eigvals_jacobi(jg, jnp.asarray(combos))
    assert ours.dtype == g.dtype
    _assert_scores_close(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    if dtype == np.float32:
        _assert_same_winner(ours.numpy(), np.asarray(ref))
        exact = robust.subset_max_eigvals(g, torch.from_numpy(combos)).numpy()
        _assert_scores_close(exact, np.asarray(jrobust.subset_max_eigvals(jg, jnp.asarray(combos))))
        _assert_scores_close(ours.numpy(), exact)


@pytest.mark.parametrize("bad", ["nan", "inf", "-inf"])
def test_jacobi_nonfinite_rows_score_inf(bad):
    n, m = 9, 6
    x = _rows(n, 24, seed=7)
    g = x @ x.T
    g[6, :] = g[:, 6] = float(bad)
    combos = _combos(n, m)
    ours = robust.subset_max_eigvals_jacobi(torch.from_numpy(g), torch.from_numpy(combos)).numpy()
    ref = np.asarray(jrobust.subset_max_eigvals_jacobi(jnp.asarray(g), jnp.asarray(combos)))
    touches = (combos == 6).any(axis=1)
    assert np.isposinf(ours[touches]).all() and np.isfinite(ours[~touches]).all()
    _assert_scores_close(ours, ref)
    _assert_same_winner(ours, ref)


@pytest.mark.parametrize("m", [0, 1])
def test_jacobi_small_m_branches(m):
    n = 5
    g = (_rows(n, 8, seed=m) @ _rows(n, 8, seed=m).T).astype(np.float32)
    g[2, 2] = np.inf
    combos = _combos(n, m)
    ours = robust.subset_max_eigvals_jacobi(torch.from_numpy(g), torch.from_numpy(combos)).numpy()
    ref = np.asarray(jrobust.subset_max_eigvals_jacobi(jnp.asarray(g), jnp.asarray(combos)))
    np.testing.assert_array_equal(ours, ref)


def test_subset_mean_and_argmin_ties():
    x = _rows(7, 33, seed=2)
    combo = np.asarray([0, 2, 5], np.int32)
    np.testing.assert_allclose(robust.subset_mean(torch.from_numpy(x), torch.from_numpy(combo)).numpy(),
                               np.asarray(jrobust.subset_mean(jnp.asarray(x), jnp.asarray(combo))),
                               rtol=MEAN_RTOL, atol=MEAN_ATOL)
    for scores in ([3.0, 1.0, 1.0, 2.0], [np.inf, np.inf], [2.0, 0.5, 0.5, 0.5, 9.0]):
        s = np.asarray(scores, np.float32)
        assert int(robust.best_subset_by_score(torch.from_numpy(s))) == int(
            jrobust.best_subset_by_score(jnp.asarray(s)))


# ---------------------------------------------------------------------------
# the exact search: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,seed", [(8, 6, 0), (10, 7, 1), (12, 8, 2), (13, 9, 3)])
def test_greedy_bound_and_branch_and_bound_exact(n, m, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)).astype(np.float32)
    d2 = a + a.T
    np.fill_diagonal(d2, 0.0)
    assert pmda.greedy_peel_bound(d2, m) == jmda.greedy_peel_bound(d2, m)
    bound, combo = jmda.greedy_peel_bound(d2, m)
    assert pmda.branch_and_bound_min_diameter(d2, m) == jmda.branch_and_bound_min_diameter(d2, m)
    assert (pmda.branch_and_bound_min_diameter(d2, m, initial_bound=bound, initial_combo=combo)
            == jmda.branch_and_bound_min_diameter(d2, m, initial_bound=bound, initial_combo=combo))
    seeds = [(0, 1), (0, 3), (2, 4)]
    assert (pmda.branch_and_bound_min_diameter(d2, m, prefixes=seeds, initial_bound=bound)
            == jmda.branch_and_bound_min_diameter(d2, m, prefixes=seeds, initial_bound=bound))
    assert pmda._exact_min_diameter(d2, m) == jmda._exact_min_diameter(d2, m)
    score, best = pmda._search_seed_group(d2, tuple(seeds), m, bound)
    jscore, jbest = jmda._search_seed_group(d2, tuple(seeds), m, bound)
    assert score == jscore and np.array_equal(best, jbest)


@pytest.mark.parametrize("start,count", [(0, 28), (5, 11), (20, 8)])
def test_device_scorer_range_exact(start, count):
    n, m = 8, 6
    x = _rows(n, 30, seed=4, outliers=2)
    d2 = pmda._dists_for_search(torch.from_numpy(x))
    score, combo = pmda._score_combo_range(d2, n, m, start, count)
    jscore, jcombo = jmda._score_combo_range(d2, n, m, start, count)
    assert score == jscore
    np.testing.assert_array_equal(combo, jcombo)
    batches = list(pmda._combo_batches(n, m, 5, start=start, count=count))
    jbatches = list(jmda._combo_batches(n, m, 5, start=start, count=count))
    assert len(batches) == len(jbatches)
    for a, b in zip(batches, jbatches):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the classes
# ---------------------------------------------------------------------------

CLASS_CASES = {
    "9x50_f3": (9, 50, 3, 1),
    "8x421_f2": (8, 421, 2, 2),
    "12x64_f3": (12, 64, 3, 3),
    "16x40_f5": (16, 40, 5, 2),
}


@pytest.mark.parametrize("case", sorted(CLASS_CASES))
def test_mda_class_matches_jax(case):
    n, d, f, outliers = CLASS_CASES[case]
    x = _rows(n, d, seed=n * d, outliers=outliers)
    agg = P.MinimumDiameterAveraging(f, device=CPU)
    out = agg.aggregate([torch.from_numpy(r) for r in x])
    ref = np.asarray(J.MinimumDiameterAveraging(f).aggregate([jnp.asarray(r) for r in x]))
    d2 = pmda._dists_for_search(torch.from_numpy(x))
    jd2 = jmda._dists_for_search(jnp.asarray(x))
    np.testing.assert_array_equal(d2, jd2)
    want = jmda._exact_min_diameter(jd2, n - f)
    assert agg.last_selection.tolist() == want
    np.testing.assert_allclose(out.numpy(), ref, rtol=MEAN_RTOL, atol=MEAN_ATOL)
    np.testing.assert_allclose(out.numpy(), x[want].mean(axis=0), rtol=MEAN_RTOL, atol=MEAN_ATOL)


@pytest.mark.parametrize("path", ["device", "host"])
@pytest.mark.parametrize("case", sorted(CLASS_CASES))
def test_smea_class_matches_jax(case, path, monkeypatch):
    n, d, f, outliers = CLASS_CASES[case]
    if path == "host":
        # both classes take their host LAPACK path
        monkeypatch.setattr(psmea, "_DEVICE_COMBO_CAP", 0)
        monkeypatch.setattr(jsmea, "_DEVICE_COMBO_CAP", 0)
    x = _rows(n, d, seed=n + d, outliers=outliers)
    m = n - f
    agg = P.SMEA(f, device=CPU)
    out = agg.aggregate(torch.from_numpy(x))
    ref = np.asarray(J.SMEA(f).aggregate(jnp.asarray(x)))
    combos = _combos(n, m)
    jscores = np.asarray(jrobust.subset_max_eigvals_jacobi(jrobust.gram_matrix(jnp.asarray(x)),
                                                           jnp.asarray(combos)))
    gram = robust.gram_matrix(torch.from_numpy(x))
    scores = robust.subset_max_eigvals_jacobi(gram, torch.from_numpy(combos)).numpy()
    _assert_scores_close(scores, jscores)
    _assert_same_winner(scores, jscores)
    assert agg.last_selection.tolist() == combos[int(np.argmin(jscores))].tolist()
    np.testing.assert_allclose(out.numpy(), ref, rtol=MEAN_RTOL, atol=MEAN_ATOL)
    if path == "host":
        jbest = jsmea._score_combo_range_smea(np.asarray(jrobust.gram_matrix(jnp.asarray(x))), n, m,
                                              0, math.comb(n, m))
        best = psmea._score_combo_range_smea(gram.numpy(), n, m, 0, math.comb(n, m))
        np.testing.assert_array_equal(best[1], jbest[1])


def test_smea_host_scorer_same_code_same_bits():
    """On one host Gram the two packages' LAPACK scorers agree exactly."""
    n, f = 10, 3
    x = _rows(n, 32, seed=11, outliers=2)
    g = (x @ x.T).astype(np.float32)
    total = math.comb(n, n - f)
    for start, count in ((0, total), (17, 40)):
        ours = psmea._score_combo_range_smea(g, n, n - f, start, count)
        ref = jsmea._score_combo_range_smea(g, n, n - f, start, count)
        assert ours[0] == ref[0] and np.array_equal(ours[1], ref[1])


def test_smea_device_combos_cached_in_order():
    c = psmea._device_combos(9, 6, torch.device(CPU))
    assert c is psmea._device_combos(9, 6, torch.device(CPU))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jsmea._device_combos(9, 6)))


NONFINITE_ROWS = {"nan_inf": (np.nan, np.inf), "inf_inf": (np.inf, np.inf),
                  "nan_neg_inf": (np.nan, -np.inf)}


@pytest.mark.parametrize("cls", ["MinimumDiameterAveraging", "SMEA"])
@pytest.mark.parametrize("rows", sorted(NONFINITE_ROWS))
def test_nonfinite_rows_match_jax(rows, cls):
    """Two adversarial rows of NaN / inf (tests/test_aggregator_classes.py's
    SMEA case, and the same for MDA): SMEA scores every subset that holds
    one +inf and averages the honest rows; MDA's branch-and-bound reads
    the same NaN-holding distances as the JAX class and makes the same
    choice."""
    r = np.random.default_rng(1)
    honest = [r.normal(size=128).astype(np.float32) for _ in range(7)]
    bad = [np.full((128,), v, np.float32) for v in NONFINITE_ROWS[rows]]
    grads = honest + bad
    agg = getattr(P, cls)(2, device=CPU)
    out = agg.aggregate([torch.from_numpy(g) for g in grads]).numpy()
    ref = np.asarray(getattr(J, cls)(2).aggregate([jnp.asarray(g) for g in grads]))
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=MEAN_RTOL, atol=MEAN_ATOL)
    if cls == "SMEA":
        assert np.isfinite(out).all() and agg.last_selection.tolist() == list(range(7))
    else:
        d2 = pmda._dists_for_search(torch.from_numpy(np.stack(grads)))
        jd2 = jmda._dists_for_search(jnp.asarray(np.stack(grads)))
        np.testing.assert_array_equal(d2, jd2)
        assert agg.last_selection.tolist() == jmda._exact_min_diameter(jd2, 7)


def test_validate_n_messages_and_options():
    for cls, n, msg in (("MinimumDiameterAveraging", 3, "f must satisfy 0 <= f < n"),
                        ("SMEA", 6, "2f must be < n")):
        x = _rows(n, 8, seed=0)
        with pytest.raises(ValueError) as ours:
            getattr(P, cls)(3, device=CPU).aggregate(torch.from_numpy(x))
        with pytest.raises(ValueError) as ref:
            getattr(J, cls)(3).aggregate(jnp.asarray(x))
        assert str(ours.value) == str(ref.value) and msg in str(ours.value)
        with pytest.raises(ValueError, match="f must be >= 0"):
            getattr(P, cls)(-1, device=CPU)
        with pytest.raises(ValueError, match="chunk_size must be > 0"):
            getattr(P, cls)(1, chunk_size=0, device=CPU)
        with pytest.raises(NotImplementedError, match="chunk_size"):
            getattr(P, cls)(1, chunk_size=7, device=CPU)
    for key in ("seed_prefix", "seeds_per_task"):
        with pytest.raises(NotImplementedError, match=key):
            P.MinimumDiameterAveraging(1, **{key: 3}, device=CPU)
    assert P.MinimumDiameterAveraging.name == J.MinimumDiameterAveraging.name
    assert P.SMEA.name == J.SMEA.name


def test_card_cap_and_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (P.MinimumDiameterAveraging, P.SMEA):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(1)
    # B3 takes at most 128 rows on the card, and the classes say so
    agg = P.SMEA(1, device=CPU)
    pmda.check_rows_on_card(agg, torch.zeros((129, 4)))  # the CPU has no cap
    on_card = types.SimpleNamespace(is_cuda=True, shape=(129, 4))
    with pytest.raises(NotImplementedError, match="at most 128 rows"):
        pmda.check_rows_on_card(agg, on_card)
    pmda.check_rows_on_card(agg, types.SimpleNamespace(is_cuda=True, shape=(128, 4)))


def test_geometric_wise_exports():
    import byzpy_tpu.aggregators.geometric_wise as jgw
    import byzpy_tpu_torch.aggregators.geometric_wise as pgw

    assert sorted(pgw.__all__) == sorted(jgw.__all__)
    assert {"MinimumDiameterAveraging", "SMEA"} <= set(P.__all__)
