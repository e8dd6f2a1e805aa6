"""The port's aggregators and attacks (``byzpy_tpu_torch.ops.robust``,
``.attack_ops``) against the JAX package's, on the CPU, same numpy inputs.

Exact where the value does not depend on summation order (medians, sorts,
ranks, selections); a stated f32 tolerance where a sum re-associates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.ops import attack_ops as jattack
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu_torch.ops import attack_ops, robust


def _x(seed, shape=(11, 257)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _with_specials(x):
    x = x.copy()
    x[0, 1] = np.nan
    x[1, 2] = np.inf
    x[2, 3] = -np.inf
    x[:, 4] = -0.0
    x[3, 4] = 0.0
    return x


def test_gram_and_pairwise_sq_dists():
    """Gram within 1e-5 |x_i| |x_j|; distances within the same, clamped >= 0."""
    x = _x(0)
    norms = np.linalg.norm(x.astype(np.float64), axis=1)
    tol = 1e-5 * np.outer(norms, norms)
    g = robust.gram_matrix(torch.from_numpy(x)).numpy()
    assert np.all(np.abs(g - np.asarray(jrobust.gram_matrix(jnp.asarray(x)))) <= tol)
    d2 = robust.pairwise_sq_dists(torch.from_numpy(x)).numpy()
    assert np.all(np.abs(d2 - np.asarray(jrobust.pairwise_sq_dists(jnp.asarray(x)))) <= 4 * tol)
    assert np.all(d2 >= 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sort_rows_bitwise(dtype):
    x = _with_specials(_x(1))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ours = robust.sort_rows(torch.from_numpy(x).to(dtype)).float().numpy()
    ref = np.asarray(jrobust.sort_rows(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("n", [4, 11])
def test_coordinate_median_bitwise(n):
    x = _with_specials(_x(2, (n, 300)))
    ours = robust.coordinate_median(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jrobust.coordinate_median(jnp.asarray(x))))


def test_trimmed_mean_within_4_ulp():
    x = _x(3, (11, 300))
    ours = robust.trimmed_mean(torch.from_numpy(x), f=3).numpy()
    ref = np.asarray(jrobust.trimmed_mean(jnp.asarray(x), f=3))
    np.testing.assert_array_max_ulp(ours, ref, maxulp=4)


def test_streams_equal_per_round():
    xs = torch.from_numpy(np.stack([_x(s, (9, 100)) for s in range(3)]))
    for stream, one in [
        (robust.coordinate_median_stream, robust.coordinate_median),
        (lambda v: robust.trimmed_mean_stream(v, f=2), lambda v: robust.trimmed_mean(v, f=2)),
        (lambda v: robust.multi_krum_stream(v, f=2, q=3), lambda v: robust.multi_krum(v, f=2, q=3)),
    ]:
        assert torch.equal(stream(xs), robust.aggregate_stream(one, xs))


def test_krum_scores_within_tolerance():
    """Scores re-associate f32 sums: rtol 1e-5."""
    x = _x(4)
    ours = robust.krum_scores(torch.from_numpy(x), f=3).numpy()
    np.testing.assert_allclose(ours, np.asarray(jrobust.krum_scores(jnp.asarray(x), f=3)), rtol=1e-5)


def test_nan_last_ranks_exact():
    scores = np.array([3.0, np.nan, 1.0, -0.0, 0.0, 1.0, np.nan, -2.0, np.inf], np.float32)
    ours = robust._nan_last_ranks(torch.from_numpy(scores)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jrobust._nan_last_ranks(jnp.asarray(scores))))


def test_ranked_mean_excludes_unselected_nan_rows():
    x = _x(5, (6, 50))
    x[4] = np.nan
    scores = np.array([0.5, 0.1, 0.3, 0.9, np.nan, 0.2], np.float32)
    ours = robust.ranked_mean(torch.from_numpy(x), torch.from_numpy(scores), 3).numpy()
    ref = np.asarray(jrobust.ranked_mean(jnp.asarray(x), jnp.asarray(scores), 3))
    assert np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("q", [1, 4])
def test_multi_krum_matches_jax(q):
    """Same selection as the JAX package; the mean within rtol 1e-6."""
    x = _x(6, (12, 400))
    x[3] *= 25.0  # an outlier row
    ours = robust.multi_krum(torch.from_numpy(x), f=3, q=q).numpy()
    ref = np.asarray(jrobust.multi_krum(jnp.asarray(x), f=3, q=q))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        robust.krum(torch.from_numpy(x), f=3).numpy(), robust.multi_krum(torch.from_numpy(x), f=3, q=1).numpy()
    )


@pytest.mark.parametrize(
    "call",
    [
        ("trimmed_mean", dict(f=3)),
        ("multi_krum", dict(f=2, q=4)),
        ("krum_scores", dict(f=4)),
    ],
)
def test_errors_match_jax(call):
    name, kw = call
    x = np.zeros((5, 8), np.float32)
    with pytest.raises(ValueError) as ours:
        getattr(robust, name)(torch.from_numpy(x), **kw)
    with pytest.raises(ValueError) as ref:
        getattr(jrobust, name)(jnp.asarray(x), **kw)
    assert str(ours.value) == str(ref.value)


def test_aggregators_reject_non_matrix():
    with pytest.raises(ValueError, match="2-D"):
        robust.coordinate_median(torch.zeros(3, 4, 5))


# ---------------------------------------------------------------------------
# attacks
# ---------------------------------------------------------------------------


def test_deterministic_attacks_match_jax():
    """sign_flip/mimic/inf exactly; empire and little within rtol 1e-6
    (means re-associate)."""
    h = _x(7, (7, 64))
    ht, hj = torch.from_numpy(h), jnp.asarray(h)
    np.testing.assert_array_equal(
        attack_ops.sign_flip(ht[0], scale=-2.0).numpy(), np.asarray(jattack.sign_flip(hj[0], scale=-2.0))
    )
    np.testing.assert_allclose(
        attack_ops.empire(ht, scale=-1.5).numpy(), np.asarray(jattack.empire(hj, scale=-1.5)), rtol=1e-6
    )
    np.testing.assert_allclose(
        attack_ops.little(ht, f=2, n_total=9).numpy(),
        np.asarray(jattack.little(hj, f=2, n_total=9)),
        rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_array_equal(attack_ops.mimic(ht, epsilon=3).numpy(), h[3])
    inf = attack_ops.inf_vector((5,), device="cpu")
    np.testing.assert_array_equal(inf.numpy(), np.asarray(jattack.inf_vector((5,))))
    with pytest.raises(ValueError, match="epsilon"):
        attack_ops.mimic(ht, epsilon=7)
    with pytest.raises(ValueError, match="N must be"):
        attack_ops.little(ht, f=5, n_total=3)


def test_gaussian_draws_from_its_generator():
    """torch's generator cannot reproduce jax.random's bits: check the
    draw is reproducible from the seed and has the asked moments."""
    a = attack_ops.gaussian(torch.Generator().manual_seed(0), (20000,), mu=1.0, sigma=2.0, device="cpu")
    b = attack_ops.gaussian(torch.Generator().manual_seed(0), (20000,), mu=1.0, sigma=2.0, device="cpu")
    assert torch.equal(a, b)
    assert abs(float(a.mean()) - 1.0) < 0.05 and abs(float(a.std()) - 2.0) < 0.05
