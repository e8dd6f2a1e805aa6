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
from byzpy_tpu.ops import pallas_kernels as pk
from byzpy_tpu.ops import preagg as jpreagg
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu_torch.ops import attack_ops, kernels, robust


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


# ---------------------------------------------------------------------------
# pre-aggregation fused into Multi-Krum (B9, B10)
# ---------------------------------------------------------------------------

PIPELINES = {
    "nnm": ("nnm_multi_krum", dict(f_nnm=3)),
    "clip": ("clipped_multi_krum", dict(tau=25.0)),
    "arc": ("arc_multi_krum", dict(f_arc=3)),
}


def _pipeline_rows(seed, n=12, d=400):
    x = _x(seed, (n, d))
    x[::3] *= 3.0  # norms ~20 and ~60: the clip and ARC engage
    x[5] *= 25.0  # an outlier row
    return x


def _jax_selected(pre: str, x: np.ndarray, f: int, q: int) -> np.ndarray:
    """Rows whose weight in the final mean is not 0, from the JAX package's
    two-step composition: the pre-aggregator, then Multi-Krum's selection
    (``_nan_last_ranks`` of Krum scores); NNM maps the selected mixed rows
    back to the source rows it mixed (its 0/1 mask)."""
    xj = jnp.asarray(x)
    if pre == "nnm":
        mixed = jpreagg.nnm(xj, f=3)
        sel = np.asarray(jrobust._nan_last_ranks(jrobust.krum_scores(mixed, f=f)) < q)
        g = np.zeros((16, 16), np.float32)
        g[:12, :12] = np.asarray(jrobust.gram_matrix(xj))
        mask = np.asarray(pk._nnm_weights(jnp.asarray(g), n_pad=16, n_real=12, k=9)[0])[:12, :12]
        return mask @ sel.astype(np.float32) > 0
    clipped = jpreagg.clip_rows(xj, threshold=25.0) if pre == "clip" else jpreagg.arc_clip(xj, f=3)
    return np.asarray(jrobust._nan_last_ranks(jrobust.krum_scores(clipped, f=f)) < q)


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("pre", sorted(PIPELINES))
def test_fused_pipelines_match_jax(pre, q):
    """Against the JAX package's two-step path (its choice on the CPU):
    the rows that carry weight are the same, exactly, and the mean is
    within rtol 1e-5, atol 1e-6 (the fused path sums the derived Gram and
    the weights in another order)."""
    name, kw = PIPELINES[pre]
    x = _pipeline_rows(20 + q)
    ours = getattr(robust, name)(torch.from_numpy(x), f=2, q=q, **kw)
    ref = getattr(jrobust, name)(jnp.asarray(x), f=2, q=q, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    g = kernels.gram(torch.from_numpy(x)[None])
    if pre == "nnm":
        w = kernels.nnm_selection_weights(g, k=9, f=2, q=q)
    elif pre == "clip":
        w = kernels.clip_selection_weights(g, pre="clip", tau=25.0, f=2, q=q)
    else:
        w = kernels.clip_selection_weights(g, pre="arc", cut_off=jpreagg.arc_cut_off(12, 3), f=2, q=q)
    np.testing.assert_array_equal((w[0] != 0).numpy(), _jax_selected(pre, x, 2, q))


@pytest.mark.parametrize("pre", sorted(PIPELINES))
def test_fused_pipelines_match_jax_fused_path(pre, monkeypatch):
    """Against the JAX package's fused path (forced on, Pallas interpret
    mode), streams included: within rtol 1e-5, atol 1e-6."""
    monkeypatch.setenv("BYZPY_TPU_PALLAS", "1")
    name, kw = PIPELINES[pre]
    xs = np.stack([_pipeline_rows(30 + k) for k in range(3)])
    ours = getattr(robust, f"{name}_stream")(torch.from_numpy(xs), f=2, q=4, **kw)
    ref = getattr(jrobust, f"{name}_stream")(jnp.asarray(xs), f=2, q=4, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    one = getattr(robust, name)(torch.from_numpy(xs[1]), f=2, q=4, **kw)
    assert torch.equal(one, ours[1])


@pytest.mark.parametrize(
    "call",
    [
        ("clipped_multi_krum", dict(tau=0.0, f=1, q=2)),
        ("clipped_multi_krum", dict(tau=-1.0, f=1, q=2)),
        ("clipped_multi_krum_stream", dict(tau=0.0, f=1, q=2)),
        ("arc_multi_krum", dict(f_arc=-1, f=1, q=2)),
        ("arc_multi_krum", dict(f_arc=9, f=1, q=2)),
        ("arc_multi_krum_stream", dict(f_arc=9, f=1, q=2)),
        ("nnm_multi_krum", dict(f_nnm=8, f=1, q=2)),
        ("nnm_multi_krum", dict(f_nnm=1, f=7, q=1)),
        ("clipped_multi_krum", dict(tau=1.0, f=1, q=8)),
        ("arc_multi_krum", dict(f_arc=1, f=7, q=1)),
    ],
)
def test_fused_pipeline_errors_match_jax(call, monkeypatch):
    """The same ValueError as the JAX package on its fused path; tau and
    f_arc are checked before any dispatch, on both of its paths."""
    monkeypatch.setenv("BYZPY_TPU_PALLAS", "1")
    name, kw = call
    x = np.zeros((8, 256), np.float32)
    if name.endswith("_stream"):
        x = x[None]
    with pytest.raises(ValueError) as ours:
        getattr(robust, name)(torch.from_numpy(x), **kw)
    with pytest.raises(ValueError) as ref:
        getattr(jrobust, name)(jnp.asarray(x), **kw)
    assert str(ours.value) == str(ref.value)


def test_clipped_multi_krum_finite_overflow_documented_divergence():
    """The JAX package's pinned deviation, reproduced: a finite row whose
    squared norm overflows f32 is excluded by the fused path (the two-step
    path clips it to the zero vector). Both outputs are finite and stay at
    the honest rows' scale."""
    x = _x(40, (10, 512))
    x[3] = 1e18
    ours = robust.clipped_multi_krum(torch.from_numpy(x), tau=3.0, f=2, q=4)
    ref = np.asarray(pk.clip_selection_mean_stream_pallas(
        jnp.asarray(x)[None], tau=3.0, f=2, q=4, interpret=True
    ))[0]
    assert torch.isfinite(ours).all()
    assert float(ours.abs().max()) < 10.0
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_aggregators_reject_non_matrix():
    with pytest.raises(ValueError, match="2-D"):
        robust.coordinate_median(torch.zeros(3, 4, 5))


# ---------------------------------------------------------------------------
# centre-seeking and coordinate aggregators (B6, B7, B4's cge / monna, CAF)
# ---------------------------------------------------------------------------


def _centre_rows(seed, n=11, d=300):
    """Normal rows, every third x3 and row 7 x20: a spread the clip, the
    norm elimination and the nearest-neighbour selection all act on."""
    x = _x(seed, (n, d))
    x[::3] *= 3.0
    x[7] *= 20.0
    return x


def _jax_caf_draw(d, seed=0):
    """The JAX package's CAF start vector, ``jax.random.normal(PRNGKey(seed),
    (d,))``, before normalization."""
    import jax

    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (d,), dtype=jnp.float32))


# name -> (port call, JAX call, rtol, atol). The selections (MeaMed, CGE,
# MoNNA) add the same selected values in the same order: rtol 1e-6. The
# loops (geometric median, centred clipping, CAF) round each step
# differently (the port's step is the kernel formula alpha z + sum w x, the
# JAX XLA path's v + sum scale (x - v) / n): 1e-4, the JAX package's own
# kernel-against-XLA tolerance (tests/test_pallas_kernels.py).
CENTRE = {
    "meamed": (lambda x: robust.mean_of_medians(x, f=3),
               lambda x: jrobust.mean_of_medians(x, f=3), 1e-6, 1e-7),
    "cge": (lambda x: robust.cge(x, f=3), lambda x: jrobust.cge(x, f=3), 1e-6, 1e-7),
    "monna": (lambda x: robust.monna(x, f=3, reference_index=2),
              lambda x: jrobust.monna(x, f=3, reference_index=2), 1e-6, 1e-7),
    "geometric_median": (robust.geometric_median, jrobust.geometric_median, 1e-4, 1e-5),
    "geometric_median_mean_init": (lambda x: robust.geometric_median(x, init="mean"),
                                   lambda x: jrobust.geometric_median(x, init="mean"), 1e-4, 1e-5),
    "centered_clipping": (lambda x: robust.centered_clipping(x, c_tau=5.0),
                          lambda x: jrobust.centered_clipping(x, c_tau=5.0), 1e-4, 1e-5),
    "centered_clipping_median_init": (
        lambda x: robust.centered_clipping(x, c_tau=5.0, init="median", M=4),
        lambda x: jrobust.centered_clipping(x, c_tau=5.0, init="median", M=4), 1e-4, 1e-5),
    "centered_clipping_zero_init": (
        lambda x: robust.centered_clipping(x, c_tau=5.0, init="zero", M=30),
        lambda x: jrobust.centered_clipping(x, c_tau=5.0, init="zero", M=30), 1e-4, 1e-5),
    "caf": (lambda x: robust.caf(x, f=3, v_init=torch.from_numpy(_jax_caf_draw(x.shape[1]))),
            lambda x: jrobust.caf(x, f=3), 1e-4, 1e-5),
}


@pytest.mark.parametrize("pallas", ["auto", "1"], ids=["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(CENTRE))
def test_centre_and_coordinate_aggregators_match_jax(name, pallas, monkeypatch):
    """Each aggregator against the JAX package on both of its CPU paths:
    its XLA path (the default here) and its kernel path forced on
    (``BYZPY_TPU_PALLAS=1``, Pallas interpret mode), within the tolerance
    of ``CENTRE``; CAF is fed the JAX package's own start vector."""
    monkeypatch.setenv("BYZPY_TPU_PALLAS", pallas)
    ours, ref, rtol, atol = CENTRE[name]
    x = _centre_rows(50 + len(name))
    out = ours(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (x.shape[1],)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref(jnp.asarray(x))), rtol=rtol, atol=atol)


def test_meamed_matches_jax_on_nonfinite_columns():
    """NaN, +-inf and -0.0 columns: the same NaN places and the same bits
    elsewhere as the JAX package's MeaMed (its XLA path on the CPU)."""
    x = _with_specials(_x(60, (9, 200)))
    for f in (0, 2, 8):
        ours = robust.mean_of_medians(torch.from_numpy(x), f=f).numpy()
        ref = np.asarray(jrobust.mean_of_medians(jnp.asarray(x), f=f))
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
        keep = ~np.isnan(ref)
        np.testing.assert_array_equal(ours[keep], ref[keep])


STREAMS = {
    "mean_of_medians": dict(f=2),
    "cge": dict(f=2),
    "monna": dict(f=2, reference_index=1),
}


@pytest.mark.parametrize("pallas", ["auto", "1"], ids=["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_centre_streams_match_jax(name, pallas, monkeypatch):
    """The three streams against the JAX package's (rtol 1e-6, as the
    single calls), and each round bitwise equal to the port's single call."""
    monkeypatch.setenv("BYZPY_TPU_PALLAS", pallas)
    kw = STREAMS[name]
    xs = np.stack([_centre_rows(70 + k, n=9, d=200) for k in range(3)])
    ours = getattr(robust, f"{name}_stream")(torch.from_numpy(xs), **kw)
    ref = getattr(jrobust, f"{name}_stream")(jnp.asarray(xs), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    for k in range(3):
        assert torch.equal(ours[k], getattr(robust, name)(torch.from_numpy(xs[k]), **kw))


def test_geometric_median_counts_its_iterations():
    """The loop steps at least once, stops when the step length is at most
    tol, and never passes max_iter; the count is kept in last_iterations."""
    x = torch.from_numpy(_centre_rows(80))
    z1 = robust.geometric_median(x, max_iter=1)
    assert robust.last_iterations["geometric_median"] == 1
    np.testing.assert_allclose(
        z1.numpy(),
        kernels.weighted_center_step(x, robust.coordinate_median(x), mode="weiszfeld").numpy())
    robust.geometric_median(x, tol=1e-3)
    loose = robust.last_iterations["geometric_median"]
    robust.geometric_median(x)
    tight = robust.last_iterations["geometric_median"]
    assert 1 < loose < tight < 256
    robust.geometric_median(x, tol=0.0, max_iter=3)
    assert robust.last_iterations["geometric_median"] == 3


def test_caf_draws_its_start_from_the_generator():
    """Without ``v_init``, CAF draws its start vector with ``torch.randn``
    from ``generator``: the same seed gives the same result, and passing
    that draw as ``v_init`` gives it too."""
    x = torch.from_numpy(_centre_rows(90))
    a = robust.caf(x, f=3, generator=torch.Generator().manual_seed(5))
    passes = robust.last_iterations["caf"]
    b = robust.caf(x, f=3, generator=torch.Generator().manual_seed(5))
    v = torch.randn((x.shape[1],), generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and torch.equal(a, robust.caf(x, f=3, v_init=v))
    assert 1 <= passes <= 4 * x.shape[0]
    with pytest.raises(ValueError, match="v_init must have shape"):
        robust.caf(x, f=3, v_init=torch.zeros(5))


@pytest.mark.parametrize(
    "call",
    [
        ("mean_of_medians", dict(f=-1)),
        ("mean_of_medians", dict(f=5)),
        ("cge", dict(f=5)),
        ("cge", dict(f=-1)),
        ("monna", dict(f=3)),
        ("monna", dict(f=1, reference_index=5)),
        ("monna", dict(f=1, reference_index=-1)),
        ("geometric_median", dict(init="zero")),
        ("centered_clipping", dict(c_tau=1.0, init="trimmed")),
        ("caf", dict(f=3)),
        ("mean_of_medians_stream", dict(f=5)),
        ("cge_stream", dict(f=5)),
        ("monna_stream", dict(f=3)),
        ("monna_stream", dict(f=1, reference_index=5)),
    ],
)
def test_centre_errors_match_jax(call):
    """The JAX package's ValueError and message for each bad argument."""
    name, kw = call
    x = np.zeros((5, 8), np.float32)
    if name.endswith("_stream"):
        x = x[None]
    with pytest.raises(ValueError) as ours:
        getattr(robust, name)(torch.from_numpy(x), **kw)
    with pytest.raises(ValueError) as ref:
        getattr(jrobust, name)(jnp.asarray(x), **kw)
    assert str(ours.value) == str(ref.value)


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
