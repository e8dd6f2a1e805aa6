"""The port's kernel wrappers (``byzpy_tpu_torch.ops.kernels``) against the
JAX package's Pallas kernels.

On the CPU every wrapper computes its plain PyTorch version; these tests
hold that version to the Pallas kernel run in interpret mode, on the same
numpy inputs. ``test_torch_cuda.py`` holds each CUDA kernel to its plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.ops import pallas_kernels as pk
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu_torch.ops import _build, kernels
from byzpy_tpu_torch.ops import robust as trobust

TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}


def _matrix(rng, shape, *, specials=True):
    """Normal data; with ``specials``, a few columns hold NaN / +-inf / -0.
    No subnormals: XLA on the CPU flushes subnormal arithmetic to zero,
    while PyTorch and CUDA (built without -ftz) keep them; the key map test
    covers subnormal keys."""
    x = rng.normal(size=shape).astype(np.float32)
    if specials:
        x[..., 0, 1] = np.nan
        x[..., 1, 2] = np.inf
        x[..., 0, 3] = -np.inf
        x[..., :2, 4] = [np.inf, -np.inf]
        x[..., :, 5] = -0.0
    return x


def _to_torch(x: np.ndarray, dt: str) -> torch.Tensor:
    return torch.from_numpy(x).to(TORCH_DTYPES[dt])


def _to_jax(x: np.ndarray, dt: str):
    return jnp.asarray(x).astype(JAX_DTYPES[dt])


def _bits(a) -> np.ndarray:
    """Monotone integer image of f32 values, so adjacent representable
    values differ by 1."""
    b = np.asarray(a, dtype=np.float32).view(np.int32).astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)


def _ulp_diff(a: torch.Tensor, b, dt: str) -> np.ndarray:
    """Distance in units of the last place of ``dt`` between finite values."""
    shift = 16 if dt == "bf16" else 0
    return np.abs(_bits(a.float().numpy()) - _bits(np.asarray(b, dtype=np.float32))) >> shift


# ---------------------------------------------------------------------------
# key map and network
# ---------------------------------------------------------------------------


def test_sort_keys_match_jax_bitwise():
    rng = np.random.default_rng(0)
    special = np.array(
        [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 1e-39, -1e-39,
         np.finfo(np.float32).max, np.finfo(np.float32).min, 1.0, -1.0],
        dtype=np.float32,
    )
    payload_nan = np.array([0x7FC00001, 0xFFC00000, 0x7F800001, 0xFF812345], dtype=np.uint32)
    random_bits = rng.integers(0, 2**32, size=8192, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([special, payload_nan.view(np.float32), random_bits.view(np.float32)])
    ours = kernels.float_sort_keys(torch.from_numpy(x)).numpy()
    ref = np.asarray(pk._float_sort_keys(jnp.asarray(x)))
    np.testing.assert_array_equal(ours, ref)
    back = kernels.keys_to_float(torch.from_numpy(ours)).numpy().view(np.uint32)
    ref_back = np.asarray(pk._keys_to_float(jnp.asarray(ref), jnp.float32)).view(np.uint32)
    np.testing.assert_array_equal(back, ref_back)


def test_batcher_pairs_identical():
    for n in range(1, 131):
        assert kernels.batcher_pairs(n) == pk.batcher_pairs(n), n


def test_network_width_covers_n():
    assert [kernels.network_width(n) for n in (1, 8, 9, 64, 65, 128)] == [8, 8, 16, 64, 128, 128]


# ---------------------------------------------------------------------------
# B1 sorted reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [3, 7, 8, 13])
def test_sorted_reduce_median_bitwise(n, dt):
    """Median: bitwise equal to the Pallas kernel (interpret mode) and, for
    f32, to ``jnp.median``; NaN columns, +-inf and -0.0 included."""
    x = _matrix(np.random.default_rng(n), (2, n, 300))
    ours = kernels.sorted_reduce_stream(_to_torch(x, dt), mode="median")
    ref = pk.sorted_reduce_stream_pallas(_to_jax(x, dt), mode="median", tile=128, interpret=True)
    ours_np = ours.float().numpy()
    ref_np = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(ours_np, ref_np)
    assert ours.dtype == TORCH_DTYPES[dt]
    if dt == "f32":
        med = np.asarray(jnp.median(jnp.asarray(x), axis=1))
        np.testing.assert_array_equal(ours_np, med)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [3, 7, 8, 13])
def test_sorted_reduce_trimmed_within_4_ulp(n, dt):
    """Trimmed mean: within 4 ulp of the Pallas kernel (the f32 sum may be
    taken in another order); non-finite results match exactly."""
    f = (n - 1) // 3
    x = _matrix(np.random.default_rng(100 + n), (2, n, 300))
    ours = kernels.sorted_reduce_stream(_to_torch(x, dt), mode="trimmed", f=f)
    ref = np.asarray(
        pk.sorted_reduce_stream_pallas(
            _to_jax(x, dt), mode="trimmed", f=f, tile=128, interpret=True
        ).astype(jnp.float32)
    )
    o = ours.float().numpy()
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(o), finite)
    np.testing.assert_array_equal(o[~finite], ref[~finite])
    assert _ulp_diff(ours[torch.from_numpy(finite)], ref[finite], dt).max() <= 4


# ---------------------------------------------------------------------------
# B3 Gram and B4 selection mean
# ---------------------------------------------------------------------------


def test_gram_plain_matches_pallas():
    """|G - G_ref| <= 1e-5 * |x_i| |x_j| (f32 sums in another order)."""
    x = _matrix(np.random.default_rng(3), (13, 300), specials=False)
    ours = kernels.gram(torch.from_numpy(x)[None])[0].numpy()
    ref = np.asarray(pk.gram_pallas(jnp.asarray(x), tile=128, interpret=True))
    norms = np.linalg.norm(x.astype(np.float64), axis=1)
    assert np.all(np.abs(ours - ref) <= 1e-5 * np.outer(norms, norms))


def _jax_selected(x: np.ndarray, *, f: int, q: int, mode: str, ref: int) -> np.ndarray:
    """The JAX package's selection (XLA scores + ``_nan_last_ranks``)."""
    xj = jnp.asarray(x)
    if mode == "krum":
        scores = jrobust.krum_scores(xj, f=f)
    elif mode == "cge":
        scores = jnp.diagonal(jrobust.gram_matrix(xj))
    else:
        scores = jrobust.pairwise_sq_dists(xj)[ref]
    return np.asarray(jrobust._nan_last_ranks(scores) < q)


@pytest.mark.parametrize("mode", ["krum", "cge", "monna"])
def test_selection_mean_plain_matches_pallas(mode):
    """Same selected rows as the JAX package, NaN row ranked last;
    aggregate within rtol 1e-6 of the Pallas kernel (interpret mode)."""
    n, f, q, ref_i = 13, 3, 5, 2
    x = _matrix(np.random.default_rng(7), (2, n, 300), specials=False)
    x[1, 4] = np.nan  # a NaN gradient must never be selected
    xt = torch.from_numpy(x)
    w = kernels.selection_weights(
        kernels.gram(xt), f=f, q=q, mode=mode, reference_index=ref_i
    )
    for k in range(2):
        np.testing.assert_array_equal(
            (w[k] > 0).numpy(), _jax_selected(x[k], f=f, q=q, mode=mode, ref=ref_i)
        )
    assert torch.all(w[w > 0] == float(np.float32(1.0 / q)))
    ours = kernels.selection_mean_stream(xt, f=f, q=q, mode=mode, reference_index=ref_i)
    ref = np.asarray(
        pk.selection_mean_stream_pallas(
            jnp.asarray(x), f=f, q=q, mode=mode, reference_index=ref_i,
            tile=128, interpret=True,
        )
    )
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_selection_mean_bf16_within_1_ulp():
    """bf16 in, bf16 out; the f32 sum rounds once to bf16, so a sum taken
    in another order may land one bf16 ulp away."""
    x = _matrix(np.random.default_rng(8), (1, 9, 200), specials=False)
    ours = kernels.selection_mean_stream(_to_torch(x, "bf16"), f=2, q=3)
    ref = pk.selection_mean_stream_pallas(_to_jax(x, "bf16"), f=2, q=3, tile=128, interpret=True)
    assert ours.dtype == torch.bfloat16
    assert _ulp_diff(ours, np.asarray(ref.astype(jnp.float32)), "bf16").max() <= 1


# ---------------------------------------------------------------------------
# B8 NNM, B9 NNM -> selection mean, B10 clip / ARC -> selection mean
# ---------------------------------------------------------------------------

# n -> (f of the pre-aggregator, f of Multi-Krum, q)
PRE_PARAMS = {3: (1, 0, 2), 8: (2, 2, 3), 13: (3, 3, 4)}
CLIP_TAU = 17.0  # near the median row norm of the data below: some rows clip
MANTISSA_BITS = {"bf16": 7, "f16": 10}


def _pre_rows(seed, n, dt, case="normal"):
    """(2, n, 300) rows with spread norms (every third row x5); ``case``
    adds a non-finite row: ``nan`` (one NaN entry), ``inf`` (an all-inf
    row) or ``overflow`` (a finite row whose squared norm overflows f32)."""
    x = _matrix(np.random.default_rng(seed), (2, n, 300), specials=False)
    x[:, ::3] *= 5.0
    if case == "nan":
        x[:, 1, 5] = np.nan
    elif case == "inf":
        x[:, 2] = np.inf
    elif case == "overflow":
        x[:, 2] = 1e20
    return x


def _assert_matches_pallas(ours: torch.Tensor, ref, dt: str) -> None:
    """Same NaN and inf places; finite values within rtol 1e-5, atol 1e-6
    in f32 (the reference's dots sum in another order), and in a 16-bit
    dtype within one of its ulps (one rounding of an f32 sum that may
    differ in its last bits) plus the same atol 1e-6 (a sum that cancels
    to near 0 keeps the f32 order's error)."""
    o = ours.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(o), np.isnan(r))
    np.testing.assert_array_equal(o[np.isinf(r)], r[np.isinf(r)])
    fin = np.isfinite(r)
    if dt == "f32":
        np.testing.assert_allclose(o[fin], r[fin], rtol=1e-5, atol=1e-6)
        return
    m = np.maximum(np.abs(o[fin]), np.abs(r[fin])).astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(m, 1e-30))) - MANTISSA_BITS[dt])
    assert np.all(np.abs(o[fin] - r[fin]) <= ulp + 1e-6)


def _run_pre_kernel(name, x, dt, n, mode="krum", tau=CLIP_TAU):
    """The port's composed wrapper and the Pallas kernel (interpret mode)
    on the same rows."""
    f_pre, f, q = PRE_PARAMS[n]
    xt, xj = _to_torch(x, dt), _to_jax(x, dt)
    sel = dict(f=f, q=q, mode=mode, reference_index=1)
    if name == "nnm":
        return (kernels.nnm_stream(xt, f=f_pre),
                pk.nnm_stream_pallas(xj, f=f_pre, tile=128, interpret=True))
    if name == "nnm_selection":
        return (kernels.nnm_selection_mean_stream(xt, f_nnm=f_pre, **sel),
                pk.nnm_selection_mean_stream_pallas(xj, f_nnm=f_pre, tile=128, interpret=True, **sel))
    if name == "clip":
        return (kernels.clip_selection_mean_stream(xt, tau=tau, **sel),
                pk.clip_selection_mean_stream_pallas(xj, tau=tau, tile=128, interpret=True, **sel))
    return (kernels.arc_selection_mean_stream(xt, f_arc=f_pre, **sel),
            pk.arc_selection_mean_stream_pallas(xj, f_arc=f_pre, tile=128, interpret=True, **sel))


PRE_KERNELS = ["nnm", "nnm_selection", "clip", "arc"]


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [3, 8, 13])
@pytest.mark.parametrize("name", PRE_KERNELS)
def test_pre_aggregated_plain_matches_pallas(name, n, dt):
    """B8, B9, B10-clip and B10-arc: the plain versions against the Pallas
    kernels in interpret mode, in the input dtype."""
    ours, ref = _run_pre_kernel(name, _pre_rows(n, n, dt), dt, n)
    assert ours.dtype == TORCH_DTYPES[dt]
    _assert_matches_pallas(ours, ref, dt)


@pytest.mark.parametrize("case", ["nan", "inf", "overflow"])
@pytest.mark.parametrize("name", PRE_KERNELS)
def test_pre_aggregated_nonfinite_rows_match_pallas(name, case):
    """The reference's non-finite rules, reproduced: a NaN or inf row, and
    a finite row whose squared norm overflows f32 (B10 excludes it, the
    documented deviation)."""
    ours, ref = _run_pre_kernel(name, _pre_rows(21, 13, "f32", case), "f32", 13)
    _assert_matches_pallas(ours, ref, "f32")


@pytest.mark.parametrize("mode", ["cge", "monna"])
@pytest.mark.parametrize("name", ["nnm_selection", "clip", "arc"])
def test_pre_aggregated_selection_modes_match_pallas(name, mode):
    """CGE and MoNNA scores behind each pre-aggregator. tau = 40 clips only
    the x5 rows: rows clipped to one norm tie in CGE up to rounding, and the
    q lowest must be rows that no clip touched."""
    ours, ref = _run_pre_kernel(name, _pre_rows(5, 13, "f32"), "f32", 13, mode=mode, tau=40.0)
    _assert_matches_pallas(ours, ref, "f32")


def _padded_gram(x: np.ndarray) -> np.ndarray:
    """The f32 Gram of one round, zero-padded to the Pallas kernels' row
    count (a multiple of 8)."""
    n = x.shape[0]
    n_pad = max(8, -(-n // 8) * 8)
    g = np.zeros((n_pad, n_pad), np.float32)
    with np.errstate(all="ignore"):
        g[:n, :n] = x.astype(np.float32) @ x.astype(np.float32).T
    return g


def _tie_rows(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    x = rng.normal(size=(13, 40)).astype(np.float32)
    if kind == "duplicates":
        x[5] = x[2]
        x[7] = x[2]
        x[9] = x[4]
    elif kind == "zeros":
        x[[1, 3, 8, 12]] = 0.0
    elif kind == "nonfinite":
        x[4, 0] = np.nan
        x[6] = np.inf
    elif kind == "all_equal":
        x[:] = x[0]
    return x


@pytest.mark.parametrize("k", [1, 6, 10, 13])
@pytest.mark.parametrize("kind", ["normal", "duplicates", "zeros", "nonfinite", "all_equal"])
def test_nnm_weights_equal_jax_selection_state(kind, k):
    """B8's selection state, exactly: the 0/1 mask and the taint flags of
    the JAX kernel's ``_nnm_weights`` from the same Gram, on inputs full
    of ties (duplicated and zero rows: stable ties in row order; NaN
    distances after every finite one)."""
    x = _tie_rows(kind)
    n = x.shape[0]
    g = _padded_gram(x)
    ref_mask, _, ref_st = pk._nnm_weights(jnp.asarray(g), n_pad=g.shape[0], n_real=n, k=k)
    mask, sel_taint = kernels.nnm_weights(torch.from_numpy(g[:n, :n].copy())[None], k=k)
    np.testing.assert_array_equal(mask[0].numpy(), np.asarray(ref_mask)[:n, :n])
    np.testing.assert_array_equal(sel_taint[0].numpy(), np.asarray(ref_st)[:n])
    assert torch.all(mask.sum(dim=1) <= k)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["nan", "inf"])
def test_mix_rows_plain_matches_the_reference_mixing(case, dt):
    """B8's mixing step alone, on a round with a non-finite row: the plain
    version, fed the reference's own selection state (``_nnm_weights`` of
    the same Gram: the mask clean of the tainted row and the taint of its
    selectors), against the Pallas kernel in interpret mode: NaN exactly
    where a mixer took the non-finite row, finite values within the f32
    rounding of the reference's HIGHEST dot (``_assert_matches_pallas``)."""
    n, f = 13, 3
    x = _pre_rows(31, n, dt, case)
    xt = _to_torch(x, dt)
    masks, taints = [], []
    for r in range(x.shape[0]):
        g = _padded_gram(xt[r].float().numpy())
        m, _, st = pk._nnm_weights(jnp.asarray(g), n_pad=g.shape[0], n_real=n, k=n - f)
        masks.append(np.asarray(m)[:n, :n])
        taints.append(np.asarray(st)[:n])
    mask, sel_taint = torch.from_numpy(np.stack(masks)), torch.from_numpy(np.stack(taints))
    assert bool(sel_taint.any())  # some mixer took the non-finite row
    ours = kernels.mix_rows_plain(xt, mask, sel_taint, k=n - f)
    ref = pk.nnm_stream_pallas(_to_jax(x, dt), f=f, tile=128, interpret=True)
    _assert_matches_pallas(ours, ref, dt)


def test_mix_rows_plain_ignores_an_unselected_nonfinite_row():
    """Under an arbitrary 0/1 mask that selects neither an all-inf row nor
    a row holding NaN, those rows change nothing: every output is finite,
    bit for bit the output with the two rows zeroed, and within f32
    rounding of the reference's mixing (``where(taint, 0, x)``, then a
    HIGHEST dot, / k)."""
    rng = np.random.default_rng(17)
    K, n, d, k = 2, 13, 300, 9
    x = _matrix(rng, (K, n, d), specials=False)
    clean = x.copy()
    x[:, 0] = np.inf
    x[:, 5, ::7] = np.nan
    clean[:, [0, 5]] = 0.0
    mask = (rng.random((K, n, n)) < 0.6).astype(np.float32)
    mask[:, [0, 5], :] = 0.0
    mt, st = torch.from_numpy(mask), torch.zeros((K, n))
    ours = kernels.mix_rows_plain(torch.from_numpy(x), mt, st, k=k)
    assert bool(torch.isfinite(ours).all())
    zeroed = kernels.mix_rows_plain(torch.from_numpy(clean), mt, st, k=k)
    assert torch.equal(ours.view(torch.int32), zeroed.view(torch.int32))
    taint = ~np.isfinite(x).all(axis=2)
    xz = jnp.where(jnp.asarray(taint)[:, :, None], 0.0, jnp.asarray(x))
    ref = jnp.einsum("kji,kjd->kid", jnp.asarray(mask), xz, precision="highest") / k
    _assert_matches_pallas(ours, ref, "f32")


@pytest.mark.parametrize("kind", ["duplicates", "zeros", "all_equal"])
def test_pre_aggregated_ties_match_pallas(kind):
    """Tie-heavy rows through every fused pipeline: the stable tie rules
    pick the same rows as the Pallas kernels (ARC's threshold among equal
    norms included)."""
    x = np.stack([_tie_rows(kind)] * 2)
    for name in PRE_KERNELS:
        ours, ref = _run_pre_kernel(name, x, "f32", 13)
        _assert_matches_pallas(ours, ref, "f32")


# ---------------------------------------------------------------------------
# B5 selection mean from a given Gram
# ---------------------------------------------------------------------------


def _b5_rows(kind: str, dt: str) -> np.ndarray:
    """(13, 300) rows: normal, tie-heavy (duplicated, zero or all-equal
    rows), an all-inf row, or one NaN entry."""
    if kind in ("duplicates", "zeros", "all_equal"):
        x = np.tile(_tie_rows(kind), (1, 8))[:, :300]
    else:
        x = _matrix(np.random.default_rng(40 + len(kind)), (13, 300), specials=False)
        x[::3] *= 5.0
    if kind == "inf":
        x[6] = np.inf
    elif kind == "nan":
        x[4, 17] = np.nan
    return np.asarray(_to_torch(x, dt).float())  # the dtype's values, in f32


def _b5_args(mode: str) -> dict:
    return {"krum": dict(f=3, q=5), "cge": dict(f=0, q=9), "monna": dict(f=0, q=9)}[mode]


def _pallas_weights(g: np.ndarray, n: int, *, f, q, mode, reference_index) -> np.ndarray:
    """The Pallas kernel's own first step (``_selection_scores`` then
    ``_selection_weights``) on the zero-padded f32 Gram."""
    gp = jnp.asarray(_padded_gram_of(g))
    scores = pk._selection_scores(gp, mode=mode, n_pad=gp.shape[0], n_real=n, f=f,
                                  reference_index=reference_index)
    return np.asarray(pk._selection_weights(scores, n_pad=gp.shape[0], n_real=n, q=q))[:n, 0]


def _padded_gram_of(g: np.ndarray) -> np.ndarray:
    n = g.shape[0]
    n_pad = max(8, -(-n // 8) * 8)
    out = np.zeros((n_pad, n_pad), np.float32)
    out[:n, :n] = g
    return out


B5_KINDS = ["normal", "duplicates", "zeros", "all_equal", "inf", "nan"]


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("kind", B5_KINDS)
@pytest.mark.parametrize("mode", ["krum", "cge", "monna"])
def test_selection_mean_from_gram_plain_matches_pallas(mode, kind, dt):
    """B5's plain version against ``selection_mean_from_gram_pallas`` in
    interpret mode on the same rows and Gram: the weights exactly equal to
    the Pallas kernel's first step (ties to the lower index, NaN scores
    last), the output within B4's tolerance (``_assert_matches_pallas``).
    A selected inf or NaN row (cge / monna take 9 of 13) poisons the output
    in both: the port's sweep reads ``w != 0``, the kernel's ``w > 0``,
    the same rows for weights of 1/q or 0."""
    x = _b5_rows(kind, dt)
    n = x.shape[0]
    with np.errstate(all="ignore"):
        g = (x @ x.T).astype(np.float32)
    sel = dict(_b5_args(mode), mode=mode, reference_index=2)
    w = kernels.selection_weights(torch.from_numpy(g)[None], **sel)[0]
    np.testing.assert_array_equal(w.numpy(), _pallas_weights(g, n, **sel))
    xt = _to_torch(x, dt)
    ours = kernels.selection_mean_from_gram(xt, torch.from_numpy(g), **sel)
    ref = pk.selection_mean_from_gram_pallas(_to_jax(x, dt), jnp.asarray(g), tile=128,
                                             interpret=True, **sel)
    assert ours.dtype == TORCH_DTYPES[dt] and ours.shape == (300,)
    np.testing.assert_array_equal(
        ours.float().numpy(), kernels.weighted_rows_plain(xt[None], w[None])[0].float().numpy())
    _assert_matches_pallas(ours, ref, dt)


def test_selection_mean_from_gram_takes_a_16_bit_gram_as_f32():
    """The Gram is read as f32, whatever its dtype, as the TPU kernel casts
    it."""
    x = torch.from_numpy(_b5_rows("normal", "f32"))
    g = x @ x.T
    a = kernels.selection_mean_from_gram(x, g.to(torch.bfloat16), f=3, q=5)
    b = kernels.selection_mean_from_gram(x, g.to(torch.bfloat16).float(), f=3, q=5)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the arrival-order fold primitives against the JAX package's
# ---------------------------------------------------------------------------


def _fold_gram(x: np.ndarray, order, dt: str):
    """The port's and the JAX package's Gram folds over the same rows in
    the same arrival order."""
    n, d = x.shape
    buf = torch.zeros((n, d), dtype=TORCH_DTYPES[dt])
    g = torch.zeros((n, n), dtype=torch.float32)
    jbuf = jnp.zeros((n, d), JAX_DTYPES[dt])
    jg = jnp.zeros((n, n), jnp.float32)
    for i in order:
        jbuf, jg = jrobust.gram_fold_update(jbuf, jg, _to_jax(x[i], dt), int(i))
        trobust.gram_fold_update(buf, g, _to_torch(x[i], dt), int(i))
    return buf, g, jbuf, jg


@pytest.mark.parametrize("pallas", ["auto", "1"], ids=["xla", "pallas"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gram_fold_and_multi_krum_from_gram_match_jax(dt, pallas, monkeypatch):
    """``gram_fold_update`` folded in a seeded arrival order against the
    JAX package's: the same staged rows, an f32 Gram (also for bf16 rows)
    within 1e-5 |x_i| |x_j|; ``multi_krum_from_gram`` against the JAX
    function on both of its CPU paths (XLA, and the Pallas kernel forced
    with ``BYZPY_TPU_PALLAS=1``) and against the barrier ``multi_krum``,
    within rtol 1e-5, atol 1e-6 (in bf16, one bf16 ulp more)."""
    monkeypatch.setenv("BYZPY_TPU_PALLAS", pallas)
    x = _matrix(np.random.default_rng(77), (11, 300), specials=False)
    x[::4] *= 3.0
    x = np.asarray(_to_torch(x, dt).float())
    order = np.random.default_rng(5).permutation(11)
    buf, g, jbuf, jg = _fold_gram(x, order, dt)
    assert g.dtype == torch.float32 and buf.dtype == TORCH_DTYPES[dt]
    np.testing.assert_array_equal(buf.float().numpy(), np.asarray(jbuf.astype(jnp.float32)))
    norms = np.linalg.norm(x.astype(np.float64), axis=1)
    bound = 1e-5 * np.outer(norms, norms)
    assert np.all(np.abs(g.numpy() - np.asarray(jg)) <= bound)
    assert np.all(np.abs(g.numpy() - x.astype(np.float64) @ x.T.astype(np.float64)) <= bound)
    ours = trobust.multi_krum_from_gram(buf, g, f=2, q=4)
    ref = jrobust.multi_krum_from_gram(jbuf, jg, f=2, q=4)
    barrier = trobust.multi_krum(buf, f=2, q=4)
    assert ours.dtype == TORCH_DTYPES[dt]
    _assert_matches_pallas(ours, ref, dt)
    _assert_matches_pallas(ours, jnp.asarray(barrier.float().numpy()), dt)


def test_krum_scores_from_gram_match_jax():
    """Within rtol 1e-5 of the JAX function (f32 sums in another order) and
    of ``krum_scores`` on the rows themselves."""
    x = _matrix(np.random.default_rng(78), (10, 200), specials=False)
    g = x @ x.T
    ours = trobust.krum_scores_from_gram(torch.from_numpy(g), f=3).numpy()
    np.testing.assert_allclose(ours, np.asarray(jrobust.krum_scores_from_gram(jnp.asarray(g), f=3)),
                               rtol=1e-5)
    np.testing.assert_allclose(ours, trobust.krum_scores(torch.from_numpy(x), f=3).numpy(), rtol=1e-5)
    with pytest.raises(ValueError) as a:
        trobust.krum_scores_from_gram(torch.from_numpy(g), f=9)
    with pytest.raises(ValueError) as b:
        jrobust.krum_scores_from_gram(jnp.asarray(g), f=9)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("f", [0, 1, 3])
def test_extremes_fold_and_trimmed_mean_from_extremes_match_jax(f):
    """The extreme buffers folded in place equal the JAX package's (the
    same sort of f + 1 values per coordinate); the trimmed mean from them
    within 4 ulp of the JAX function's."""
    n = 2 * f + 3
    x = _matrix(np.random.default_rng(79 + f), (n, 150), specials=False)
    low = torch.full((f, 150), float("inf"))
    high = torch.full((f, 150), float("-inf"))
    jlow, jhigh = jnp.full((f, 150), jnp.inf), jnp.full((f, 150), -jnp.inf)
    total = torch.from_numpy(x[0]).clone()
    for i in range(n):
        if i:
            trobust.fold_add(total, torch.from_numpy(x[i]))
        assert trobust.extremes_fold_update(low, torch.from_numpy(x[i]), largest=False) is low
        trobust.extremes_fold_update(high, torch.from_numpy(x[i]), largest=True)
        jlow = jrobust.extremes_fold_update(jlow, jnp.asarray(x[i]), largest=False)
        jhigh = jrobust.extremes_fold_update(jhigh, jnp.asarray(x[i]), largest=True)
    np.testing.assert_array_equal(low.numpy(), np.asarray(jlow))
    np.testing.assert_array_equal(high.numpy(), np.asarray(jhigh))
    ours = trobust.trimmed_mean_from_extremes(total, low, high, n, f=f)
    jtotal = jnp.asarray(x[0])
    for i in range(1, n):
        jtotal = jtotal + jnp.asarray(x[i])
    ref = np.asarray(jrobust.trimmed_mean_from_extremes(jtotal, jlow, jhigh, n, f=f))
    assert _ulp_diff(ours, ref, "f32").max() <= 4
    with pytest.raises(ValueError, match="0 <= 2f < n"):
        trobust.trimmed_mean_from_extremes(total, low, high, 2 * f, f=f)


def test_weighted_rows_reads_nan_weights():
    """The sweep reads every row whose weight is not 0: a NaN weight
    poisons every column (B9 and B10 write all-NaN weights when a
    non-finite row was selected); 0-weight rows, NaN data included, are
    never read."""
    x = torch.from_numpy(_matrix(np.random.default_rng(2), (1, 5, 64), specials=False))
    x[0, 3] = float("nan")
    w = torch.tensor([[0.5, 0.0, 0.5, 0.0, 0.0]])
    assert torch.isfinite(kernels.weighted_rows(x, w)).all()
    w_nan = torch.full((1, 5), float("nan"))
    out = kernels.weighted_rows(x, w_nan)
    assert torch.isnan(out).all()
    assert np.all(out.numpy().view(np.uint32) == 0x7FC00000)


# ---------------------------------------------------------------------------
# B6 MeaMed
# ---------------------------------------------------------------------------


def _meamed_inputs(seed, n, K=2, d=300):
    """Normal columns with NaN / +-inf / -0 specials; columns from 8 on are
    quantized to halves, so deviations tie at the cut (equal deviations
    with different values among them: med - r and med + r)."""
    x = _matrix(np.random.default_rng(seed), (K, n, d))
    x[..., 8:] = np.round(x[..., 8:] * 2.0) / 2.0
    return x


CANONICAL_NAN = {torch.float32: (torch.int32, 0x7FC00000), torch.bfloat16: (torch.int16, 0x7FC0),
                 torch.float16: (torch.int16, 0x7E00)}


def _nan_is_canonical(t: torch.Tensor) -> bool:
    """Every NaN of ``t`` is the positive quiet NaN of its dtype (read in
    the dtype: PyTorch's CPU f16 -> f32 cast changes NaN bits)."""
    ints, bits = CANONICAL_NAN[t.dtype]
    return bool((t[torch.isnan(t)].view(ints) == bits).all())


def _assert_bitwise(ours: torch.Tensor, ref) -> None:
    """NaN at the same places, the same f32 bits everywhere else. The port
    writes every NaN as the canonical quiet NaN; the reference keeps what
    its arithmetic gave (``inf + -inf`` in a sum is a negative NaN)."""
    o = ours.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(o), np.isnan(r))
    assert _nan_is_canonical(ours)
    keep = ~np.isnan(r)
    np.testing.assert_array_equal(o[keep].view(np.uint32), r[keep].view(np.uint32))


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [3, 8, 13])
def test_meamed_plain_bitwise_equals_pallas(n, dt):
    """B6's plain version against the Pallas kernel in interpret mode,
    bitwise, at f = 0, n // 4 and n - 1 on K = 2 rounds: the same key sort,
    median, window cut and node-order tie fill, the selected values added
    in node order and multiplied by the f32 reciprocal of k (the
    reference's division by a constant compiles to that)."""
    x = _meamed_inputs(500 + n, n)
    for f in sorted({0, n // 4, n - 1}):
        ours = kernels.meamed_stream(_to_torch(x, dt), f=f)
        ref = pk.meamed_stream_pallas(_to_jax(x, dt), f=f, tile=128, interpret=True)
        assert ours.dtype == TORCH_DTYPES[dt]
        _assert_bitwise(ours, ref)


def test_meamed_plain_stable_ties_match_pallas():
    """The reference's own tie test inputs (test_pallas_kernels.py): random
    n and f, values quantized to halves; bitwise."""
    rng = np.random.default_rng(11)
    for _ in range(10):
        n = int(rng.integers(5, 14))
        f = int(rng.integers(0, n))
        x = (np.round(rng.normal(size=(n, 256)) * 2) / 2).astype(np.float32)
        ours = kernels.meamed_stream(torch.from_numpy(x)[None], f=f)
        _assert_bitwise(ours, pk.meamed_stream_pallas(jnp.asarray(x)[None], f=f, tile=128, interpret=True))


def _nonfinite_median_columns():
    """(12, 8) columns whose median is not finite or whose deviations are
    NaN: a majority of +inf, -inf and +inf in the middle (NaN median),
    inf rows with finite ones, a NaN entry, all -inf."""
    x = np.random.default_rng(3).normal(size=(12, 8)).astype(np.float32)
    x[:7, 0] = np.inf
    x[:6, 1] = -np.inf
    x[6:, 1] = np.inf
    x[[2, 9], 2] = np.inf
    x[4, 3] = np.nan
    x[:, 4] = -np.inf
    x[:11, 5] = np.inf
    x[3, 6] = -np.inf
    x[::2, 7] = 3e38
    return x


@pytest.mark.parametrize("f", [0, 3, 5, 11])
def test_meamed_plain_nonfinite_medians_match_pallas(f):
    """Non-finite medians (the cut is inf when at least k deviations are
    not NaN, NaN otherwise), NaN columns, and a median of 3e38 and a
    normal value, bitwise."""
    x = _nonfinite_median_columns()[None]
    _assert_bitwise(kernels.meamed_stream(torch.from_numpy(x), f=f),
                    pk.meamed_stream_pallas(jnp.asarray(x), f=f, tile=128, interpret=True))


def test_meamed_median_near_flt_max_keeps_the_halves():
    """At even n the median is 0.5 a + 0.5 b, so two near-FLT_MAX middle
    values give a finite median (pallas_kernels.py:649-653). The
    reference's intent, computed in numpy: median 3.1e38, the k = 1
    closest value 3e38 (ties at the cut in node order). Under jit, XLA on
    the CPU rewrites the reference's 0.5 a + 0.5 b into 0.5 (a + b), which
    overflows to inf and selects 2e38 instead; the port keeps the halves
    (ROADMAP.md section C)."""
    big = np.array([[2e38], [3e38], [3.2e38], [3.3e38]], np.float32)
    med = np.float32(0.5) * big[1, 0] + np.float32(0.5) * big[2, 0]
    assert np.isfinite(med)
    ours = kernels.meamed_stream(torch.from_numpy(big)[None], f=3)
    np.testing.assert_array_equal(ours.numpy(), np.full((1, 1), 3e38, np.float32))
    odd = np.full((3, 4), 3e38, np.float32)
    np.testing.assert_array_equal(kernels.meamed_stream(torch.from_numpy(odd)[None], f=2).numpy(),
                                  np.full((1, 4), 3e38, np.float32))


# ---------------------------------------------------------------------------
# B7 weighted centre step
# ---------------------------------------------------------------------------


def _center_inputs(seed, n, case="normal", d=300):
    """Rows at two scales (every third x5) and their coordinate median as
    the centre; ``case`` adds an all-inf row or one NaN entry."""
    x = _matrix(np.random.default_rng(seed), (n, d), specials=False)
    x[::3] *= 5.0
    z = np.median(x, axis=0).astype(np.float32)
    if case == "inf":
        x[2] = np.inf
    elif case == "nan":
        x[1, 7] = np.nan
    return x, z


@pytest.mark.parametrize("case", ["normal", "inf", "nan"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("mode", ["weiszfeld", "clip"])
def test_center_step_plain_matches_pallas(mode, dt, case):
    """B7's plain step against the Pallas kernel in interpret mode: finite
    values within f32 rounding (rtol 1e-5, atol 1e-6; one ulp in a 16-bit
    dtype); an all-inf row (weight 0, 0 * inf) or a NaN entry makes the
    whole step NaN in both. c_tau = 30 clips the x5 rows only."""
    x, z = _center_inputs(600 + len(case), 13, case)
    kw = dict(mode=mode, c_tau=30.0)
    ours = kernels.weighted_center_step(_to_torch(x, dt), _to_torch(z, dt), **kw)
    ref = pk.weighted_center_step_pallas(_to_jax(x, dt), _to_jax(z, dt), interpret=True, **kw)
    assert ours.dtype == TORCH_DTYPES[dt]
    if case != "normal":
        assert torch.isnan(ours).all() and _nan_is_canonical(ours)
    _assert_matches_pallas(ours, ref, dt)


def test_center_weights_clip_some_rows():
    """The clip weights are min(1, c_tau / dist) / n and alpha = 1 - sum w:
    at c_tau = 30 the x5 rows clip and the others keep 1/n."""
    x, z = _center_inputs(7, 13)
    w, alpha = kernels.center_weights(torch.from_numpy(x), torch.from_numpy(z), mode="clip", c_tau=30.0)
    full = w == w.max()
    assert int(full.sum()) == 8 and float(w.max()) == float(np.float32(1.0) * np.float32(1 / 13))
    assert abs(float(alpha) - (1.0 - float(w.double().sum()))) < 1e-6


def test_center_sweep_reads_zero_weight_rows():
    """Every row enters the sweep: a weight-0 inf row gives 0 * inf = NaN
    (B4's sweep skips it)."""
    x = np.ones((4, 6), np.float32)
    x[2] = np.inf
    w = torch.tensor([0.5, 0.5, 0.0, 0.0])
    out = kernels.center_sweep(torch.from_numpy(x), torch.zeros(6), w, torch.zeros(1))
    assert torch.isnan(out).all()
    assert torch.isfinite(kernels.weighted_rows(torch.from_numpy(x)[None], w[None])).all()


# ---------------------------------------------------------------------------
# input checks
# ---------------------------------------------------------------------------

SORT_BAD = [
    dict(mode="mean"),
    dict(mode="trimmed", f=2),
    dict(mode="trimmed", f=-1),
]
SELECT_BAD = [
    dict(f=1, q=1, mode="mean"),
    dict(f=3, q=1, mode="krum"),
    dict(f=1, q=4, mode="krum"),
    dict(f=0, q=0, mode="cge"),
    dict(f=0, q=5, mode="cge"),
    dict(f=0, q=1, mode="monna", reference_index=4),
    dict(f=0, q=1, mode="monna", reference_index=-1),
]


PRE_BAD = [
    ("nnm", dict(f=4)),
    ("nnm", dict(f=-1)),
    ("nnm_selection", dict(f_nnm=4, f=1, q=2)),
    ("nnm_selection", dict(f_nnm=1, f=3, q=1)),
    ("nnm_selection", dict(f_nnm=1, f=1, q=2, mode="mean")),
    ("nnm_selection", dict(f_nnm=1, f=0, q=1, mode="monna", reference_index=4)),
    ("clip", dict(tau=0.0, f=1, q=2)),
    ("clip", dict(tau=-1.0, f=1, q=2)),
    ("clip", dict(tau=1.0, f=1, q=4)),
    ("clip", dict(tau=1.0, f=0, q=0, mode="cge")),
    ("arc", dict(f_arc=5, f=1, q=2)),
    ("arc", dict(f_arc=-1, f=1, q=2)),
    ("arc", dict(f_arc=1, f=3, q=1)),
]
PRE_CALLS = {
    "nnm": (kernels.nnm_stream, pk.nnm_stream_pallas),
    "nnm_selection": (kernels.nnm_selection_mean_stream, pk.nnm_selection_mean_stream_pallas),
    "clip": (kernels.clip_selection_mean_stream, pk.clip_selection_mean_stream_pallas),
    "arc": (kernels.arc_selection_mean_stream, pk.arc_selection_mean_stream_pallas),
}


@pytest.mark.parametrize("name,kw", PRE_BAD)
def test_pre_aggregated_errors_match_jax(name, kw):
    x = np.zeros((1, 4, 16), np.float32)
    ours_fn, ref_fn = PRE_CALLS[name]
    with pytest.raises(ValueError) as ours:
        ours_fn(torch.from_numpy(x), **kw)
    with pytest.raises(ValueError) as ref:
        ref_fn(jnp.asarray(x), interpret=True, **kw)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("f", [-1, 4, 7])
def test_meamed_errors_match_jax(f):
    x = np.zeros((1, 4, 16), np.float32)
    with pytest.raises(ValueError) as ours:
        kernels.meamed_stream(torch.from_numpy(x), f=f)
    with pytest.raises(ValueError) as ref:
        pk.meamed_stream_pallas(jnp.asarray(x), f=f, interpret=True)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("call", [dict(mode="median"), dict(z_len=15), dict(z_len=17)])
def test_center_step_errors_match_jax(call):
    x = np.zeros((4, 16), np.float32)
    z = np.zeros((call.get("z_len", 16),), np.float32)
    mode = call.get("mode", "clip")
    with pytest.raises(ValueError) as ours:
        kernels.weighted_center_step(torch.from_numpy(x), torch.from_numpy(z), mode=mode)
    with pytest.raises(ValueError) as ref:
        pk.weighted_center_step_pallas(jnp.asarray(x), jnp.asarray(z), mode=mode, interpret=True)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("kw", SORT_BAD)
def test_sorted_reduce_errors_match_jax(kw):
    x = np.zeros((1, 4, 16), np.float32)
    with pytest.raises(ValueError) as ours:
        kernels.sorted_reduce_stream(torch.from_numpy(x), **kw)
    with pytest.raises(ValueError) as ref:
        pk.sorted_reduce_stream_pallas(jnp.asarray(x), interpret=True, **kw)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("kw", SELECT_BAD)
def test_selection_errors_match_jax(kw):
    x = np.zeros((1, 4, 16), np.float32)
    with pytest.raises(ValueError) as ours:
        kernels.selection_mean_stream(torch.from_numpy(x), **kw)
    with pytest.raises(ValueError) as ref:
        pk.selection_mean_stream_pallas(jnp.asarray(x), interpret=True, **kw)
    assert str(ours.value) == str(ref.value)


FROM_GRAM_BAD = SELECT_BAD + [dict(f=1, q=1, mode="krum", gram_n=5)]


@pytest.mark.parametrize("kw", FROM_GRAM_BAD)
def test_selection_from_gram_errors_match_jax(kw):
    kw = dict(kw)
    n = kw.pop("gram_n", 4)
    x = np.zeros((4, 16), np.float32)
    g = np.zeros((n, n), np.float32)
    with pytest.raises(ValueError) as ours:
        kernels.selection_mean_from_gram(torch.from_numpy(x), torch.from_numpy(g), **kw)
    with pytest.raises(ValueError) as plain:
        kernels.selection_mean_from_gram_plain(torch.from_numpy(x), torch.from_numpy(g), **kw)
    with pytest.raises(ValueError) as ref:
        pk.selection_mean_from_gram_pallas(jnp.asarray(x), jnp.asarray(g), interpret=True, **kw)
    assert str(ours.value) == str(ref.value) == str(plain.value)


def test_unsupported_dtype_raises_in_both():
    x = np.zeros((1, 4, 16), np.int32)
    with pytest.raises(ValueError, match="unsupported dtype"):
        kernels.sorted_reduce_stream(torch.from_numpy(x))
    with pytest.raises(ValueError, match="unsupported dtype"):
        pk.sorted_reduce_stream_pallas(jnp.asarray(x), interpret=True)
    with pytest.raises(ValueError, match="unsupported dtype"):
        kernels.selection_mean_stream(torch.from_numpy(x), f=0, q=1)
    with pytest.raises(ValueError, match="unsupported dtype"):
        kernels.gram(torch.from_numpy(x))
    with pytest.raises(ValueError, match="unsupported dtype"):
        kernels.meamed_stream(torch.from_numpy(x), f=1)
    with pytest.raises(ValueError, match="unsupported dtype"):
        kernels.weighted_center_step(torch.from_numpy(x[0]), torch.from_numpy(x[0, 0]))


# ---------------------------------------------------------------------------
# the loader: raises without nvcc, never reached from CPU tensors
# ---------------------------------------------------------------------------


def test_loader_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "_libs", {})
    for name in _build.SOURCES:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(name)


def test_cpu_tensors_never_reach_the_loader(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA loader")

    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "function", boom)
    kernels.reset_launch_counts()
    x = torch.from_numpy(_matrix(np.random.default_rng(1), (2, 9, 64), specials=False))
    kernels.sorted_reduce_stream(x, mode="median")
    kernels.sorted_reduce_stream(x, mode="trimmed", f=2)
    g = kernels.gram(x)
    for mode in ("krum", "cge", "monna"):
        kernels.selection_mean_stream(x, f=2, q=3, mode=mode)
    kernels.weighted_rows(x, kernels.selection_weights(g, f=2, q=3))
    kernels.selection_mean_from_gram(x[0], g[0], f=2, q=3)
    kernels.nnm_stream(x, f=2)
    kernels.nnm_selection_mean_stream(x, f_nnm=2, f=2, q=3)
    kernels.clip_selection_mean_stream(x, tau=5.0, f=2, q=3)
    kernels.arc_selection_mean_stream(x, f_arc=2, f=2, q=3)
    kernels.meamed_stream(x, f=2)
    for mode in ("weiszfeld", "clip"):
        kernels.weighted_center_step(x[0], x[0, 0], mode=mode)
    kernels.sort_columns(x[0])
    kernels.segment_sum(x[0], torch.ones((2, 9)), fill=torch.tensor([4], dtype=torch.int32))
    kernels.row_sq_dists(x[0], x[0, 1])
    assert all(v == 0 for v in kernels.launch_counts.values())


def test_unknown_device_mix_raises():
    x = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.weighted_rows(x, torch.zeros((1, 4), device="meta"))


# ---------------------------------------------------------------------------
# B11 segment sum, B2 column sort and the row reduction beside B11
# ---------------------------------------------------------------------------


def _assert_row_chain(out: np.ndarray, ref: np.ndarray) -> None:
    """``out`` (the port's row chain) against an XLA:CPU row einsum of the
    same inputs: bit for bit on the columns XLA vectorizes, 8 wide; within
    2 ulp on the last ``d mod 8``, which XLA sums in a loop of its own."""
    d = out.shape[-1]
    cut = d - d % 8
    np.testing.assert_array_equal(out[..., :cut].view(np.uint32), ref[..., :cut].view(np.uint32))
    assert (np.abs(_bits(out[..., cut:]) - _bits(ref[..., cut:])) <= 2).all()


def test_fma_f32_rounds_once():
    """``fma_f32`` is ``a * b + c`` rounded once: exact against rational
    arithmetic on random values and on three values whose f64 sum lands
    exactly halfway between two f32 values (where a plain f64 emulation
    rounds twice and misses by one ulp)."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.normal(size=2000).astype(np.float32)
    b = rng.normal(size=2000).astype(np.float32)
    c = (rng.normal(size=2000) * 1e-3).astype(np.float32)
    e = 2.0 ** -20
    a = np.concatenate([a, np.float32([1 + e, 1 + e, -(1 + e)])])
    b = np.concatenate([b, np.float32([2 ** -24 - 2 ** -44, 2 ** -24 + 2 ** -44, 2 ** -24 - 2 ** -44])])
    c = np.concatenate([c, np.float32([1 + 2 ** -23, 1 + 2 ** -23, -(1 + 2 ** -23)])])
    out = kernels.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        got = Fraction(float(out[i]))
        up, down = np.nextafter(out[i], np.float32(np.inf)), np.nextafter(out[i], np.float32(-np.inf))
        # the nearest f32 to the exact value (ties to even never occur here)
        assert abs(got - exact) <= abs(Fraction(float(up)) - exact), i
        assert abs(got - exact) <= abs(Fraction(float(down)) - exact), i
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert not np.array_equal(out[-3:], naive[-3:])


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("R,d", [(8, 421), (13, 193), (16, 1000), (64, 4099)])
def test_segment_sum_plain_matches_einsum_and_pallas_bitwise(R, d, C):
    """The plain B11 (an FMA chain over rows in index order) equals, bit
    for bit, the Pallas kernel in interpret mode (one row tile: R <= 256)
    and each cohort's row einsum ``einsum("n,nd->d")``, the masked
    family's form, on every column XLA:CPU vectorizes (the first 8 floor(d
    / 8)); XLA computes the last d mod 8 columns in a loop of its own that
    differs from the chain by an ulp now and then (``_assert_row_chain``).
    XLA:CPU's ``einsum("cr,rd->cd")`` is the chain too at C = 1 and at
    small sizes; as a matrix product at C > 1 and R x d >= 32 x 4099 it
    sums in another order, so there it is held to the recursive-summation
    bound R u sum_r |w_r x_r| (u = 2^-24)."""
    rng = np.random.default_rng(R * 7 + C)
    x = (rng.normal(size=(R, d)) * rng.uniform(0.1, 50.0, size=(R, 1))).astype(np.float32)
    w = rng.normal(size=(C, R)).astype(np.float32)
    out = kernels.segment_sum(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    pal = np.asarray(pk.ragged_segment_sum_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(out.view(np.uint32), pal.view(np.uint32))
    for c in range(C):
        _assert_row_chain(out[c], np.asarray(jnp.einsum("n,nd->d", jnp.asarray(w[c]), jnp.asarray(x))))
    ref = np.asarray(jnp.einsum("cr,rd->cd", jnp.asarray(w), jnp.asarray(x)))
    if C == 1 or R * d < 32 * 4099:
        for c in range(C):
            _assert_row_chain(out[c], ref[c])
    bound = R * 2.0 ** -24 * (np.abs(w).astype(np.float64) @ np.abs(x))
    assert (np.abs(out.astype(np.float64) - ref) <= bound).all()


@pytest.mark.parametrize("C", [5, 9, 17])
@pytest.mark.parametrize("R,d", [(8, 421), (13, 193), (16, 1000), (64, 4099)])
def test_segment_sum_plain_matches_pallas_bitwise_at_many_cohorts(R, d, C):
    """The plain B11 at cohort counts past one tile of 4 (5, 9) and of 16
    (17) equals the Pallas kernel in interpret mode bit for bit, and each
    cohort's row einsum on the columns XLA:CPU vectorizes. XLA's own loop
    over the last d mod 8 columns is held to the recursive-summation bound
    here (it differs from the chain by up to 4 ulp on these inputs, where
    the sums cancel), as is the matrix-product einsum on every column."""
    rng = np.random.default_rng(R * 7 + C)
    x = (rng.normal(size=(R, d)) * rng.uniform(0.1, 50.0, size=(R, 1))).astype(np.float32)
    w = rng.normal(size=(C, R)).astype(np.float32)
    out = kernels.segment_sum(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    pal = np.asarray(pk.ragged_segment_sum_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(out.view(np.uint32), pal.view(np.uint32))
    bound = R * 2.0 ** -24 * (np.abs(w).astype(np.float64) @ np.abs(x))
    cut = d - d % 8
    for c in range(C):
        row = np.asarray(jnp.einsum("n,nd->d", jnp.asarray(w[c]), jnp.asarray(x)))
        np.testing.assert_array_equal(out[c, :cut].view(np.uint32), row[:cut].view(np.uint32))
        assert (np.abs(out[c].astype(np.float64) - row) <= bound[c]).all()
    ref = np.asarray(jnp.einsum("cr,rd->cd", jnp.asarray(w), jnp.asarray(x)))
    assert (np.abs(out.astype(np.float64) - ref) <= bound).all()


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("C", [1, 3, 5, 9, 17])
def test_segment_sum_fill_matches_pallas_bitwise(C, as_tensor):
    """``fill`` < R with zero rows and zero weights past it: the rows past
    the fill are not read (they hold NaN here), and the result equals the
    Pallas kernel given the same fill, and the full sum, bit for bit. (The
    Pallas kernel is one chain only within one row tile: it adds each
    tile's sum to the output, so the comparison keeps its default single
    tile.)"""
    rng = np.random.default_rng(C)
    R, d, fill = 24, 700, 11
    x = rng.normal(size=(R, d)).astype(np.float32)
    w = rng.normal(size=(C, R)).astype(np.float32)
    x[fill:], w[:, fill:] = 0.0, 0.0
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    # garbage past the fill is never read
    xg = xt.clone()
    xg[fill:] = float("nan")
    f = torch.tensor([fill], dtype=torch.int32) if as_tensor else fill
    out = kernels.segment_sum(xg, wt, fill=f).numpy()
    pal = np.asarray(pk.ragged_segment_sum_pallas(
        jnp.asarray(x), jnp.asarray(w), fill=jnp.asarray([fill], jnp.int32), interpret=True))
    np.testing.assert_array_equal(out.view(np.uint32), pal.view(np.uint32))
    full = kernels.segment_sum(xt, wt).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), full.view(np.uint32))


@pytest.mark.parametrize("dt", ["bf16", "f16"])
def test_segment_sum_16bit_matches_pallas_bitwise(dt):
    """16-bit rows upcast exactly, accumulate in f32 and round once to the
    row dtype, as the Pallas kernel does; NaN and inf rows included."""
    rng = np.random.default_rng(5)
    x = _matrix(rng, (12, 300))
    w = rng.normal(size=(2, 12)).astype(np.float32)
    out = kernels.segment_sum(_to_torch(x, dt), torch.from_numpy(w))
    pal = pk.ragged_segment_sum_pallas(_to_jax(x, dt), jnp.asarray(w), interpret=True)
    ref = np.asarray(pal.astype(jnp.float32))
    got = out.float().numpy()
    assert out.dtype == TORCH_DTYPES[dt]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_array_equal(got[ok], ref[ok])


def test_segment_sum_appended_zero_rows_keep_the_bits():
    """The padding contract: zero rows (or zero weights) appended after the
    last row leave every output bit as it was."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.normal(size=(13, 777)) * 30).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(2, 13)).astype(np.float32))
    out = kernels.segment_sum(x, w)
    xp = torch.cat([x, torch.zeros((51, 777))])
    wp = torch.cat([w, torch.zeros((2, 51))], dim=1)
    assert torch.equal(kernels.segment_sum(xp, wp).view(torch.int32), out.view(torch.int32))


def test_segment_sum_checks_its_inputs():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="float32"):
        kernels.segment_sum(x, torch.zeros((1, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(C, 4\)"):
        kernels.segment_sum(x, torch.zeros((1, 5)))
    with pytest.raises(ValueError, match="int32"):
        kernels.segment_sum(x, torch.zeros((1, 4)), fill=torch.tensor([2]))


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [1, 5, 8, 13, 64, 128])
def test_sort_columns_plain_matches_pallas_bitwise(n, dt):
    """The plain B2 equals ``sort_columns(..., interpret=True)`` bit for
    bit on columns holding NaN, +-inf and +-0 (the key sort: -0.0 before
    +0.0, NaN canonical), and ``robust.sort_rows`` takes it."""
    x = _matrix(np.random.default_rng(n), (max(n, 6), 257))[:n]
    if n > 3:
        x[2:4, 6] = [0.0, -0.0]
    out = kernels.sort_columns(_to_torch(x, dt))
    ref = pk.sort_columns(_to_jax(x, dt), interpret=True)
    ints, np_ints = (torch.int32, np.int32) if dt == "f32" else (torch.int16, np.int16)
    np.testing.assert_array_equal(out.view(ints).numpy(), np.asarray(ref).view(np_ints))
    assert torch.equal(trobust.sort_rows(_to_torch(x, dt)).view(ints), out.view(ints))


def test_row_sq_dists_is_padding_stable_and_close_to_f64():
    """The row reduction: each row's value does not depend on how many rows
    the matrix has (bit for bit), and it is the f64 sum within f32
    rounding (rtol 1e-6)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.normal(size=(13, 9000)) * rng.uniform(0.1, 50, (13, 1))).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=9000).astype(np.float32))
    for zz in (None, z):
        out = kernels.row_sq_dists(x, zz)
        padded = kernels.row_sq_dists(torch.cat([x, torch.zeros((19, 9000))]), zz)[:13]
        assert torch.equal(out.view(torch.int32), padded.view(torch.int32))
        v = x.double() - (0 if zz is None else zz.double())
        np.testing.assert_allclose(out.numpy(), (v * v).sum(1).numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="z must be"):
        kernels.row_sq_dists(x, z[:10])
