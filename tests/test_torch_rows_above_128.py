"""More than 128 rows: the port's counterparts of the reference's XLA
branches against the JAX package, on the CPU, same numpy inputs.

Above ``kernels.MAX_NETWORK_ROWS`` the reference leaves every aggregator
to XLA (``use_pallas_for``) and the port takes its PyTorch counterpart on
any device (``ops/robust.py``, "Above the networks"). Exact where the
reference value does not depend on summation order (sorts, medians, the
selected rows); the row contractions are the same FMA chain in both (B11's
plain version against XLA:CPU's row einsum, ``d`` a multiple of 8), so the
median and the selection means are exact too. The trimmed mean and MeaMed
contract with a vector of ones, which XLA rewrites into a reduction of
its own order: within ``rtol=1e-5`` / ``atol=1e-6``. The Gram and
NNM's mixing product are BLAS products in both packages, summed in other
orders: f32 within ``rtol=1e-5``; the iterative aggregators within
``rtol=1e-5`` / ``atol=1e-6``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.ops import preagg as jpreagg
from byzpy_tpu.ops import ragged as jragged
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu_torch.ops import kernels, preagg, robust
from byzpy_tpu_torch.ops import ragged as ragged_ops

ROWS = (129, 196, 256)
D = 64


def _x(n, seed=0):
    x = np.random.default_rng(seed + n).normal(size=(n, D)).astype(np.float32)
    x[: n // 10] *= 8.0  # a tail of large rows for the selections to drop
    return x


@pytest.fixture(autouse=True)
def _no_network(monkeypatch, request):
    """Above 128 rows no network wrapper may be reached (the f16 test runs
    at 12 rows too, where the networks' plain versions serve)."""
    if request.node.name.startswith("test_f16"):
        return

    def refuse(name):
        def wrapper(*args, **kwargs):
            raise AssertionError(f"{name} reached above the networks")
        return wrapper

    for name in ("sorted_reduce_stream", "sort_columns", "gram", "meamed_stream",
                 "selection_mean_stream", "selection_mean_from_gram", "weighted_rows",
                 "center_loop", "nnm_stream", "nnm_selection_mean_stream",
                 "clip_selection_mean_stream", "arc_selection_mean_stream"):
        monkeypatch.setattr(kernels, name, refuse(name))


def _exact(ours, ref):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _close(ours, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=rtol, atol=atol, equal_nan=True)


def test_gate_is_the_network_width():
    assert kernels.use_kernel_for(kernels.MAX_NETWORK_ROWS)
    assert not kernels.use_kernel_for(kernels.MAX_NETWORK_ROWS + 1)


EXACT = {
    "sort_rows": (robust.sort_rows, jrobust.sort_rows),
    "median": (robust.coordinate_median, jrobust.coordinate_median),
    "cge": (functools.partial(robust.cge, f=20), functools.partial(jrobust.cge, f=20)),
    "monna": (functools.partial(robust.monna, f=20, reference_index=3),
              functools.partial(jrobust.monna, f=20, reference_index=3)),
    "multi_krum": (functools.partial(robust.multi_krum, f=20, q=40),
                   functools.partial(jrobust.multi_krum, f=20, q=40)),
    "clipped_multi_krum": (functools.partial(robust.clipped_multi_krum, tau=9.0, f=20, q=40),
                           functools.partial(jrobust.clipped_multi_krum, tau=9.0, f=20, q=40)),
    "arc_multi_krum": (functools.partial(robust.arc_multi_krum, f_arc=20, f=20, q=40),
                       functools.partial(jrobust.arc_multi_krum, f_arc=20, f=20, q=40)),
}


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("family", sorted(EXACT))
def test_exact_families_above_128(family, n):
    """Bit for bit: the same sort keys, the same ranks, the same row
    chains."""
    ours_fn, ref_fn = EXACT[family]
    x = _x(n)
    _exact(ours_fn(torch.from_numpy(x)), ref_fn(jnp.asarray(x)))


ONES_CONTRACTION = {
    "trimmed": (functools.partial(robust.trimmed_mean, f=20),
                functools.partial(jrobust.trimmed_mean, f=20)),
    "meamed": (functools.partial(robust.mean_of_medians, f=20),
               functools.partial(jrobust.mean_of_medians, f=20)),
}


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("family", sorted(ONES_CONTRACTION))
def test_ones_contraction_families_above_128(family, n):
    """The same kept values, summed in another order: f32 within
    ``rtol=1e-5`` / ``atol=1e-6``."""
    ours_fn, ref_fn = ONES_CONTRACTION[family]
    x = _x(n)
    _close(ours_fn(torch.from_numpy(x)), ref_fn(jnp.asarray(x)))


@pytest.mark.parametrize("n", ROWS)
def test_median_keeps_nan_columns_above_128(n):
    x = _x(n)
    x[5, 7] = np.nan
    ours = robust.coordinate_median(torch.from_numpy(x))
    _exact(ours, jrobust.coordinate_median(jnp.asarray(x)))
    assert torch.isnan(ours[7]) and torch.isfinite(ours[:7]).all()


@pytest.mark.parametrize("n", ROWS)
def test_gram_and_krum_from_gram_above_128(n):
    """The Gram within rtol 1e-5 (two BLAS orders); Multi-Krum from the
    reference's own Gram is exact."""
    x = _x(n)
    g_ref = jrobust.gram_matrix(jnp.asarray(x))
    _close(robust.gram_matrix(torch.from_numpy(x)), g_ref, rtol=1e-5, atol=1e-3)
    ours = robust.multi_krum_from_gram(torch.from_numpy(x), torch.from_numpy(np.array(g_ref)),
                                       f=20, q=40)
    _exact(ours, jrobust.multi_krum_from_gram(jnp.asarray(x), g_ref, f=20, q=40))


@pytest.mark.parametrize("n", ROWS)
def test_nnm_above_128(n):
    """NNM's selections agree; the mixed rows within f32 rounding of two
    BLAS products. A non-finite row taints the rows that select it."""
    x = _x(n)
    x[9, 2] = np.inf
    _close(preagg.nnm(torch.from_numpy(x), f=20), jpreagg.nnm(jnp.asarray(x), f=20))
    x = _x(n, seed=1)
    _close(robust.nnm_multi_krum(torch.from_numpy(x), f_nnm=20, f=20, q=40),
           jrobust.nnm_multi_krum(jnp.asarray(x), f_nnm=20, f=20, q=40))


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("init", ["median", "mean"])
def test_geometric_median_above_128(n, init):
    x = _x(n)
    ours = robust.geometric_median(torch.from_numpy(x), init=init, max_iter=64)
    _close(ours, jrobust.geometric_median(jnp.asarray(x), init=init, max_iter=64))
    assert 1 <= robust.last_iterations["geometric_median"] <= 64


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("init", ["mean", "median", "zero"])
def test_centered_clipping_above_128(n, init):
    x = _x(n)
    ours = robust.centered_clipping(torch.from_numpy(x), c_tau=3.0, M=5, init=init)
    _close(ours, jrobust.centered_clipping(jnp.asarray(x), c_tau=3.0, M=5, init=init))


@pytest.mark.parametrize("name", ["median", "trimmed", "multi_krum", "meamed"])
def test_streams_above_128(name):
    ref_fn = {**EXACT, **ONES_CONTRACTION}[name][1]
    check = _close if name in ONES_CONTRACTION else _exact
    xs = np.stack([_x(129, seed=s) for s in range(2)])
    stream = {"median": robust.coordinate_median_stream,
              "trimmed": functools.partial(robust.trimmed_mean_stream, f=20),
              "multi_krum": functools.partial(robust.multi_krum_stream, f=20, q=40),
              "meamed": functools.partial(robust.mean_of_medians_stream, f=20)}[name]
    ours = stream(torch.from_numpy(xs))
    for k in range(2):
        check(ours[k], ref_fn(jnp.asarray(xs[k])))


@pytest.mark.parametrize("name", ["trimmed", "median", "multi_krum", "cge", "geomed"])
def test_masked_family_at_a_bucket_of_256(name):
    """The masked programs at a 256-row bucket holding 150 valid rows
    against the reference's masked programs on the same padded input."""
    x = _x(256)
    valid = np.zeros(256, bool)
    valid[np.random.default_rng(3).choice(256, 150, replace=False)] = True
    x[~valid] = 0.0
    ours_fn, ref_fn = {
        "trimmed": (functools.partial(robust.masked_trimmed_mean, f=10),
                    functools.partial(jrobust.masked_trimmed_mean, f=10)),
        "median": (robust.masked_coordinate_median, jrobust.masked_coordinate_median),
        "multi_krum": (functools.partial(robust.masked_multi_krum, f=10, q=30),
                       functools.partial(jrobust.masked_multi_krum, f=10, q=30)),
        "cge": (functools.partial(robust.masked_cge, f=10), functools.partial(jrobust.masked_cge, f=10)),
        "geomed": (functools.partial(robust.masked_geometric_median, max_iter=32),
                   functools.partial(jrobust.masked_geometric_median, max_iter=32)),
    }[name]
    ours = ours_fn(torch.from_numpy(x), torch.from_numpy(valid))
    ref = ref_fn(jnp.asarray(x), jnp.asarray(valid))
    if name == "geomed":
        _close(ours, ref)
    else:
        _exact(ours, ref)


def _ragged_batch(sizes, capacity, seed=7):
    rng = np.random.default_rng(seed)
    flat = np.zeros((capacity, D), np.float32)
    seg = np.full(capacity, len(sizes), np.int32)
    offsets, lengths, off = [], [], 0
    for c, m in enumerate(sizes):
        flat[off:off + m] = rng.normal(size=(m, D))
        seg[off:off + m] = c
        offsets.append(off)
        lengths.append(m)
        off += m
    return flat, seg, np.int32(offsets), np.int32(lengths)


@pytest.mark.parametrize("mode", ["trimmed", "median"])
@pytest.mark.parametrize("sizes", [(200, 30), (40, 129, 9)])
def test_ragged_long_slots_match_the_reference(mode, sizes):
    """A batch at a capacity of 256 with a cohort longer than 128 rows:
    ``long_slots`` runs the reference's own segmented program (one sort
    of (segment, key), the windowed contraction or the middle rows); the
    median exactly, the trimmed mean within ``rtol=1e-5`` (the reference
    contracts with ones, an XLA reduction)."""
    flat, seg, offsets, lengths = _ragged_batch(sizes, 256)
    args = [torch.from_numpy(a) for a in (flat, seg, offsets, lengths)]
    jargs = [jnp.asarray(a) for a in (flat, seg, offsets, lengths)]
    C = len(sizes)
    if mode == "trimmed":
        ours = ragged_ops.ragged_trimmed_mean(*args, f=4, n_cohorts=C, long_slots=True)
        _close(ours, jragged.ragged_trimmed_mean(*jargs, f=4, n_cohorts=C))
    else:
        ours = ragged_ops.ragged_median(*args, n_cohorts=C, long_slots=True)
        _exact(ours, jragged.ragged_median(*jargs, n_cohorts=C))
    assert torch.isfinite(ours).all()


@pytest.mark.parametrize("mode", ["trimmed", "median"])
def test_segmented_sort_reduce_takes_any_batch_rows(mode):
    """The segmented sort-reduce's batch above 128 rows (slots of at most
    128) against the reference's segmented program; a slot longer than
    128 rows writes NaN, as the kernel does, never a wrong value."""
    flat, seg, offsets, lengths = _ragged_batch((128, 100, 27), 256)
    args = [torch.from_numpy(a) for a in (flat, offsets, lengths)]
    jargs = [jnp.asarray(a) for a in (flat, seg, offsets, lengths)]
    if mode == "trimmed":
        ours = kernels.segmented_sort_reduce(*args, mode="trimmed", f=3)
        _close(ours, jragged.ragged_trimmed_mean(*jargs, f=3, n_cohorts=3))
    else:
        ours = kernels.segmented_sort_reduce(*args, mode="median")
        _exact(ours, jragged.ragged_median(*jargs, n_cohorts=3))
    flat, seg, offsets, lengths = _ragged_batch((129,), 256)
    out = kernels.segmented_sort_reduce(*(torch.from_numpy(a) for a in (flat, offsets, lengths)),
                                        mode=mode, f=1)
    assert torch.isnan(out).all()


@pytest.mark.parametrize("n", [12, 129])
def test_f16_above_row_norm_256_matches_reference_f32(n):
    """The reference sums f16 squared norms in f16 (``jnp.sum(diff * diff,
    axis=1)`` in ``_monna_xla`` and the masked programs), which overflows
    to inf once a row's L2 norm passes ~256; the port sums in f32. Rows of
    norm ~1,000 in f16: the port's MoNNA, masked MoNNA and masked centred
    clipping equal the reference's f32 result on the same (f16-exact)
    values within f16 rounding (``rtol=2e-3``)."""
    rng = np.random.default_rng(11)
    x16 = (rng.normal(size=(n, D)) * 125.0).astype(np.float16)  # norms ~1,000
    assert np.linalg.norm(x16.astype(np.float32), axis=1).min() > 256
    x32 = x16.astype(np.float32)
    valid = np.ones(n, bool)
    valid[-2:] = False
    cases = [
        (lambda x: robust.monna(x, f=2, reference_index=1),
         lambda x: jrobust.monna(x, f=2, reference_index=1)),
        (lambda x: robust.masked_monna(x, torch.from_numpy(valid), f=2, reference_index=1),
         lambda x: jrobust.masked_monna(x, jnp.asarray(valid), f=2, reference_index=1)),
        (lambda x: robust.masked_centered_clipping(x, torch.from_numpy(valid), c_tau=300.0, M=3),
         lambda x: jrobust.masked_centered_clipping(x, jnp.asarray(valid), c_tau=300.0, M=3)),
    ]
    for ours_fn, ref_fn in cases:
        ours = ours_fn(torch.from_numpy(x16))
        assert ours.dtype == torch.float16 and torch.isfinite(ours).all()
        ref = np.asarray(ref_fn(jnp.asarray(x32)))
        np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2e-3, atol=0.05)
