"""The port's pre-aggregators (``byzpy_tpu_torch.ops.preagg``) against the
JAX package's ``byzpy_tpu.ops.preagg``, on the CPU, same numpy inputs.

Exact where no sum is taken in another order (``arc_cut_off``, the rows
NNM selects, which rows are NaN); a stated f32 tolerance where a norm or
a mean re-associates. ``nnm`` on a CPU tensor is B8's plain version; the
JAX ``nnm`` at these sizes is its XLA path, so the two are independent
computations of the same function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.ops import preagg as jpreagg
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu_torch.ops import kernels, preagg


def _x(seed, shape=(11, 257), spread=True):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if spread:
        x[::3] *= 4.0  # norms ~16 and ~64: a threshold of 20 clips some rows
    return x


def _close(ours: torch.Tensor, ref, rtol=1e-6, atol=1e-6):
    """Same NaN places; finite values within ``rtol`` / ``atol`` (norms and
    means summed in another order)."""
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=rtol, atol=atol, equal_nan=True)


# ---------------------------------------------------------------------------
# static clipping, ARC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold", [0.5, 20.0, 1e6])
def test_clip_rows_matches_jax(threshold):
    """f32 within rtol 1e-6 (the norm's sum re-associates); an inf row
    clips to inf * 0 = NaN and a NaN entry makes its row NaN in both."""
    x = _x(0)
    x[4] = np.inf
    x[7, 3] = np.nan
    ours = preagg.clip_rows(torch.from_numpy(x), threshold=threshold)
    _close(ours, jpreagg.clip_rows(jnp.asarray(x), threshold=threshold))
    norms = torch.linalg.vector_norm(ours, dim=1)
    finite = torch.isfinite(norms)
    assert torch.all(norms[finite] <= threshold * (1 + 1e-6))


def test_clip_rows_bf16_within_one_ulp():
    x = _x(1, (6, 64))
    ours = preagg.clip_rows(torch.from_numpy(x).to(torch.bfloat16), threshold=10.0)
    ref = np.asarray(jpreagg.clip_rows(jnp.asarray(x).astype(jnp.bfloat16), threshold=10.0))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref.astype(np.float32), rtol=2**-7, atol=1e-6)


def test_arc_cut_off_identical():
    for n in range(1, 41):
        for f in range(0, n + 1):
            assert preagg.arc_cut_off(n, f) == jpreagg.arc_cut_off(n, f), (n, f)


@pytest.mark.parametrize("f", [0, 1, 3, 5, 11])
def test_arc_clip_matches_jax(f):
    x = _x(2)
    _close(preagg.arc_clip(torch.from_numpy(x), f=f), jpreagg.arc_clip(jnp.asarray(x), f=f))


def test_arc_clip_ties_and_nan_match_jax():
    """Equal norms (the threshold is that norm: nothing clips) and a NaN
    row (its norm sorts last, as in jnp.sort)."""
    x = _x(3, (8, 64), spread=False)
    x = x / np.linalg.norm(x, axis=1, keepdims=True) * 5.0
    _close(preagg.arc_clip(torch.from_numpy(x), f=3), jpreagg.arc_clip(jnp.asarray(x), f=3))
    x[2, 0] = np.nan
    x[5] *= 10.0
    _close(preagg.arc_clip(torch.from_numpy(x), f=3), jpreagg.arc_clip(jnp.asarray(x), f=3))


def test_arc_clip_rejects_f_above_n():
    with pytest.raises(ValueError) as ours:
        preagg.arc_clip(torch.zeros(4, 8), f=5)
    with pytest.raises(ValueError) as ref:
        jpreagg.arc_clip(jnp.zeros((4, 8)), f=5)
    assert str(ours.value) == str(ref.value)


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bucket_size", [1, 2, 3, 4, 11, 16])
def test_bucket_means_matches_jax(bucket_size):
    """The same permutation (numpy) to both; means within rtol 1e-6, the
    ragged last bucket averaging only its real rows."""
    x = _x(4)
    perm = np.random.default_rng(bucket_size).permutation(x.shape[0])
    ours = preagg.bucket_means(
        torch.from_numpy(x), torch.from_numpy(perm), bucket_size=bucket_size
    )
    ref = jpreagg.bucket_means(jnp.asarray(x), jnp.asarray(perm), bucket_size=bucket_size)
    assert tuple(ours.shape) == ref.shape
    _close(ours, ref)


def test_bucket_means_with_a_torch_generator():
    """The caller draws the permutation from a torch.Generator: every row
    lands in exactly one bucket."""
    x = torch.from_numpy(_x(5, (9, 16)))
    perm = torch.randperm(9, generator=torch.Generator().manual_seed(0))
    out = preagg.bucket_means(x, perm, bucket_size=4)
    assert out.shape == (3, 16)
    torch.testing.assert_close(out[:2].sum(0) * 4 + out[2], x.sum(0), rtol=1e-5, atol=1e-5)


def test_bucket_means_rejects_bad_perm():
    with pytest.raises(ValueError) as ours:
        preagg.bucket_means(torch.zeros(4, 8), torch.arange(3), bucket_size=2)
    with pytest.raises(ValueError) as ref:
        jpreagg.bucket_means(jnp.zeros((4, 8)), jnp.arange(3), bucket_size=2)
    assert str(ours.value) == str(ref.value)


# ---------------------------------------------------------------------------
# Nearest-Neighbour Mixing (B8's plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,f", [(3, 1), (8, 0), (8, 2), (13, 3), (21, 5)])
def test_nnm_matches_jax(n, f):
    """Within rtol 1e-5, atol 1e-6 of the JAX ``nnm`` (mixing sums in
    another order)."""
    x = _x(10 + n, (n, 300))
    _close(preagg.nnm(torch.from_numpy(x), f=f), jpreagg.nnm(jnp.asarray(x), f=f), rtol=1e-5)


def test_nnm_duplicated_and_zero_rows_select_like_jax():
    """Ties in the distances (equal and zero rows): the same rows are mixed
    as the JAX package's stable argsort mixes, so the means agree."""
    x = _x(12, (10, 64))
    x[6] = x[1]
    x[8] = x[1]
    x[[2, 4]] = 0.0
    _close(preagg.nnm(torch.from_numpy(x), f=3), jpreagg.nnm(jnp.asarray(x), f=3), rtol=1e-5)


def test_nnm_nonfinite_row_taints_only_selectors():
    """The JAX package's rule (its tests/test_pallas_kernels.py): a NaN row
    is NaN after mixing (it selects itself); no other row selects it, and
    those rows stay finite and equal the JAX result."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (10, 64), jnp.float32)).copy()
    x[4] = np.nan
    ours = preagg.nnm(torch.from_numpy(x), f=3)
    ref = np.asarray(jpreagg.nnm(jnp.asarray(x), f=3))
    assert torch.isnan(ours[4]).all() and np.isnan(ref[4]).all()
    keep = [i for i in range(10) if i != 4]
    assert torch.isfinite(ours[keep]).all()
    np.testing.assert_allclose(ours[keep].numpy(), ref[keep], rtol=1e-5, atol=1e-6)


def test_nnm_inf_row_becomes_nan_for_selectors():
    """Selecting an inf row gives NaN, not inf (the documented divergence
    from gather semantics); at f = 0 every row selects it."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (6, 32), jnp.float32)).copy()
    x[1] = np.inf
    ours = preagg.nnm(torch.from_numpy(x), f=0)
    assert torch.isnan(ours).all() and np.isnan(np.asarray(jpreagg.nnm(jnp.asarray(x), f=0))).all()
    assert np.all(ours.numpy().view(np.uint32) == 0x7FC00000)  # canonical NaN


def test_nnm_bf16_keeps_dtype():
    x = _x(13, (12, 256), spread=False) * 2
    ours = preagg.nnm(torch.from_numpy(x).to(torch.bfloat16), f=3)
    ref = np.asarray(jpreagg.nnm(jnp.asarray(x).astype(jnp.bfloat16), f=3).astype(jnp.float32))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2**-7, atol=1e-6)


def test_nnm_errors_match_jax():
    for f in (-1, 4):
        with pytest.raises(ValueError) as ours:
            preagg.nnm(torch.zeros(4, 8), f=f)
        with pytest.raises(ValueError) as ref:
            jpreagg.nnm(jnp.zeros((4, 8)), f=f)
        assert str(ours.value) == str(ref.value)


def test_nnm_then_median_matches_jax():
    """Configuration (b) of the round: NNM feeding the coordinate median."""
    from byzpy_tpu_torch.ops import robust

    x = _x(14, (8, 300))
    ours = robust.coordinate_median(preagg.nnm(torch.from_numpy(x), f=2))
    ref = jrobust.coordinate_median(jpreagg.nnm(jnp.asarray(x), f=2))
    _close(ours, ref, rtol=1e-5)


def test_nnm_on_cpu_is_the_kernels_plain_version():
    x = torch.from_numpy(_x(15, (9, 100)))
    mask, sel_taint = kernels.nnm_weights_plain(kernels.gram_plain(x[None]), k=7)
    expected = kernels.mix_rows_plain(x[None], mask, sel_taint, k=7)[0]
    assert torch.equal(preagg.nnm(x, f=2), expected)
