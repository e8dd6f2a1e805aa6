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

TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


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
    assert all(v == 0 for v in kernels.launch_counts.values())


def test_unknown_device_mix_raises():
    x = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.weighted_rows(x, torch.zeros((1, 4), device="meta"))
