"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from byzpy_tpu_torch.ops import kernels


def _matrix(rng, shape, *, specials=True):
    """Normal data; with ``specials``, a few columns hold NaN / +-inf / -0."""
    x = rng.normal(size=shape).astype(np.float32)
    if specials:
        x[..., 0, 1] = np.nan
        x[..., 1, 2] = np.inf
        x[..., 0, 3] = -np.inf
        x[..., :2, 4] = [np.inf, -np.inf]
        x[..., :, 5] = -0.0
    return x


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [3, 8, 13, 64, 128])
def test_cuda_sorted_reduce_matches_plain(cuda_device, n, dt):
    x = torch.from_numpy(_matrix(np.random.default_rng(n), (2, n, 1000))).to(cuda_device, DTYPES[dt])
    med = kernels.sorted_reduce_stream(x, mode="median")
    ref = kernels.sorted_reduce_stream_plain(x, mode="median")
    assert torch.equal(med.view(torch.int16 if dt == "bf16" else torch.int32),
                       ref.view(torch.int16 if dt == "bf16" else torch.int32))
    f = (n - 1) // 3
    tm = kernels.sorted_reduce_stream(x, mode="trimmed", f=f)
    tref = kernels.sorted_reduce_stream_plain(x, mode="trimmed", f=f)
    torch.testing.assert_close(tm, tref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 16, 64, 128])
def test_cuda_gram_and_selection_match_plain(cuda_device, n):
    x = torch.from_numpy(_matrix(np.random.default_rng(n), (2, n, 5000), specials=False))
    x = x.to(cuda_device)
    g = kernels.gram(x)
    ref = kernels.gram_plain(x)
    norms = torch.linalg.vector_norm(x, dim=2)
    assert torch.all((g - ref).abs() <= 1e-5 * norms[:, :, None] * norms[:, None, :])
    assert torch.equal(g, g.transpose(1, 2))
    f, q = max(0, n // 4), max(1, n // 3)
    for mode in ("krum", "cge", "monna"):
        w = kernels.selection_weights(g, f=f, q=q, mode=mode)
        assert torch.equal(w, kernels.selection_weights_plain(g, f=f, q=q, mode=mode))
        out = kernels.weighted_rows(x, w)
        torch.testing.assert_close(out, kernels.weighted_rows_plain(x, w), rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_rejects_what_the_kernels_do_not_take(cuda_device):
    """n > 128 raises NotImplementedError; a strided tensor raises; nothing
    falls back to the plain version."""
    wide = torch.zeros((1, 129, 64), device=cuda_device)
    for call in (
        lambda: kernels.sorted_reduce_stream(wide),
        lambda: kernels.gram(wide),
        lambda: kernels.selection_mean_stream(wide, f=1, q=2),
    ):
        with pytest.raises(NotImplementedError):
            call()
    strided = torch.zeros((1, 64, 8), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.sorted_reduce_stream(strided)


@pytest.mark.cuda
def test_cuda_launch_counts_and_empty_inputs(cuda_device):
    kernels.reset_launch_counts()
    x = torch.randn((2, 8, 300), device=cuda_device)
    kernels.sorted_reduce_stream(x, mode="median")
    kernels.selection_mean_stream(x, f=2, q=3)
    expected = dict.fromkeys(kernels.launch_counts, 0)
    expected.update({"sorted_reduce:median": 1, "gram": 1, "selection_weights:krum": 1,
                     "weighted_rows": 1})
    assert kernels.launch_counts == expected
    # each wrapper counts its own launch when called directly
    w = kernels.selection_weights(kernels.gram(x), f=2, q=3, mode="cge")
    kernels.weighted_rows(x, w)
    assert kernels.launch_counts["gram"] == 2
    assert kernels.launch_counts["selection_weights:cge"] == 1
    assert kernels.launch_counts["weighted_rows"] == 2
    assert kernels.sorted_reduce_stream(torch.zeros((0, 8, 300), device=cuda_device)).shape == (0, 300)
    assert kernels.gram(torch.zeros((1, 8, 0), device=cuda_device)).abs().sum() == 0
    assert sum(kernels.launch_counts.values()) == 7


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 8, 300), (2, 8, 0)], ids=["K0", "d0"])
def test_cuda_empty_inputs_launch_nothing(cuda_device, shape):
    """K = 0 or d = 0 launches no kernel, so no count moves."""
    x = torch.zeros(shape, device=cuda_device)
    kernels.reset_launch_counts()
    for mode in ("krum", "cge", "monna"):
        assert kernels.selection_mean_stream(x, f=2, q=3, mode=mode).shape == (shape[0], shape[2])
    assert kernels.sorted_reduce_stream(x, mode="median").shape == (shape[0], shape[2])
    assert kernels.sorted_reduce_stream(x, mode="trimmed", f=2).shape == (shape[0], shape[2])
    assert kernels.gram(x).shape == (shape[0], 8, 8)
    assert kernels.weighted_rows(x, torch.zeros(shape[:2], device=cuda_device)).shape == (shape[0], shape[2])
    if shape[0] == 0:
        assert kernels.selection_weights(torch.zeros((0, 8, 8), device=cuda_device), f=2, q=3).shape == (0, 8)
    assert all(v == 0 for v in kernels.launch_counts.values())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["krum", "cge", "monna"])
def test_cuda_selection_never_picks_a_nan_row(cuda_device, mode):
    x = torch.from_numpy(_matrix(np.random.default_rng(5), (1, 13, 2000), specials=False))
    x[0, 4] = float("nan")
    x = x.to(cuda_device)
    g = kernels.gram(x)
    w = kernels.selection_weights(g, f=3, q=5, mode=mode, reference_index=1)
    assert float(w[0, 4]) == 0.0
    assert torch.equal(w, kernels.selection_weights_plain(g, f=3, q=5, mode=mode, reference_index=1))
    assert bool(torch.isfinite(kernels.selection_mean_stream(x, f=3, q=5, mode=mode, reference_index=1)).all())
