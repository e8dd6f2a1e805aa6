"""B3's summation order on the CPU: ``kernels.gram_split_k_plain`` (the
split-K Gram's own order, which the CUDA kernel equals bit for bit on the
card) and ``kernels.gram_chunks`` (the chunking that fixes that order),
against a sequential FMA chain, the JAX package's ``gram_pallas`` in
interpret mode and the port's CPU path ``gram_plain``.
``tests/test_torch_cuda.py -k gram`` holds the kernel to the order on the
card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.ops import pallas_kernels as pk
from byzpy_tpu_torch.ops import kernels

TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
H100_SMS = 132


def _rows(seed, shape, dt, *, specials=False):
    """Normal rows in ``dt`` (scaled so f16 squares stay finite); with
    ``specials``, a NaN, a +-inf pair and a -0.0 column."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if specials:
        x[..., 0, 1] = np.nan
        x[..., 1, 2] = np.inf
        x[..., 2 % shape[-2], 3] = -np.inf
        x[..., :, 4] = -0.0
    return torch.from_numpy(x).to(TORCH_DTYPES[dt])


def _bits_equal_nan_at_same_places(a: torch.Tensor, b: torch.Tensor) -> bool:
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _sequential_chain(x: torch.Tensor, start: int, end: int, span: int) -> torch.Tensor:
    """One chunk's partial: for c = start .. start + span - 1 in order,
    ``acc = fma(x[i, c], x[j, c], acc)`` from +0.0, columns from ``end`` on
    read as zeros."""
    x = x.float()
    acc = torch.zeros((x.shape[0], x.shape[0]))
    for c in range(start, start + span):
        col = x[:, c] if c < end else torch.zeros(x.shape[0])
        acc = kernels.fma_f32(col[:, None], col[None, :], acc)
    return acc


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,d", [(1, 7), (5, 40), (13, 96), (8, 33)])
def test_split_k_plain_one_chunk_is_the_sequential_chain(n, d, dt):
    """With one chunk the order is one ascending FMA chain an entry over
    the columns zero-padded to a multiple of 32, bit for bit, NaN and +-inf
    included."""
    x = _rows(n + d, (n, max(d, 5)), dt, specials=n >= 3)[:, :d]
    ref = _sequential_chain(x, 0, d, -(-d // 32) * 32)
    for chunk in (-(-d // 32) * 32, 512):
        assert _bits_equal_nan_at_same_places(kernels.gram_split_k_plain(x[None], chunk)[0], ref)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d,chunk", [(100, 32), (130, 64), (192, 64), (1100, 512)])
def test_split_k_plain_adds_the_chunks_partials_in_order(d, chunk, dt):
    """Several chunks: each chunk's sequential chain over its own columns
    (the last one's padded to a multiple of 32 and no further), then the
    partials added from +0.0 in chunk order, per round of a stack."""
    x = _rows(d + chunk, (2, 6, d), dt, specials=True)
    out = kernels.gram_split_k_plain(x, chunk)
    for k in range(2):
        ref = torch.zeros((6, 6))
        for c0 in range(0, d, chunk):
            span = min(chunk, -(-(d - c0) // 32) * 32)
            ref = ref + _sequential_chain(x[k], c0, d, span)
        assert _bits_equal_nan_at_same_places(out[k], ref)
    assert torch.equal(out.isnan(), out.transpose(1, 2).isnan())


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [1, 5, 8, 13, 64])
def test_split_k_plain_matches_pallas_and_gram_plain(n, dt):
    """Within 1e-5 |x_i| |x_j| of ``gram_pallas`` (interpret mode) and of
    ``gram_plain``: f32 sums in another order. ``d`` has a tail past the
    last 32-column tile, and the H100's chunking gives three chunks."""
    d = 1100
    x = _rows(n, (n, d), dt)
    chunk, nchunks = kernels.gram_chunks(d, 1, H100_SMS)
    assert nchunks == 3
    ours = kernels.gram_split_k_plain(x[None], chunk)[0].numpy()
    xf = x.float().numpy()
    norms = np.linalg.norm(xf.astype(np.float64), axis=1)
    bound = 1e-5 * np.outer(norms, norms)
    ref = np.asarray(pk.gram_pallas(jnp.asarray(xf).astype(JAX_DTYPES[dt]), tile=128,
                                    interpret=True))
    assert np.all(np.abs(ours - ref) <= bound)
    assert np.all(np.abs(ours - kernels.gram_plain(x[None])[0].numpy()) <= bound)
    np.testing.assert_array_equal(ours, ours.T)


def _wrapper_chunking(d, K, sms):
    """The chunking as ``kernels.gram`` computed it inline before it called
    ``gram_chunks``."""
    per_round = max(1, 4 * sms // K)
    chunk = max(512, -(-(-(-d // per_round)) // 32) * 32)
    return chunk, -(-d // chunk)


@pytest.mark.parametrize("K", [1, 4])
def test_gram_chunks_rules(K):
    """A multiple of 32, at least 512 columns, covering ``d`` with no empty
    chunk, at most four blocks a SM over the K rounds, and the wrapper's
    chunking at 132 SMs (421,642 columns: 528 chunks of 800 at K = 1)."""
    for d in (1, 31, 32, 511, 512, 513, 5000, 5001, 270_336, 421_641, 421_642, 1_048_576,
              10_000_019):
        chunk, nchunks = kernels.gram_chunks(d, K, H100_SMS)
        assert chunk % 32 == 0 and chunk >= 512
        assert nchunks * chunk >= d > (nchunks - 1) * chunk
        assert nchunks * K <= 4 * H100_SMS or chunk == 512
        assert (chunk, nchunks) == _wrapper_chunking(d, K, H100_SMS)
    assert kernels.gram_chunks(421_642, 1, H100_SMS) == (800, 528)
    assert kernels.gram_chunks(421_642, 4, H100_SMS) == (3200, 132)


def test_split_k_plain_takes_empty_inputs_and_rejects_bad_chunks():
    assert kernels.gram_split_k_plain(torch.zeros((2, 3, 0)), 512).shape == (2, 3, 3)
    assert kernels.gram_split_k_plain(torch.zeros((0, 3, 9)), 512).shape == (0, 3, 3)
    for chunk in (0, 48):
        with pytest.raises(ValueError):
            kernels.gram_split_k_plain(torch.zeros((1, 3, 9)), chunk)
