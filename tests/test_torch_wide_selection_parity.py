"""B6's and B9's plain versions against the Pallas kernels at the widths
where the port's CUDA kernels take their wide paths: 64 rows (the
column-sort engine's and the weights block's full narrow width), 65 (the
first of the engine's two runs and merge) and 128.

On the CPU ``kernels.meamed_stream`` and ``kernels.nnm_selection_mean_stream``
compute their plain versions (the CUDA kernels' oracles, which
``test_torch_cuda.py`` holds the kernels to bit for bit); here those
versions meet the JAX package's Pallas kernels in interpret mode, on the
same numpy rows. Each interpret-mode compile of a wide network takes 10-130
s on a CPU, so B6 runs at 64 and 65 rows (the plain version sorts with
``torch.sort`` at any width; the card tests hold the kernel to it at 100
and 128 rows too), and B9's Krum at 64 (CGE and MoNNA at 128).

The Pallas kernels add their selected rows with ``jnp.sum`` over the row
axis, which XLA on the CPU takes as one chain at a few rows (the narrow
tests of ``test_torch_kernels.py`` hold B6 bitwise there) but not at 64:
the means are held within the tolerance of those tests' Pallas
comparisons. The rows selected must agree: a wrong pick among the tied
deviations at the cut moves a mean by ~2 r / k, r the tie's distance to
the median (~0.5 here), far outside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.ops import pallas_kernels as pk
from byzpy_tpu_torch.ops import kernels

TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
CANONICAL_NAN = {torch.float32: (torch.int32, 0x7FC00000), torch.bfloat16: (torch.int16, 0x7FC0),
                 torch.float16: (torch.int16, 0x7E00)}


def _meamed_rows(seed, n, d=256):
    """(1, n, d) normal rows with a NaN, +-inf and -0.0 column; from column
    8 on quantized to halves, so deviations tie at the cut (med - r and med
    + r among them)."""
    x = np.random.default_rng(seed).normal(size=(1, n, d)).astype(np.float32)
    x[0, 0, 1] = np.nan
    x[0, 1, 2] = np.inf
    x[0, 0, 3] = -np.inf
    x[0, :, 5] = -0.0
    x[..., 8:] = np.round(x[..., 8:] * 2.0) / 2.0
    return x


MANTISSA_BITS = {"bf16": 7, "f16": 10}


def _assert_matches_pallas(ours: torch.Tensor, ref, dt: str) -> None:
    """NaN and inf at the same places, NaN canonical in the port's dtype;
    finite values within rtol 1e-5, atol 1e-6 in f32 and, in a 16-bit
    dtype, within one of its ulps plus 1e-6 (test_torch_kernels.py's
    Pallas tolerance)."""
    o = ours.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(o), np.isnan(r))
    if ours.dtype in CANONICAL_NAN:
        ints, bits = CANONICAL_NAN[ours.dtype]
        assert bool((ours[torch.isnan(ours)].view(ints) == bits).all())
    np.testing.assert_array_equal(o[np.isinf(r)], r[np.isinf(r)])
    fin = np.isfinite(r)
    if dt == "f32":
        np.testing.assert_allclose(o[fin], r[fin], rtol=1e-5, atol=1e-6)
        return
    m = np.maximum(np.abs(o[fin]), np.abs(r[fin])).astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(m, 1e-30))) - MANTISSA_BITS[dt])
    assert np.all(np.abs(o[fin] - r[fin]) <= ulp + 1e-6)


@pytest.mark.parametrize(("n", "dt"), [(64, "f32"), (65, "f32"), (64, "bf16"), (65, "bf16"),
                                       (64, "f16"), (65, "f16")])
def test_meamed_plain_matches_pallas_at_wide_n(n, dt):
    """B6's plain version against the Pallas kernel in interpret mode at f =
    n // 4, with deviations tied at the cut: the same NaN and inf columns,
    the means within the Pallas tolerance."""
    x = _meamed_rows(600 + n, n)
    f = n // 4
    ours = kernels.meamed_stream(torch.from_numpy(x).to(TORCH_DTYPES[dt]), f=f)
    ref = pk.meamed_stream_pallas(jnp.asarray(x).astype(JAX_DTYPES[dt]), f=f, tile=128, interpret=True)
    assert ours.dtype == TORCH_DTYPES[dt]
    _assert_matches_pallas(ours, ref, dt)


def _repeated_rows(seed, n, d=256):
    """(1, n, d) rows at two scales (every third x5), repeated in groups of
    three, so distances tie at NNM's cut and in the selection's scores."""
    x = np.random.default_rng(seed).normal(size=(1, n, d)).astype(np.float32)
    x[:, ::3] *= 5.0
    return np.ascontiguousarray(x[:, np.arange(n) // 3 * 3])


@pytest.mark.parametrize(("n", "mode"), [(64, "krum"), (64, "cge"), (128, "cge"), (128, "monna")])
def test_nnm_selection_plain_matches_pallas_at_wide_n(n, mode):
    """B9's whole call (the plain Gram, weights and sweep on the CPU) against
    the Pallas kernel in interpret mode on repeated rows: the same rows
    weighted, the means within the Pallas comparison's tolerance (the
    reference's dots sum in another order)."""
    x = _repeated_rows(700 + n, n)
    f_nnm, f, q = n // 8, n // 8, 3 * n // 16
    sel = dict(f=f, q=q, mode=mode, reference_index=n // 2)
    ours = kernels.nnm_selection_mean_stream(torch.from_numpy(x), f_nnm=f_nnm, **sel)
    ref = pk.nnm_selection_mean_stream_pallas(jnp.asarray(x), f_nnm=f_nnm, tile=128, interpret=True, **sel)
    _assert_matches_pallas(ours, ref, "f32")
