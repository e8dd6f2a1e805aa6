"""B8's selection state and B5's plain versions against the JAX package at
the widths where the CUDA kernels tile the problem: B8's block sorts a
mixer's column across 8 lanes from 32 rows on (a lane a column up to 16),
and B5's weights block and row sweep cover 8 to 128 rows.

On the CPU ``kernels.nnm_weights`` and ``kernels.selection_mean_from_gram``
compute their plain versions (the CUDA kernels' oracles, which
``test_torch_cuda.py`` holds the kernels to bit for bit). Here they meet
the functions the Pallas kernels compute with, run as plain XLA on the
same inputs: ``_nnm_weights`` (``pallas_kernels.py:1216``) for B8, and for
B5 ``_selection_scores`` / ``_selection_weights`` (:843-883) and the sum of
``_selection_from_gram_kernel`` (:1094), written out below. An
interpret-mode compile of a Pallas kernel at these widths takes 10-130 s
on a CPU; the XLA path takes about a second.

Tolerances: B8's mask and ``sel_taint`` are 0/1 and compared exactly. B5's
weights are 1/q or 0 and compared exactly. Its output adds the same
products in another order (XLA's reduction over the row axis is not one
ascending chain), so each entry is held within (q - 1) f32 ulps of the sum
of the terms' magnitudes, a bound on the difference of two summation
orders of q terms, plus one ulp of the output dtype where it is 16-bit
(the two f32 sums may round to neighbouring 16-bit values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.ops import pallas_kernels as pk
from byzpy_tpu_torch.ops import kernels

TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
# one ulp of the dtype, relative to the value (its mantissa bits)
REL_ULP = {"f32": 2.0 ** -23, "bf16": 2.0 ** -7, "f16": 2.0 ** -10}


def _rows(seed: int, n: int, d: int, case: str) -> np.ndarray:
    """(n, d) normal f32 rows, every third x5. ``dup``: rows repeated in
    threes and rows 1 and 4 zero, so distances tie at NNM's cut and scores
    tie in B5's ranks; ``nonfinite``: row n // 2 all inf and a NaN entry in
    the last row (their squared norms, and every distance to them, are not
    finite)."""
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    x[::3] *= 5.0
    if case in ("dup", "nonfinite"):
        x = x[np.arange(n) // 3 * 3]
        x[[i for i in (1, 4) if i < n]] = 0.0
    if case == "nonfinite":
        x[n // 2] = np.inf
        x[n - 1, 5] = np.nan
    return x


def _gram(x: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore", over="ignore"):
        return (x.astype(np.float64) @ x.T.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("case", ["dup", "nonfinite"])
@pytest.mark.parametrize("n", [8, 64, 100, 128])
def test_nnm_weights_plain_matches_jax_at_wide_n(n, case):
    g = _gram(_rows(700 + n, n, 96, case))
    f = n // 4
    for k in sorted({1, n - f, n}):
        mask, sel_taint = kernels.nnm_weights(torch.from_numpy(g)[None], k=k)
        ref_mask, _, ref_taint = pk._nnm_weights(jnp.asarray(g), n_pad=n, n_real=n, k=k)
        np.testing.assert_array_equal(mask[0].numpy(), np.asarray(ref_mask))
        np.testing.assert_array_equal(sel_taint[0].numpy(), np.asarray(ref_taint))
        if case == "nonfinite" and k == n:  # every mixer took the inf row
            assert bool(sel_taint.all())


def _jax_selection_mean(x, g, *, f, q, mode, ref):
    """``_selection_from_gram_kernel``'s weights and sum on (n, d) rows,
    no pads: (weights (n,) f32, output (d,) in x's dtype)."""
    n = g.shape[0]
    scores = pk._selection_scores(g, mode=mode, n_pad=n, n_real=n, f=f, reference_index=ref)
    w = pk._selection_weights(scores, n_pad=n, n_real=n, q=q)
    xt = jnp.where(w > 0.0, x.astype(jnp.float32), 0.0)
    return w[:, 0], jnp.sum(xt * w, axis=0).astype(x.dtype)


def _b5_args(n, mode):
    return (n // 8, 3 * n // 16 or 1) if mode == "krum" else (0, n - n // 8)


@pytest.mark.parametrize("mode", ["krum", "cge", "monna"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [8, 64, 128])
def test_selection_mean_from_gram_plain_matches_jax(n, dt, mode):
    d = 257
    x = torch.from_numpy(_rows(800 + n, n, d, "dup")).to(TORCH_DTYPES[dt])
    xf = x.float().numpy()
    g = _gram(xf)
    f, q = _b5_args(n, mode)
    sel = dict(f=f, q=q, mode=mode, reference_index=n // 2)
    ours = kernels.selection_mean_from_gram(x, torch.from_numpy(g), **sel)
    w = kernels.selection_weights(torch.from_numpy(g)[None], **sel)[0].numpy()
    ref_w, ref = _jax_selection_mean(jnp.asarray(xf).astype(JAX_DTYPES[dt]), jnp.asarray(g), f=f, q=q,
                                     mode=mode, ref=n // 2)
    np.testing.assert_array_equal(w.view(np.int32), np.asarray(ref_w).view(np.int32))
    assert int((w != 0).sum()) == q
    ours, ref = ours.float().numpy(), np.asarray(ref, dtype=np.float32)
    terms = np.abs(xf[w != 0] * w[w != 0][:, None]).sum(axis=0)
    tol = (q - 1) * 2.0 ** -24 * terms + (REL_ULP[dt] * np.abs(ref) if dt != "f32" else 0.0)
    assert np.all(np.abs(ours - ref) <= tol), float(np.max(np.abs(ours - ref) - tol))
