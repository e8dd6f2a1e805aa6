"""B4's and B10's plain weights against the JAX package at 64 and 128 rows:
the widths where the CUDA weights blocks tile the (n, n) problem over
1,024 threads.

On the CPU ``kernels.selection_weights`` and ``kernels.clip_selection_weights``
compute their plain versions (the CUDA kernels' oracles, which
``test_torch_cuda.py`` holds the kernels to bit for bit). Here they meet
the functions the Pallas kernels compute their weights with, run as plain
XLA on the same (n, n) Gram: ``_selection_scores`` and ``_selection_weights``
(``pallas_kernels.py:843-883``), and for B10 the clip of
``_clip_selection_stream_kernel`` (:1497-1543) in front of them, written
out below from the package's own key functions. An interpret-mode compile
of a Pallas kernel at these widths takes 10-130 s on a CPU; the XLA path
takes about a second.

Tolerances: B4's weights are 1/q or 0, so they are compared bit for bit
(the selection is exact: repeated rows tie in both, by index). B10's
weights w_sel c are compared on the same selection (w != 0 equal) and
within one f32 ulp in value: the clip factors divide by a square root,
and PyTorch's CPU square root is off by one ulp on some inputs (the
kernels' and XLA's are correctly rounded).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.ops import pallas_kernels as pk
from byzpy_tpu_torch.ops import kernels
from byzpy_tpu_torch.ops.preagg import arc_cut_off


def _gram(seed: int, n: int, case: str) -> np.ndarray:
    """The f32 Gram of (n, 512) normal rows, every third x5 (two norm
    scales, so clipping engages); ``dup``: rows repeated in threes, so
    distances tie in Krum's sort and norms at ARC's cut."""
    x = np.random.default_rng(seed).normal(size=(n, 512))
    x[::3] *= 5.0
    if case == "dup":
        x = x[np.arange(n) // 3 * 3]
    return (x @ x.T).astype(np.float32)


def _jax_selection_weights(g, *, f, q, mode, ref):
    n = g.shape[0]
    scores = pk._selection_scores(g, mode=mode, n_pad=n, n_real=n, f=f, reference_index=ref)
    return pk._selection_weights(scores, n_pad=n, n_real=n, q=q)[:, 0]


def _jax_clip_weights(g, *, pre, tau, cut_off, f, q, mode, ref):
    """w_eff of ``_clip_selection_stream_kernel`` on a Gram of n = n_pad
    rows (no pads)."""
    n = g.shape[0]
    norms = jnp.sqrt(jnp.maximum(jnp.diagonal(g), 0.0))
    if pre == "clip":
        threshold = jnp.asarray(tau, jnp.float32)
    else:  # the norm at stable rank cut_off - 1 in int32 key space
        keys = pk._float_sort_keys(norms)
        idx = jnp.arange(n)
        rank = jnp.sum(jnp.where((keys[None, :] < keys[:, None])
                                 | ((keys[None, :] == keys[:, None]) & (idx[None, :] < idx[:, None])), 1, 0),
                       axis=1)
        threshold = pk._keys_to_float(jnp.sum(jnp.where(rank == cut_off - 1, keys, 0)), jnp.float32)
    cfac = jnp.minimum(1.0, threshold / jnp.maximum(norms, 1e-12))
    w_sel = _jax_selection_weights(cfac[:, None] * cfac[None, :] * g, f=f, q=q, mode=mode, ref=ref)
    bad = ~jnp.isfinite(norms)
    w_eff = jnp.where(bad, 0.0, w_sel * cfac)
    return jnp.where(jnp.any((w_sel > 0) & bad), jnp.nan, w_eff)


def _args(n, mode):
    return (n // 8, 3 * n // 16) if mode == "krum" else (0, n - n // 8)


@pytest.mark.parametrize("mode", ["krum", "cge", "monna"])
@pytest.mark.parametrize("case", ["random", "dup"])
@pytest.mark.parametrize("n", [64, 128])
def test_selection_weights_plain_matches_jax_at_wide_n(n, case, mode):
    g = _gram(900 + n, n, case)
    f, q = _args(n, mode)
    ours = kernels.selection_weights(torch.from_numpy(g)[None], f=f, q=q, mode=mode,
                                     reference_index=n // 2)[0].numpy()
    ref = np.asarray(_jax_selection_weights(jnp.asarray(g), f=f, q=q, mode=mode, ref=n // 2))
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))
    assert int((ours != 0).sum()) == q


@pytest.mark.parametrize("mode", ["krum", "cge", "monna"])
@pytest.mark.parametrize("pre", ["clip", "arc"])
@pytest.mark.parametrize("case", ["random", "dup"])
@pytest.mark.parametrize("n", [64, 128])
def test_clip_selection_weights_plain_matches_jax_at_wide_n(n, case, pre, mode):
    g = _gram(950 + n, n, case)
    f, q = _args(n, mode)
    tau = float(np.median(np.sqrt(np.diagonal(g))))  # a norm of the round: rows at the threshold
    cut_off = arc_cut_off(n, n // 8)
    ours = kernels.clip_selection_weights(
        torch.from_numpy(g)[None], pre=pre, tau=tau, cut_off=cut_off, f=f, q=q, mode=mode,
        reference_index=n // 2)[0].numpy()
    ref = np.asarray(_jax_clip_weights(jnp.asarray(g), pre=pre, tau=tau, cut_off=cut_off, f=f, q=q,
                                       mode=mode, ref=n // 2))
    np.testing.assert_array_equal(ours != 0, ref != 0)
    assert int((ours != 0).sum()) == q
    np.testing.assert_allclose(ours, ref, rtol=2.0 ** -23, atol=0)
