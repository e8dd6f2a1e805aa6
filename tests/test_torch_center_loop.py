"""B7's loop (``byzpy_tpu_torch.ops.kernels.center_loop``) against the JAX
package, on the CPU.

``center_loop_plain`` is the loop kernel's plain version: the whole
Weiszfeld or centred-clipping loop, its step the kernel formula
``alpha z + sum_i w_i x_i`` rounded to x's dtype, its sums over columns in
the kernel's fixed order. It is held to the JAX package's loops
(``byzpy_tpu.ops.robust.geometric_median`` / ``centered_clipping``, their
XLA path) in f32, and to the JAX package's own loop semantics around its
Pallas step (``weighted_center_step_pallas`` in interpret mode) in f32,
bf16 and f16. ``test_torch_cuda.py`` holds the CUDA kernel to the plain
version bit for bit on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.ops import pallas_kernels as pk
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu_torch.ops import kernels
from byzpy_tpu_torch.ops import robust

TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
MANTISSA_BITS = {"bf16": 7, "f16": 10}
CANONICAL_NAN = {torch.float32: (torch.int32, 0x7FC00000), torch.bfloat16: (torch.int16, 0x7FC0),
                 torch.float16: (torch.int16, 0x7E00)}
RTOL, ATOL = 1e-4, 1e-5  # the loops' tolerance of tests/test_torch_robust.py
# Weiszfeld's count is compared at this tol: at the default 1e-6 the last
# steps' lengths (1-3e-6 at these shapes) are f32 rounding noise of the two
# packages' summation orders, so the count there is the noise's
COUNT_TOL = 1e-5
# the 16-bit loops stop where a step moves the centre by less than this
TOL_16 = 1e-2


def _rows(seed, n=11, d=3 * 1024 + 17):
    """Normal rows, every third x3 and row 7 x20: some rows clip at c_tau = 5
    and the Weiszfeld weights spread over two decades."""
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    x[::3] *= 3.0
    x[7 % n] *= 20.0
    return x


def _start(xj, mode):
    """The JAX package's own start (``jnp.median`` for the geometric median,
    its einsum row mean for centred clipping), as the port's tensor."""
    z0 = jnp.median(xj, axis=0) if mode == "weiszfeld" else jrobust._row_mean_einsum(xj)
    return torch.from_numpy(np.array(z0.astype(jnp.float32))).to(TORCH_DTYPES[_dt_of(xj)])


def _dt_of(xj) -> str:
    return {jnp.dtype(v): k for k, v in JAX_DTYPES.items()}[xj.dtype]


def _jax_loop(xj, mode, *, max_iter, tol=1e-6, c_tau=5.0):
    """The JAX package's loop, its iteration count and its centre: the
    geometric median's ``while_loop`` stops after step k when the step length
    ``sqrt(sum((z_k - z_{k-1})**2))`` in x's dtype is not above tol, so the
    count is read from ``geometric_median(max_iter=k)``, k = 1, 2, ...;
    centred clipping runs ``max_iter`` steps."""
    if mode == "clip":
        return max_iter, jrobust.centered_clipping(xj, c_tau=c_tau, M=max_iter)
    prev = jrobust.geometric_median(xj, max_iter=0)
    for k in range(1, max_iter + 1):
        cur = jrobust.geometric_median(xj, tol=tol, max_iter=k)
        if not bool(jnp.sqrt(jnp.sum((cur - prev) ** 2)) > tol):
            return k, cur
        prev = cur
    return max_iter, cur


def _pallas_loop(xj, z0j, mode, *, max_iter, tol, c_tau=5.0):
    """The reference's loop semantics (robust.py:727-754, :814) around its
    Pallas step in interpret mode: ``(iterations, centre)``."""
    z, it = z0j, 0
    while it < max_iter:
        zn = pk.weighted_center_step_pallas(xj, z, mode=mode, c_tau=c_tau, interpret=True)
        it += 1
        if mode == "weiszfeld" and not bool(jnp.sqrt(jnp.sum((zn - z) ** 2)) > tol):
            return it, zn
        z = zn
    return it, z


def _assert_close(ours: torch.Tensor, ref, dt: str) -> None:
    """Within rtol 1e-4 / atol 1e-5; in a 16-bit dtype also one of its ulps
    (each step rounds an f32 sum whose last bits the two summation orders
    may set differently)."""
    o = ours.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(o), np.isnan(r))
    fin = np.isfinite(r)
    o, r = o[fin], r[fin]
    tol = ATOL + RTOL * np.abs(r)
    if dt != "f32":
        m = np.maximum(np.abs(o), np.abs(r)).astype(np.float64)
        tol = tol + np.exp2(np.floor(np.log2(np.maximum(m, 1e-30))) - MANTISSA_BITS[dt])
    assert np.all(np.abs(o - r) <= tol), float(np.max(np.abs(o - r) / tol))


def _all_canonical_nan(t: torch.Tensor) -> bool:
    ints, bits = CANONICAL_NAN[t.dtype]
    return bool((t.view(ints) == bits).all())


# ---------------------------------------------------------------------------
# the loops against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("mode", ["weiszfeld", "clip"])
def test_center_loop_plain_matches_jax_loops_f32(mode, seed):
    """f32: the plain loop from the JAX package's start against its
    ``geometric_median`` (to tol 1e-6 and to COUNT_TOL, the counts equal)
    and ``centered_clipping`` (M = 10, and 30 from zero), XLA path."""
    x = _rows(seed)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    z0 = _start(xj, mode)
    if mode == "weiszfeld":
        out, its = kernels.center_loop_plain(xt, z0, mode=mode)
        _assert_close(out, jrobust.geometric_median(xj), "f32")
        out, its = kernels.center_loop_plain(xt, z0, mode=mode, tol=COUNT_TOL)
        k, ref = _jax_loop(xj, mode, max_iter=256, tol=COUNT_TOL)
        assert int(its) == k
        _assert_close(out, ref, "f32")
        return
    out, its = kernels.center_loop_plain(xt, z0, mode=mode, c_tau=5.0, max_iter=10)
    assert int(its) == 10
    _assert_close(out, jrobust.centered_clipping(xj, c_tau=5.0), "f32")
    out, _ = kernels.center_loop_plain(xt, torch.zeros_like(z0), mode=mode, c_tau=5.0, max_iter=30)
    _assert_close(out, jrobust.centered_clipping(xj, c_tau=5.0, init="zero", M=30), "f32")


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("mode", ["weiszfeld", "clip"])
def test_center_loop_plain_matches_the_pallas_step_loop(mode, dt):
    """Every dtype: the plain loop against the reference's loop around its
    Pallas step (interpret mode), from the same start, the counts equal:
    Weiszfeld to COUNT_TOL in f32 and TOL_16 in a 16-bit dtype (there the
    JAX package's XLA path rounds its weights and differences to x's dtype,
    which the kernel formula does not), clipping M = 10."""
    x = _rows(5, n=13, d=2 * 1024 + 5)
    xj = jnp.asarray(x).astype(JAX_DTYPES[dt])
    xt = torch.from_numpy(x).to(TORCH_DTYPES[dt])
    z0 = _start(xj, mode)
    z0j = jnp.asarray(z0.float().numpy()).astype(JAX_DTYPES[dt])
    tol = COUNT_TOL if dt == "f32" else TOL_16
    max_iter = 40 if mode == "weiszfeld" else 10
    out, its = kernels.center_loop_plain(xt, z0, mode=mode, c_tau=5.0, tol=tol, max_iter=max_iter)
    k, ref = _pallas_loop(xj, z0j, mode, max_iter=max_iter, tol=tol)
    assert out.dtype == TORCH_DTYPES[dt]
    assert int(its) == k and (mode == "clip" or k < max_iter)
    _assert_close(out, ref, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("mode", ["weiszfeld", "clip"])
def test_center_loop_first_step_is_the_pallas_step(mode, dt):
    """One step of the loop is ``weighted_center_step`` bit for bit, and
    within the Pallas step (interpret mode) as tests/test_torch_kernels.py
    holds it: rtol 1e-5 / atol 1e-6, one ulp in a 16-bit dtype."""
    x = _rows(6, n=9, d=1024 + 300)
    z = np.median(x, axis=0).astype(np.float32)
    xt, zt = torch.from_numpy(x).to(TORCH_DTYPES[dt]), torch.from_numpy(z).to(TORCH_DTYPES[dt])
    out, its = kernels.center_loop(xt, zt, mode=mode, c_tau=30.0, max_iter=1)
    assert int(its) == 1
    step = kernels.weighted_center_step(xt, zt, mode=mode, c_tau=30.0)
    assert torch.equal(out.view(torch.int16 if dt != "f32" else torch.int32),
                       step.view(torch.int16 if dt != "f32" else torch.int32))
    ref = pk.weighted_center_step_pallas(jnp.asarray(x).astype(JAX_DTYPES[dt]),
                                         jnp.asarray(z).astype(JAX_DTYPES[dt]), mode=mode,
                                         c_tau=30.0, interpret=True)
    o, r = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dt == "f32":
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-6)
    else:
        m = np.maximum(np.abs(o), np.abs(r)).astype(np.float64)
        ulp = np.exp2(np.floor(np.log2(np.maximum(m, 1e-30))) - MANTISSA_BITS[dt])
        assert np.all(np.abs(o - r) <= ulp + 1e-6)


@pytest.mark.parametrize("init", ["median", "mean"])
def test_robust_geometric_median_counts_as_the_jax_loop(init):
    """``robust.geometric_median`` (one loop, its count into
    last_iterations) against the JAX package's, values and count."""
    x = _rows(7)
    out = robust.geometric_median(torch.from_numpy(x), tol=COUNT_TOL, init=init)
    ref = jrobust.geometric_median(jnp.asarray(x), tol=COUNT_TOL, init=init)
    _assert_close(out, ref, "f32")
    if init == "median":
        k, _ = _jax_loop(jnp.asarray(x), "weiszfeld", max_iter=256, tol=COUNT_TOL)
        assert robust.last_iterations["geometric_median"] == k


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------


def test_first_step_is_forced_at_large_z():
    """|z| ~ 2^24: a Weiszfeld step that moves z by less than its ulp stops
    the loop after its first step (delta = 0), which the it == 0 test
    forces; an offset zprev would be absorbed and skip it (the reference's
    note at robust.py:720-726). The JAX package agrees."""
    rng = np.random.default_rng(8)
    x = (2.0 ** 24 + rng.integers(-2, 3, size=(7, 1024 + 9)) * 2.0).astype(np.float32)
    z0 = torch.from_numpy(np.median(x, axis=0).astype(np.float32) + 4.0)
    out, its = kernels.center_loop_plain(torch.from_numpy(x), z0, mode="weiszfeld")
    assert int(its) >= 1 and not torch.equal(out, z0)
    ref = jrobust.geometric_median(jnp.asarray(x))
    np.testing.assert_allclose(robust.geometric_median(torch.from_numpy(x)).numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    assert robust.last_iterations["geometric_median"] >= 1


@pytest.mark.parametrize("mode", ["weiszfeld", "clip"])
def test_zero_steps_return_the_start(mode):
    x = torch.from_numpy(_rows(9, n=5, d=700))
    z0 = x[1].clone()
    out, its = kernels.center_loop(x, z0, mode=mode, max_iter=0)
    assert torch.equal(out, z0) and out.data_ptr() != z0.data_ptr() and int(its) == 0
    if mode == "weiszfeld":
        assert torch.equal(robust.geometric_median(x, max_iter=0), robust.coordinate_median(x))
        assert robust.last_iterations["geometric_median"] == 0
    else:
        assert torch.equal(robust.centered_clipping(x, c_tau=5.0, M=0), x.mean(dim=0))


@pytest.mark.parametrize("mode", ["weiszfeld", "clip"])
def test_one_row(mode):
    """n = 1: Weiszfeld starts on the row (its mean), stays there (weight 1)
    and stops on the zero step after its forced first one; clipping walks
    towards it by c_tau a step. The JAX package agrees."""
    x = _rows(10, n=1, d=1500)
    xt = torch.from_numpy(x)
    if mode == "weiszfeld":
        out = robust.geometric_median(xt, init="mean", max_iter=50)
        assert torch.equal(out, xt[0]) and robust.last_iterations["geometric_median"] == 1
        ref = jrobust.geometric_median(jnp.asarray(x), init="mean", max_iter=50)
    else:
        out = robust.centered_clipping(xt, c_tau=0.5, init="zero", M=4)
        ref = jrobust.centered_clipping(jnp.asarray(x), c_tau=0.5, init="zero", M=4)
        assert abs(float(out.norm()) - 2.0) < 1e-4
    _assert_close(out, ref, "f32")


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("case", ["inf_row", "nan_entry"])
@pytest.mark.parametrize("mode", ["weiszfeld", "clip"])
def test_nonfinite_rows_make_the_whole_result_nan(mode, case, dt):
    """An all-inf row (weight 0, 0 * inf = NaN) or one NaN entry: the
    centre is all canonical NaN, as the reference's; Weiszfeld stops after
    its forced first step (a NaN step length is not above tol)."""
    x = _rows(11, n=6, d=900)
    if case == "inf_row":
        x[2] = np.inf
    else:
        x[4, 33] = np.nan
    xt = torch.from_numpy(x).to(TORCH_DTYPES[dt])
    z0 = robust.coordinate_median(xt)
    out, its = kernels.center_loop(xt, z0, mode=mode, c_tau=5.0, max_iter=6)
    assert _all_canonical_nan(out)
    assert int(its) == (1 if mode == "weiszfeld" else 6)
    xj = jnp.asarray(x).astype(JAX_DTYPES[dt])
    ref = (jrobust.geometric_median(xj, max_iter=6) if mode == "weiszfeld"
           else jrobust.centered_clipping(xj, c_tau=5.0, init="median", M=6))
    assert bool(jnp.all(jnp.isnan(ref)))


def test_negative_tol_runs_max_iter_steps():
    x = torch.from_numpy(_rows(12, n=8, d=1100))
    z0 = robust.coordinate_median(x)
    out, its = kernels.center_loop(x, z0, mode="weiszfeld", tol=-1.0, max_iter=23)
    assert int(its) == 23
    z = z0
    for _ in range(23):
        z = kernels.weighted_center_step(x, z)
    assert torch.equal(out, z)
    ref = jrobust.geometric_median(jnp.asarray(x.numpy()), tol=-1.0, max_iter=23)
    _assert_close(out, ref, "f32")


def test_loop_rejects_what_the_step_rejects():
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="unknown mode"):
        kernels.center_loop(x, x[0], mode="median")
    with pytest.raises(ValueError, match="z must have shape"):
        kernels.center_loop(x, x[0, :15], mode="clip")
    with pytest.raises(ValueError, match="max_iter"):
        kernels.center_loop(x, x[0], mode="clip", max_iter=-1)
    with pytest.raises(ValueError, match="unsupported dtype"):
        kernels.center_loop(x.double(), x[0].double(), mode="clip")


# ---------------------------------------------------------------------------
# the fixed order
# ---------------------------------------------------------------------------


def _numpy_tree(sq: np.ndarray) -> np.float32:
    """The kernel's order by hand (csrc/center_step.cu's header), in f32:
    per 1024-column chunk, thread t adds columns t, t + 256, t + 512,
    t + 768; a butterfly adds each warp's 32 threads; the 8 warp sums add
    in order; lane l adds chunks l, l + 32, ...; a butterfly adds the
    lanes."""
    f = np.float32

    def butterfly(v):
        v = list(v)
        for o in (16, 8, 4, 2, 1):
            v = [f(v[i] + v[i ^ o]) for i in range(32)]
        return v[0]

    d = sq.shape[0]
    chunks = -(-d // 1024)
    parts = []
    for b in range(chunks):
        threads = []
        for t in range(256):
            acc = f(0.0)
            for k in range(4):
                c = b * 1024 + t + 256 * k
                if c < d:
                    acc = f(acc + sq[c])
            threads.append(acc)
        part = f(0.0)
        for w in range(8):
            part = f(part + butterfly(threads[32 * w:32 * w + 32]))
        parts.append(part)
    lanes = []
    for lane in range(32):
        acc = f(0.0)
        for b in range(lane, chunks, 32):
            acc = f(acc + parts[b])
        lanes.append(acc)
    return butterfly(lanes)


def test_plain_order_is_the_hand_built_tree(monkeypatch):
    """The plain distances equal the hand-built tree bit for bit at d = 3 x
    1024 + 17 (a ragged last chunk), and read no device property: the
    order is fixed by d alone."""
    def no_device(*a, **k):
        raise AssertionError("the order read a device property")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "device_count", no_device)
    x = _rows(13, n=3, d=3 * 1024 + 17)
    z = np.median(x, axis=0).astype(np.float32)
    got = kernels.center_sq_dists_plain(torch.from_numpy(x), torch.from_numpy(z)).numpy()
    for i in range(3):
        diff = (x[i] - z).astype(np.float32)
        want = _numpy_tree((diff * diff).astype(np.float32))
        assert got[i].view(np.int32) == np.float32(want).view(np.int32)


def test_loop_on_the_cpu_counts_no_launch():
    kernels.reset_launch_counts()
    x = torch.from_numpy(_rows(14, n=5, d=600))
    kernels.center_loop(x, x[0].clone(), mode="weiszfeld")
    robust.centered_clipping(x, c_tau=5.0)
    assert all(v == 0 for v in kernels.launch_counts.values())
