"""The port's s4 codec (4-bit codes, two a byte: ``parallel.quantization``'s
s4 mode, ``ops/codec_kernels`` B16 / B17) against the JAX package, on the
CPU.

Held bit for bit: packed codes, scales and decoded values equal the JAX
XLA twins (``_quantize_s4_xla``, ``_dequantize_s4_xla``) and the Pallas
kernels B16 / B17 in interpret mode. Every step is one IEEE operation in
f32; the scale is ``absmax * f32(1/7)``, a multiply by the rounded
constant. Inputs come from numpy with a seed and hold NaN, +-inf, an
all-zero block, an all-zero row and a partial last block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from byzpy_tpu.engine.actor import wire as jwire
from byzpy_tpu.parallel import collectives as jcoll
from byzpy_tpu.parallel import quantization as jq
from byzpy_tpu_torch.ops import codec_kernels as ck
from byzpy_tpu_torch.ops import kernels
from byzpy_tpu_torch.parallel import collectives as coll
from byzpy_tpu_torch.parallel import quantization as q

DTYPES = ("float32", "bfloat16", "float16")


def _rows(shape, seed, *, specials=True):
    """Normal values x3; with ``specials``, NaN, +inf and -inf entries, an
    all-zero first 100 values in the second row and an all-zero third row,
    on the 2-D view."""
    x = (np.random.default_rng(seed).normal(size=shape) * 3.0).astype(np.float32)
    if specials and x.size >= 8:
        v = x.reshape(-1, x.shape[-1])
        d = v.shape[1]
        v[0, 5 % d] = np.nan
        v[-1, 3 % d] = np.inf
        v[0, d - 1] = -np.inf
        if v.shape[0] > 2:
            v[1, : min(d, 100)] = 0.0
            v[2] = 0.0
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _tbits(t: torch.Tensor):
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return _bits(t.contiguous().view(ints).numpy())


def _torch(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _s4(block, **kw):
    return q.CommPrecision("s4", block=block, **kw), jq.CommPrecision("s4", block=block, **kw)


@pytest.mark.parametrize("shape", [(1000,), (37, 515), (3, 5, 300), (4, 1023)],
                         ids=["rank1", "rank2", "rank3", "odd"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [256, 100, 32, 1024, 2])
def test_s4_codec_matches_jax_xla_and_pallas_bitwise(block, dtype, shape):
    """Packed codes, scales, ``orig_d`` and decoded values equal the XLA
    twins bit for bit, and the Pallas s4 kernels in interpret mode at
    blocks of 100 and more (interpret mode unrolls a tile's blocks, so
    small blocks cost minutes there; the XLA twin covers them)."""
    x = _rows(shape, seed=hash((block, dtype, shape)) % 1000)
    jx, tx = jnp.asarray(x).astype(dtype), _torch(x, dtype)
    p, jp = _s4(block)
    ours = q.encode_blockwise(tx, p)
    ref = jq.encode_blockwise(jx, jp, use_pallas=False)
    pallas = jq.encode_blockwise(jx, jp, use_pallas=True, interpret=True) if block >= 100 else ref
    assert ours.values.dtype == torch.uint8 and ours.code == "s4"
    assert ours.orig_d == ref.orig_d == shape[-1] and ours.orig_dtype == dtype
    nb = -(-shape[-1] // block)
    assert tuple(ours.values.shape) == (*shape[:-1], nb * block // 2) == ref.values.shape
    for r in (ref, pallas):
        np.testing.assert_array_equal(_tbits(ours.values), _bits(r.values))
        np.testing.assert_array_equal(_tbits(ours.scales), _bits(r.scales))
    dec = q.dequantize_blockwise(ours)
    assert dec.dtype == getattr(torch, dtype) and tuple(dec.shape) == shape
    np.testing.assert_array_equal(_tbits(dec), _bits(jq.dequantize_blockwise(ref, use_pallas=False)))
    if block >= 100:
        np.testing.assert_array_equal(
            _tbits(dec), _bits(jq.dequantize_blockwise(pallas, use_pallas=True, interpret=True)))
    f32 = q.dequantize_blockwise(ours, dtype=torch.float32)
    np.testing.assert_array_equal(
        _tbits(f32), _bits(jq.dequantize_blockwise(ref, dtype=jnp.float32, use_pallas=False)))
    assert bool(torch.isfinite(f32).all())


def test_s4_scale_multiplies_by_the_f32_constant():
    """The scale is ``absmax * f32(1/7)`` (the reference's ``absmax * (1.0 /
    7.0)``), which differs from ``absmax / 7`` on some blocks."""
    x = np.random.default_rng(0).normal(size=(8, 1000)).astype(np.float32)
    scales = q.encode_blockwise(torch.from_numpy(x), "s4").scales.numpy()
    xb = np.pad(x, ((0, 0), (0, 24))).reshape(8, 4, 256)
    absmax = np.abs(xb).max(axis=2)
    np.testing.assert_array_equal(_bits(scales), _bits(absmax * np.float32(1 / 7)))
    assert (scales != (absmax / np.float32(7))).any()


@pytest.mark.parametrize("out", DTYPES)
def test_s4_decode_dtype_and_rows_match_jax_and_the_wire(out):
    """``dequantize_rows(mode="s4")`` decodes wire-layout packed rows as the
    reference's ``dequantize_rows`` and its host codec ``decode_rows_np``
    do, into each dtype; a capacity row (zero bytes and scales) decodes to
    -0.0."""
    x = _rows((9, 777), seed=11)
    ref = jq.encode_blockwise(jnp.asarray(x), "s4")
    codes = np.concatenate([np.asarray(ref.values), np.zeros((1, ref.values.shape[1]), np.uint8)])
    scales = np.concatenate([np.asarray(ref.scales), np.zeros((1, ref.scales.shape[1]), np.float32)])
    want = jq.dequantize_rows(jnp.asarray(codes), jnp.asarray(scales), mode="s4", block=256, d=777,
                              dtype=jnp.dtype(out))
    got = q.dequantize_rows(torch.from_numpy(codes), torch.from_numpy(scales), mode="s4", block=256,
                            d=777, dtype=getattr(torch, out))
    np.testing.assert_array_equal(_tbits(got), _bits(want))
    host = jwire.decode_rows_np(codes, scales, mode="s4", block=256, d=777)
    got = q.dequantize_rows(torch.from_numpy(codes), torch.from_numpy(scales), mode="s4", block=256,
                            d=777)
    np.testing.assert_array_equal(_tbits(got), _bits(host))
    assert np.signbit(host[-1]).all() and torch.signbit(got[-1]).all() and not got[-1].any()


@pytest.mark.parametrize("shape", [(3, 0), (0, 5), (2, 0, 4), (0,)])
def test_s4_empty_inputs_match_jax(shape):
    ours = q.encode_blockwise(torch.zeros(shape), "s4")
    ref = jq.encode_blockwise(jnp.zeros(shape, jnp.float32), "s4")
    assert tuple(ours.values.shape) == ref.values.shape and ours.values.dtype == torch.uint8
    assert tuple(ours.scales.shape) == ref.scales.shape and ours.orig_d == ref.orig_d
    dec = q.dequantize_blockwise(ours, dtype=torch.bfloat16)
    assert tuple(dec.shape) == jq.dequantize_blockwise(ref).shape and dec.dtype == torch.bfloat16


def test_s4_scalar_input_matches_jax():
    ours = q.encode_blockwise(torch.tensor(2.5), "s4")
    ref = jq.encode_blockwise(jnp.asarray(2.5, jnp.float32), "s4")
    assert tuple(ours.values.shape) == ref.values.shape == (128,)
    np.testing.assert_array_equal(_tbits(ours.values), _bits(ref.values))
    dec = q.dequantize_blockwise(ours)
    assert tuple(dec.shape) == jq.dequantize_blockwise(ref).shape == (1,)
    assert float(dec[0]) == float(jq.dequantize_blockwise(ref)[0])


def test_s4_nonfinite_values_cannot_poison_blocks():
    x = _rows((4, 512), seed=9, specials=False)
    x[1, 3], x[2, 300], x[3, 7] = np.inf, -np.inf, np.nan
    ours = q.encode_blockwise(torch.from_numpy(x), "s4")
    dec = q.dequantize_blockwise(ours).numpy()
    assert np.isfinite(dec).all() and np.isfinite(ours.scales.numpy()).all()
    vals = ck.s4_values(ours.values).numpy()
    assert vals[1, 3] == 7.0 and vals[2, 300] == -7.0 and vals[3, 7] == 0.0


@pytest.mark.parametrize("block", [256, 100])
def test_s4_stochastic_matches_jax_on_its_draws(block):
    """Given the reference's own uniform draws (``u=``), the stochastic s4
    codes equal ``_quantize_s4_xla``'s bit for bit; the same draws give the
    same codes, and each decode is within one code step of ``x``."""
    x = _rows((5, 600), seed=4)
    key = jax.random.PRNGKey(7)
    p, jp = _s4(block, stochastic=True)
    ref = jq.encode_blockwise(jnp.asarray(x), jp, key=key)
    nb = -(-600 // block)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (5, nb, block), jnp.float32)))
    ours = q.encode_blockwise(torch.from_numpy(x), p, u=u)
    np.testing.assert_array_equal(_tbits(ours.values), _bits(ref.values))
    np.testing.assert_array_equal(_tbits(ours.scales), _bits(ref.scales))
    again = q.encode_blockwise(torch.from_numpy(x), p, u=u.clone())
    assert torch.equal(again.values, ours.values)
    gen = q.encode_blockwise(torch.from_numpy(x), p, generator=torch.Generator().manual_seed(1))
    step = torch.repeat_interleave(gen.scales, block, dim=1)[:, :600]
    fin = torch.isfinite(torch.from_numpy(x))
    assert bool(((gen.dequantize() - torch.from_numpy(x)).abs() <= step * 1.0001)[fin].all())
    with pytest.raises(ValueError, match="PRNG key"):
        q.encode_blockwise(torch.zeros(2, 256), p)


@pytest.mark.parametrize("block", [256, 64])
def test_s4_ef_encode_matches_jax_and_telescopes(block):
    """``ef_encode`` under s4 equals the reference bit for bit over 8
    rounds, and the residual is the accumulated ``true - sent``."""
    p, jp = _s4(block, error_feedback=True)
    r = jr = None
    sent = np.zeros((4, 515), np.float32)
    true = np.zeros_like(sent)
    for i in range(8):
        g = _rows((4, 515), seed=20 + i, specials=False) / 3.0
        qb, r = q.ef_encode(torch.from_numpy(g), r, p)
        jqb, jr = jq.ef_encode(jnp.asarray(g), jr, jp)
        np.testing.assert_array_equal(_tbits(qb.values), _bits(jqb.values))
        np.testing.assert_array_equal(_tbits(r), _bits(jr))
        sent += q.dequantize_blockwise(qb).numpy()
        true += g
    np.testing.assert_allclose(r.numpy(), true - sent, atol=1e-4)
    per_round = float(q.quantization_error_bound(torch.from_numpy(true), mode="s4", block=block).max())
    assert np.abs(true - sent).max() <= 4 * per_round + 1e-5


@pytest.mark.parametrize("shape", [(8, 1024), (5, 1000), (3, 515), (7,)])
def test_s4_roundtrip_within_error_bound(shape):
    x = _rows(shape, seed=shape[-1], specials=False)
    tx = torch.from_numpy(x)
    dec = q.dequantize_blockwise(q.encode_blockwise(tx, "s4")).numpy()
    bound = q.quantization_error_bound(tx, mode="s4").numpy()
    assert (np.abs(dec - x) <= bound * 1.0001 + 1e-7).all()


def test_s4_reshard_q_matches_jax_one_device_mesh():
    """``reshard_q`` / ``reshard_q_ef`` under s4 (src = dst = None) equal the
    reference's on a one-device mesh bit for bit, eagerly."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("nodes",))
    src, dst = NamedSharding(mesh, P("nodes")), NamedSharding(mesh, P(None, "nodes"))
    x = _rows((8, 700), seed=21, specials=False)
    res = (_rows((8, 700), seed=22, specials=False) * 1e-3).astype(np.float32)
    got = coll.reshard_q(torch.from_numpy(x), precision="s4")
    np.testing.assert_array_equal(_tbits(got), _bits(jcoll.reshard_q(jnp.asarray(x), src, dst,
                                                                     precision="s4")))
    dec, new_res = coll.reshard_q_ef(torch.from_numpy(x), torch.from_numpy(res), precision="s4")
    jdec, jres = jcoll.reshard_q_ef(jnp.asarray(x), jnp.asarray(res), src, dst, precision="s4")
    np.testing.assert_array_equal(_tbits(dec), _bits(jdec))
    np.testing.assert_array_equal(_tbits(new_res), _bits(jres))


def test_s4_kernel_wrappers_check_inputs_and_count_nothing_on_the_cpu():
    before = dict(kernels.launch_counts)
    x = torch.from_numpy(_rows((3, 300), seed=1))
    packed, scales = ck.encode_rows_s4(x, block=100)
    pp, ps = ck.encode_rows_s4_plain(x, block=100)
    assert torch.equal(packed, pp) and torch.equal(scales, ps) and packed.shape == (3, 150)
    assert torch.equal(ck.decode_rows_s4(packed, scales, block=100, d=300),
                       ck.decode_rows_s4_plain(packed, scales, block=100, d=300))
    assert kernels.launch_counts == before
    with pytest.raises(ValueError, match="even"):
        ck.encode_rows_s4(x, block=101)
    with pytest.raises(ValueError, match="2-D"):
        ck.encode_rows_s4(x[0], block=100)
    with pytest.raises(ValueError, match="unsupported dtype"):
        ck.encode_rows_s4(x.double(), block=100)
    with pytest.raises(ValueError, match="uint8"):
        ck.decode_rows_s4(packed.to(torch.int8), scales, block=100, d=300)
    with pytest.raises(ValueError, match="do not cover"):
        ck.decode_rows_s4(packed, scales, block=100, d=301)
    with pytest.raises(ValueError, match="one row per code row"):
        ck.decode_rows_s4(packed, scales[:2], block=100, d=300)
