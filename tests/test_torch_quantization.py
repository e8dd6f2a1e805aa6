"""The port's compressed wire fabric (``byzpy_tpu_torch.parallel``
quantization and collectives, ``ops/codec_kernels``) against the JAX
package, on the CPU.

The codecs are held bit for bit: codes, scales and decoded values equal
the JAX XLA codecs and the Pallas kernels B13/B14/B15 in interpret mode
(every step is one IEEE operation in f32, so nothing may differ). Inputs
come from numpy with a seed and hold NaN, +-inf, an all-zero block and a
partial last block; none is subnormal (XLA on the CPU flushes those).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from byzpy_tpu.parallel import collectives as jcoll
from byzpy_tpu.parallel import quantization as jq
from byzpy_tpu_torch.ops import codec_kernels as ck
from byzpy_tpu_torch.ops import kernels
from byzpy_tpu_torch.parallel import collectives as coll
from byzpy_tpu_torch.parallel import quantization as q

MODES = ("int8", "fp8", "fp8_e5m2")
DTYPES = ("float32", "bfloat16", "float16")


def _rows(shape, seed, *, specials=True):
    """Normal values x3 of ``shape``; with ``specials``, NaN, +inf and -inf
    entries, an all-zero first block in the second row and an all-zero
    row, on the 2-D view."""
    x = (np.random.default_rng(seed).normal(size=shape) * 3.0).astype(np.float32)
    if specials and x.ndim >= 1 and x.size >= 8:
        v = x.reshape(-1, x.shape[-1])
        d = v.shape[1]
        v[0, 5 % d] = np.nan
        v[-1, 3 % d] = np.inf
        v[0, (d - 1)] = -np.inf
        if v.shape[0] > 2:
            v[1, : min(d, 100)] = 0.0
            v[2] = 0.0
    return x


def _bits(a):
    """Bit pattern of an array of any float / int dtype as an integer array."""
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _tbits(t: torch.Tensor):
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return _bits(t.contiguous().view(ints).numpy())


def _jnp(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _jax_encode(jx, mode, block, **kw):
    if mode == "int8":
        return jq.quantize_blockwise(jx, block=block, **kw)
    return jq.encode_blockwise(jx, jq.CommPrecision(mode, block=block), **kw)


# ---------------------------------------------------------------------------
# the codecs, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1000,), (37, 515), (3, 5, 300)], ids=["rank1", "rank2", "rank3"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [256, 128, 100])
@pytest.mark.parametrize("mode", MODES)
def test_codec_matches_jax_xla_and_pallas_bitwise(mode, block, dtype, shape):
    """Codes, scales, ``orig_dtype`` and decoded values equal the JAX XLA
    codec and the Pallas kernels (B13 int8 / B15 fp8 encode, B14 decode)
    in interpret mode, bit for bit."""
    x = _rows(shape, seed=hash((mode, block, dtype, shape)) % 1000)
    jx, tx = _jnp(x, dtype), _torch(x, dtype)
    ours = q.encode_blockwise(tx, q.CommPrecision(mode, block=block))
    if mode == "int8":
        assert ours.values.dtype == torch.int8
        np.testing.assert_array_equal(
            _tbits(q.quantize_blockwise(tx, block=block).values), _tbits(ours.values))
    assert ours.values.shape == tx.shape and ours.code == mode
    ref = _jax_encode(jx, mode, block, use_pallas=False)
    pallas = _jax_encode(jx, mode, block, use_pallas=True, interpret=True)
    assert ours.orig_dtype == ref.orig_dtype == dtype and ours.block == block
    for r in (ref, pallas):
        np.testing.assert_array_equal(_tbits(ours.values), _bits(r.values))
        np.testing.assert_array_equal(_tbits(ours.scales), _bits(r.scales))
    dec = q.dequantize_blockwise(ours)
    assert dec.dtype == getattr(torch, dtype) and dec.shape == tx.shape
    np.testing.assert_array_equal(_tbits(dec), _bits(jq.dequantize_blockwise(ref, use_pallas=False)))
    np.testing.assert_array_equal(
        _tbits(dec), _bits(jq.dequantize_blockwise(pallas, use_pallas=True, interpret=True)))
    f32 = q.dequantize_blockwise(ours, dtype=torch.float32)
    np.testing.assert_array_equal(
        _tbits(f32), _bits(jq.dequantize_blockwise(ref, dtype=jnp.float32, use_pallas=False)))
    assert bool(torch.isfinite(f32).all())


@pytest.mark.parametrize("out", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_decode_dtype_matches_jax(mode, out):
    """Decoding f32 codes into each dtype rounds the f32 product once, as
    the reference's ``astype`` does; a string dtype name works too."""
    x = _rows((6, 700), seed=3)
    ours = q.encode_blockwise(_torch(x, "float32"), mode)
    ref = _jax_encode(jnp.asarray(x), mode, 256)
    got = q.dequantize_blockwise(ours, dtype=getattr(torch, out))
    np.testing.assert_array_equal(_tbits(got), _bits(jq.dequantize_blockwise(ref, dtype=out)))
    assert torch.equal(q.dequantize_blockwise(ours, dtype=out), got)
    assert torch.equal(ours.dequantize(getattr(torch, out)), got)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(3, 0), (0, 5), (2, 0, 4), (0,)])
def test_empty_inputs_match_jax(shape, mode):
    jx = jnp.zeros(shape, jnp.float32)
    ours = q.encode_blockwise(torch.zeros(shape), mode)
    ref = _jax_encode(jx, mode, 256)
    assert tuple(ours.values.shape) == ref.values.shape
    assert tuple(ours.scales.shape) == ref.scales.shape
    assert ours.values.dtype == ck.code_dtype(mode) and ours.scales.dtype == torch.float32
    dec = q.dequantize_blockwise(ours, dtype=torch.bfloat16)
    assert tuple(dec.shape) == jq.dequantize_blockwise(ref).shape and dec.dtype == torch.bfloat16


def test_scalar_input_matches_jax():
    for mode in MODES:
        ours = q.encode_blockwise(torch.tensor(2.5), mode)
        ref = _jax_encode(jnp.asarray(2.5, jnp.float32), mode, 256)
        # int8 keeps the 0-d shape, the fp8 codec a trailing axis of 1, as in the reference
        assert tuple(ours.values.shape) == ref.values.shape == (() if mode == "int8" else (1,))
        assert tuple(ours.scales.shape) == ref.scales.shape == (1,)
        np.testing.assert_array_equal(_tbits(ours.scales), _bits(ref.scales))
        dec = q.dequantize_blockwise(ours)
        assert tuple(dec.shape) == jq.dequantize_blockwise(ref).shape
        assert float(dec.reshape(())) == float(jq.dequantize_blockwise(ref).reshape(()))


@pytest.mark.parametrize("mode", MODES)
def test_nonfinite_rows_cannot_poison_blocks(mode):
    """The reference's guard (test_quantization.py:56): the scale comes
    from the finite values, inf clips to the codomain edge, NaN encodes as
    0, and the decoded tensor is finite."""
    x = _rows((4, 512), seed=9, specials=False)
    x[1, 3], x[2, 300], x[3, 7] = np.inf, -np.inf, np.nan
    ours = q.encode_blockwise(torch.from_numpy(x), mode)
    dec = q.dequantize_blockwise(ours).numpy()
    assert np.isfinite(dec).all() and np.isfinite(ours.scales.numpy()).all()
    qmax = {"int8": 127.0, "fp8": 448.0, "fp8_e5m2": 57344.0}[mode]
    vals = ours.values.float().numpy()
    assert vals[1, 3] == qmax and vals[2, 300] == -qmax and vals[3, 7] == 0.0


# ---------------------------------------------------------------------------
# wire rows, error feedback, error bounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [256, 100])
@pytest.mark.parametrize("mode", MODES)
def test_dequantize_rows_matches_jax(mode, block, dtype):
    """Wire-layout rows (int8 codes, fp8 as uint8 bit patterns) decode as
    the reference's ``dequantize_rows`` does, into each dtype."""
    x = _rows((9, 777), seed=11)
    ref = _jax_encode(jnp.asarray(x), mode, block)
    wire = np.asarray(ref.values) if mode == "int8" else np.asarray(ref.values).view(np.uint8)
    want = jq.dequantize_rows(jnp.asarray(wire), ref.scales, mode=mode, block=block, d=777,
                              dtype=jnp.dtype(dtype))
    got = q.dequantize_rows(torch.from_numpy(wire.copy()), torch.from_numpy(np.array(ref.scales)),
                            mode=mode, block=block, d=777, dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(_tbits(got), _bits(want))


@pytest.mark.parametrize("mode", MODES)
def test_ef_encode_matches_jax_and_telescopes(mode):
    """``ef_encode`` equals the reference bit for bit over 8 rounds, and
    the EF contract holds (test_subint8_fabric.py:140): the residual is
    the accumulated ``true - sent`` and stays within a few rounds' bound."""
    p, jp = q.CommPrecision(mode, error_feedback=True), jq.CommPrecision(mode, error_feedback=True)
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
    per_round = float(q.quantization_error_bound(torch.from_numpy(true), mode=mode).max())
    assert np.abs(true - sent).max() <= 4 * per_round + 1e-5


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(8, 1024), (5, 1000), (64, 333), (3, 515), (7,)])
def test_roundtrip_within_error_bound(shape, mode):
    """The error contract (test_quantization.py:24, test_subint8_fabric.py:39):
    each decoded value within ``quantization_error_bound``, which equals
    the reference's."""
    x = _rows(shape, seed=len(shape) + shape[-1], specials=False)
    tx = torch.from_numpy(x)
    dec = q.dequantize_blockwise(q.encode_blockwise(tx, mode)).numpy()
    bound = q.quantization_error_bound(tx, mode=mode).numpy()
    np.testing.assert_allclose(
        bound, np.asarray(jq.quantization_error_bound(jnp.asarray(x), mode=mode)), rtol=1e-6)
    assert (np.abs(dec - x) <= bound * 1.0001 + 1e-7).all()


def test_zero_blocks_get_scale_one():
    ours = q.quantize_blockwise(torch.zeros(4, 512), block=128)
    assert ours.scales.shape == (4, 4) and bool((ours.scales == 1.0).all())
    assert bool((ours.dequantize() == 0.0).all())


# ---------------------------------------------------------------------------
# stochastic rounding
# ---------------------------------------------------------------------------


def test_stochastic_matches_jax_on_its_draws():
    """Given the reference's own uniform draws (``u=``), the stochastic
    codes equal the reference's bit for bit; ``encode_blockwise`` with a
    stochastic int8 precision takes the same path."""
    x = _rows((5, 600), seed=4)
    key = jax.random.PRNGKey(7)
    ref = jq.quantize_blockwise(jnp.asarray(x), block=256, stochastic=True, key=key)
    u = np.array(jax.random.uniform(key, (5, 3, 256), jnp.float32))
    ours = q.quantize_blockwise(torch.from_numpy(x), block=256, stochastic=True, u=torch.from_numpy(u))
    np.testing.assert_array_equal(_tbits(ours.values), _bits(ref.values))
    np.testing.assert_array_equal(_tbits(ours.scales), _bits(ref.scales))
    enc = q.encode_blockwise(torch.from_numpy(x), q.CommPrecision("int8", stochastic=True),
                             u=torch.from_numpy(u))
    assert torch.equal(enc.values, ours.values)


def test_stochastic_same_draws_same_codes_and_unbiased():
    x = torch.from_numpy(_rows((4, 512), seed=5, specials=False))
    a = q.quantize_blockwise(x, stochastic=True, generator=torch.Generator().manual_seed(1))
    b = q.quantize_blockwise(x, stochastic=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.values, b.values)
    u = torch.rand((4, 2, 256), generator=torch.Generator().manual_seed(2))
    assert torch.equal(q.quantize_blockwise(x, stochastic=True, u=u).values,
                       q.quantize_blockwise(x, stochastic=True, u=u.clone()).values)
    # unbiased: the mean of 400 decodes is within 4 standard errors of x
    gen = torch.Generator().manual_seed(3)
    decs = torch.stack([q.quantize_blockwise(x, stochastic=True, generator=gen).dequantize()
                        for _ in range(400)])
    step = q.quantize_blockwise(x).scales.repeat_interleave(256, dim=1)
    assert bool(((decs.mean(0) - x).abs() <= 4 * 0.5 * step / 20 + 1e-6).all())
    # one code step at most from x, never more
    assert bool(((decs - x).abs() <= step * 1.0001).all())


def test_stochastic_needs_draws():
    with pytest.raises(ValueError, match="PRNG key"):
        q.quantize_blockwise(torch.zeros(2, 256), stochastic=True)
    with pytest.raises(ValueError, match="PRNG key"):
        q.encode_blockwise(torch.zeros(2, 256), q.CommPrecision("int8", stochastic=True))
    with pytest.raises(ValueError, match="one draw per padded block value"):
        q.quantize_blockwise(torch.zeros(2, 300), stochastic=True, u=torch.zeros(2, 300))


# ---------------------------------------------------------------------------
# CommPrecision and the errors
# ---------------------------------------------------------------------------


def _same_error(ours_fn, ref_fn, exc):
    with pytest.raises(exc) as ours:
        ours_fn()
    with pytest.raises(exc) as ref:
        ref_fn()
    assert str(ours.value) == str(ref.value)


def test_comm_precision_laws_match_jax():
    for mode in ("off", "bf16", "int8", "fp8", "fp8_e5m2", "s4"):
        for block in (256, 64):
            ours, ref = q.CommPrecision(mode, block=block), jq.CommPrecision(mode, block=block)
            assert ours.enabled == ref.enabled and ours.blockwise == ref.blockwise
            assert ours.wire_bytes_per_value() == ref.wire_bytes_per_value()
            assert ours.wire_bytes_per_value(2) == ref.wire_bytes_per_value(2)
            assert ours.error_bound(3.0) == pytest.approx(ref.error_bound(3.0), rel=1e-12)
    assert q.as_comm_precision(None) == q.CommPrecision()
    assert q.as_comm_precision("int8") == q.CommPrecision("int8")
    p = q.CommPrecision("fp8", error_feedback=True)
    assert q.as_comm_precision(p) is p
    assert q.DEFAULT_BLOCK == jq.DEFAULT_BLOCK and q.SUB_INT8_MODES == jq.SUB_INT8_MODES


def test_comm_precision_errors_match_jax():
    _same_error(lambda: q.CommPrecision("int4"), lambda: jq.CommPrecision("int4"), ValueError)
    _same_error(lambda: q.CommPrecision("int8", block=0), lambda: jq.CommPrecision("int8", block=0),
                ValueError)
    _same_error(lambda: q.CommPrecision("s4", block=255), lambda: jq.CommPrecision("s4", block=255),
                ValueError)
    _same_error(lambda: q.as_comm_precision(3), lambda: jq.as_comm_precision(3), TypeError)
    _same_error(lambda: q.encode_blockwise(torch.zeros(2, 8), "bf16"),
                lambda: jq.encode_blockwise(jnp.zeros((2, 8)), "bf16"), ValueError)
    _same_error(
        lambda: q.encode_blockwise(torch.zeros(2, 8), q.CommPrecision("fp8", stochastic=True),
                                   generator=torch.Generator()),
        lambda: jq.encode_blockwise(jnp.zeros((2, 8)), jq.CommPrecision("fp8", stochastic=True),
                                    key=jax.random.PRNGKey(0)),
        ValueError)
    _same_error(lambda: q.quantization_error_bound(torch.zeros(4), mode="bf16"),
                lambda: jq.quantization_error_bound(jnp.zeros(4), mode="bf16"), ValueError)
    with pytest.raises(ValueError, match="no wire row codec"):
        q.dequantize_rows(torch.zeros(2, 8, dtype=torch.int8), torch.ones(2, 1), mode="bf16",
                          block=8, d=8)


def test_s4_raises_not_implemented_naming_the_roadmap():
    """s4 raised ``NotImplementedError`` (ROADMAP B16/B17) until its kernels
    came; every door that raised now runs (their bits are held to the JAX
    package in ``tests/test_torch_s4.py``): nibble 8 (code 0) decodes to 0
    at any scale, and a QuantizedBlocks without ``orig_d`` decodes the whole
    packed width."""
    x = torch.zeros(2, 512)
    zero_codes = torch.full((2, 256), 0x88, dtype=torch.uint8)
    outs = [
        q.dequantize_blockwise(q.encode_blockwise(x, "s4")),
        q.dequantize_blockwise(q.encode_blockwise(torch.zeros(2, 0), "s4")),
        q.dequantize_blockwise(q.ef_encode(x, None, "s4")[0]),
        q.dequantize_blockwise(q.QuantizedBlocks(zero_codes, torch.ones(2, 2), 256, "float32", "s4")),
        q.dequantize_rows(zero_codes, torch.ones(2, 2), mode="s4", block=256, d=512),
        coll.reshard_q(x, precision="s4"),
    ]
    assert [tuple(o.shape) for o in outs] == [(2, 512), (2, 0), (2, 512), (2, 512), (2, 512), (2, 512)]
    assert all(bool((o == 0).all()) for o in outs)


def test_codec_kernel_wrappers_check_inputs_and_count_nothing_on_the_cpu():
    before = dict(kernels.launch_counts)
    x = torch.from_numpy(_rows((3, 300), seed=1))
    for mode in MODES:
        codes, scales = ck.encode_rows(x, block=100, mode=mode)
        pc, ps = ck.encode_rows_plain(x, block=100, mode=mode)
        assert torch.equal(codes.view(torch.uint8), pc.view(torch.uint8)) and torch.equal(scales, ps)
        assert torch.equal(ck.decode_rows(codes, scales, block=100),
                           ck.decode_rows_plain(codes, scales, block=100))
    assert kernels.launch_counts == before
    with pytest.raises(ValueError, match="2-D"):
        ck.encode_rows(x[0], block=100, mode="int8")
    with pytest.raises(ValueError, match="unsupported dtype"):
        ck.encode_rows(x.double(), block=100, mode="int8")
    with pytest.raises(ValueError, match="positive int"):
        ck.encode_rows(x, block=0, mode="int8")
    with pytest.raises(ValueError, match="no blockwise code"):
        ck.encode_rows(x, block=100, mode="s4")
    with pytest.raises(ValueError, match="cover fewer"):
        ck.decode_rows(torch.zeros(3, 300, dtype=torch.int8), torch.ones(3, 2), block=100)
    with pytest.raises(ValueError, match="int8 or fp8"):
        ck.decode_rows(torch.zeros(3, 300), torch.ones(3, 3), block=100)
    with pytest.raises(ValueError, match="unsupported dtype"):
        ck.decode_rows(torch.zeros(3, 300, dtype=torch.int8), torch.ones(3, 3), block=100,
                       dtype=torch.float64)


# ---------------------------------------------------------------------------
# the single-card compressed reshard
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_device():
    mesh = Mesh(np.array(jax.devices()[:1]), ("nodes",))
    return NamedSharding(mesh, P("nodes")), NamedSharding(mesh, P(None, "nodes"))


@pytest.mark.parametrize("mode", ["off", "bf16", *MODES])
def test_reshard_q_matches_jax_one_device_mesh(one_device, mode):
    """On one device the reshard is the identity and only encode -> decode
    runs: the port's ``reshard_q`` / ``reshard_q_ef`` (src = dst = None)
    equal the reference's on a one-device mesh bit for bit, eagerly and
    under ``jit``. One exception: the jitted reference contracts the
    residual ``xc - codes * scale`` into one fused multiply-add on the
    CPU, so its residual is held within one ulp of the decoded value."""
    src, dst = one_device
    x = _rows((8, 700), seed=21, specials=False)
    res = (_rows((8, 700), seed=22, specials=False) * 1e-3).astype(np.float32)
    got = coll.reshard_q(torch.from_numpy(x), precision=mode)
    dec, new_res = coll.reshard_q_ef(torch.from_numpy(x), torch.from_numpy(res), precision=mode)
    for fn in (lambda f: f, jax.jit):
        want = fn(lambda a: jcoll.reshard_q(a, src, dst, precision=mode))(jnp.asarray(x))
        np.testing.assert_array_equal(_tbits(got), _bits(want))
        jdec, jres = fn(lambda a, r: jcoll.reshard_q_ef(a, r, src, dst, precision=mode))(
            jnp.asarray(x), jnp.asarray(res))
        np.testing.assert_array_equal(_tbits(dec), _bits(jdec))
        if fn is jax.jit:
            np.testing.assert_array_less(np.abs(new_res.numpy() - np.asarray(jres)),
                                         np.spacing(np.abs(dec.numpy())) + 1e-30)
        else:
            np.testing.assert_array_equal(_tbits(new_res), _bits(jres))
    if mode == "off":
        assert got is not None and torch.equal(got, torch.from_numpy(x))
        assert torch.equal(new_res, torch.from_numpy(res))


def test_reshard_q_takes_no_layout():
    """A layout is a ``parallel.mesh.Sharding`` (the mesh slice's reshard;
    ``tests/test_torch_collectives.py``) or ``None``: anything else, such
    as a bare name, raises."""
    x = torch.zeros(2, 8)
    for call in (lambda: coll.reshard_q(x, "src", None, precision="int8"),
                 lambda: coll.reshard_q_ef(x, x, None, "dst", precision="int8")):
        with pytest.raises(TypeError, match="Sharding"):
            call()
