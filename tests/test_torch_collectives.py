"""The collectives over a gloo world of 2 and of 4 ranks on the CPU,
against the JAX package's collectives in ``shard_map`` (and its GSPMD
``reshard_q``) on a CPU mesh of the same size.

Each rank's input is row ``rank`` of an array made from a seed with
numpy; the JAX package runs the same function per device over the
stacked array. Tolerance 0 everywhere the value is order-free: gathers,
all-to-alls, shifts, the ring all-reduce (the port adds in the
reference's order), sums of small integers, the quantized gathers,
all-to-alls and reshards (the same codes and scales decode to the same
bits). Where a decoded value is added to a partial sum (the compressed
ring, the quantized reduce-scatter, the second error-feedback round),
XLA on the CPU contracts the decode's multiply and the add into one fused
multiply-add where the port rounds twice: those hold within 2 f32 ulp of
the largest result a sum (the second error-feedback round, whose input
moved by such an ulp, within one code step).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_mesh_world import World, local_inputs
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from byzpy_tpu.parallel import collectives as JC

SIZES = [2, 4]
CODED = ["int8", "fp8", "fp8_e5m2", "s4"]
# one code step of each coded mode relative to its block's absmax
CODE_STEP = {"int8": 1 / 127, "s4": 1 / 7, "fp8": 32 / 448, "fp8_e5m2": 8192 / 57344}
MODES = ["bf16", *CODED]


@pytest.fixture(scope="module", params=SIZES, ids=lambda k: f"world{k}")
def world(request, tmp_path_factory):
    w = World(request.param, str(tmp_path_factory.mktemp(f"rdzv{request.param}")))
    yield w
    w.close()


def _mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("nodes",))


def _per_device(fn, xs):
    """``fn`` of each device's row of ``xs`` inside the JAX package's
    ``shard_map``, the results stacked in device order."""
    k = xs.shape[0]
    f = JC.sharded_fn(_mesh(k), "nodes", lambda b: fn(b[0])[None],
                      in_spec=P("nodes"), out_spec=P("nodes"))
    return np.asarray(f(jnp.asarray(xs)))


def _check(world, op, *, shape, kind="normal", kw=None, ref_fn, atol=0.0, seed=0):
    got = np.stack(world.run("collective", op=op, seed=seed, shape=shape, kind=kind, kw=kw))
    want = _per_device(ref_fn, local_inputs(seed, world.size, shape, kind))
    assert got.shape == want.shape and got.dtype == want.dtype
    if atol:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)


# -- primitives -------------------------------------------------------------

PRIMITIVES = {
    "all_gather_axis0": ("all_gather", (3, 16), "normal", {"axis": 0},
                         lambda b: JC.all_gather(b, "nodes", axis=0)),
    "all_gather_axis1": ("all_gather", (3, 16), "normal", {"axis": 1},
                         lambda b: JC.all_gather(b, "nodes", axis=1)),
    "all_gather_untiled": ("all_gather", (3, 16), "normal", {"axis": 1, "tiled": False},
                           lambda b: JC.all_gather(b, "nodes", axis=1, tiled=False)),
    "all_reduce_sum": ("all_reduce_sum", (5, 7), "int", {},
                       lambda b: JC.all_reduce_sum(b, "nodes")),
    "all_reduce_mean": ("all_reduce_mean", (5, 7), "int", {},
                        lambda b: JC.all_reduce_mean(b, "nodes")),
    "reduce_scatter_axis0": ("reduce_scatter_sum", (8, 6), "int", {"axis": 0},
                             lambda b: JC.reduce_scatter_sum(b, "nodes", axis=0)),
    "reduce_scatter_axis1": ("reduce_scatter_sum", (3, 8), "int", {"axis": 1},
                             lambda b: JC.reduce_scatter_sum(b, "nodes", axis=1)),
    "all_to_all_1_0": ("all_to_all", (4, 8), "normal", {"split_axis": 1, "concat_axis": 0},
                       lambda b: JC.all_to_all(b, "nodes", split_axis=1, concat_axis=0)),
    "all_to_all_0_1": ("all_to_all", (8, 3), "normal", {"split_axis": 0, "concat_axis": 1},
                       lambda b: JC.all_to_all(b, "nodes", split_axis=0, concat_axis=1)),
    "neighbor_shift_1": ("neighbor_shift", (2, 5), "normal", {"offset": 1},
                         lambda b: JC.neighbor_shift(b, "nodes", offset=1)),
    "neighbor_shift_3": ("neighbor_shift", (2, 5), "normal", {"offset": 3},
                         lambda b: JC.neighbor_shift(b, "nodes", offset=3)),
    "ring_all_reduce": ("ring_all_reduce_sum", (7, 9), "normal", {},
                        lambda b: JC.ring_all_reduce_sum(b, "nodes")),
}


@pytest.mark.parametrize("case", sorted(PRIMITIVES))
def test_primitive_matches_shard_map(world, case):
    op, shape, kind, kw, ref = PRIMITIVES[case]
    _check(world, op, shape=shape, kind=kind, kw=kw, ref_fn=ref)


def test_axis_size_and_index(world):
    got = world.run("collective", op="all_gather", seed=0, shape=(1,), kind="int")
    assert all(g.shape == (world.size,) for g in got)


# -- quantized collectives ---------------------------------------------------


def _ulps(world, fn, shape, sums):
    """``sums`` f32 ulp of the largest magnitude ``fn`` gives on the
    stacked inputs (the reference's result)."""
    want = _per_device(fn, local_inputs(0, world.size, shape))
    return sums * 2 * float(np.spacing(np.float32(np.abs(want).max())))


@pytest.mark.parametrize("mode", MODES)
def test_ring_all_reduce_compressed_matches(world, mode):
    ref = functools.partial(JC.ring_all_reduce_sum, axis_name="nodes", precision=mode)
    atol = 0.0 if mode == "bf16" else _ulps(world, ref, (4, 256), world.size - 1)
    _check(world, "ring_all_reduce_sum", shape=(4, 256), kw={"precision": mode}, ref_fn=ref,
           atol=atol)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_all_gather_q_matches(world, mode, axis):
    _check(world, "all_gather_q", shape=(4, 512), kw={"precision": mode, "axis": axis},
           ref_fn=lambda b: JC.all_gather_q(b, "nodes", precision=mode, axis=axis))


@pytest.mark.parametrize("mode", MODES)
def test_reduce_scatter_sum_q_matches(world, mode):
    ref = functools.partial(JC.reduce_scatter_sum_q, axis_name="nodes", precision=mode)
    _check(world, "reduce_scatter_sum_q", shape=(8, 512), kw={"precision": mode}, ref_fn=ref,
           atol=_ulps(world, ref, (8, 512), world.size - 1))


@pytest.mark.parametrize("mode", MODES)
def test_all_to_all_q_matches(world, mode):
    _check(world, "all_to_all_q", shape=(8, 2, 256),
           kw={"precision": mode, "split_axis": 0, "concat_axis": 1},
           ref_fn=lambda b: JC.all_to_all_q(b, "nodes", precision=mode, split_axis=0,
                                            concat_axis=1))


def test_quantized_collectives_refuse_straddling_blocks(world):
    with pytest.raises(RuntimeError, match="multiple of the quantization block"):
        world.run("collective", op="all_gather_q", seed=0, shape=(4, 100),
                  kw={"precision": "int8", "axis": 1})
    with pytest.raises(RuntimeError, match="leading axes"):
        world.run("collective", op="all_to_all_q", seed=0, shape=(4, 8),
                  kw={"precision": "int8", "split_axis": 1, "concat_axis": 0})


# -- reshard between layouts -----------------------------------------------

# (name, whole shape, src spec, dst spec); None is replicated
LAYOUTS = [
    ("transpose", (8, 2048), ("nodes", None), (None, "nodes")),
    ("transpose_back", (8, 2048), (None, "nodes"), ("nodes", None)),
    ("gather_flat", (2048,), ("nodes",), None),
    ("gather_rows", (8, 512), ("nodes", None), None),
    ("split_flat", (2048,), None, ("nodes",)),
]


def _ref_reshard(k, shape, src, dst, mode, *, ef=False, seed=0):
    mesh = _mesh(k)

    def layout(spec):
        return NamedSharding(mesh, P() if spec is None else P(*spec))

    x = jnp.asarray(local_inputs(seed, 1, shape)[0])
    if not ef:
        return np.asarray(jax.jit(lambda v: JC.reshard_q(v, layout(src), layout(dst),
                                                         precision=mode))(x))
    step = jax.jit(lambda v, r: JC.reshard_q_ef(v, r, layout(src), layout(dst), precision=mode))
    r = jnp.zeros_like(x)
    outs = []
    for _ in range(2):
        y, r = step(x, r)
        outs.append((np.asarray(y), np.asarray(r)))
    return outs


def _blocks(whole, spec, k):
    for dim, entry in enumerate(spec or ()):
        if entry == "nodes":
            return np.split(whole, k, axis=dim)
    return [whole] * k


@pytest.mark.parametrize("mode", [None, *MODES])
@pytest.mark.parametrize("name,shape,src,dst", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_reshard_q_matches_gspmd(world, name, shape, src, dst, mode):
    got = world.run("reshard", seed=0, shape=shape, src=src, dst=dst, precision=mode)
    want = _blocks(_ref_reshard(world.size, shape, src, dst, mode), dst, world.size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", CODED)
def test_reshard_q_ef_matches_gspmd(world, mode):
    """Two error-feedback rounds of the transpose: round 1's decoded
    blocks bit for bit and its residual within one ulp of the decoded
    value (XLA on the CPU contracts ``xc - codes * scale`` into a fused
    multiply-add); round 2, whose input carries that residual, within
    one code step of its block."""
    shape, src, dst = (8, 2048), ("nodes", None), (None, "nodes")
    got = world.run("reshard", seed=1, shape=shape, src=src, dst=dst, precision=mode, ef=True)
    want = _ref_reshard(world.size, shape, src, dst, mode, ef=True, seed=1)
    for rnd in range(2):
        ys = _blocks(want[rnd][0], dst, world.size)
        rs = _blocks(want[rnd][1], src, world.size)
        for rank in range(world.size):
            y, r = got[rank][rnd]
            ulp = float(np.spacing(np.abs(ys[rank]).max()))
            if rnd == 0:
                np.testing.assert_array_equal(y, ys[rank])
                np.testing.assert_allclose(r, rs[rank], rtol=0, atol=ulp)
            else:
                step = CODE_STEP[mode] * float(np.abs(ys[rank]).max())
                np.testing.assert_allclose(y, ys[rank], rtol=0, atol=step + ulp)
                np.testing.assert_allclose(r, rs[rank], rtol=0, atol=step + 2 * ulp)


def test_reshard_q_refuses_a_straddling_block(world):
    with pytest.raises(RuntimeError, match="multiple of the quantization block"):
        world.run("reshard", seed=0, shape=(8, 1000), src=("nodes", None), dst=(None, "nodes"),
                  precision="int8")


# -- host-level helpers ------------------------------------------------------


@pytest.mark.parametrize("which", ["allreduce", "colsum", "elementwise"])
def test_sharded_fn_and_allreduce_sharded(world, which):
    k = world.size
    shape = (4 * k, 2 * k)
    x = jnp.asarray(local_inputs(0, 1, shape, "int")[0])
    mesh = _mesh(k)
    if which == "allreduce":
        want = JC.allreduce_sharded(mesh, x)
    elif which == "colsum":
        want = JC.sharded_fn(mesh, "nodes", lambda s: JC.all_reduce_sum(s.sum(0), "nodes"),
                             in_spec=P(None, "nodes"), out_spec=P("nodes"))(x)
    else:
        want = JC.sharded_fn(mesh, "nodes", lambda s: s * 2.0 + 1.0)(x)
    for got in world.run("sharded", seed=0, shape=shape, which=which):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_traffic_record(world):
    """The record of a few collectives: opcode, dtype, result bytes and
    group size, every rank the same."""
    k = world.size
    results = world.run("traffic", seed=0)
    ops, per, total = results[0]
    assert all(r[0] == ops for r in results)
    x_bytes = 4 * 512 * 4
    assert ops[:5] == [
        ("all-gather", "float32", k * x_bytes, k),
        ("all-reduce", "float32", x_bytes, k),
        ("all-to-all", "float32", x_bytes, k),
        ("reduce-scatter", "float32", x_bytes // k, k),
        ("collective-permute", "float32", x_bytes, k),
    ]
    # the int8 gather moves codes (one byte a value) and f32 scales
    assert ops[5:] == [("all-gather", "int8", k * 4 * 512, k),
                       ("all-gather", "float32", k * 4 * 2 * 4, k)]
    assert per["all-reduce"] == 2 * x_bytes * (k - 1) // k
    assert total == sum(per.values())


def test_mesh_and_default_mesh(world):
    """``parallel.mesh`` (the reference's axis names, the -1 axis, the
    layouts' placements) and ``configs.mesh`` in every rank."""
    k = world.size
    for rank, out in enumerate(world.run("mesh_api")):
        assert out["init_again"] is False and out["init_twice"] is False
        assert out["grid"] == ((k // 2, 2), ("nodes", "data"), "nodes")
        assert out["feat"] == ((k,), ("feat",), "feat")
        assert out["grid_mesh"] == (k // 2, 2)
        assert out["placements"] == ["S(0)", "S(1)"]
        assert out["sharded_dims"] == (0, 1, None)
        assert all(e is not None for e in out["errors"]), out["errors"]
        assert out["default_is_mesh"] and out["set_default"] and out["cleared"]
        assert out["axis"] == (k, rank)
