"""The 2-D ``(nodes, data)`` grid round and the ring gossip round over a
gloo world of 4 ranks on the CPU, against the JAX package's
``grid_mesh(2, 2)`` round and its ``node_mesh(4)`` ring.

The grid round holds 4 nodes (one byzantine) on a (2, 2) grid: rank
``(i, j)`` takes node rank ``i``'s two nodes and the ``j``-th half of each
node's batch, and the columns split over all four ranks. The bundle is
``_torch_mesh_world.linear_data``'s, whose gradients are exact in f32 in
either package and any summation order (so the two halves' means,
all-reduced over ``data``, are the whole batch's mean bit for bit): the
coordinate-wise family, with the byzantine node mimicking honest node 0,
must agree bit for bit (tolerance 0); under the Empire attack the Gram,
norm and distance families sum over ``d`` in another order and are held
within rtol 1e-5, atol 1e-6 after 3 steps (the mesh round's tolerance in
``tests/test_torch_mesh_ps.py``).

The collectives and ``reshard_q`` take a tuple of both axes, the group of
their product, ranked nodes major: held against the reference's
``shard_map`` and ``reshard_q`` on the same (2, 2) device grid, exact
where the value is order-free (gathers, exchanges, sums of small
integers, codes).

The ring is ``Topology.ring(4, 2)``, one node a rank, the last node
byzantine (it sends ``-half``), the coordinate median on neighbourhoods of
3 rows: without compression the rounds are bit for bit the reference's,
with and without the shard split; the int8 payload's codes are equal, and
its rounds are held within 2 ulp of each coordinate a step (XLA fuses a
decode into an FMA where the port rounds twice, ROADMAP C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_mesh_world import BATCH, GOSSIP_LR, World, linear_data, local_inputs
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from byzpy_tpu.models.bundle import ModelBundle as JBundle
from byzpy_tpu.ops import attack_ops as jattack
from byzpy_tpu.ops import preagg as jpreagg
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu.parallel import collectives as JC
from byzpy_tpu.parallel import comms as jcomms
from byzpy_tpu.parallel import gossip as jgossip
from byzpy_tpu.parallel import ps as jps
from byzpy_tpu.parallel.mesh import grid_mesh as jgrid_mesh
from byzpy_tpu.parallel.quantization import quantize_blockwise as jquantize
from byzpy_tpu_torch.parallel import comms

SIZE, GRID, NODES, STEPS = 4, (2, 2), 4, 3
EXACT = ["trimmed", "median", "mean"]
CLOSE = ["multi_krum", "cge", "geomed", "cclip", "nnm_mk", "clip+trimmed"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(SIZE, str(tmp_path_factory.mktemp("rdzv_grid")))
    yield w
    w.close()


def _bundle(w):
    return JBundle(apply_fn=lambda p, x: x @ p["w"], params={"w": jnp.asarray(w)},
                   loss_fn=lambda p, x, y: jnp.mean((x @ p["w"]) * y))


def _ref_aggregate(name):
    f, q = 1, 2
    return {
        "trimmed": lambda m: jrobust.trimmed_mean(m, f=f),
        "median": jrobust.coordinate_median,
        "mean": lambda m: jnp.mean(m, axis=0),
        "multi_krum": lambda m: jrobust.multi_krum(m, f=f, q=q),
        "cge": lambda m: jrobust.cge(m, f=f),
        "geomed": lambda m: jrobust.geometric_median(m, max_iter=64),
        "cclip": lambda m: jrobust.centered_clipping(m, c_tau=0.05, M=5),
        "nnm_mk": lambda m: jrobust.nnm_multi_krum(m, f_nnm=f, f=f, q=q),
        "clip+trimmed": (lambda m: jpreagg.clip_rows(m, threshold=0.05),
                         lambda m: jrobust.trimmed_mean(m, f=f)),
    }[name]


def ref_grid_round(agg, *, su, attack="empire"):
    """The JAX package's round on ``grid_mesh(2, 2)`` (4 CPU devices),
    jitted: each step's weights and metrics."""
    w, xs, ys = linear_data(n_nodes=NODES)
    cfg = jps.PSStepConfig(n_nodes=NODES, n_byzantine=1, learning_rate=0.125, momentum=0.5)
    fn = _ref_aggregate(agg)
    pre, fn = fn if isinstance(fn, tuple) else (None, fn)
    step, opt = jps.build_ps_train_step(
        _bundle(w), fn, cfg, pre_aggregate=pre,
        attack=(lambda h, key: jattack.empire(h)) if attack == "empire" else (
            lambda h, key: jattack.mimic(h, epsilon=0)),
        mesh=jgrid_mesh(*GRID), sharded_update=su)
    step = jax.jit(step)
    params, out = {"w": jnp.asarray(w)}, []
    for _ in range(STEPS):
        params, opt, metrics = step(params, opt, jnp.asarray(xs), jnp.asarray(ys),
                                    jax.random.PRNGKey(0))
        out.append({"w": np.asarray(params["w"]),
                    "metrics": {m: float(v) for m, v in metrics.items()}})
    return out


def _grid_run(world, agg, su, **kw):
    results = world.run("ps_round", agg=agg, su=su, grid=GRID, n_nodes=NODES, n_byz=1, f=1, q=2,
                        **kw)
    for r in results[1:]:
        for a, b in zip(results[0]["steps"], r["steps"]):
            np.testing.assert_array_equal(a["w"], b["w"])
    return results[0]["steps"]


@pytest.mark.parametrize("su", ["off", "on"])
@pytest.mark.parametrize("agg", EXACT)
def test_grid_round_matches_the_reference_bitwise(world, agg, su):
    got, want = _grid_run(world, agg, su, attack="mimic"), ref_grid_round(agg, su=su,
                                                                         attack="mimic")
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["w"], w["w"], err_msg=f"step {s + 1}")
        np.testing.assert_allclose(g["metrics"]["agg_grad_norm"], w["metrics"]["agg_grad_norm"],
                                   rtol=1e-5)
        np.testing.assert_allclose(g["metrics"]["honest_loss"], w["metrics"]["honest_loss"],
                                   rtol=1e-5)


@pytest.mark.parametrize("agg", CLOSE)
def test_grid_round_row_coupled_families_match_the_reference(world, agg):
    got, want = _grid_run(world, agg, "on"), ref_grid_round(agg, su="on")
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["w"], w["w"], rtol=1e-5, atol=1e-6, err_msg=f"step {s + 1}")


def test_grid_round_equals_the_one_axis_round_bitwise(world):
    """The grid's data split changes the layout only: the trimmed mean's
    parameters equal the port's round on a 1-D mesh of the same 4 ranks."""
    grid = _grid_run(world, "trimmed", "on")
    flat = world.run("ps_round", agg="trimmed", su="on", n_nodes=NODES, n_byz=1, f=1, q=2)[0]
    for g, w in zip(grid, flat["steps"]):
        np.testing.assert_array_equal(g["w"], w["w"])


def test_grid_round_traffic_follows_the_laws(world):
    """The grid's wire bytes a device: the update's all-gather over the
    (nodes, data) product is ``ps_round_wire_bytes``' gather term with
    ``feat_shards = nodes x data``; the transpose exchanges over ``nodes``
    only the columns of this rank's ``data`` slice, ``(k - 1) / (k D)``
    of each node's row where the law (one row a chip) counts
    ``(kD - 1) / kD``; the gradient's all-reduce over ``data`` is the
    reference's automatic psum."""
    d = linear_data()[0].size
    per, ops, _ = world.run("ps_traffic", agg="median", grid=GRID, n_nodes=NODES, n_byz=1, f=1,
                            su="on")[0]
    k, n_data = GRID
    law = comms.ps_round_wire_bytes(d, k * n_data, update_sharded=True)
    assert law == jcomms.ps_round_wire_bytes(d, k * n_data, update_sharded=True)
    assert per["all-gather"] == law / 2
    rows = NODES // k
    assert per["all-to-all"] == NODES * d // (k * n_data) * 4 * (k - 1) // k
    # the two halves' gradient means, over data: rows x d f32, a ring all-reduce
    grads = [b for op, dtype, b, g in ops if op == "all-reduce" and b == rows * d * 4]
    assert len(grads) == 1 and {g for op, _, b, g in ops if op == "all-to-all"} == {k}


# -- the ring ----------------------------------------------------------------


def test_ring_exchange_collects_neighbours(world):
    """The reference's ``test_ring_exchange_collects_neighbors``: rank i
    receives i - 1, then i - 2; int8 codes and scales cross unchanged."""
    for i, got in enumerate(world.run("ring_exchange_case", k=2)):
        assert got[:, 0].tolist() == [(i - 1) % SIZE, (i - 2) % SIZE]
    from _torch_mesh_world import local_inputs

    rows = local_inputs(7, SIZE, (600,))
    for i, (values, scales) in enumerate(world.run("ring_exchange_case", k=2, int8=True)):
        for s in (1, 2):
            q = jquantize(jnp.asarray(rows[(i - s) % SIZE]), block=256)
            np.testing.assert_array_equal(values[s - 1], np.asarray(q.values))
            np.testing.assert_array_equal(scales[s - 1], np.asarray(q.scales))


def ref_ring_round(*, su, comm):
    w, xs, ys = linear_data(n_nodes=SIZE)
    bundle = JBundle(apply_fn=lambda p, x: x @ p["w"], params={"w": jnp.asarray(w)},
                     loss_fn=lambda p, x, y: jnp.mean((x @ p["w"]) * y))
    step, init = jgossip.build_ring_gossip_train_step(
        bundle, jrobust.coordinate_median, jgossip.GossipStepConfig(SIZE, 1, GOSSIP_LR),
        Mesh(np.array(jax.devices()[:SIZE]), ("nodes",)), k=2, comm_precision=comm,
        update_sharding=su)
    step = jax.jit(step)
    theta, out = init(), []
    for _ in range(STEPS):
        theta, loss = step(theta, jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(0))
        out.append((np.asarray(theta), float(loss)))
    return out


def _ring(world, **kw):
    results = world.run("ring_round", **kw)
    return [(np.concatenate([r[s][0] for r in results]), results[0][s][1]) for s in range(STEPS)]


@pytest.mark.parametrize("comm", ["off", "bf16", "int8"])
@pytest.mark.parametrize("su", ["off", "on"])
def test_ring_round_matches_the_reference(world, su, comm):
    """Without compression bit for bit; with bf16 or int8 within 2 ulp of
    each coordinate a step."""
    got, want = _ring(world, su=su, comm=comm), ref_ring_round(su=su, comm=comm)
    for s, ((g, gl), (w, wl)) in enumerate(zip(got, want)):
        if comm == "off":
            np.testing.assert_array_equal(g, w, err_msg=f"step {s + 1}")
        else:
            ulp = np.spacing(np.abs(w).astype(np.float32))
            assert np.all(np.abs(g - w) <= 2 * (s + 1) * ulp), f"step {s + 1}"
        np.testing.assert_allclose(gl, wl, rtol=1e-5)


def test_ring_shard_split_equals_the_unsplit_round_bitwise(world):
    """The reference's ``test_ring_gossip_shard_split_parity``: the split
    (coordinate median) reproduces the ring exchange bit for bit, and the
    byzantine node keeps its half-step."""
    on, off = _ring(world, su="on"), _ring(world, su="off")
    for (a, _), (b, _) in zip(on, off):
        np.testing.assert_array_equal(a, b)
    # an int8 gather on the way back stays within a code step of the f32 split
    q = _ring(world, su="on", gather="int8")
    for s, ((a, _), (b, _)) in enumerate(zip(q, on)):
        assert np.abs(a - b).max() <= (s + 1) * np.abs(b).max() / 127, f"step {s + 1}"


def test_ring_rejects_a_mesh_of_another_size(world):
    for err in world.run("ring_wrong_size"):
        assert "must have size" in err


def test_grid_round_splits_each_nodes_batch(world):
    """A batch that does not divide over ``data`` is refused."""
    for err in world.run("grid_odd_batch"):
        assert "must divide over the 2 ranks of the 'data' axis" in err, err
    assert BATCH % GRID[1] == 0


# -- collectives over both axes of the grid -----------------------------------

AXES = ("nodes", "data")
TWO_AXES = {
    "all_gather": ("all_gather", (3, 8), "normal", {"axis": 1},
                   lambda b: JC.all_gather(b, AXES, axis=1)),
    "all_reduce_sum": ("all_reduce_sum", (5, 7), "int", {},
                       lambda b: JC.all_reduce_sum(b, AXES)),
    "reduce_scatter": ("reduce_scatter_sum", (8, 3), "int", {"axis": 0},
                       lambda b: JC.reduce_scatter_sum(b, AXES, axis=0)),
    "all_to_all": ("all_to_all", (4, 8), "normal", {"split_axis": 1, "concat_axis": 0},
                   lambda b: JC.all_to_all(b, AXES, split_axis=1, concat_axis=0)),
    "neighbor_shift": ("neighbor_shift", (2, 5), "normal", {"offset": 1},
                       lambda b: JC.neighbor_shift(b, AXES, offset=1)),
    "all_gather_q_int8": ("all_gather_q", (2, 512), "normal", {"precision": "int8"},
                          lambda b: JC.all_gather_q(b, AXES, precision="int8")),
    "all_to_all_q_int8": ("all_to_all_q", (8, 512), "normal",
                          {"split_axis": 0, "concat_axis": 0, "precision": "int8"},
                          lambda b: JC.all_to_all_q(b, AXES, split_axis=0, concat_axis=0,
                                                    precision="int8")),
}


def _grid_devices():
    return jgrid_mesh(*GRID)


@pytest.mark.parametrize("case", sorted(TWO_AXES))
def test_collective_over_both_axes_matches_shard_map(world, case):
    op, shape, kind, kw, ref = TWO_AXES[case]
    got = np.stack(world.run("grid_collective", op=op, seed=3, shape=shape, kind=kind, kw=kw))
    xs = local_inputs(3, SIZE, shape, kind)
    f = JC.sharded_fn(_grid_devices(), AXES, lambda b: ref(b[0])[None], in_spec=P(AXES),
                      out_spec=P(AXES))
    want = np.asarray(f(jnp.asarray(xs)))
    np.testing.assert_array_equal(got, want)


def _grid_blocks(whole, spec):
    for dim, entry in enumerate(spec or ()):
        if entry == "nodes":
            parts = np.split(whole, GRID[0], axis=dim)
            return [parts[r // GRID[1]] for r in range(SIZE)]
        if entry == AXES:
            return np.split(whole, SIZE, axis=dim)
    return [whole] * SIZE


# (name, whole shape, src spec, dst spec): rows over nodes to columns over
# both axes and back, the flat vector over both axes gathered and split
GRID_LAYOUTS = [
    ("rows_to_columns", (4, 2048), ("nodes", None), (None, AXES)),
    ("columns_to_rows", (4, 2048), (None, AXES), ("nodes", None)),
    ("gather_flat", (2048,), (AXES,), None),
    ("split_flat", (2048,), None, (AXES,)),
]


@pytest.mark.parametrize("mode", [None, "bf16", "int8", "s4"])
@pytest.mark.parametrize("name,shape,src,dst", GRID_LAYOUTS, ids=[c[0] for c in GRID_LAYOUTS])
def test_reshard_over_both_axes_matches_gspmd(world, name, shape, src, dst, mode):
    mesh = _grid_devices()

    def layout(spec):
        return NamedSharding(mesh, P() if spec is None else P(*spec))

    x = jnp.asarray(local_inputs(0, 1, shape)[0])
    want = np.asarray(jax.jit(lambda v: JC.reshard_q(v, layout(src), layout(dst),
                                                     precision=mode))(x))
    got = world.run("grid_reshard", seed=0, shape=shape, src=src, dst=dst, precision=mode)
    for g, w in zip(got, _grid_blocks(want, dst)):
        np.testing.assert_array_equal(g, w)
