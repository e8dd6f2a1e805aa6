"""The gossip round over a device mesh (``build_gossip_train_step(mesh=,
update_sharding=)``), the actor ``ParameterServer(update_sharding=)`` and
the compiled mesh steps, over gloo worlds of 2 and 4 ranks on the CPU,
against the JAX package's ``build_gossip_train_step(mesh=node_mesh(k))``.

Eight nodes on ``Topology.ring(8, 3)``, two byzantine mimicking honest
node 0, on ``_torch_mesh_world.linear_data``'s bundle, whose half-steps
are exact in f32 in either package. Each rank holds its nodes' rows; the
test concatenates them in rank order. The coordinate-wise family (the
median, and the trimmed mean keeping 2 of 4 rows) must agree bit for bit
with the sharded update off and on, without compression and with the
int8 exchange (the codes of exact rows are equal; a decoded value is one
product). Multi-Krum and NNM -> Multi-Krum sum over ``d`` in another
order: within rtol 1e-6, atol 1e-7, the reference's own tolerance for
``update_sharding`` on against off (``tests/test_sharded_update.py:289``).
The actor PS is held to its unsharded round within the same tolerance
(``tests/test_sharded_update.py:344``), and the compiled mesh steps on CPU
tensors equal the eager ones bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_mesh_world import GOSSIP_BYZ, GOSSIP_LR, GOSSIP_NODES, World, linear_data
from jax.sharding import Mesh

from byzpy_tpu.engine.peer_to_peer.topology import Topology as JTopology
from byzpy_tpu.models.bundle import ModelBundle as JBundle
from byzpy_tpu.ops import attack_ops as jattack
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu.parallel import gossip as jgossip

STEPS = 3
CLOSE = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda k: f"world{k}")
def world(request, tmp_path_factory):
    w = World(request.param, str(tmp_path_factory.mktemp(f"rdzv_gossip{request.param}")))
    yield w
    w.close()


def _ref_aggregate(name):
    return {
        "median": jrobust.coordinate_median,
        "trimmed": lambda m: jrobust.trimmed_mean(m, f=1),
        "multi_krum": lambda m: jrobust.multi_krum(m, f=1, q=2),
        "nnm_mk": lambda m: jrobust.nnm_multi_krum(m, f_nnm=1, f=1, q=2),
    }[name]


def ref_gossip(k, agg, *, su, comm=None):
    """The JAX package's gossip round on a ``k``-device ``nodes`` mesh,
    jitted: the ``(n, d)`` rows and the honest loss after each step."""
    w, xs, ys = linear_data(n_nodes=GOSSIP_NODES)
    bundle = JBundle(apply_fn=lambda p, x: x @ p["w"], params={"w": jnp.asarray(w)},
                     loss_fn=lambda p, x, y: jnp.mean((x @ p["w"]) * y))
    step, init = jgossip.build_gossip_train_step(
        bundle, _ref_aggregate(agg), JTopology.ring(GOSSIP_NODES, 3),
        jgossip.GossipStepConfig(GOSSIP_NODES, GOSSIP_BYZ, GOSSIP_LR),
        attack=lambda h, key: jattack.mimic(h, epsilon=0), comm_precision=comm,
        mesh=Mesh(np.array(jax.devices()[:k]), ("nodes",)), update_sharding=su)
    step = jax.jit(step)
    theta, out = init(), []
    for _ in range(STEPS):
        theta, metrics = step(theta, jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(0))
        out.append((np.asarray(theta), float(metrics["honest_loss"])))
    return out


def _port(world, agg, **kw):
    results = world.run("gossip_round", agg=agg, steps=STEPS, **kw)
    for r in results[1:]:
        assert [loss for _, loss in r] == [loss for _, loss in results[0]]
    return [(np.concatenate([r[s][0] for r in results]), results[0][s][1]) for s in range(STEPS)]


def _compare(got, want, *, exact):
    for s, ((g, gl), (w, wl)) in enumerate(zip(got, want)):
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"step {s + 1}")
        else:
            np.testing.assert_allclose(g, w, err_msg=f"step {s + 1}", **CLOSE)
        np.testing.assert_allclose(gl, wl, rtol=1e-5)


@pytest.mark.parametrize("comm", ["off", "int8"])
@pytest.mark.parametrize("su", ["off", "on"])
@pytest.mark.parametrize("agg", ["median", "trimmed"])
def test_gossip_mesh_round_matches_the_reference_bitwise(world, agg, su, comm):
    _compare(_port(world, agg, su=su, comm=comm),
             ref_gossip(world.size, agg, su=su, comm=comm), exact=True)


@pytest.mark.parametrize("su", ["off", "on"])
@pytest.mark.parametrize("agg", ["multi_krum", "nnm_mk"])
def test_gossip_mesh_round_gram_families_match_the_reference(world, agg, su):
    _compare(_port(world, agg, su=su), ref_gossip(world.size, agg, su=su), exact=False)


@pytest.mark.parametrize("agg", ["median", "multi_krum"])
def test_gossip_update_sharding_on_equals_off(world, agg):
    """The reference's ``test_gossip_update_sharding_parity`` on the port:
    the feature-sharded exchange against the all-gathered one, bit for bit
    for the median and within f32 rounding for Multi-Krum."""
    _compare(_port(world, agg, su="on"), _port(world, agg, su="off"), exact=agg == "median")


def test_gossip_mesh_round_equals_the_single_device_round(world):
    """The port's mesh round (both exchanges) is its ``mesh=None`` round
    bit for bit for the median."""
    import torch

    from _torch_mesh_world import _mimic, linear_loss, port_gossip_aggregate
    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.models import ModelBundle
    from byzpy_tpu_torch.parallel import GossipStepConfig, build_gossip_train_step

    w, xs, ys = linear_data(n_nodes=GOSSIP_NODES)
    bundle = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)},
                         loss_fn=linear_loss)
    step, init = build_gossip_train_step(bundle, port_gossip_aggregate("median"),
                                         Topology.ring(GOSSIP_NODES, 3),
                                         GossipStepConfig(GOSSIP_NODES, GOSSIP_BYZ, GOSSIP_LR),
                                         attack=_mimic)
    theta, single = init(), []
    for _ in range(STEPS):
        theta, metrics = step(theta, torch.from_numpy(xs), torch.from_numpy(ys))
        single.append((theta.numpy().copy(), float(metrics["honest_loss"])))
    for su in ("off", "on"):
        _compare(_port(world, "median", su=su), single, exact=True)


@pytest.mark.parametrize("mode", ["auto", "on"])
@pytest.mark.parametrize("which", ["trimmed", "nnm_mk"])
def test_actor_ps_update_sharding_matches_the_unsharded_round(world, which, mode):
    """The reference's ``test_actor_ps_update_sharding_parity``: every rank
    runs the same ``ParameterServer`` over the same gradients; the
    feature-sharded inline aggregate (the plain aggregator, and the fused
    NNM -> Multi-Krum pipeline) matches the unsharded one."""
    base = world.run("actor_ps", which=which, mode=None)
    shard = world.run("actor_ps", which=which, mode=mode)
    for a, b in zip(shard, base):
        np.testing.assert_allclose(a, b, **CLOSE)
        np.testing.assert_array_equal(a, shard[0])


@pytest.mark.parametrize("kind", ["ps", "gossip"])
def test_compiled_mesh_step_on_cpu_tensors_is_the_eager_step(world, kind):
    for eager, compiled in world.run("compiled_equals_eager", kind=kind):
        for e, c in zip(eager, compiled):
            np.testing.assert_array_equal(c, e)


def test_every_door_of_the_training_mesh_builds(world):
    """The training mesh's doors build: the grid round, the compiled mesh
    steps, the gossip mesh round, the ring and the actor PS's
    ``update_sharding``."""
    for result in world.run("refusals"):
        for door in ("grid_round", "jit_mesh", "gossip", "jit_gossip", "ring_gossip", "actor_ps"):
            assert result[door] is None, (door, result[door])
