"""The port's gossip round (``byzpy_tpu_torch.parallel.gossip``) and its
``Topology`` against the JAX package (``build_gossip_train_step`` with
``mesh=None``), on the CPU.

Exact parity of a compressed round needs the same flat order and the same
half-step bits in both packages. The single-leaf linear bundle has one
row-major leaf ``w`` in both, and its data are dyadic (inputs in {-1, 0,
1}, weights and targets multiples of 1/64, ``B * d_out = 128``), so every
node's first gradient is exact in f32 whatever the summation order: the
broadcast matrices, and so the int8 codes, are equal bit for bit at step
1. The MLP ravels in another order in each package (flax sorts, the port
follows ``named_parameters``), so its compressed round is held within
the codec's error bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.engine.peer_to_peer.topology import Topology as JTopology
from byzpy_tpu.models import data as jdata
from byzpy_tpu.models import nets as jnets
from byzpy_tpu.models.bundle import ModelBundle as JBundle
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu.parallel import gossip as jgossip
from byzpy_tpu.utils.trees import ravel_pytree_fn
from byzpy_tpu_torch.engine.peer_to_peer import Topology
from byzpy_tpu_torch.models import ModelBundle, from_flax, nets, ordered_like, synthetic_classification
from byzpy_tpu_torch.ops import kernels, robust
from byzpy_tpu_torch.parallel import GossipStepConfig, build_gossip_train_step, quantization

N = 8
LR = 0.05
# f32 tolerance of a round whose inputs are equal bit for bit: the
# aggregators sum in another order in each package
EXACT = dict(rtol=1e-6, atol=1e-7)


def _topologies(cls):
    return {
        "ring1": cls.ring(N, 1),
        "ring2": cls.ring(N, 2),
        "complete": cls.complete(N),
        # test_parallel_gossip.py:72: node 2 has in-degree 2, the rest 1
        "irregular": cls.from_edges(N, [(i, (i + 1) % N) for i in range(N)] + [(0, 2)]),
    }


TOPOLOGIES = _topologies(Topology)
JTOPOLOGIES = _topologies(JTopology)


def _trim_f(name):
    """The trimmed mean's f on a topology: at most 2, and 2f below its
    smallest neighbourhood."""
    kmin = min(len(r) for r in TOPOLOGIES[name].in_neighbor_lists())
    return min(2, (kmin - 1) // 2)


def _aggregators(name):
    f = _trim_f(name)
    return {
        "mean": (lambda m: m.mean(dim=0), lambda m: jnp.mean(m, axis=0)),
        "median": (robust.coordinate_median, jrobust.coordinate_median),
        "trimmed": (lambda m: robust.trimmed_mean(m, f=f), lambda m: jrobust.trimmed_mean(m, f=f)),
    }


def _byz(name):
    return 2 if name == "complete" else 1


def _attack(h, g):
    return -h.mean(dim=0, keepdim=True)


def _jattack(h, key):
    return -jnp.mean(h, axis=0, keepdims=True)


# ---------------------------------------------------------------------------
# the dyadic linear bundle
# ---------------------------------------------------------------------------

D_IN, D_OUT, BATCH = 100, 8, 16  # d = 800: three 256-blocks and a partial one


def _linear(seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.integers(-32, 33, size=(D_IN, D_OUT)) / 64.0).astype(np.float32)
    xs = rng.integers(-1, 2, size=(N, BATCH, D_IN)).astype(np.float32)
    ys = (rng.integers(-64, 65, size=(N, BATCH, D_OUT)) / 64.0).astype(np.float32)

    def loss(p, x, y):
        return torch.mean((x @ p["w"] - y) ** 2)

    def jloss(p, x, y):
        return jnp.mean((x @ p["w"] - y) ** 2)

    ours = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)}, loss_fn=loss)
    ref = JBundle(apply_fn=lambda p, x: x @ p["w"], params={"w": jnp.asarray(w)}, loss_fn=jloss)
    return ours, ref, xs, ys


def _code_step(theta: torch.Tensor, mode: str) -> torch.Tensor:
    """One code step of ``mode`` at each coordinate of ``theta``'s blocks
    (twice the round-to-nearest bound; bf16: one unit in the last place)."""
    if mode == "bf16":
        return theta.abs() * 2.0 ** -7
    if mode == "int8":
        return 2.0 * quantization.quantization_error_bound(theta, mode="int8")
    return torch.zeros_like(theta)


@pytest.mark.parametrize("mode", ["off", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("agg", ["mean", "median", "trimmed"])
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_gossip_round_matches_jax_on_the_linear_bundle(topo, agg, mode):
    """2 gossip rounds, 1 byzantine (2 on the complete graph) sign-flipping
    the honest mean. Step 1 within f32 rounding of the reference (its
    broadcast matrix and codes are the port's bit for bit); step 2 within
    one code step of the mode at each coordinate on top (the step-1 rows
    differ in their last bits, which can move a value across a rounding
    boundary). ``fp8`` exchanges uncompressed rows in both packages."""
    ours_b, ref_b, xs, ys = _linear()
    ours_agg, ref_agg = _aggregators(topo)[agg]
    b = _byz(topo)
    step, init = build_gossip_train_step(
        ours_b, ours_agg, TOPOLOGIES[topo], GossipStepConfig(N, b, LR), attack=_attack,
        comm_precision=mode)
    jstep, jinit = jgossip.build_gossip_train_step(
        ref_b, ref_agg, JTOPOLOGIES[topo], jgossip.GossipStepConfig(N, b, LR), attack=_jattack,
        comm_precision=mode)
    jstep = jax.jit(jstep)
    theta, jtheta = init(), jinit()
    np.testing.assert_array_equal(theta.numpy(), np.asarray(jtheta))
    tol = torch.zeros_like(theta)
    for s in range(2):
        theta, metrics = step(theta, torch.from_numpy(xs), torch.from_numpy(ys))
        jtheta, jmetrics = jstep(jtheta, jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(s))
        want = torch.from_numpy(np.array(jtheta))
        excess = (theta - want).abs() - (EXACT["atol"] + EXACT["rtol"] * want.abs() + tol)
        assert float(excess.max()) <= 0.0, f"step {s + 1}: {float(excess.max()):.3g} past the tolerance"
        np.testing.assert_allclose(float(metrics["honest_loss"]), float(jmetrics["honest_loss"]),
                                   rtol=1e-6)
        tol = tol + _code_step(theta, mode)


@pytest.mark.parametrize("mode", ["fp8", "fp8_e5m2", "s4"])
def test_gossip_sub_int8_modes_exchange_uncompressed(mode):
    """The reference's replicated exchange compresses only bf16 and int8;
    every other mode falls to its uncompressed ``else`` (gossip.py:233-235).
    The port does the same: the round is bit-identical to ``off``."""
    ours_b, _, xs, ys = _linear(seed=1)
    outs = []
    for m in ("off", mode):
        step, init = build_gossip_train_step(
            ours_b, robust.coordinate_median, TOPOLOGIES["ring2"], GossipStepConfig(N, 1, LR),
            attack=_attack, comm_precision=m)
        outs.append(step(init(), torch.from_numpy(xs), torch.from_numpy(ys))[0])
    assert torch.equal(outs[0], outs[1])


def test_gossip_off_is_the_default_and_counts_no_launch_on_the_cpu():
    ours_b, _, xs, ys = _linear(seed=2)
    before = dict(kernels.launch_counts)
    outs = []
    for kw in ({}, {"comm_precision": None}, {"comm_precision": "off"},
               {"comm_precision": quantization.CommPrecision()}):
        step, init = build_gossip_train_step(
            ours_b, robust.coordinate_median, TOPOLOGIES["complete"], GossipStepConfig(N, 2, LR),
            attack=_attack, **kw)
        outs.append(step(init(), torch.from_numpy(xs), torch.from_numpy(ys))[0])
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    step, init = build_gossip_train_step(
        ours_b, robust.coordinate_median, TOPOLOGIES["complete"], GossipStepConfig(N, 2, LR),
        comm_precision="int8")
    step(init(), torch.from_numpy(xs), torch.from_numpy(ys))
    assert kernels.launch_counts == before


# ---------------------------------------------------------------------------
# the MLP: the flat orders differ
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mlp():
    jb = jnets.mnist_mlp(hidden=16, seed=0)
    bundle = nets.mnist_mlp(hidden=16, seed=0, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jb.params))
    bundle.params = ordered_like(from_flax(tree, device="cpu"), bundle.params)
    x, y = synthetic_classification(n_samples=N * 32, seed=11, device="cpu")
    jx, jy = jdata.synthetic_classification(n_samples=N * 32, seed=11)
    return (bundle, jb, x.reshape(N, 32, 28, 28, 1), y.reshape(N, 32),
            jx.reshape(N, 32, 28, 28, 1), jy.reshape(N, 32))


def _to_port_rows(jtheta, jb, bundle):
    """The reference's ``(n, d)`` theta in the port's flat order."""
    _, unravel = ravel_pytree_fn(jb.params)
    rows = []
    for row in np.asarray(jtheta):
        tree = jax.tree_util.tree_map(np.asarray, unravel(jnp.asarray(row)))
        p = ordered_like(from_flax(tree, device="cpu"), bundle.params)
        rows.append(torch.cat([v.reshape(-1) for v in p.values()]))
    return torch.stack(rows)


@pytest.mark.parametrize("mode", ["off", "int8"])
@pytest.mark.parametrize("topo", ["ring2", "complete"])
def test_gossip_mlp_matches_jax(mlp, topo, mode):
    """One round of ``mnist_mlp(hidden=16)``: off within the PS tests'
    rtol 1e-4, atol 1e-5; int8 within that plus each package's codec bound
    (its blocks group other coordinates: the two decoded broadcasts are
    each within ``absmax / 254`` of the half-steps, and the median moves no
    further than its inputs)."""
    bundle, jb, xs, ys, jxs, jys = mlp
    b = _byz(topo)
    ours_agg, ref_agg = _aggregators(topo)["median"]
    step, init = build_gossip_train_step(bundle, ours_agg, TOPOLOGIES[topo],
                                         GossipStepConfig(N, b, LR), attack=_attack,
                                         comm_precision=mode)
    jstep, jinit = jgossip.build_gossip_train_step(jb, ref_agg, JTOPOLOGIES[topo],
                                                   jgossip.GossipStepConfig(N, b, LR),
                                                   attack=_jattack, comm_precision=mode)
    theta0 = init()
    theta, metrics = step(theta0, xs, ys)
    jtheta, jmetrics = jax.jit(jstep)(jinit(), jxs, jys, jax.random.PRNGKey(0))
    want = _to_port_rows(jtheta, jb, bundle)
    tol = 1e-5 + 1e-4 * want.abs()
    if mode == "int8":
        # the half-steps' largest magnitude bounds every block's absmax
        tol = tol + 2.0 * float(theta0.abs().max() + 1.0) / 254.0
    assert bool(((theta - want).abs() <= tol).all())
    np.testing.assert_allclose(float(metrics["honest_loss"]), float(jmetrics["honest_loss"]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the round's own semantics
# ---------------------------------------------------------------------------


def _half_steps(bundle, theta, xs, ys, lr):
    """Every node's local SGD half-step by hand (the oracle of
    test_parallel_gossip.py:30)."""
    from torch.func import grad

    from byzpy_tpu_torch.utils import ravel_fn

    ravel, unravel = ravel_fn(bundle.params)
    return torch.stack([
        theta[i] - lr * ravel(grad(bundle.loss_fn)(unravel(theta[i]), xs[i], ys[i]))
        for i in range(theta.shape[0])
    ])


@pytest.mark.parametrize("topo", ["ring1", "irregular"])
def test_gossip_round_is_the_exact_neighbour_mean(mlp, topo):
    """With ``aggregate = mean`` and no byzantine node, every node's new
    row is the mean of its own and its in-neighbours' half-steps
    (test_parallel_gossip.py:68 and :115)."""
    bundle, _, xs, ys, _, _ = mlp
    t = TOPOLOGIES[topo]
    step, init = build_gossip_train_step(bundle, lambda m: m.mean(dim=0), t,
                                         GossipStepConfig(N, 0, LR))
    theta0 = init()
    theta1, metrics = step(theta0, xs, ys)
    assert np.isfinite(float(metrics["honest_loss"]))
    halves = _half_steps(bundle, theta0, xs, ys, LR)
    for i in range(N):
        want = halves[[i] + t.in_neighbors(i)].mean(dim=0)
        torch.testing.assert_close(theta1[i], want, rtol=1e-4, atol=1e-5)
    assert not torch.allclose(theta1[0], theta1[1])


@pytest.mark.parametrize("mode", ["off", "int8"])
def test_gossip_training_converges_under_attack(mlp, mode):
    """test_parallel_gossip.py:133: on the complete graph with 2 of 8 nodes
    sign-flipping the honest mean, the trimmed mean (f = 2) still trains:
    the honest loss falls by a fifth in 15 rounds, int8 exchange too."""
    bundle, _, xs, ys, _, _ = mlp
    step, init = build_gossip_train_step(
        bundle, lambda m: robust.trimmed_mean(m, f=2), TOPOLOGIES["complete"],
        GossipStepConfig(N, 2, 0.1), attack=_attack, comm_precision=mode)
    theta, losses = init(), []
    for _ in range(15):
        theta, metrics = step(theta, xs, ys)
        losses.append(float(metrics["honest_loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_gossip_byzantine_nodes_keep_their_half_step(mlp):
    bundle, _, xs, ys, _, _ = mlp
    step, init = build_gossip_train_step(
        bundle, robust.coordinate_median, TOPOLOGIES["complete"], GossipStepConfig(N, 2, LR),
        attack=_attack, comm_precision="int8")
    theta0 = init()
    theta1, _ = step(theta0, xs, ys)
    halves = _half_steps(bundle, theta0, xs, ys, LR)
    torch.testing.assert_close(theta1[6:], halves[6:], rtol=1e-5, atol=1e-6)


def test_gossip_rejects_bad_configs_as_jax_does():
    ours_b, ref_b, _, _ = _linear()
    for cfg_args, topo_n in (((N, 0), N - 1), ((N, N), N)):
        with pytest.raises(ValueError) as ours:
            build_gossip_train_step(ours_b, robust.coordinate_median, Topology.ring(topo_n),
                                    GossipStepConfig(*cfg_args))
        with pytest.raises(ValueError) as ref:
            jgossip.build_gossip_train_step(ref_b, jrobust.coordinate_median,
                                            JTopology.ring(topo_n), jgossip.GossipStepConfig(*cfg_args))
        assert str(ours.value) == str(ref.value)
    step, init = build_gossip_train_step(ours_b, robust.coordinate_median, Topology.ring(N),
                                         GossipStepConfig(N))
    with pytest.raises(ValueError, match="node batches"):
        step(init(), torch.zeros(N - 1, 2, D_IN), torch.zeros(N - 1, 2, D_OUT))


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_topology_matches_jax(name):
    t, jt = TOPOLOGIES[name], JTOPOLOGIES[name]
    assert t.edges == jt.edges and t.n_nodes == jt.n_nodes
    assert t.is_ring() == jt.is_ring()
    for i in range(N):
        assert t.in_neighbors(i) == jt.in_neighbors(i)
        assert t.out_neighbors(i) == jt.out_neighbors(i)
    for include_self in (True, False):
        assert t.in_neighbor_lists(include_self=include_self) == \
            jt.in_neighbor_lists(include_self=include_self)
        groups, jgroups = t.in_neighbor_groups(include_self=include_self), \
            jt.in_neighbor_groups(include_self=include_self)
        assert len(groups) == len(jgroups)
        for (a, b), (ja, jb) in zip(groups, jgroups):
            np.testing.assert_array_equal(a, ja)
            np.testing.assert_array_equal(b, jb)
            assert a.dtype == ja.dtype and b.dtype == jb.dtype
        np.testing.assert_array_equal(t.in_mask(include_self=include_self),
                                      jt.in_mask(include_self=include_self))
        if name == "irregular":
            with pytest.raises(ValueError) as ours:
                t.in_neighbor_matrix(include_self=include_self)
            with pytest.raises(ValueError) as ref:
                jt.in_neighbor_matrix(include_self=include_self)
            assert str(ours.value) == str(ref.value)
        else:
            np.testing.assert_array_equal(t.in_neighbor_matrix(include_self=include_self),
                                          jt.in_neighbor_matrix(include_self=include_self))


def test_topology_errors_match_jax():
    for call in (lambda cls: cls(3).add_edge(0, 3), lambda cls: cls.ring(4).in_neighbors(-1),
                 lambda cls: cls.from_edges(3, [(0, 1)]).in_neighbor_lists(include_self=False)):
        with pytest.raises(ValueError) as ours:
            call(Topology)
        with pytest.raises(ValueError) as ref:
            call(JTopology)
        assert str(ours.value) == str(ref.value)
    t = Topology(3)
    t.add_edge(1, 1)  # self-loops are dropped
    assert t.edges == set()
