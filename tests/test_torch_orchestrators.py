"""The port's node tier and parameter server against the JAX package's, on
the CPU: ``byzpy_tpu_torch.observability`` (the switch, spans, the
registry), ``engine.overlap``, ``engine.node`` (node ABCs, actors,
applications, distributed nodes), ``engine.parameter_server`` (the
serial, overlapped, pool-scheduled, fused-pipeline and adaptive-feed
rounds) and ``utils.training``.

The same deterministic nodes run in both packages: each gradient is a
numpy-seeded tree ``{"b", "w"}`` (sorted keys, so both packages ravel it
in one order) plus a tenth of the node's parameters, so a schedule that
computes before it applies changes the numbers. Tolerances: the median
and the selections (Krum) are exact; the means (trimmed mean, Multi-Krum,
the NNM pipeline) are held within f32 rounding (``MEAN``), since the two
packages sum in different orders. Every wait is bounded
(``asyncio.wait_for``).
"""

import asyncio
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import byzpy_tpu.aggregators as JAgg
import byzpy_tpu.engine.graph as JGraph
import byzpy_tpu.engine.node as JNode
import byzpy_tpu.engine.overlap as JOverlap
import byzpy_tpu.engine.parameter_server as JPS
import byzpy_tpu.pre_aggregators as JPre
from byzpy_tpu.attacks.adaptive import PublicRoundState as JPublicRoundState
from byzpy_tpu.models import nets as jnets
from byzpy_tpu.observability import metrics as jmetrics
from byzpy_tpu.observability import runtime as jruntime
from byzpy_tpu.observability import tracing as jtracing
from byzpy_tpu.utils import training as jtraining
import byzpy_tpu_torch.aggregators as PAgg
import byzpy_tpu_torch.engine.graph as PGraph
import byzpy_tpu_torch.engine.node as PNode
import byzpy_tpu_torch.engine.overlap as POverlap
import byzpy_tpu_torch.engine.parameter_server as PPS
import byzpy_tpu_torch.pre_aggregators as PPre
from byzpy_tpu_torch.attacks.adaptive import PublicRoundState as PPublicRoundState
from byzpy_tpu_torch.models import from_flax, nets, ordered_like, to_flax
from byzpy_tpu_torch.observability import metrics as pmetrics
from byzpy_tpu_torch.observability import runtime as pruntime
from byzpy_tpu_torch.observability import tracing as ptracing
from byzpy_tpu_torch.utils import training as ptraining

WAIT_S = 60
LR = 0.25
# f32 rounding of a mean over a handful of rows summed in another order
MEAN = dict(rtol=2e-6, atol=2e-6)
EXACT = dict(rtol=0, atol=0)


def _run(coro, timeout=WAIT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _np(tree):
    """A tree of jnp arrays or tensors as a dictionary of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _assert_trees(ours, ref, tol):
    ours, ref = _np(ours), _np(ref)
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], **tol, err_msg=k)
    else:
        np.testing.assert_allclose(ours, ref, **tol)


# ---------------------------------------------------------------------------
# one scenario, two packages
# ---------------------------------------------------------------------------

PORT = SimpleNamespace(
    name="port", node=PNode, ps=PPS, agg=PAgg, pre=PPre, graph=PGraph, overlap=POverlap,
    asarray=lambda a: torch.from_numpy(np.array(a, dtype=np.float32)),
    dev={"device": "cpu"}, public_state=PPublicRoundState)
REF = SimpleNamespace(
    name="jax", node=JNode, ps=JPS, agg=JAgg, pre=JPre, graph=JGraph, overlap=JOverlap,
    asarray=lambda a: jnp.asarray(np.array(a, dtype=np.float32)),
    dev={}, public_state=JPublicRoundState)


def _noise(node: int, rnd: int) -> dict:
    rng = np.random.default_rng(1000 * node + rnd)
    return {"b": rng.normal(size=(5,)).astype(np.float32),
            "w": rng.normal(size=(4, 3)).astype(np.float32)}


def _classes(pkg):
    """The scenario's honest and byzantine node classes for ``pkg``."""

    class Honest(pkg.node.HonestNode):
        def __init__(self, idx, *, fail_round=None, hang_round=None, release=None):
            self.idx = idx
            self.calls = 0
            self.fail_round = fail_round
            self.hang_round = hang_round
            self.release = release
            self.zombie_done = None
            self.params = {k: pkg.asarray(np.full(v.shape, 0.5 * (idx + 1), np.float32))
                           for k, v in _noise(0, 0).items()}
            self.resynced = []

        def next_batch(self):
            return None, None

        def honest_gradient(self, x, y):
            r = self.calls
            self.calls += 1
            if r == self.fail_round:
                raise RuntimeError(f"node {self.idx} lost its device")
            if r == self.hang_round:
                self.release.wait(10.0)
                self.zombie_done = True
            n = _noise(self.idx, r)
            return {k: pkg.asarray(n[k]) + 0.1 * self.params[k] for k in n}

        def apply_server_gradient(self, gradient):
            self.params = {k: self.params[k] - LR * gradient[k] for k in self.params}

        def resync_params(self, state):
            self.resynced.append(state["round"])
            self.params = dict(state["params"])

    class SignFlip(pkg.node.ByzantineNode):
        def __init__(self):
            self.applied = 0

        def next_batch(self):
            return None, None

        def byzantine_gradient(self, honest_gradients):
            mean = {k: sum(g[k] for g in honest_gradients) / len(honest_gradients)
                    for k in honest_gradients[0]}
            return {k: -3.0 * v for k, v in mean.items()}

        def apply_server_gradient(self, gradient):
            self.applied += 1

    return Honest, SignFlip


def _aggregator(pkg, name):
    return {
        "median": lambda: pkg.agg.CoordinateWiseMedian(**pkg.dev),
        "trimmed": lambda: pkg.agg.CoordinateWiseTrimmedMean(f=1, **pkg.dev),
        "krum": lambda: pkg.agg.Krum(f=1, **pkg.dev),
        "multi_krum": lambda: pkg.agg.MultiKrum(f=1, q=3, **pkg.dev),
    }[name]()


TOL = {"median": EXACT, "krum": EXACT, "trimmed": MEAN, "multi_krum": MEAN}
MODES = {
    "serial": {},
    "stream_prefetch": {"overlap": (True, 1)},
    "barrier_prefetch": {"overlap": (False, 1)},
    "stream_only": {"overlap": (True, 0)},
    "pool": {"pool": 2},
    "pool_overlap": {"pool": 2, "overlap": (True, 1)},
}


async def _ps_run(pkg, agg_name, mode, *, rounds=4, n_honest=4, actors=False, pre=None):
    Honest, SignFlip = _classes(pkg)
    honest = [Honest(i) for i in range(n_honest)]
    byz = [SignFlip()]
    spec = MODES[mode]
    kw = {}
    if "overlap" in spec:
        stream, depth = spec["overlap"]
        kw["overlap"] = pkg.overlap.OverlapConfig(stream=stream, prefetch_depth=depth)
    if "pool" in spec:
        kw["pool_config"] = pkg.graph.ActorPoolConfig(backend="thread", count=spec["pool"])
    if pre is not None:
        kw["pre_aggregator"] = pre(pkg)
    handles_h, handles_b = honest, byz
    if actors:
        handles_h = [await pkg.node.HonestNodeActor.spawn(Honest, i, backend="thread")
                     for i in range(n_honest)]
        handles_b = [await pkg.node.ByzantineNodeActor.spawn(SignFlip, backend="thread")]
    ps = pkg.ps.ParameterServer(handles_h, handles_b, aggregator=_aggregator(pkg, agg_name), **kw)
    aggregates, modes = [], []

    def on_round(i, agg):
        aggregates.append(agg)
        modes.append(None if ps.last_overlap_stats is None else ps.last_overlap_stats.mode)

    await ps.run(rounds, on_round=on_round)
    await ps.close()
    params = None
    if actors:
        for h in handles_h + handles_b:
            await h.close()
    else:
        params = [n.params for n in honest]
    return {"aggregates": aggregates, "params": params, "modes": modes,
            "rounds": ps.rounds_completed, "byz_applied": [b.applied for b in byz]}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("agg_name", sorted(TOL))
def test_ps_rounds_match_reference(agg_name, mode):
    """Every round's aggregate, every node's applied state and the overlap
    mode of each round equal the JAX package's (exact for the median and
    Krum's selection, f32 rounding for the means)."""
    ours = _run(_ps_run(PORT, agg_name, mode))
    ref = _run(_ps_run(REF, agg_name, mode))
    assert ours["rounds"] == ref["rounds"] == 4
    assert ours["modes"] == ref["modes"]
    assert ours["byz_applied"] == ref["byz_applied"]
    tol = TOL[agg_name]
    for a, b in zip(ours["aggregates"], ref["aggregates"], strict=True):
        _assert_trees(a, b, tol)
    for a, b in zip(ours["params"], ref["params"], strict=True):
        _assert_trees(a, b, tol)


@pytest.mark.parametrize("agg_name", ["median", "trimmed"])
def test_ps_overlapped_round_matches_serial(agg_name):
    """Within the port, the overlapped rounds give the serial round's
    aggregates and node states (per-node program order kept): bit for bit
    wherever the same rows reach the same program (the barrier ingest, and
    the median's slot-buffer fold); the trimmed mean's incremental fold
    sums in arrival order, so its stream rounds agree within f32 rounding
    (``tests/test_overlap_stream.py`` marks that fold not bit-identical in
    the JAX package too)."""
    serial = _run(_ps_run(PORT, agg_name, "serial"))
    for mode in ("stream_prefetch", "barrier_prefetch", "stream_only"):
        got = _run(_ps_run(PORT, agg_name, mode))
        tol = MEAN if agg_name == "trimmed" and mode != "barrier_prefetch" else EXACT
        for a, b in zip(got["aggregates"] + got["params"], serial["aggregates"] + serial["params"]):
            _assert_trees(a, b, tol)
        assert got["modes"] == ["barrier" if mode == "barrier_prefetch" else "stream"] * 4


@pytest.mark.parametrize("pre", ["nnm", "clipping", "bucketing"])
def test_ps_pre_aggregated_round_matches_reference(pre):
    """An NNM or Clipping -> Multi-Krum pair takes the fused pipeline
    (``fused_pipeline_matrix_fn``), bucketing the two-step path; the
    aggregates match the JAX package's within f32 rounding, and the
    overlapped round keeps the barrier (mode ``barrier``)."""
    makers = {
        "nnm": lambda pkg: pkg.pre.NearestNeighborMixing(f=1, **pkg.dev),
        "clipping": lambda pkg: pkg.pre.Clipping(threshold=2.0, **pkg.dev),
        "bucketing": lambda pkg: pkg.pre.Bucketing(bucket_size=1, **pkg.dev),
    }
    for mode in ("serial", "stream_prefetch"):
        ours = _run(_ps_run(PORT, "multi_krum", mode, pre=makers[pre]))
        ref = _run(_ps_run(REF, "multi_krum", mode, pre=makers[pre]))
        assert ours["modes"] == ref["modes"]
        for a, b in zip(ours["aggregates"], ref["aggregates"], strict=True):
            _assert_trees(a, b, MEAN)
        for a, b in zip(ours["params"], ref["params"], strict=True):
            _assert_trees(a, b, MEAN)


def test_ps_fused_pipeline_is_taken():
    """NNM -> Multi-Krum resolves to the fused function; a pool keeps the
    two steps."""
    agg = PAgg.MultiKrum(f=1, q=3, device="cpu")
    pre = PPre.NearestNeighborMixing(f=1, device="cpu")
    Honest, _ = _classes(PORT)
    ps = PPS.ParameterServer([Honest(0)], aggregator=agg, pre_aggregator=pre)
    assert ps._fused_pipeline is not None
    ps = PPS.ParameterServer([Honest(0)], aggregator=agg, pre_aggregator=pre,
                             pool_config=PGraph.ActorPoolConfig(backend="thread", count=2))
    assert ps._fused_pipeline is None


def test_ps_on_thread_actors_matches_reference():
    """Nodes in ``thread`` actors (``HonestNodeActor.spawn``): the same
    aggregates as the JAX package's nodes in its thread actors."""
    for mode in ("serial", "stream_prefetch"):
        ours = _run(_ps_run(PORT, "median", mode, actors=True))
        ref = _run(_ps_run(REF, "median", mode, actors=True))
        for a, b in zip(ours["aggregates"], ref["aggregates"], strict=True):
            _assert_trees(a, b, EXACT)
        local = _run(_ps_run(PORT, "median", mode))
        for a, b in zip(ours["aggregates"], local["aggregates"], strict=True):
            _assert_trees(a, b, EXACT)


def test_ps_constructor_errors_match_reference():
    for pkg_ours, pkg_ref in ((PORT, REF),):
        msgs = []
        for pkg in (pkg_ours, pkg_ref):
            Honest, _ = _classes(pkg)
            agg = _aggregator(pkg, "median")
            with pytest.raises(ValueError) as empty:
                pkg.ps.ParameterServer([], aggregator=agg)
            with pytest.raises(ValueError) as quorum:
                pkg.ps.ParameterServer([Honest(0)], aggregator=agg,
                                       elastic=pkg.ps.ElasticPolicy(min_quorum=2))
            msgs.append((str(empty.value), str(quorum.value)))
        assert msgs[0] == msgs[1]
    # update_sharding builds in both packages (the feature-sharded round is
    # held in tests/test_torch_mesh_gossip.py); an unknown mode is refused
    Honest, _ = _classes(PORT)
    for pkg in (PORT, REF):
        H, _ = _classes(pkg)
        pkg.ps.ParameterServer([H(0)], aggregator=_aggregator(pkg, "median"), update_sharding="on")
    with pytest.raises(ValueError, match="mode must be one of"):
        PPS.ParameterServer([Honest(0)], aggregator=_aggregator(PORT, "median"),
                            update_sharding="sideways")


def test_ps_round_failure_without_elastic_raises_like_reference():
    msgs = []
    for pkg in (PORT, REF):
        Honest, SignFlip = _classes(pkg)
        ps = pkg.ps.ParameterServer([Honest(0), Honest(1, fail_round=0)], [SignFlip()],
                                    aggregator=_aggregator(pkg, "median"))
        with pytest.raises(RuntimeError) as info:
            _run(ps.round())
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] == "node 1 lost its device"


def test_ps_flush_and_round_then_run_keep_serial_state():
    """Direct ``round()`` calls under prefetch leave chains; ``flush``
    settles them (every node applied the last aggregate, nothing pending),
    and the next round consumes the prefetched gradients: the state equals
    the serial schedule's."""

    async def scenario(overlap):
        Honest, SignFlip = _classes(PORT)
        honest = [Honest(i) for i in range(4)]
        ps = PPS.ParameterServer(honest, [SignFlip()], aggregator=_aggregator(PORT, "median"),
                                 overlap=overlap)
        for _ in range(3):
            await ps.round()
        await ps.flush()
        pending = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        state = ([n.params for n in honest], [n.calls for n in honest])
        await ps.close()
        return state, pending, ps._pending_honest

    (params, calls), pending, chains = _run(scenario(POverlap.OverlapConfig()))
    (sparams, scalls), _, _ = _run(scenario(None))
    assert not pending or all(t.done() for t in pending)
    assert chains is None
    for a, b in zip(params, sparams):
        _assert_trees(a, b, EXACT)
    # the prefetch computed round 4's gradients already
    assert calls == [c + 1 for c in scalls]


def test_ps_close_cancels_prefetch_chains_and_leaves_no_task():
    async def scenario():
        Honest, SignFlip = _classes(PORT)

        class Slow(Honest):
            async def honest_gradient_for_next_batch(self):
                await asyncio.sleep(0.05)
                return self.honest_gradient(None, None)

        ps = PPS.ParameterServer([Slow(i) for i in range(3)], aggregator=_aggregator(PORT, "median"),
                                 overlap=POverlap.OverlapConfig())
        await ps.round()
        assert ps._pending_honest and not all(t.done() for t in ps._pending_honest)
        await ps.close()
        return [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]

    assert _run(scenario()) == []


def test_ps_publishes_public_state_to_adaptive_nodes_like_reference():
    """A local byzantine node whose class defines ``observe_round`` gets
    each closed round's aggregate and counters, as in the JAX package."""
    seen = {}
    for pkg in (PORT, REF):
        Honest, SignFlip = _classes(pkg)
        log = []

        class Watcher(SignFlip):
            def observe_round(self, state):
                assert isinstance(state, pkg.public_state)
                log.append((state.round_id, state.server_round, _np(state.aggregate)))

        ps = pkg.ps.ParameterServer([Honest(i) for i in range(4)], [Watcher()],
                                    aggregator=_aggregator(pkg, "median"))
        _run(ps.run(3))
        seen[pkg.name] = log
    assert [e[:2] for e in seen["port"]] == [e[:2] for e in seen["jax"]] == [(0, 1), (1, 2), (2, 3)]
    for a, b in zip(seen["port"], seen["jax"]):
        _assert_trees(a[2], b[2], EXACT)


# ---------------------------------------------------------------------------
# mnist_mlp nodes with converted weights
# ---------------------------------------------------------------------------

MLP_HIDDEN = 16
MLP_BATCH = 8


def _mlp_batch(node: int, rnd: int):
    rng = np.random.default_rng(7 * node + 100 * rnd)
    x = rng.normal(size=(MLP_BATCH, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(MLP_BATCH,))
    return x, y


class _JMnistNode(JNode.HonestNode):
    def __init__(self, idx):
        self.idx, self.calls = idx, 0
        self.bundle = jnets.mnist_mlp(seed=0, hidden=MLP_HIDDEN)
        self._grad = jax.jit(jax.grad(self.bundle.loss_fn))

    def next_batch(self):
        x, y = _mlp_batch(self.idx, self.calls)
        self.calls += 1
        return jnp.asarray(x), jnp.asarray(y, dtype=jnp.int32)

    def honest_gradient(self, x, y):
        return self._grad(self.bundle.params, x, y)

    def apply_server_gradient(self, gradient):
        self.bundle = self.bundle.with_params(
            jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, self.bundle.params, gradient))


class _PMnistNode(PNode.HonestNode):
    def __init__(self, idx, flax_params):
        self.idx, self.calls = idx, 0
        self.bundle = nets.mnist_mlp(seed=0, hidden=MLP_HIDDEN, device="cpu")
        self.bundle.params = ordered_like(from_flax(flax_params, device="cpu"), self.bundle.params)
        self._grad = torch.func.grad(self.bundle.loss_fn)

    def next_batch(self):
        x, y = _mlp_batch(self.idx, self.calls)
        self.calls += 1
        return torch.from_numpy(x), torch.from_numpy(y)

    def honest_gradient(self, x, y):
        return self._grad(self.bundle.params, x, y)

    def apply_server_gradient(self, gradient):
        self.bundle.params = {k: p - 0.1 * gradient[k] for k, p in self.bundle.params.items()}


def test_mnist_mlp_nodes_three_rounds_match_reference():
    """``mnist_mlp`` nodes, the JAX package's weights carried across by
    ``models/convert.py``, fixed batches, a sign-flip node and the trimmed
    mean, 3 rounds: aggregates and final weights agree within 1e-5 (the
    two packages' gradients differ in f32 rounding)."""
    flax_params = jax.tree_util.tree_map(np.asarray, jnets.mnist_mlp(seed=0, hidden=MLP_HIDDEN).params)

    class PFlip(PNode.ByzantineNode):
        def next_batch(self):
            return None, None

        def byzantine_gradient(self, honest):
            return {k: -3.0 * sum(g[k] for g in honest) / len(honest) for k in honest[0]}

        def apply_server_gradient(self, gradient):
            pass

    class JFlip(JNode.ByzantineNode):
        def next_batch(self):
            return None, None

        def byzantine_gradient(self, honest):
            return jax.tree_util.tree_map(lambda *gs: -3.0 * sum(gs) / len(gs), *honest)

        def apply_server_gradient(self, gradient):
            pass

    pnodes = [_PMnistNode(i, flax_params) for i in range(4)]
    jnodes = [_JMnistNode(i) for i in range(4)]
    pps = PPS.ParameterServer(pnodes, [PFlip()],
                              aggregator=PAgg.CoordinateWiseTrimmedMean(f=1, device="cpu"))
    jps = JPS.ParameterServer(jnodes, [JFlip()], aggregator=JAgg.CoordinateWiseTrimmedMean(f=1))
    for _ in range(3):
        ours = _run(pps.round())
        ref = _run(jps.round())
        ours_flax = to_flax(ours)["params"]
        ref_np = jax.tree_util.tree_map(np.asarray, ref)["params"]
        for layer in ref_np:
            for leaf in ref_np[layer]:
                np.testing.assert_allclose(ours_flax[layer][leaf], ref_np[layer][leaf],
                                           rtol=1e-4, atol=1e-5, err_msg=f"{layer}/{leaf}")
    for pn, jn in zip(pnodes, jnodes):
        theirs = jax.tree_util.tree_map(np.asarray, jn.bundle.params)["params"]
        mine = to_flax(pn.bundle.params)["params"]
        for layer in theirs:
            for leaf in theirs[layer]:
                np.testing.assert_allclose(mine[layer][leaf], theirs[layer][leaf],
                                           rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# node ABCs, actors, applications, distributed nodes
# ---------------------------------------------------------------------------


def test_node_base_defaults_match_reference():
    for pkg in (PORT, REF):
        Honest, SignFlip = _classes(pkg)
        node = Honest(0)
        assert node.ping() is True
        assert node.resync_params({"round": 0, "params": node.params}) is None
        g = node.honest_gradient_for_next_batch()
        assert sorted(g) == ["b", "w"]
        b = SignFlip().byzantine_gradient_for_next_batch([g, g])
        np.testing.assert_array_equal(_np(b["w"]), -3.0 * _np(g["w"]))


def test_node_actor_spawn_and_errors_match_reference():
    async def scenario(pkg):
        Honest, SignFlip = _classes(pkg)
        errors = []
        for spawner, cls in ((pkg.node.HonestNodeActor, SignFlip),
                             (pkg.node.ByzantineNodeActor, Honest)):
            with pytest.raises(TypeError) as info:
                await spawner.spawn(cls, backend="thread")
            errors.append(str(info.value).split(" is not ")[1])
        actor = await pkg.node.HonestNodeActor.spawn(Honest, 2, backend="thread")
        async with actor:
            g = await actor.honest_gradient_for_next_batch()
            assert await actor.ping() is True
            with pytest.raises(AttributeError):
                actor._private  # noqa: B018
        return errors, _np(g)

    ours, g_ours = _run(scenario(PORT))
    ref, g_ref = _run(scenario(REF))
    assert ours == ref
    _assert_trees(g_ours, g_ref, EXACT)


def test_node_actor_cuda_backend_raises_without_a_card(monkeypatch):
    Honest, _ = _classes(PORT)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(PNode.HonestNodeActor.spawn(Honest, 0, backend="cuda"))
    # a process node's child is on the card by default: refused before a spawn
    monkeypatch.delenv("BYZPY_TPU_TORCH_CHILD_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        _run(PNode.HonestNodeActor.spawn(Honest, 0, backend="process"))


def test_node_application_registry_matches_reference():
    async def scenario(pkg):
        app = pkg.node.HonestNodeApplication(
            pool_config=pkg.graph.ActorPoolConfig(backend="thread", count=2))
        app.register_aggregation(_aggregator(pkg, "median"))
        graph = pkg.graph.ComputationGraph([pkg.graph.GraphNode(
            "double", pkg.graph.CallableOp(lambda v: 2 * v, name="double"),
            {"v": pkg.graph.GraphInput("v")})])
        app.register_pipeline("double", graph, metadata={"k": 1})
        errors = []
        for name in ("aggregate", "honest_gradient", "double"):
            with pytest.raises(ValueError) as info:
                app.register_pipeline(name, graph)
            errors.append(str(info.value))
        with pytest.raises(KeyError) as missing:
            await app.run_pipeline("nope")
        async with app:
            out = await app.run_pipeline("double", {"v": 21})
            grads = [pkg.asarray(np.arange(6, dtype=np.float32) * (i + 1)) for i in range(5)]
            agg = await app.aggregate(grads)
        byz = pkg.node.ByzantineNodeApplication()
        byz.register_attack(_empire(pkg))
        attacked = await byz.attack(honest_grads=grads)
        return (app.pipeline_names(), app.pipeline_metadata("double"), errors, str(missing.value),
                out, _np(agg), _np(attacked))

    ours = _run(scenario(PORT))
    ref = _run(scenario(REF))
    assert ours[:5] == ref[:5]
    np.testing.assert_array_equal(ours[5], ref[5])
    np.testing.assert_allclose(ours[6], ref[6], **MEAN)


def _empire(pkg):
    if pkg is PORT:
        from byzpy_tpu_torch.attacks import EmpireAttack

        return EmpireAttack(scale=-2.0, device="cpu")
    from byzpy_tpu.attacks import EmpireAttack

    return EmpireAttack(scale=-2.0)


def _distributed_classes(pkg):
    Honest, _ = _classes(pkg)

    class DHonest(pkg.node.DistributedHonestNode):
        def __init__(self, idx, **kw):
            super().__init__(**kw)
            self.inner = Honest(idx)

        def next_batch(self):
            return None, None

        def honest_gradient(self, x, y):
            return self.inner.honest_gradient(x, y)

        def apply_server_gradient(self, gradient):
            self.inner.apply_server_gradient(gradient)

    class DByz(pkg.node.DistributedByzantineNode):
        def next_batch(self):
            return None, None

        def byzantine_gradient(self, honest_gradients):
            return {k: -2.0 * sum(g[k] for g in honest_gradients) / len(honest_gradients)
                    for k in honest_gradients[0]}

        def apply_server_gradient(self, gradient):
            pass

    return DHonest, DByz


def test_distributed_nodes_in_parameter_server_match_reference():
    """``DistributedHonestNode`` (gradient as a pipeline on a thread pool
    of 2, its ``aggregate`` pipeline) and ``DistributedByzantineNode``
    (the override lifted into an ``attack`` pipeline) drive 3 PS rounds
    equal to the JAX package's."""

    async def scenario(pkg):
        DHonest, DByz = _distributed_classes(pkg)
        cfg = pkg.graph.ActorPoolConfig(backend="thread", count=2)
        honest = [DHonest(i, aggregator=_aggregator(pkg, "median"), pool_config=cfg)
                  for i in range(4)]
        byz = [DByz(pool_config=cfg)]
        ps = pkg.ps.ParameterServer(honest, byz, aggregator=_aggregator(pkg, "median"))
        aggs = []
        await ps.run(3, on_round=lambda i, a: aggs.append(_np(a)))
        own = await honest[0].aggregate([n.inner.params for n in honest])
        for n in honest + byz:
            await n.close()
        return aggs, _np(own), [_np(n.inner.params) for n in honest]

    ours = _run(scenario(PORT))
    ref = _run(scenario(REF))
    for a, b in zip(ours[0] + [ours[1]] + ours[2], ref[0] + [ref[1]] + ref[2], strict=True):
        _assert_trees(a, b, EXACT)


def test_distributed_byzantine_requires_override_like_reference():
    msgs = []
    for pkg in (PORT, REF):
        class Bare(pkg.node.DistributedByzantineNode):
            def next_batch(self):
                return None, None

            def apply_server_gradient(self, gradient):
                pass

        with pytest.raises(TypeError) as info:
            Bare()
        with pytest.raises(TypeError) as noargs:
            type("NoArgs", (pkg.node.DistributedByzantineNode,),
                 {"byzantine_gradient": lambda self: None})
        msgs.append((str(info.value), str(noargs.value)))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the overlap engine
# ---------------------------------------------------------------------------


def test_overlap_config_and_stats_match_reference():
    for pkg in (POverlap, JOverlap):
        with pytest.raises(ValueError, match="prefetch_depth must be >= 0"):
            pkg.OverlapConfig(prefetch_depth=-1)
    assert POverlap.OverlapConfig() == POverlap.OverlapConfig(stream=True, prefetch_depth=1)
    ours, ref = POverlap.RoundOverlapStats(), JOverlap.RoundOverlapStats()
    for lag in (0.3, 0.1, 0.2, 0.4, 0.05):
        ours.observe_lag(lag)
        ref.observe_lag(lag)
    for pct in (0, 25, 50, 90, 100):
        assert ours.lag_percentile(pct) == ref.lag_percentile(pct)
    assert ours.mode == ref.mode == "barrier"


@pytest.mark.parametrize("pkg", [POverlap, JOverlap], ids=["port", "jax"])
def test_gather_arrival_order_semantics(pkg):
    """Arrival order drives ``on_item``; results come in input order; the
    first error by input index is raised after every sibling settled; an
    ``on_item`` error is its item's failure; cancelling cancels the
    awaitables (``tests/test_overlap_stream.py``'s cases)."""

    async def scenario():
        seen = []

        async def item(i, delay):
            await asyncio.sleep(delay)
            return i

        assert await pkg.gather_arrival_order(
            [item(0, 0.03), item(1, 0.0), item(2, 0.015)],
            on_item=lambda i, v: seen.append(i)) == [0, 1, 2]
        assert seen == [1, 2, 0]
        done = []

        async def ok(i, delay):
            await asyncio.sleep(delay)
            done.append(i)
            return i

        async def boom(delay, exc):
            await asyncio.sleep(delay)
            raise exc

        with pytest.raises(KeyError):
            await pkg.gather_arrival_order([boom(0.02, KeyError("a")), boom(0.0, ValueError("b")),
                                            ok(3, 0.04)])
        assert done == [3]
        done.clear()

        def folder(i, v):
            if i == 0:
                raise ValueError("bad gradient shape")

        with pytest.raises(ValueError, match="bad gradient shape"):
            await pkg.gather_arrival_order([ok(0, 0.0), ok(1, 0.03)], on_item=folder)
        assert done == [0, 1]
        cancelled = []

        async def cancellable(i):
            try:
                await asyncio.sleep(30.0)
            except asyncio.CancelledError:
                cancelled.append(i)
                raise

        task = asyncio.ensure_future(pkg.gather_arrival_order([cancellable(0), cancellable(1)]))
        await asyncio.sleep(0.01)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        assert sorted(cancelled) == [0, 1]
        with pytest.raises(KeyError):
            await pkg.settle_all([boom(0.01, KeyError("x")), ok(9, 0.02)])
        assert 9 in done
        assert await pkg.settle_all([ok(1, 0.0), ok(2, 0.0)]) == [1, 2]
        assert isinstance(pkg.now(), float)

    _run(scenario())


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


@pytest.fixture
def telemetry():
    """Telemetry on in both packages, tracers and registries cleared, and
    everything switched off afterwards."""
    for rt, tr, mt in ((pruntime, ptracing, pmetrics), (jruntime, jtracing, jmetrics)):
        rt.enable()
        tr.tracer().clear()
        mt.registry().reset()
    yield
    for rt, tr in ((pruntime, ptracing), (jruntime, jtracing)):
        rt.disable()
        tr.tracer().clear()


def _spans(tracing, names):
    """``[(span name, track name or None, mode)]`` of the retained events."""
    ev = tracing.tracer().events()
    if tracing is ptracing:
        tracks = tracing.tracer().track_names()
    else:
        tracks = {tid: name for name, tid in tracing.tracer()._tracks.items()}
    return [(e["name"], tracks.get(e["tid"]), e.get("args", {}).get("mode")) for e in ev
            if e["name"] in names]


PS_SPANS = {"ps.round", "ps.gather", "ps.aggregate", "ps.broadcast", "ps.fold", "ps.fold_finalize"}


@pytest.mark.parametrize("mode", ["serial", "stream_prefetch", "barrier_prefetch", "pool"])
def test_ps_round_spans_and_metrics_match_reference(telemetry, mode):
    """With telemetry on, a PS round records the reference's spans (names,
    tracks, modes, in order) and its round counter and histogram."""
    got = {}
    for pkg, tracing, metrics in ((PORT, ptracing, pmetrics), (REF, jtracing, jmetrics)):
        _run(_ps_run(pkg, "median", mode, rounds=2))
        got[pkg.name] = (_spans(tracing, PS_SPANS), metrics.registry())
    assert got["port"][0] == got["jax"][0]
    assert got["port"][0][0][0] in PS_SPANS
    want_mode = {"serial": "serial", "pool": "serial"}.get(mode, "stream" if "stream" in mode else "barrier")
    preg, jreg = got["port"][1], got["jax"][1]
    assert preg.counter("byzpy_ps_rounds_total", labels={"mode": want_mode}).value == \
        jreg.counter("byzpy_ps_rounds_total", labels={"mode": want_mode}).value == 2
    assert preg.histogram("byzpy_ps_round_seconds").count == \
        jreg.histogram("byzpy_ps_round_seconds").count == 2
    if mode != "serial" and mode != "pool":
        assert preg.histogram("byzpy_overlap_ingest_lag_seconds").count == \
            jreg.histogram("byzpy_overlap_ingest_lag_seconds").count


def test_disabled_telemetry_records_nothing():
    pruntime.disable()
    ptracing.tracer().clear()
    assert ptracing.span("x") is ptracing.NULL_SPAN
    assert ptracing.device_span("x") is ptracing.NULL_SPAN
    sp = ptracing.begin_span("x")
    assert sp is ptracing.NULL_SPAN
    ptracing.end_span(sp)
    with ptracing.NULL_SPAN as s:
        assert s.set(a=1) is ptracing.NULL_SPAN
    _run(_ps_run(PORT, "median", "serial", rounds=1))
    assert ptracing.tracer().events() == []


def test_spans_nest_and_begin_end_span_links(telemetry):
    """A span opened inside another is its child (``parent`` = the outer
    ``span`` id); ``begin_span`` links to the open span but restores the
    caller's context at once, so the next span is the outer's sibling, not
    the deferred span's child; an exception is recorded on its span."""
    with ptracing.span("outer", track="t", a=1):
        with ptracing.device_span("inner", track="t") as inner:
            inner.set(b=2)
        sp = ptracing.begin_span("deferred", track="u")
        with ptracing.span("after"):
            pass
    ptracing.end_span(sp)
    ev = {e["name"]: e for e in ptracing.tracer().events()}
    outer_id = ev["outer"]["args"]["span"]
    assert ev["inner"]["args"]["parent"] == outer_id
    assert ev["deferred"]["args"]["parent"] == outer_id
    assert ev["after"]["args"]["parent"] == outer_id
    assert ev["inner"]["args"]["b"] == 2 and ev["outer"]["args"]["a"] == 1
    assert ev["inner"]["tid"] == ev["outer"]["tid"] != ev["deferred"]["tid"]
    assert ptracing.tracer().track_names()[ev["deferred"]["tid"]] == "u"
    with pytest.raises(ZeroDivisionError):
        with ptracing.span("boom"):
            1 / 0
    last = ptracing.tracer().events()[-1]
    assert last["args"]["error"] == "ZeroDivisionError" and "parent" not in last["args"]


def test_metrics_registry_matches_reference():
    samples = [3e-5, 2e-4, 7e-3, 0.3, 0.3, 12.0, 100.0, 1e-6]
    for pct in (0, 10, 50, 75, 99, 100):
        assert pmetrics.percentile_of_sorted(sorted(samples), pct) == \
            jmetrics.percentile_of_sorted(sorted(samples), pct)
    assert pmetrics.percentile_of_sorted([], 50) == 0.0
    ph, jh = pmetrics.Histogram("h"), jmetrics.Histogram("h")
    for s in samples:
        ph.observe(s)
        jh.observe(s)
    assert ph.counts == jh.counts and ph.count == jh.count and ph.sum == jh.sum
    for pct in (0, 10, 50, 75, 99, 100):
        assert ph.percentile(pct) == jh.percentile(pct)
    reg = pmetrics.MetricsRegistry()
    c = reg.counter("c_total", labels={"mode": "x"})
    assert reg.counter("c_total", labels={"mode": "x"}) is c
    assert reg.counter("c_total", labels={"mode": "y"}) is not c
    c.inc(2)
    assert c.value == 2.0 and reg.histogram("h_seconds").mean == 0.0
    reg.reset()
    assert reg.counter("c_total", labels={"mode": "x"}).value == 0.0
    for bad, err in ((lambda: reg.histogram("c_total"), "already registered"),
                     (lambda: reg.counter("bad name"), "invalid metric name"),
                     (lambda: reg.counter("ok", labels={"1x": "v"}), "invalid label name"),
                     (lambda: c.inc(-1), "counters only go up"),
                     (lambda: pmetrics.Histogram("h", buckets=(2, 1)), "ascending")):
        with pytest.raises(ValueError, match=err):
            bad()


def test_telemetry_switch_reads_the_environment(monkeypatch):
    for value, want in (("1", True), ("on", True), ("no", False), ("", False)):
        monkeypatch.setenv("BYZPY_TPU_TELEMETRY", value)
        assert pruntime.TelemetryState().enabled is want
        assert jruntime.TelemetryState().enabled is want


# ---------------------------------------------------------------------------
# utils.training
# ---------------------------------------------------------------------------


class _CountingPS:
    def __init__(self, asynchronous):
        self.n = 0
        self.asynchronous = asynchronous

    def round(self):
        self.n += 1
        if self.asynchronous:
            return asyncio.sleep(0)
        return None


@pytest.mark.parametrize("asynchronous", [False, True])
def test_train_with_progress_matches_reference(asynchronous):
    histories = []
    for mod in (ptraining, jtraining):
        ps = _CountingPS(asynchronous)

        async def evaluate(i, ps=ps):
            return (i, ps.n)

        hist = mod.train_with_progress(ps, 25, eval_callback=evaluate if asynchronous else
                                       (lambda i, ps=ps: (i, ps.n)), eval_interval=10,
                                       progress=False)
        histories.append(hist)
    assert histories[0] == histories[1] == [(9, (9, 10)), (19, (19, 20)), (24, (24, 25))]


def test_train_with_progress_drives_a_parameter_server():
    async def scenario():
        Honest, SignFlip = _classes(PORT)
        nodes = [Honest(i) for i in range(4)]
        ps = PPS.ParameterServer(nodes, [SignFlip()], aggregator=_aggregator(PORT, "median"))
        hist = await ptraining.train_with_progress_async(
            ps, 5, eval_callback=lambda i: float(nodes[0].params["b"][0]), eval_interval=2,
            progress=False)
        return hist, ps.rounds_completed

    hist, rounds = _run(scenario())
    assert rounds == 5 and [i for i, _ in hist] == [1, 3, 4]
