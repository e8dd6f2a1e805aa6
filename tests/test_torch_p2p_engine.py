"""The port's message fabric and gossip runner against the JAX package's,
on the CPU: ``engine.node`` (``Message``, the delivery routes,
``InProcessContext``, ``MessageRouter``, ``DecentralizedNode``,
``DecentralizedCluster``) and ``engine.peer_to_peer`` (the P2P workers,
``DecentralizedPeerToPeer``'s barrier, streaming and overlapped rounds,
the ``PeerToPeer`` facade).

``SGDModelWorker`` ravels the converted ``mnist_mlp`` weights in the JAX
package's order and layout (``models.convert.flax_layout``), so its flat
vectors and gossip frames compare with the JAX worker's coordinate by
coordinate: the starting vectors are equal bit for bit, and the rounds
agree within the f32 rounding of the two packages' gradients (``GRAD``).
Within the port, the barrier and streaming rounds of the coordinate
median are equal bit for bit. Both packages' in-process registries are
cleared around every case, and every wait is bounded.
"""

import asyncio
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import byzpy_tpu.aggregators as JAgg
import byzpy_tpu.engine.graph as JGraph
import byzpy_tpu.engine.node as JNode
import byzpy_tpu.engine.overlap as JOverlap
import byzpy_tpu.engine.peer_to_peer as JP2P
from byzpy_tpu.attacks import EmpireAttack as JEmpire
from byzpy_tpu.models import nets as jnets
from byzpy_tpu.observability import runtime as jruntime
from byzpy_tpu.observability import tracing as jtracing
import byzpy_tpu_torch.aggregators as PAgg
import byzpy_tpu_torch.engine.graph as PGraph
import byzpy_tpu_torch.engine.node as PNode
import byzpy_tpu_torch.engine.overlap as POverlap
import byzpy_tpu_torch.engine.peer_to_peer as PP2P
from byzpy_tpu_torch.attacks import EmpireAttack as PEmpire
from byzpy_tpu_torch.engine.node import context as pcontext
from byzpy_tpu_torch.models import flax_layout, from_flax, from_flax_layout, nets, ordered_like
from byzpy_tpu_torch.observability import runtime as pruntime
from byzpy_tpu_torch.observability import tracing as ptracing

WAIT_S = 60
# three rounds of SGD on an MLP whose gradients the two packages round
# differently in f32
GRAD = dict(rtol=1e-4, atol=2e-6)
HIDDEN = 16
BATCH = 8


def _run(coro, timeout=WAIT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def clean_registries():
    for mod in (PNode.context, JNode.context):
        mod.InProcessContext.clear_registry()
    yield
    for mod in (PNode.context, JNode.context):
        mod.InProcessContext.clear_registry()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _cluster(mod, n, topology=None, topo_mod=None):
    topo_mod = topo_mod or (PP2P if mod is PNode else JP2P)
    cluster = mod.DecentralizedCluster(topology or topo_mod.Topology.complete(n))
    for i in range(n):
        nid = f"node-{i}"
        cluster.add_node(mod.DecentralizedNode(nid, mod.InProcessContext(nid)))
    return cluster


# ---------------------------------------------------------------------------
# the message fabric
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [PNode, JNode], ids=["port", "jax"])
def test_cluster_message_order_and_routing(mod):
    """Broadcasts reach every out-neighbour once, in send order per sender;
    a ring forbids direct sends off its edges; replies skip the check;
    pipelines and message waits work across nodes (``tests/
    test_node_layer.py``'s cases, in both packages)."""
    p2p = PP2P if mod is PNode else JP2P
    graph_mod = PGraph if mod is PNode else JGraph

    async def scenario():
        cluster = _cluster(mod, 4)
        received = {f"node-{i}": [] for i in range(4)}
        async with cluster:
            for nid, node in cluster.nodes.items():
                async def handler(msg, nid=nid):
                    received[nid].append((msg.sender, msg.payload, msg.metadata))
                node.register_handler("gossip", handler)
            for k in range(3):
                for i in (2, 0):
                    reached = await cluster.node(f"node-{i}").broadcast_message(
                        "gossip", (i, k), tag=k)
                    assert reached == [f"node-{j}" for j in range(4) if j != i]
            for _ in range(50):
                if sum(map(len, received.values())) == 18:
                    break
                await asyncio.sleep(0.01)
            waiting = cluster.node("node-1").scheduler.pending_message_count("gossip")
        ring = _cluster(mod, 4, p2p.Topology.ring(4, 1))
        async with ring:
            n0 = ring.node("node-0")
            await n0.send_message("node-1", "ping", "hi")
            with pytest.raises(ValueError) as forbid:
                await n0.send_message("node-2", "ping", "hi")
            with pytest.raises(ValueError) as unknown:
                await n0.send_message("node-9", "ping", "hi")
            await ring.node("node-1").reply_message("node-0", "pong", "yo")
            pong = await n0.wait_for_message("pong", timeout=2)
            ping = await ring.node("node-1").wait_for_message("ping", timeout=2)
            graph = graph_mod.ComputationGraph([graph_mod.GraphNode(
                "double", graph_mod.CallableOp(lambda v: v * 2), {"v": graph_mod.GraphInput("v")})])
            n0.register_pipeline("double", graph)
            doubled = await n0.execute_pipeline("double", {"v": 21})
            with pytest.raises(KeyError) as missing:
                await n0.execute_pipeline("nope")
            with pytest.raises(TimeoutError):
                await n0.wait_for_message("never", timeout=0.02)
            await n0.multicast_message(["node-1"], "multi", 5)
            multi = await ring.node("node-1").wait_for_message("multi", timeout=2)
            routes = (n0.router.in_neighbor_ids(), n0.router.out_neighbor_ids(), n0.router.index)
        return (received, waiting, str(forbid.value), str(unknown.value), pong.payload,
                ping.sender, doubled, str(missing.value), multi.payload, routes)

    out = _run(scenario())
    received = out[0]
    for i in range(4):
        want = [(f"node-{s}", (s, k), {"tag": k}) for k in range(3) for s in (2, 0) if s != i]
        assert received[f"node-{i}"] == want
    assert out[1] == 6
    assert out[2] == "topology forbids 'node-0' -> 'node-2'"
    assert out[3] == "unknown node id 'node-9'"
    assert out[4:7] == ("yo", "node-0", {"double": 42})
    assert "no pipeline 'nope'" in out[7]
    assert out[8] == 5 and out[9] == (["node-3"], ["node-1"], 0)


def test_cluster_errors_and_lifecycle_match_reference():
    msgs = []
    for mod in (PNode, JNode):
        p2p = PP2P if mod is PNode else JP2P

        async def scenario():
            out = []
            cluster = mod.DecentralizedCluster(p2p.Topology.complete(2))
            cluster.add_node(mod.DecentralizedNode("a", mod.InProcessContext("a")))
            for node in (mod.DecentralizedNode("a", mod.InProcessContext("a2")),):
                with pytest.raises(ValueError) as dup:
                    cluster.add_node(node)
                out.append(str(dup.value))
            with pytest.raises(RuntimeError) as short:
                await cluster.start_all()
            out.append(str(short.value))
            cluster.add_node(mod.DecentralizedNode("b", mod.InProcessContext("b")))
            with pytest.raises(ValueError) as full:
                cluster.add_node(mod.DecentralizedNode("c", mod.InProcessContext("c")))
            out.append(str(full.value))
            out.append(cluster.node_ids_map())
            # a clashing id fails the start and rolls the started node back
            clash = mod.InProcessContext("b")
            await clash.start(mod.DecentralizedNode("b", clash))
            with pytest.raises(RuntimeError) as taken:
                await cluster.start_all()
            out.append(str(taken.value))
            out.append(sorted(mod.InProcessContext._registry))
            await clash.shutdown()
            with pytest.raises(RuntimeError) as unbound:
                mod.DecentralizedNode("z", mod.InProcessContext("z")).router  # noqa: B018
            out.append(str(unbound.value))
            ctx = mod.InProcessContext("lonely")
            with pytest.raises(ConnectionError) as gone:
                await ctx.send_message("nobody", mod.context.Message("t", "lonely"))
            out.append(str(gone.value))
            return out

        msgs.append(_run(scenario()))
    assert msgs[0] == msgs[1]


def _delivery_scenario():
    """A registered route delivers to ids the registry does not know; a
    broadcast to a dead neighbour logs, skips it and reaches the rest."""

    async def scenario(caplog):
        seen = []

        async def route(target_id, message):
            if target_id == "elsewhere":
                seen.append((target_id, message.payload))
                return True
            return False

        pcontext.register_delivery_route(route)
        pcontext.register_delivery_route(route)
        try:
            ctx = PNode.InProcessContext("x")
            await ctx.send_message("elsewhere", PNode.Message("t", "x", 7))
            assert await pcontext.route_message("nowhere", PNode.Message("t", "x")) is False
        finally:
            pcontext.unregister_delivery_route(route)
            pcontext.unregister_delivery_route(route)
        assert route not in pcontext._delivery_routes
        cluster = _cluster(PNode, 3)
        async with cluster:
            await cluster.node("node-2").shutdown()
            with caplog.at_level(logging.WARNING):
                reached = await cluster.node("node-0").broadcast_message("g", 1)
        return seen, reached

    return scenario


def test_delivery_route_registry(caplog):
    seen, reached = _run(_delivery_scenario()(caplog))
    assert seen == [("elsewhere", 7)]
    assert reached == ["node-1"]
    assert "broadcast node-0 -> node-2 failed" in caplog.text


def test_autonomous_tasks_and_example_consensus():
    """``examples/p2p/decentralized_autonomous.py`` on the port: four
    nodes on ``complete(4)``, background tasks that half-step towards
    their targets, gossip and take the coordinate median for 15 rounds,
    reach consensus (spread < 0.15), and a shutdown cancels a task that
    never ends."""

    async def scenario():
        cluster = _cluster(PNode, 4)
        targets = np.linspace(0.0, 2.0, 4)
        events, finals = [asyncio.Event() for _ in range(4)], {}

        def loop(target, done):
            async def run(node):
                agg = PAgg.CoordinateWiseMedian(device="cpu")
                w = torch.zeros((32,))
                n_in = len(node.router.in_neighbor_ids())
                for _ in range(15):
                    w = w - 0.3 * 2.0 * (w - target)
                    await node.broadcast_message("gossip", w)
                    received = [(await node.wait_for_message("gossip", timeout=5)).payload
                                for _ in range(n_in)]
                    w = agg.aggregate([w] + received)
                finals[node.node_id] = w
                done.set()
            return run

        ticks = []

        async def forever(node):
            while True:
                ticks.append(1)
                await asyncio.sleep(0.005)

        async with cluster:
            for i, node in enumerate(cluster.nodes.values()):
                node.start_autonomous_task(loop(float(targets[i]), events[i]))
            task = cluster.node("node-0").start_autonomous_task(forever)
            await asyncio.gather(*(e.wait() for e in events))
        return finals, task, ticks

    finals, task, ticks = _run(scenario())
    w0 = np.array([float(v[0]) for v in finals.values()])
    assert w0.max() - w0.min() < 0.15
    assert task.cancelled() and ticks


# ---------------------------------------------------------------------------
# the P2P workers
# ---------------------------------------------------------------------------


def _batch(node: int, step: int):
    rng = np.random.default_rng(31 * node + 1000 * step)
    return (rng.normal(size=(BATCH, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, size=(BATCH,)))


def _port_worker(i, flax_params):
    bundle = nets.mnist_mlp(seed=0, hidden=HIDDEN, device="cpu")
    bundle.params = ordered_like(from_flax(flax_params, device="cpu"), bundle.params)
    step = [0]

    def batch_fn():
        x, y = _batch(i, step[0])
        step[0] += 1
        return torch.from_numpy(x), torch.from_numpy(y)

    return PP2P.SGDModelWorker(bundle, batch_fn)


def _jax_worker(i):
    bundle = jnets.mnist_mlp(seed=0, hidden=HIDDEN)
    step = [0]

    def batch_fn():
        x, y = _batch(i, step[0])
        step[0] += 1
        return jnp.asarray(x), jnp.asarray(y, dtype=jnp.int32)

    return JP2P.SGDModelWorker(bundle, batch_fn)


def _flax_params():
    return jax.tree_util.tree_map(np.asarray, jnets.mnist_mlp(seed=0, hidden=HIDDEN).params)


def test_sgd_worker_ravels_like_the_reference():
    """The port worker's flat vector is the JAX worker's bit for bit; its
    half steps agree within ``GRAD``; ``params`` and ``flax_layout`` /
    ``from_flax_layout`` invert each other."""
    flax_params = _flax_params()
    ours, ref = _port_worker(0, flax_params), _jax_worker(0)
    np.testing.assert_array_equal(_np(ours.parameters()), _np(ref.parameters()))
    for _ in range(3):
        a, b = ours.half_step(0.1), ref.half_step(0.1)
        np.testing.assert_allclose(_np(a), _np(b), **GRAD)
        assert abs(ours.last_loss - ref.last_loss) < 1e-5
    back = from_flax_layout(flax_layout(ours.params), ours.params)
    assert list(back) == list(ours.params)
    assert all(torch.equal(back[k], ours.params[k]) for k in back)
    ours.apply_aggregate(np.zeros(ours.parameters().shape, np.float32))
    assert ours.parameters().dtype == torch.float32 and float(ours.parameters().abs().sum()) == 0.0
    fresh = _port_worker(1, flax_params)
    assert fresh.last_loss is None


def test_sgd_worker_never_updates_a_sent_vector():
    """A returned vector (a gossip frame) keeps its bits through the
    worker's next half step and its next aggregate."""
    worker = _port_worker(0, _flax_params())
    sent = worker.half_step(0.1)
    copy = sent.clone()
    worker.half_step(0.1)
    worker.apply_aggregate(torch.zeros_like(sent))
    worker.half_step(0.1)
    assert torch.equal(sent, copy)
    assert worker.parameters() is not sent


def test_attack_and_function_workers_match_reference():
    rng = np.random.default_rng(3)
    honest = [rng.normal(size=(12,)).astype(np.float32) for _ in range(3)]
    ours = PP2P.AttackP2PWorker(PEmpire(scale=-3.0, device="cpu")).malicious_vector(
        [torch.from_numpy(h) for h in honest])
    ref = JP2P.AttackP2PWorker(JEmpire(scale=-3.0)).malicious_vector([jnp.asarray(h) for h in honest])
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-6, atol=1e-6)
    msgs = []
    for mod, att in ((PP2P, PEmpire(device="cpu")), (JP2P, JEmpire())):
        with pytest.raises(ValueError) as info:
            mod.AttackP2PWorker(att).malicious_vector([])
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    from byzpy_tpu_torch.attacks import GaussianAttack

    fallback = PP2P.AttackP2PWorker(GaussianAttack(mu=0.0, sigma=0.0, seed=0, device="cpu"), dim=5)
    assert fallback.malicious_vector([]).shape == (5,)
    fn = PP2P.FunctionP2PWorker(lambda hs: -sum(hs))
    assert torch.equal(fn.malicious_vector([torch.ones(2), torch.ones(2)]), -2 * torch.ones(2))


# ---------------------------------------------------------------------------
# the gossip runner
# ---------------------------------------------------------------------------

TOPOLOGIES = {"complete5": ("complete", (5,), 1), "ring6": ("ring", (6, 2), 1)}


async def _p2p_run(port, topo_name, agg_name, *, overlap=None, rounds=3, record=None):
    mod = PP2P if port else JP2P
    kind, args, n_byz = TOPOLOGIES[topo_name]
    topology = getattr(mod.Topology, kind)(*args)
    n_honest = topology.n_nodes - n_byz
    flax_params = _flax_params()
    workers = [_port_worker(i, flax_params) if port else _jax_worker(i) for i in range(n_honest)]
    attack = PEmpire(scale=-3.0, device="cpu") if port else JEmpire(scale=-3.0)
    byz = [mod.AttackP2PWorker(attack) for _ in range(n_byz)]
    agg = {"trimmed": (lambda: PAgg.CoordinateWiseTrimmedMean(f=1, device="cpu"),
                       lambda: JAgg.CoordinateWiseTrimmedMean(f=1)),
           "median": (lambda: PAgg.CoordinateWiseMedian(device="cpu"),
                      lambda: JAgg.CoordinateWiseMedian())}[agg_name][0 if port else 1]()
    if record is not None:
        agg = record(agg)
    ov = None
    if overlap is not None:
        ov = (POverlap if port else JOverlap).OverlapConfig(stream=overlap[0],
                                                            prefetch_depth=overlap[1])
    p2p = mod.DecentralizedPeerToPeer(workers, byz, aggregator=agg, topology=topology,
                                      learning_rate=0.1, overlap=ov)
    outs = []
    async with p2p:
        if ov is not None and ov.prefetch_depth:
            await p2p.run_async(rounds)
        else:
            for _ in range(rounds):
                outs.append({i: _np(v) for i, v in (await p2p.run_round_async()).items()})
    return outs, [_np(w.parameters()) for w in workers], p2p.rounds_completed


@pytest.mark.parametrize("mode", ["barrier", "stream", "overlap"])
@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_p2p_rounds_match_reference(topo_name, mode):
    """``SGDModelWorker``s on converted ``mnist_mlp`` weights and fixed
    batches, an Empire byzantine peer and the trimmed mean, 3 rounds on
    ``complete(5)`` and ``ring(6, 2)``: each honest node's aggregate and
    its final flat parameters agree with the JAX package's within
    ``GRAD``."""
    overlap = {"barrier": None, "stream": (True, 0), "overlap": (True, 1)}[mode]
    ours = _run(_p2p_run(True, topo_name, "trimmed", overlap=overlap))
    ref = _run(_p2p_run(False, topo_name, "trimmed", overlap=overlap))
    assert ours[2] == ref[2] == 3
    for a, b in zip(ours[0], ref[0], strict=True):
        assert sorted(a) == sorted(b)
        for i in a:
            np.testing.assert_allclose(a[i], b[i], **GRAD)
    for a, b in zip(ours[1], ref[1], strict=True):
        np.testing.assert_allclose(a, b, **GRAD)


def test_p2p_barrier_and_streaming_rounds_are_bitwise_equal():
    """The coordinate median's fold is its barrier program on the same
    rows in the same slots: the barrier, streaming and overlapped runs of
    the port give the same bits; and each honest node's aggregate is the
    direct call on its own half step followed by its frames in arrival
    order."""
    calls = []

    def record(agg):
        class Recording(type(agg)):
            def aggregate(self, gradients):
                out = super().aggregate(gradients)
                calls.append(([g.clone() for g in gradients], out.clone()))
                return out

        rec = Recording(device="cpu")
        return rec

    barrier = _run(_p2p_run(True, "ring6", "median", record=record))
    stream = _run(_p2p_run(True, "ring6", "median", overlap=(True, 0)))
    overlap = _run(_p2p_run(True, "ring6", "median", overlap=(True, 1)))
    for a, b in zip(barrier[0], stream[0], strict=True):
        for i in a:
            np.testing.assert_array_equal(a[i], b[i])
    for a, b, c in zip(barrier[1], stream[1], overlap[1], strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert len(calls) == 3 * 5
    direct = PAgg.CoordinateWiseMedian(device="cpu")
    for vectors, out in calls:
        assert len(vectors) == 3
        assert torch.equal(direct.aggregate(vectors), out)


def test_gossip_frames_keep_their_bits():
    """Frames are shared by reference (the in-process context queues the
    sender's very tensor at every neighbour): a frame a node received
    keeps its bits after the sender's next half step and aggregate."""

    async def scenario():
        flax_params = _flax_params()
        workers = [_port_worker(i, flax_params) for i in range(3)]
        p2p = PP2P.DecentralizedPeerToPeer(
            workers, [], aggregator=PAgg.CoordinateWiseMedian(device="cpu"),
            topology=PP2P.Topology.complete(3), learning_rate=0.1)
        frames = []
        async with p2p:
            async def keep(msg):
                frames.append((msg.sender, msg.payload, msg.payload.clone()))
            for node in p2p.nodes.values():
                node.register_handler(PP2P.runner.GOSSIP_TYPE, keep)
            for _ in range(3):
                await p2p.run_round_async()
        return frames, workers

    frames, workers = _run(scenario())
    assert len(frames) == 3 * 6
    for sender, payload, copy in frames:
        assert torch.equal(payload, copy), sender
    assert all(f[1] is not w.parameters() for f in frames for w in workers)


def test_byzantine_node_ignores_byzantine_frames():
    """A byzantine peer waits for its honest in-neighbours only; frames
    from other byzantine peers are consumed and dropped."""

    async def scenario(mod, agg, attack):
        class Quad(mod.HonestP2PWorker):
            def __init__(self, t):
                self.t, self.w = t, None

            def half_step(self, lr):
                base = torch.zeros(4) if mod is PP2P else jnp.zeros(4)
                self.w = (self.w if self.w is not None else base) + lr * self.t
                return self.w

            def parameters(self):
                return self.w

            def apply_aggregate(self, v):
                self.w = v

        seen = []

        def craft(hs):
            seen.append(len(hs))
            return -1.0 * hs[0]

        p2p = mod.DecentralizedPeerToPeer(
            [Quad(float(t)) for t in range(3)],
            [mod.FunctionP2PWorker(craft), mod.FunctionP2PWorker(craft)],
            aggregator=agg, topology=mod.Topology.complete(5), learning_rate=1.0)
        async with p2p:
            outs = [await p2p.run_round_async() for _ in range(2)]
        return seen, [{i: _np(v) for i, v in o.items()} for o in outs]

    ours = _run(scenario(PP2P, PAgg.CoordinateWiseMedian(device="cpu"), None))
    ref = _run(scenario(JP2P, JAgg.CoordinateWiseMedian(), None))
    assert ours[0] == ref[0] == [3, 3, 3, 3]
    for a, b in zip(ours[1], ref[1]):
        for i in a:
            np.testing.assert_array_equal(a[i], b[i])


def test_runner_constructor_errors_match_reference():
    msgs = []
    for mod, agg in ((PP2P, PAgg.CoordinateWiseMedian(device="cpu")), (JP2P, JAgg.CoordinateWiseMedian())):
        out = []
        for kw in ({"honest": 2, "byz": 0, "n": 3}, {"honest": 2, "byz": 1, "n": 3, "idx": [0, 1]},
                   {"honest": 1, "byz": 1, "n": 3, "idx": [2, 2]}):
            with pytest.raises(ValueError) as info:
                mod.DecentralizedPeerToPeer(
                    [object()] * kw["honest"], [object()] * kw["byz"], aggregator=agg,
                    topology=mod.Topology.complete(kw["n"]),
                    byzantine_indices=kw.get("idx"))
            out.append(str(info.value))
        msgs.append(out)
    assert msgs[0] == msgs[1]


def test_peer_to_peer_facade():
    """``examples/p2p/gossip_mnist.py``'s front door at a small width:
    ``PeerToPeer.run`` owns its loop; ``round`` is the async alias; a
    removed node leaves the facade's fabric; the final vectors equal the
    runner's own."""
    flax_params = _flax_params()
    workers = [_port_worker(i, flax_params) for i in range(4)]
    p2p = PP2P.PeerToPeer(workers, [PP2P.AttackP2PWorker(PEmpire(scale=-3.0, device="cpu"))],
                          aggregator=PAgg.CoordinateWiseTrimmedMean(f=1, device="cpu"),
                          topology=PP2P.Topology.complete(5), learning_rate=0.1)
    p2p.run(rounds=2)
    assert p2p.rounds_completed == 2
    # the JAX package's facade on the same workers and batches
    jworkers = [_jax_worker(i) for i in range(4)]
    jp2p = JP2P.PeerToPeer(jworkers, [JP2P.AttackP2PWorker(JEmpire(scale=-3.0))],
                           aggregator=JAgg.CoordinateWiseTrimmedMean(f=1),
                           topology=JP2P.Topology.complete(5), learning_rate=0.1)
    jp2p.run(rounds=2)
    assert jp2p.rounds_completed == 2
    for w, jw in zip(workers, jworkers, strict=True):
        np.testing.assert_allclose(_np(w.parameters()), _np(jw.parameters()), **GRAD)
    assert PP2P.PeerToPeer.round is PP2P.PeerToPeer.round_async

    async def more():
        out = await p2p.round()
        await p2p.remove_node(4)
        out2 = await p2p.round_async()
        await p2p.run_async(1)
        await p2p.shutdown_async()
        return out, out2

    out, out2 = _run(more())
    assert sorted(out) == sorted(out2) == [0, 1, 2, 3]
    assert p2p.rounds_completed == 5
    assert all(torch.equal(out2[i], out2[i]) for i in out2)


@pytest.fixture
def telemetry():
    for rt, tr in ((pruntime, ptracing), (jruntime, jtracing)):
        rt.enable()
        tr.tracer().clear()
    yield
    for rt, tr in ((pruntime, ptracing), (jruntime, jtracing)):
        rt.disable()
        tr.tracer().clear()


@pytest.mark.parametrize("mode", ["barrier", "overlap"])
def test_p2p_round_spans_match_reference(telemetry, mode):
    """With telemetry on, the gossip rounds record the reference's spans:
    names, tracks and modes, in order."""
    overlap = None if mode == "barrier" else (True, 1)
    got = []
    for port, tracing in ((True, ptracing), (False, jtracing)):
        _run(_p2p_run(port, "complete5", "median", overlap=overlap, rounds=2))
        tracks = (tracing.tracer().track_names() if port else
                  {tid: name for name, tid in tracing.tracer()._tracks.items()})
        got.append([(e["name"], tracks.get(e["tid"]), e.get("args", {}).get("mode"))
                    for e in tracing.tracer().events() if e["name"].startswith("p2p.")])
    assert got[0] == got[1] and got[0]
