"""The out-of-process actor tier on the CPU: process and remote actors,
process pools, the process and remote node contexts.

The JAX package's ``tests/test_actor_backends.py``, ``test_remote_contexts.py``
(its hub cases; the mesh context is not ported) and ``test_elastic_remote.py``
cases, on ``child_device="cpu"`` (``BYZPY_TPU_TORCH_CHILD_DEVICE=cpu``), plus
the port's own: pooled results, process-node rounds and a P2P run on
``ProcessContext`` held bit for bit against the in-process ones, and the
process nodes' weights against the JAX package's node through
``models.convert`` (within 1e-5: the two packages' gradients differ in f32
rounding). Every wait carries its own timeout and every child is closed
in a ``finally``. The actor classes live at module level (a child imports
them by reference) and this module imports no JAX at its top, so a child
does not load it.
"""

import asyncio
import functools
import time
import warnings

import numpy as np
import pytest
import torch

from byzpy_tpu_torch import aggregators as PAgg
from byzpy_tpu_torch.configs.actor import use_actor
from byzpy_tpu_torch.engine.actor import resolve_backend, wire
from byzpy_tpu_torch.engine.actor.backends.process import ProcessActorBackend
from byzpy_tpu_torch.engine.actor.backends.remote import RemoteActorBackend, RemoteActorServer
from byzpy_tpu_torch.engine.actor.base import spawn_actor
from byzpy_tpu_torch.engine.actor.channels import Endpoint
from byzpy_tpu_torch.engine.actor.factory import parse_spec
from byzpy_tpu_torch.engine.graph import ActorPool, ActorPoolConfig, SubTask, run_operator
from byzpy_tpu_torch.engine.node import (
    DecentralizedNode,
    InProcessContext,
    ProcessContext,
    RemoteClientContext,
    RemoteNodeServer,
)
from byzpy_tpu_torch.engine.node import base as PNode
from byzpy_tpu_torch.engine.node.actors import HonestNodeActor
from byzpy_tpu_torch.engine.parameter_server import ElasticPolicy, ParameterServer
from byzpy_tpu_torch.engine.peer_to_peer import Topology
from byzpy_tpu_torch.engine.peer_to_peer import nodes as PP2P
from byzpy_tpu_torch.engine.peer_to_peer.runner import DecentralizedPeerToPeer
from byzpy_tpu_torch.models import nets

WAIT_S = 60
D = 32


@pytest.fixture(autouse=True)
def _cpu_children(monkeypatch):
    monkeypatch.setenv("BYZPY_TPU_TORCH_CHILD_DEVICE", "cpu")
    yield
    InProcessContext.clear_registry()
    ProcessContext.clear_registry()


def _run(coro, timeout=WAIT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
        return self.value

    async def async_incr(self, by=1):
        await asyncio.sleep(0)
        self.value += by
        return self.value

    def boom(self):
        raise ValueError("kaboom")

    def echo_array(self, arr):
        return arr * 2


def test_process_backend_rpc_channels_and_errors():
    async def main():
        backend = resolve_backend("process")
        try:
            ref = await spawn_actor(backend, Counter, 100)
            assert await ref.incr(by=2) == 102
            assert await ref.async_incr() == 103
            out = await ref.echo_array(torch.arange(4.0))
            assert torch.equal(out, torch.arange(4.0) * 2)
            big = torch.randn(50_000)  # 200 KB: through the shm store
            assert torch.equal(await ref.echo_array(big), big * 2)
            # a blocked chan_get and a call in flight together (request ids)
            await backend.chan_open("inbox")
            getter = asyncio.ensure_future(backend.chan_get("inbox"))
            await asyncio.sleep(0.05)
            assert await ref.incr() == 104
            await backend.chan_put("inbox", {"t": big})
            got = await asyncio.wait_for(getter, 10)
            assert torch.equal(got["t"], big)
            with pytest.raises(RuntimeError, match="kaboom"):
                await ref.boom()
            with pytest.raises(TypeError, match="lambda"):
                await ref.echo_array(lambda: 1)
        finally:
            await backend.close()

    _run(main())


def test_process_backend_inline_without_shm(monkeypatch):
    monkeypatch.setenv("BYZPY_TPU_TORCH_SHM", "0")

    async def main():
        backend = ProcessActorBackend(child_device="cpu")
        try:
            ref = await spawn_actor(backend, Counter)
            big = torch.randn(50_000, dtype=torch.float64)
            assert torch.equal(await ref.echo_array(big), big * 2)
        finally:
            await backend.close()

    _run(main())


def test_process_backend_needs_a_card_for_a_card_child(monkeypatch):
    """``child_device="cuda"`` (the default) with no card refuses at start,
    before anything is spawned; a bad spec refuses at once."""
    monkeypatch.delenv("BYZPY_TPU_TORCH_CHILD_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    backend = ProcessActorBackend()
    assert backend.child_device == "cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        _run(backend.start())
    assert backend._proc is None
    with pytest.raises(ValueError, match="child_device"):
        ProcessActorBackend(child_device="tpu")


def test_process_backend_close_keeps_loop_responsive():
    """``close`` joins the child off the event loop."""

    class SlowJoinProc:
        def join(self, timeout=None):
            time.sleep(0.5)

        def is_alive(self):
            return False

        def kill(self):
            pass

    async def main():
        backend = ProcessActorBackend(child_device="cpu")
        backend._started = True
        backend._proc = SlowJoinProc()
        gaps = []

        async def ticker():
            loop = asyncio.get_running_loop()
            prev = loop.time()
            while True:
                await asyncio.sleep(0.01)
                now = loop.time()
                gaps.append(now - prev)
                prev = now

        t = asyncio.ensure_future(ticker())
        await backend.close()
        t.cancel()
        assert gaps and max(gaps) < 0.3, f"loop stalled {max(gaps):.3f}s"
        assert backend._proc is None and not backend._started

    _run(main())


def test_remote_tcp_backend():
    async def main():
        server = RemoteActorServer("127.0.0.1", 0)
        await server.start()
        backend = resolve_backend(f"tcp://127.0.0.1:{server.port}")
        try:
            ref = await spawn_actor(backend, Counter, 5)
            assert await ref.incr() == 6
            assert torch.equal(await ref.echo_array(torch.ones(3)), 2 * torch.ones(3))
            await backend.chan_open("c")
            getter = asyncio.ensure_future(backend.chan_get("c"))
            await asyncio.sleep(0.05)
            assert await ref.incr() == 7
            await backend.chan_put("c", {"x": 1})
            assert await asyncio.wait_for(getter, 10) == {"x": 1}
            # a thread actor reaches the remote mailbox over the TCP transport
            local = resolve_backend("thread")
            await local.start()
            try:
                other = Endpoint("tcp", f"127.0.0.1:{server.port}", backend.actor_id)
                from byzpy_tpu_torch.engine.actor import router

                router.channel_router.unregister(other)
                await local.chan_put("c", "via-tcp", endpoint=other)
                assert await asyncio.wait_for(backend.chan_get("c"), 10) == "via-tcp"
            finally:
                await local.close()
            with pytest.raises(RuntimeError, match="kaboom"):
                await ref.boom()
        finally:
            await backend.close()
            await server.close()

    _run(main())


def test_remote_server_close_with_live_connections():
    async def main():
        server = RemoteActorServer("127.0.0.1", 0)
        await server.start()
        backend = resolve_backend(f"tcp://127.0.0.1:{server.port}")
        try:
            ref = await spawn_actor(backend, Counter)
            assert await ref.incr() == 1
            pending = asyncio.ensure_future(backend.chan_get("never"))
            await asyncio.sleep(0.05)
            await asyncio.wait_for(server.close(), timeout=5)
            with pytest.raises((ConnectionError, asyncio.TimeoutError)):
                await asyncio.wait_for(pending, 5)
        finally:
            await backend.close()
            await server.close()

    _run(main())


def test_factory_specs():
    assert resolve_backend("thread").scheme == "thread"
    assert resolve_backend("process").scheme == "process"
    assert parse_spec("cuda:1") == ("cuda", 1)
    b = resolve_backend("tcp://h:1234")
    assert (b.host, b.port) == ("h", 1234)
    assert parse_spec("process") == ("process", None)
    assert parse_spec("tcp://h:1234") == ("tcp", 1234)
    for bad in ("gpu", "tpu", "tcp://missingport", "cuda:x"):
        with pytest.raises(ValueError):
            resolve_backend(bad)
    with use_actor("process"):
        assert ActorPoolConfig().resolved_backend() == "process"
    with use_actor("tcp://127.0.0.1:9"):
        assert ActorPoolConfig().resolved_capabilities() == frozenset({"cpu", "remote"})
    assert ActorPoolConfig(backend="process").resolved_capabilities() == frozenset({"cpu"})


def test_untrusted_bind_warns_beyond_loopback():
    async def bind(host):
        server = RemoteActorServer(host=host, port=0)
        await server.start()
        await server.close()

    with pytest.warns(RuntimeWarning, match="trusted"):
        _run(bind("0.0.0.0"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _run(bind("127.0.0.1"))


def test_remote_actor_server_with_signed_wire(monkeypatch):
    """Construct and call over loopback with signing on both ends; a
    client under another key is dropped and its call fails."""
    monkeypatch.setenv("BYZPY_TPU_TORCH_WIRE_KEY", "cluster-secret")

    async def main():
        server = RemoteActorServer(host="127.0.0.1", port=0)
        await server.start()
        be = RemoteActorBackend("127.0.0.1", server.port)
        try:
            await be.start()
            await be.construct(Counter, 10)
            out = await be.call("incr", 5)
            # a frame signed under another key: the server drops the peer
            monkeypatch.setenv("BYZPY_TPU_TORCH_WIRE_KEY", "wrong")
            forged = wire.encode({"op": "construct", "actor_id": "x", "req_id": 0,
                                  "payload": (Counter, (1,), {})})
            monkeypatch.setenv("BYZPY_TPU_TORCH_WIRE_KEY", "cluster-secret")
            reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
            try:
                writer.write(forged)
                await writer.drain()
                assert await asyncio.wait_for(reader.read(), 10) == b""  # closed, no reply
            finally:
                writer.close()
            assert "x" not in server._actors
            return out
        finally:
            await be.close()
            await server.close()

    assert _run(main()) == 15


# -- process pools ------------------------------------------------------------


def _add_one(x):
    return x + 1


def test_process_pool_matches_direct_calls():
    """Median (feature chunks), Multi-Krum (row scores) and the trimmed
    mean on a process pool of two: bit for bit the direct call. The
    pickled path ships a function once (the worker's cache), and a
    callable that does not pickle by reference is refused."""
    grads = [torch.from_numpy(np.random.default_rng(i).normal(size=600).astype(np.float32))
             for i in range(11)]
    ops = [PAgg.CoordinateWiseMedian(device="cpu"), PAgg.MultiKrum(2, 4, device="cpu"),
           PAgg.CoordinateWiseTrimmedMean(2, device="cpu")]
    for op in ops:
        op.chunk_size = 4 if isinstance(op, PAgg.MultiKrum) else 128

    async def main():
        pool = ActorPool(ActorPoolConfig(backend="process", count=2))
        await pool.start()
        try:
            for op in ops:
                direct = await run_operator(op, {"gradients": grads})
                pooled = await run_operator(op, {"gradients": grads}, pool=pool)
                assert torch.equal(direct, pooled), type(op).__name__
            out = await pool.run_subtask(SubTask(fn=_add_one, args=(torch.ones(2),), kwargs={}))
            assert torch.equal(out, 2 * torch.ones(2))
            with pytest.raises(TypeError, match="lambda"):
                await pool.run_subtask(SubTask(fn=lambda x: x, args=(1,), kwargs={}))
        finally:
            await pool.close()

    _run(main(), 120)


# -- remote node fabric (the hub) ---------------------------------------------


def _collector(store):
    async def handler(message):
        store.append(message)

    return handler


def test_hub_hosted_and_client_nodes_roundtrip():
    async def go():
        async with RemoteNodeServer() as server:
            topo = Topology.complete(2)
            ids = {0: "hosted", 1: "client"}
            hosted = DecentralizedNode("hosted", server.context("hosted"))
            hosted.bind_topology(topo, ids)
            got_hosted, got_client = [], []
            hosted.register_handler("gossip", _collector(got_hosted))
            await hosted.start()
            client = DecentralizedNode("client", RemoteClientContext("client", *server.address))
            client.bind_topology(topo, ids)
            client.register_handler("gossip", _collector(got_client))
            await client.start()
            try:
                assert client.context.is_connected
                await client.send_message("hosted", "gossip", torch.ones(4))
                await hosted.send_message("client", "gossip", {"v": 7})
                for _ in range(250):
                    if got_hosted and got_client:
                        break
                    await asyncio.sleep(0.02)
                assert len(got_hosted) == 1 and torch.equal(got_hosted[0].payload, torch.ones(4))
                assert got_client[0].payload == {"v": 7}
            finally:
                await client.shutdown()
                await hosted.shutdown()

    _run(go())


def test_hub_routes_between_two_clients():
    async def go():
        async with RemoteNodeServer() as server:
            topo = Topology.complete(2)
            ids = {0: "a", 1: "b"}
            nodes, stores = [], {}
            try:
                for nid in ("a", "b"):
                    n = DecentralizedNode(nid, RemoteClientContext(nid, *server.address))
                    n.bind_topology(topo, ids)
                    stores[nid] = []
                    n.register_handler("msg", _collector(stores[nid]))
                    await n.start()
                    nodes.append(n)
                await nodes[0].broadcast_message("msg", [1, 2, 3])
                for _ in range(250):
                    if stores["b"]:
                        break
                    await asyncio.sleep(0.02)
                assert stores["b"][0].payload == [1, 2, 3] and stores["b"][0].sender == "a"
            finally:
                for n in nodes:
                    await n.shutdown()

    _run(go())


def test_hub_unknown_target_raises():
    async def go():
        async with RemoteNodeServer() as server:
            node = DecentralizedNode("x", RemoteClientContext("x", *server.address))
            node.bind_topology(Topology.complete(2), {0: "x", 1: "ghost"})
            await node.start()
            try:
                with pytest.raises(ConnectionError):
                    await node.send_message("ghost", "msg", None)
            finally:
                await node.shutdown()

    _run(go())


# -- elastic PS against a dying remote node -----------------------------------


class LocalNode:
    def __init__(self, value):
        self.value = float(value)

    def honest_gradient_for_next_batch(self):
        return [torch.full((D,), self.value)]

    def apply_server_gradient(self, g):
        self.applied = g


class RemoteNode(PNode.HonestNode):
    def __init__(self, value):
        self.value = float(value)

    def next_batch(self):
        return None, None

    def honest_gradient(self, x, y):
        return [torch.full((D,), self.value)]

    def apply_server_gradient(self, g):
        self.applied = g


@pytest.mark.parametrize("elastic", [True, False])
def test_remote_node_death(elastic):
    """With the elastic policy the survivors carry the round and the dead
    remote node is suspected; without it the round fails fast."""

    async def main():
        server = RemoteActorServer("127.0.0.1", 0)
        await server.start()
        remote = await HonestNodeActor.spawn(RemoteNode, 3.0,
                                             backend=f"tcp://127.0.0.1:{server.port}")
        try:
            agg = PAgg.CoordinateWiseTrimmedMean(f=0, device="cpu")
            if elastic:
                ps = ParameterServer(honest_nodes=[LocalNode(1.0), LocalNode(2.0), remote],
                                     aggregator=agg,
                                     elastic=ElasticPolicy(min_quorum=2, call_timeout=5.0))
                out = await ps.round()
                assert torch.allclose(out[0], torch.full((D,), 2.0))
                await server.close()
                out = await ps.round()
                assert torch.allclose(out[0], torch.full((D,), 1.5))
                assert "honest:2" in ps.elastic_state.suspects and ps.rounds_completed == 2
            else:
                ps = ParameterServer(honest_nodes=[LocalNode(1.0), remote], aggregator=agg)
                await ps.round()
                await server.close()
                with pytest.raises(Exception) as err:
                    await asyncio.wait_for(ps.round(), 10)
                assert not isinstance(err.value, asyncio.TimeoutError)
        finally:
            await remote.close()
            await server.close()

    _run(main())


# -- process nodes: weights carried across ------------------------------------

MLP_HIDDEN = 16
MLP_BATCH = 8


def _mlp_batch(node: int, rnd: int):
    rng = np.random.default_rng(7 * node + 100 * rnd)
    x = rng.normal(size=(MLP_BATCH, 28, 28, 1)).astype(np.float32)
    return x, rng.integers(0, 10, size=(MLP_BATCH,))


class MnistNode(PNode.HonestNode):
    """``mnist_mlp`` on the CPU from a flat start vector (built by
    ``models.convert`` from the JAX package's weights, or the port's own)."""

    def __init__(self, idx, flax_params=None):
        from byzpy_tpu_torch.models.convert import from_flax, ordered_like

        self.idx, self.calls = idx, 0
        self.bundle = nets.mnist_mlp(seed=0, hidden=MLP_HIDDEN, device="cpu")
        if flax_params is not None:
            self.bundle.params = ordered_like(from_flax(flax_params, device="cpu"),
                                              self.bundle.params)
        self._grad = torch.func.grad(self.bundle.loss_fn)

    def next_batch(self):
        x, y = _mlp_batch(self.idx, self.calls)
        self.calls += 1
        return torch.from_numpy(x), torch.from_numpy(y)

    def honest_gradient(self, x, y):
        return self._grad(self.bundle.params, x, y)

    def apply_server_gradient(self, gradient):
        self.bundle.params = {k: p - 0.1 * gradient[k] for k, p in self.bundle.params.items()}

    def params(self):
        return self.bundle.params


async def _mnist_rounds(backend, flax_params, rounds=3):
    actors = await asyncio.gather(*(HonestNodeActor.spawn(MnistNode, i, flax_params,
                                                          backend=backend) for i in range(4)))
    try:
        ps = ParameterServer(actors, [], aggregator=PAgg.CoordinateWiseTrimmedMean(f=1, device="cpu"))
        outs = [await ps.round() for _ in range(rounds)]
        return outs, [await a.params() for a in actors]
    finally:
        for a in actors:
            await a.close()


def test_process_nodes_match_thread_nodes_and_the_reference():
    """Four ``mnist_mlp`` process-actor nodes, 3 PS rounds with the trimmed
    mean: every aggregate and each node's final parameters equal the
    thread-actor nodes' bit for bit, and the JAX package's node on the
    same numpy start within 1e-5 (``models.convert``)."""
    import jax
    import jax.numpy as jnp

    from byzpy_tpu.aggregators import CoordinateWiseTrimmedMean as JTrimmed
    from byzpy_tpu.engine.node import base as JNode
    from byzpy_tpu.engine.parameter_server import ParameterServer as JPS
    from byzpy_tpu.models import nets as jnets
    from byzpy_tpu_torch.models.convert import to_flax

    flax_params = jax.tree_util.tree_map(np.asarray, jnets.mnist_mlp(seed=0, hidden=MLP_HIDDEN).params)
    proc = _run(_mnist_rounds("process", flax_params), 120)
    thread = _run(_mnist_rounds("thread", flax_params))
    for a, b in zip(proc[0], thread[0], strict=True):
        assert all(torch.equal(a[k], b[k]) for k in b)
    for a, b in zip(proc[1], thread[1], strict=True):
        assert all(torch.equal(a[k], b[k]) for k in b)

    class JMnist(JNode.HonestNode):
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

    jnodes = [JMnist(i) for i in range(4)]
    jps = JPS(jnodes, [], aggregator=JTrimmed(f=1))
    for _ in range(3):
        _run(jps.round())
    for mine, jn in zip(proc[1], jnodes, strict=True):
        theirs = jax.tree_util.tree_map(np.asarray, jn.bundle.params)["params"]
        ours = to_flax(mine)["params"]
        for layer in theirs:
            for leaf in theirs[layer]:
                np.testing.assert_allclose(ours[layer][leaf], theirs[layer][leaf],
                                           rtol=1e-4, atol=1e-5)


# -- P2P on ProcessContext ----------------------------------------------------


class Batches:
    """A picklable batch source: node ``i``'s fixed batches, step by step."""

    def __init__(self, node: int) -> None:
        self.node, self.step = node, 0

    def __call__(self):
        x, y = _mlp_batch(self.node, self.step)
        self.step += 1
        return torch.from_numpy(x), torch.from_numpy(y)


async def _p2p(context_factory, rounds=2):
    workers = [PP2P.SGDModelWorker(nets.mnist_mlp(seed=0, hidden=MLP_HIDDEN, device="cpu"),
                                   Batches(i)) for i in range(3)]
    p2p = DecentralizedPeerToPeer(workers, [], aggregator=PAgg.CoordinateWiseMedian(device="cpu"),
                                  topology=Topology.complete(3), learning_rate=0.1,
                                  context_factory=context_factory)
    outs = []
    async with p2p:
        for _ in range(rounds):
            outs.append(await p2p.run_round_async())
    return outs


def test_p2p_on_process_context_matches_in_process():
    """Three honest ``SGDModelWorker`` nodes on ``complete(3)`` with the
    median, 2 rounds: each node's aggregate on ``ProcessContext`` children
    equals the ``InProcessContext`` run bit for bit."""
    ours = _run(_p2p(functools.partial(ProcessContext, child_device="cpu")), 120)
    ref = _run(_p2p(InProcessContext))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref, strict=True):
        assert sorted(a) == sorted(b)
        for i in a:
            assert torch.equal(torch.as_tensor(a[i]), b[i])


def test_process_context_configure_must_pickle_by_reference():
    async def main():
        ctx = ProcessContext("solo", configure=lambda node: None, child_device="cpu")
        node = DecentralizedNode("solo", ctx)
        with pytest.raises(TypeError, match="lambda"):
            await node.start()
        assert ctx._proc is None

    _run(main())
