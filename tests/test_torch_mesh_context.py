"""``MeshRemoteContext`` on loopback: full-mesh gossip, the reconnect
monitor, the inbound fallback and the shutdown, against the JAX package's
``MeshRemoteContext`` in the same scenarios.

Each scenario is one function that takes a package's node classes and
returns what every node received (sender, type, payload as a numpy
array or a plain value), so the two packages' runs are compared entry by
entry (exact: the payloads cross as host arrays, bits unchanged).
"""

import asyncio

import numpy as np
import pytest
import torch

from byzpy_tpu_torch.engine import node as port_node
from byzpy_tpu_torch.engine.node import DecentralizedNode, InProcessContext, MeshRemoteContext
from byzpy_tpu_torch.engine.peer_to_peer import Topology

WAIT_S = 30


def _packages():
    """``{"port": (DecentralizedNode, MeshRemoteContext, Topology, make_vec),
    "reference": ...}``, the JAX package's imported here."""
    import jax.numpy as jnp

    from byzpy_tpu.engine.node import DecentralizedNode as RefNode
    from byzpy_tpu.engine.node import MeshRemoteContext as RefMesh
    from byzpy_tpu.engine.peer_to_peer import Topology as RefTopology

    return {
        "port": (DecentralizedNode, MeshRemoteContext, Topology,
                 lambda v: torch.full((3,), v)),
        "reference": (RefNode, RefMesh, RefTopology, lambda v: jnp.full((3,), v)),
    }


def _plain(payload):
    if isinstance(payload, torch.Tensor):
        return ("array", payload.numpy().tolist())
    if isinstance(payload, np.ndarray):
        return ("array", payload.tolist())
    return ("value", payload)


async def _until(cond, what):
    for _ in range(WAIT_S * 50):
        if cond():
            return
        await asyncio.sleep(0.02)
    raise TimeoutError(what)


async def _mesh(pkg, n):
    Node, Mesh, Topo, _ = pkg
    ctxs = [Mesh(f"m{i}", reconnect_interval=0.2) for i in range(n)]
    ids = {i: f"m{i}" for i in range(n)}
    nodes, stores = [], {}
    for i, ctx in enumerate(ctxs):
        node = Node(f"m{i}", ctx)
        node.bind_topology(Topo.complete(n), ids)
        stores[f"m{i}"] = []

        async def keep(message, store=stores[f"m{i}"]):
            store.append(message)

        node.register_handler("gossip", keep)
        await node.start()
        nodes.append(node)
    book = {c.node_id: (c.host, c.port) for c in ctxs}
    for ctx in ctxs:
        for pid, addr in book.items():
            if pid != ctx.node_id:
                ctx.add_peer(pid, addr)
    return nodes, ctxs, stores


async def _gossip_and_reconnect(pkg):
    """Three nodes: a direct send, everyone broadcasts a vector, then m2's
    outbound connections are killed and the monitor re-dials (m2 retries
    its send until a path exists)."""
    make_vec = pkg[3]
    nodes, ctxs, stores = await _mesh(pkg, 3)
    try:
        await nodes[0].send_message("m1", "gossip", make_vec(5.0))
        for i, node in enumerate(nodes):
            reached = await node.broadcast_message("gossip", make_vec(float(i)))
            assert sorted(reached) == sorted(f"m{j}" for j in range(3) if j != i)
        await _until(lambda: all(len(s) >= 2 for s in stores.values()) and len(stores["m1"]) >= 3,
                     "broadcast")
        for _, writer, _lock in list(ctxs[2]._out.values()):
            writer.close()
        ctxs[2]._out.clear()
        for attempt in range(50):
            try:
                await nodes[2].send_message("m0", "gossip", "back")
                break
            except ConnectionError:
                if attempt == 49:
                    raise
                await asyncio.sleep(0.1)
        await _until(lambda: len(stores["m0"]) >= 3, "reconnect")
        await _until(lambda: "m0" in ctxs[2]._out, "the monitor's re-dial")
        live = {c.node_id: sorted(c.connected_peers()) for c in ctxs}
    finally:
        for node in nodes:
            await node.shutdown()
    # the shutdown closed every inbound writer and the servers
    assert all(not c._inbound_writers and c._server is None for c in ctxs)
    got = {nid: sorted((m.sender, m.type, _plain(m.payload)) for m in msgs)
           for nid, msgs in stores.items()}
    return got, live


async def _inbound_fallback(pkg):
    """``b`` has no address-book entry for ``a`` and answers over the
    connection ``a`` opened."""
    Node, Mesh, Topo, _ = pkg
    a, b = Mesh("a", reconnect_interval=0.2), Mesh("b", reconnect_interval=0.2)
    na, nb = Node("a", a), Node("b", b)
    got_a, got_b = [], []
    for node, store in ((na, got_a), (nb, got_b)):
        node.bind_topology(Topo.complete(2), {0: "a", 1: "b"})

        async def keep(message, store=store):
            store.append(message)

        node.register_handler("m", keep)
    await na.start()
    await nb.start()
    try:
        a.add_peer("b", (b.host, b.port))
        await na.send_message("b", "m", 1)
        await _until(lambda: got_b, "a -> b")
        await nb.send_message("a", "m", 2)
        await _until(lambda: got_a, "b -> a over the inbound connection")
        role = b.connected_peers().get("a")
        with pytest.raises(ConnectionError, match="no live connection"):
            await b.send_message("ghost", None)
    finally:
        await na.shutdown()
        await nb.shutdown()
    return [m.payload for m in got_b], [m.payload for m in got_a], role


@pytest.fixture(autouse=True)
def _clear_registries():
    InProcessContext.clear_registry()
    yield
    InProcessContext.clear_registry()


def test_mesh_context_is_exported_as_in_the_reference():
    from byzpy_tpu.engine import node as ref_node

    assert "MeshRemoteContext" in port_node.__all__ and "MeshRemoteContext" in ref_node.__all__
    assert port_node.MeshRemoteContext is MeshRemoteContext


def test_full_mesh_gossip_and_reconnect_match_the_reference():
    runs = {name: asyncio.run(asyncio.wait_for(_gossip_and_reconnect(pkg), WAIT_S * 2))
            for name, pkg in _packages().items()}
    port_got, port_live = runs["port"]
    ref_got, ref_live = runs["reference"]
    assert port_got == ref_got
    assert port_live == ref_live
    # every node heard every other's broadcast, m1 the direct send too
    assert [s for s, _, _ in port_got["m1"]].count("m0") == 2
    assert ("m2", "gossip", ("value", "back")) in port_got["m0"]


def test_inbound_fallback_matches_the_reference():
    runs = {name: asyncio.run(asyncio.wait_for(_inbound_fallback(pkg), WAIT_S))
            for name, pkg in _packages().items()}
    assert runs["port"] == runs["reference"] == ([1], [2], "in")


def test_untrusted_bind_warns_beyond_loopback():
    async def bind(host):
        ctx = MeshRemoteContext("w", host=host)
        node = DecentralizedNode("w", ctx)
        node.bind_topology(Topology.complete(1), {0: "w"})
        await node.start()
        await node.shutdown()

    with pytest.warns(RuntimeWarning, match="trusted"):
        asyncio.run(bind("0.0.0.0"))
