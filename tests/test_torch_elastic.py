"""The port's elastic rounds and liveness against the JAX package's, on the
CPU: ``engine.parameter_server.elastic`` (``ElasticPolicy``,
``ElasticState``, ``call_node``, the PS's elastic round with its resync
gate and prefetch chains), ``engine.node.liveness`` (``LivenessTracker``,
``HeartbeatMonitor``) and ``engine.peer_to_peer.elastic``
(``HeartbeatPolicy``, the runner's ``remove_node``).

Crashes are deterministic (a node raises on its k-th call) and a hang is
a call that blocks on an event the test releases, so both packages see
the same failures in the same rounds: their aggregates (coordinate
median: exact), node states (exact) and ``elastic_state`` event logs must
be equal. Heartbeats tick every 20-50 ms and every wait is bounded
(``asyncio.wait_for``), so no test sleeps for seconds or can hang.
"""

import asyncio
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import byzpy_tpu.aggregators as JAgg
import byzpy_tpu.engine.node as JNode
import byzpy_tpu.engine.parameter_server as JPS
import byzpy_tpu.engine.parameter_server.elastic as jelastic
import byzpy_tpu.engine.peer_to_peer as JP2P
from byzpy_tpu.engine.node import liveness as jliveness
import byzpy_tpu_torch.aggregators as PAgg
import byzpy_tpu_torch.engine.node as PNode
import byzpy_tpu_torch.engine.parameter_server as PPS
import byzpy_tpu_torch.engine.parameter_server.elastic as pelastic
import byzpy_tpu_torch.engine.peer_to_peer as PP2P
from byzpy_tpu_torch.engine.node import liveness as pliveness
from byzpy_tpu_torch.engine.overlap import OverlapConfig

WAIT_S = 60


def _run(coro, timeout=WAIT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def clean_registries():
    """Both packages' in-process registries, empty around every case."""
    for mod in (PNode.context, JNode.context):
        mod.InProcessContext.clear_registry()
    yield
    for mod in (PNode.context, JNode.context):
        mod.InProcessContext.clear_registry()


def _np(tree):
    if isinstance(tree, (list, tuple)):
        return [_np(t) for t in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# the elastic PS round
# ---------------------------------------------------------------------------

D = 24


def _pkg(port: bool):
    if port:
        return dict(ps=PPS, agg=lambda: PAgg.CoordinateWiseMedian(device="cpu"),
                    full=lambda v: torch.full((D,), v, dtype=torch.float32), node=PNode)
    return dict(ps=JPS, agg=lambda: JAgg.CoordinateWiseMedian(),
                full=lambda v: jnp.full((D,), v, jnp.float32), node=JNode)


def _node_class(pkg):
    full = pkg["full"]

    class Node(pkg["node"].HonestNode):
        """Gradient = value + calls + a quarter of the node's state; raises
        on the calls in ``fail``; blocks on ``release`` at call ``hang``."""

        def __init__(self, value, *, fail=(), hang=None, release=None, apply_fails=False):
            self.value = float(value)
            self.state = full(0.0)
            self.calls = 0
            self.fail = set(fail)
            self.hang, self.release = hang, release
            self.apply_fails = apply_fails
            self.resynced = []
            self.finished = threading.Event()

        def next_batch(self):
            return None, None

        def honest_gradient(self, x, y):
            r = self.calls
            self.calls += 1
            if r in self.fail:
                raise ConnectionError(f"node {self.value:g} down at call {r}")
            if r == self.hang:
                self.release.wait(10.0)
                self.finished.set()
            return full(self.value + r) + 0.25 * self.state

        def apply_server_gradient(self, g):
            if self.apply_fails:
                raise RuntimeError("disk full")
            self.state = self.state - 0.5 * g

        def resync_params(self, payload):
            self.resynced.append(payload["round"])
            self.state = full(payload["value"])

    class Byz(pkg["node"].ByzantineNode):
        def __init__(self, *, fail=()):
            self.calls = 0
            self.fail = set(fail)

        def next_batch(self):
            return None, None

        def byzantine_gradient(self, honest):
            r = self.calls
            self.calls += 1
            if r in self.fail:
                raise ConnectionError("byzantine node down")
            return -3.0 * honest[0]

        def apply_server_gradient(self, g):
            pass

    return Node, Byz


async def _zombie_done(port: bool, node) -> None:
    """Wait until a timed-out call into ``node`` has returned and its
    daemon thread has let go of the node."""
    mod = pelastic if port else jelastic
    await asyncio.get_running_loop().run_in_executor(None, node.finished.wait, 10.0)
    assert await _wait_until(lambda: id(node) not in mod._inflight_ids)


async def _elastic_scenario(port: bool, prefetch: int):
    """Five honest nodes and one byzantine one, six rounds: node 1 crashes
    on its second call, node 2 hangs on its third (timed out, released
    after that round, re-admitted through ``resync``), node 4 fails its
    applies, the byzantine node crashes once."""
    pkg = _pkg(port)
    Node, Byz = _node_class(pkg)
    release = threading.Event()
    nodes = [Node(1.0), Node(2.0, fail={1}), Node(3.0, hang=2, release=release), Node(4.0),
             Node(5.0, apply_fails=True)]
    byz = [Byz(fail={3})]
    ps_box = []

    def resync():
        return {"round": ps_box[0].rounds_completed, "value": float(ps_box[0].rounds_completed)}

    policy = pkg["ps"].ElasticPolicy(min_quorum=2, call_timeout=0.3, readmit_every=1, resync=resync)
    overlap = OverlapConfig(prefetch_depth=prefetch) if port else \
        JPS.OverlapConfig(prefetch_depth=prefetch)
    ps = pkg["ps"].ParameterServer(nodes, byz, aggregator=pkg["agg"](), elastic=policy,
                                   overlap=overlap if prefetch else None)
    ps_box.append(ps)
    aggs, suspects = [], []
    for r in range(6):
        aggs.append(_np(await ps.round()))
        suspects.append(sorted(ps.elastic_state.suspects))
        if nodes[2].calls > 2 and not release.is_set():
            release.set()
            # the abandoned call ends before the next round probes the node
            await _zombie_done(port, nodes[2])
    await ps.flush()
    await ps.close()
    records = {nid: (rec.since_round, rec.failures, rec.last_error.split(":")[0])
               for nid, rec in ps.elastic_state.suspects.items()}
    return {"aggs": aggs, "suspects": suspects, "events": list(ps.elastic_state.events),
            "states": [_np(n.state) for n in nodes], "resynced": [n.resynced for n in nodes],
            "calls": [n.calls for n in nodes], "records": records}


@pytest.mark.parametrize("prefetch", [0, 1])
def test_elastic_round_matches_reference(prefetch):
    """Crash, timeout, failed applies and a byzantine crash: the rounds
    shrink, the quorum holds, the suspects are probed, resynced and
    re-admitted; aggregates, node states and the event log equal the JAX
    package's."""
    ours = _run(_elastic_scenario(True, prefetch))
    ref = _run(_elastic_scenario(False, prefetch))
    assert ours["events"] == ref["events"]
    assert ours["suspects"] == ref["suspects"]
    assert ours["resynced"] == ref["resynced"]
    assert ours["calls"] == ref["calls"]
    assert ours["records"] == ref["records"]
    for a, b in zip(ours["aggs"] + ours["states"], ref["aggs"] + ref["states"], strict=True):
        np.testing.assert_array_equal(a, b)
    kinds = {k for _, _, k in ours["events"]}
    assert {"suspected", "failed", "readmitted", "resync"} <= kinds


def test_elastic_aggregate_is_the_survivors_aggregate():
    """A round that loses a node aggregates exactly the survivors' rows."""

    async def scenario():
        pkg = _pkg(True)
        Node, Byz = _node_class(pkg)
        nodes = [Node(1.0), Node(2.0, fail={0}), Node(7.0)]
        ps = PPS.ParameterServer(nodes, [Byz()], aggregator=pkg["agg"](),
                                 elastic=PPS.ElasticPolicy(min_quorum=2))
        agg = await ps.round()
        honest = [torch.full((D,), 1.0), torch.full((D,), 7.0)]
        direct = PAgg.CoordinateWiseMedian(device="cpu").aggregate(honest + [-3.0 * honest[0]])
        return agg, direct

    agg, direct = _run(scenario())
    assert torch.equal(agg, direct)


def test_timed_out_actor_call_is_never_folded():
    """A node in a ``thread`` actor whose call outlives ``call_timeout``:
    the round goes on without it, the abandoned call's result (a NaN
    gradient) never reaches an aggregate, and the next probe of the node
    runs after the leftover call on the actor's one thread and is
    re-admitted with a fresh gradient."""

    class Slow(PNode.HonestNode):
        def __init__(self, value, release):
            self.value, self.calls, self.release = value, 0, release

        def next_batch(self):
            return None, None

        def honest_gradient(self, x, y):
            self.calls += 1
            if self.calls == 2:
                self.release.wait(10.0)
                return torch.full((D,), float("nan"))
            return torch.full((D,), self.value + self.calls)

        def apply_server_gradient(self, g):
            pass

    async def scenario():
        release = threading.Event()
        actors = [await PNode.HonestNodeActor.spawn(Slow, float(v), release, backend="thread")
                  for v in (1.0, 2.0, 3.0)]
        ps = PPS.ParameterServer(actors, aggregator=PAgg.CoordinateWiseMedian(device="cpu"),
                                 elastic=PPS.ElasticPolicy(min_quorum=2, call_timeout=0.2))
        out = [await ps.round()]
        out.append(await ps.round())   # every node's second call hangs: quorum lost
        return out

    async def scenario_one_slow():
        release = threading.Event()

        class Fast(Slow):
            def honest_gradient(self, x, y):
                self.calls += 1
                return torch.full((D,), self.value + self.calls)

        actors = [await PNode.HonestNodeActor.spawn(Fast, 1.0, release, backend="thread"),
                  await PNode.HonestNodeActor.spawn(Slow, 2.0, release, backend="thread"),
                  await PNode.HonestNodeActor.spawn(Fast, 3.0, release, backend="thread")]
        ps = PPS.ParameterServer(actors, aggregator=PAgg.CoordinateWiseMedian(device="cpu"),
                                 elastic=PPS.ElasticPolicy(min_quorum=2, call_timeout=0.2))
        first = await ps.round()
        second = await ps.round()
        suspects = sorted(ps.elastic_state.suspects)
        release.set()
        third = await ps.round()
        events = list(ps.elastic_state.events)
        for a in actors:
            await a.close()
        return first, second, suspects, third, events

    with pytest.raises(PPS.QuorumLostError):
        _run(scenario())
    first, second, suspects, third, events = _run(scenario_one_slow())
    assert torch.equal(first, torch.full((D,), 3.0))
    # round 2 without node 1: the median of 3.0 and 5.0, no NaN
    assert torch.equal(second, torch.full((D,), 4.0)) and suspects == ["honest:1"]
    # round 3: node 1's third call (value 2 + 3) is the fresh one
    assert torch.equal(third, torch.full((D,), 5.0))
    assert (2, "honest:1", "readmitted") in events


def test_timed_out_sync_node_is_never_reentered_concurrently():
    """A plain node whose call timed out keeps running in its daemon
    thread; a probe meanwhile fails with ``NodeBusyError`` (as in the JAX
    package) instead of entering the node's state twice."""
    msgs = []
    for port in (True, False):
        pkg = _pkg(port)
        Node, _ = _node_class(pkg)

        async def scenario():
            release = threading.Event()
            nodes = [Node(1.0), Node(2.0, hang=0, release=release), Node(3.0)]
            ps = pkg["ps"].ParameterServer(nodes, aggregator=pkg["agg"](),
                                           elastic=pkg["ps"].ElasticPolicy(call_timeout=0.1))
            await ps.round()
            await ps.round()
            rec = ps.elastic_state.suspects["honest:1"]
            release.set()
            await _zombie_done(port, nodes[1])
            await ps.round()
            return rec.last_error.split(":")[0], rec.failures, sorted(ps.elastic_state.suspects)

        msgs.append(_run(scenario()))
    assert msgs[0] == msgs[1] == ("NodeBusyError", 2, [])


def test_quorum_lost_and_external_suspects_match_reference():
    out = []
    for port in (True, False):
        pkg = _pkg(port)
        Node, Byz = _node_class(pkg)

        async def scenario():
            nodes = [Node(1.0), Node(2.0, fail={0, 1, 2}), Node(3.0)]
            ps = pkg["ps"].ParameterServer(
                nodes, [Byz()], aggregator=pkg["agg"](),
                elastic=pkg["ps"].ElasticPolicy(min_quorum=3))
            with pytest.raises(pkg["ps"].QuorumLostError) as info:
                await ps.round()
            ext = pkg["ps"].ParameterServer(
                [Node(1.0), Node(2.0), Node(3.0)], [Byz()], aggregator=pkg["agg"](),
                elastic=pkg["ps"].ElasticPolicy(external_suspects=lambda: ["honest:2"]))
            agg = await ext.round()
            return str(info.value), list(ext.elastic_state.events), _np(agg)

        out.append(_run(scenario()))
    assert out[0][:2] == out[1][:2]
    assert "min_quorum=3" in out[0][0]
    np.testing.assert_array_equal(out[0][2], out[1][2])


def test_elastic_policy_and_state_match_reference():
    for kw in ({"min_quorum": 0}, {"readmit_every": -1}):
        errs = []
        for mod in (pelastic, jelastic):
            with pytest.raises(ValueError) as info:
                mod.ElasticPolicy(**kw)
            errs.append(str(info.value))
        assert errs[0] == errs[1]
    assert pelastic.node_id("honest", 3) == jelastic.node_id("honest", 3) == "honest:3"
    ours, ref = pelastic.ElasticState(), jelastic.ElasticState()
    pol_ours, pol_ref = pelastic.ElasticPolicy(readmit_every=2), jelastic.ElasticPolicy(readmit_every=2)
    for st, pol in ((ours, pol_ours), (ref, pol_ref)):
        st.fail(0, "honest:1", ValueError("x"))
        st.fail(1, "honest:1", ValueError("y"))
        st.readmit(2, "honest:0")
        probes = [st.due_for_probe("honest:1", pol) for _ in range(4)]
        st.readmit(3, "honest:1")
        st.readmit(3, "honest:1")
        st.probes = probes
    assert list(ours.events) == list(ref.events)
    assert ours.probes == ref.probes == [False, True, False, True]
    for _ in range(pelastic.MAX_EVENTS + 10):
        ours.note(0, "n", "failed")
    assert len(ours.events) == pelastic.MAX_EVENTS == jelastic.MAX_EVENTS


def test_call_node_conventions():
    class Mixed:
        def sync(self, a):
            return a + 1

        async def coro(self, a):
            return a + 2

        def returns_awaitable(self, a):
            return asyncio.sleep(0, result=a + 3)

    async def scenario():
        m = Mixed()
        got = [await pelastic.call_node(m, "sync", (1,)),
               await pelastic.call_node(m, "coro", (1,)),
               await pelastic.call_node(m, "returns_awaitable", (1,))]
        got += [await pelastic.call_node(m, name, (1,), timeout=1.0)
                for name in ("sync", "coro", "returns_awaitable")]
        return got

    assert _run(scenario()) == [2, 3, 4, 2, 3, 4]


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [pliveness, jliveness], ids=["port", "jax"])
def test_liveness_tracker_state_machine(mod):
    """``tests/test_liveness.py``'s pure state-machine case, in both
    packages: consecutive-miss suspicion, one-reply recovery, startup
    grace for peers that never replied, crash-guarded callbacks."""
    events = []
    tr = mod.LivenessTracker(max_missed=2, startup_grace=10.0,
                             on_suspect=lambda p: events.append(("suspect", p)),
                             on_recover=lambda p: events.append(("recover", p)))
    tr.start_clock(0.0)
    tr.ensure("a")
    tr.ensure("b")
    tr.record_reply("a")
    for t in (1.0, 2.0, 3.0):
        tr.mark_pending("a")
        tr.mark_pending("b")
        tr.account_pending(t)
    assert tr.suspects() == ["a"]
    for t in (11.0, 12.0, 13.0):
        tr.mark_pending("b")
        tr.account_pending(t)
    assert tr.suspects() == ["a", "b"]
    tr.record_reply("a")
    assert tr.alive() == ["a"] and tr.suspects() == ["b"]
    assert events == [("suspect", "a"), ("suspect", "b"), ("recover", "a")]
    boom = mod.LivenessTracker(max_missed=1, on_suspect=lambda p: 1 / 0)
    boom.mark_pending("c")
    boom.account_pending(0.0)
    assert boom.suspects() == ["c"]
    for kw, err in (({"max_missed": 0}, "max_missed"), ({"startup_grace": -1}, "startup_grace")):
        with pytest.raises(ValueError, match=err):
            mod.LivenessTracker(**kw)


def _cluster(mod, n, topology):
    cluster = mod.DecentralizedCluster(topology)
    for i in range(n):
        nid = f"node-{i}"
        cluster.add_node(mod.DecentralizedNode(nid, mod.InProcessContext(nid)))
    return cluster


async def _wait_until(pred, timeout=5.0, step=0.02):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return True
        await asyncio.sleep(step)
    return False


@pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
def test_heartbeat_detects_death_and_recovery(port):
    """Three nodes on ``complete(3)``: the observer sees both peers alive,
    suspects the one that shuts down exactly once, and a rejoined peer
    recovers (one pong resets its misses)."""
    node_mod, p2p = (PNode, PP2P) if port else (JNode, JP2P)
    live = pliveness if port else jliveness

    async def scenario():
        cluster = _cluster(node_mod, 3, p2p.Topology.complete(3))
        await cluster.start_all()
        nodes = list(cluster.nodes.values())
        for passive in nodes[1:]:
            live.HeartbeatMonitor.install_responder(passive)
        events = []
        mon = live.HeartbeatMonitor(nodes[0], interval=0.02, max_missed=3,
                                    on_suspect=lambda p: events.append(("suspect", p)),
                                    on_recover=lambda p: events.append(("recover", p)))
        await mon.start()
        with pytest.raises(RuntimeError, match="already running"):
            await mon.start()
        try:
            assert await _wait_until(lambda: len(mon.alive()) == 2)
            await nodes[2].shutdown()
            assert await _wait_until(lambda: "node-2" in mon.suspects())
            await nodes[2].start()   # the peer comes back
            assert await _wait_until(lambda: mon.suspects() == [])
        finally:
            await mon.stop()
            await cluster.shutdown_all()
        return events, mon.max_missed, mon.startup_grace, sorted(mon.peers)

    events, missed, grace, peers = _run(scenario())
    assert events == [("suspect", "node-2"), ("recover", "node-2")]
    assert (missed, grace, peers) == (3, 0.0, ["node-1", "node-2"])


def test_heartbeat_startup_grace_shields_a_silent_peer():
    async def scenario():
        cluster = _cluster(PNode, 2, PP2P.Topology.complete(2))
        await cluster.start_all()
        nodes = list(cluster.nodes.values())
        mon = pliveness.HeartbeatMonitor(nodes[0], interval=0.02, max_missed=1,
                                         startup_grace=0.3)
        await mon.start()
        try:
            await asyncio.sleep(0.15)
            early = mon.suspects()
            assert await _wait_until(lambda: mon.suspects() == ["node-1"])
        finally:
            await mon.stop()
            await cluster.shutdown_all()
        return early

    assert _run(scenario()) == []


# ---------------------------------------------------------------------------
# the P2P runner's membership
# ---------------------------------------------------------------------------


def _quad_worker(port: bool):
    if port:
        base, full = PP2P.HonestP2PWorker, (lambda v: torch.full((6,), v, dtype=torch.float32))
    else:
        base, full = JP2P.HonestP2PWorker, (lambda v: jnp.full((6,), v, jnp.float32))

    class QuadWorker(base):
        def __init__(self, target):
            self.target = full(float(target))
            self.w = full(0.0)

        def half_step(self, lr):
            self.w = self.w - lr * 2.0 * (self.w - self.target)
            return self.w

        def parameters(self):
            return self.w

        def apply_aggregate(self, vector):
            self.w = vector

    return QuadWorker


async def _p2p_removal(port: bool, policy: bool):
    mod = PP2P if port else JP2P
    Quad = _quad_worker(port)
    agg = PAgg.CoordinateWiseMedian(device="cpu") if port else JAgg.CoordinateWiseMedian()
    workers = [Quad(t) for t in (0.0, 1.0, 2.0, 9.0)]
    kw = {"elastic": mod.HeartbeatPolicy(interval=0.02, max_missed=3)} if policy else {}
    p2p = mod.DecentralizedPeerToPeer(workers, [], aggregator=agg, topology=mod.Topology.complete(4),
                                      learning_rate=0.3, gossip_timeout=5.0, **kw)
    outs = []
    async with p2p:
        outs.append(await p2p.run_round_async())
        if policy:
            await p2p.nodes[3].shutdown()
            assert await _wait_until(lambda: ("node-3", "removed") in p2p.elastic_events)
        else:
            await p2p.remove_node(3)
        for _ in range(4):
            outs.append(await p2p.run_round_async())
        indices = list(p2p.honest_indices)
        events = list(p2p.elastic_events)
    return [{i: _np(v) for i, v in o.items()} for o in outs], [_np(w.w) for w in workers], indices, events


@pytest.mark.parametrize("policy", [False, True], ids=["remove_node", "heartbeat_policy"])
def test_p2p_removal_matches_reference(policy):
    """``remove_node`` (or ``HeartbeatPolicy`` seeing a peer die) shrinks
    the fabric; the survivors' rounds equal the JAX package's bit for bit,
    and equal a fabric that never had the peer."""
    ours = _run(_p2p_removal(True, policy))
    ref = _run(_p2p_removal(False, policy))
    assert ours[2] == ref[2] == [0, 1, 2]
    assert ours[3] == ref[3] == ([("node-3", "removed")] if policy else [])
    for a, b in zip(ours[0], ref[0], strict=True):
        assert sorted(a) == sorted(b)
        for i in a:
            np.testing.assert_array_equal(a[i], b[i])
    for a, b in zip(ours[1], ref[1], strict=True):
        np.testing.assert_array_equal(a, b)


def test_p2p_removal_guards_match_reference():
    msgs = []
    for port in (True, False):
        mod = PP2P if port else JP2P
        Quad = _quad_worker(port)
        agg = PAgg.CoordinateWiseMedian(device="cpu") if port else JAgg.CoordinateWiseMedian()

        async def scenario():
            p2p = mod.DecentralizedPeerToPeer([Quad(0.0), Quad(1.0)], [], aggregator=agg,
                                              topology=mod.Topology.complete(2))
            out = []
            async with p2p:
                await p2p.remove_node(1)
                for bad, exc in ((0, ValueError), (7, KeyError)):
                    with pytest.raises(exc) as info:
                        await p2p.remove_node(bad)
                    out.append(str(info.value))
            unbounded = mod.DecentralizedPeerToPeer([Quad(0.0), Quad(1.0)], [], aggregator=agg,
                                                    topology=mod.Topology.complete(2),
                                                    gossip_timeout=None)
            with pytest.raises(ValueError) as info:
                await unbounded.remove_node(1)
            out.append(str(info.value).split(":")[0])
            for kw in ({"gossip_timeout": None, "elastic": mod.HeartbeatPolicy()},
                       {"elastic": mod.HeartbeatPolicy(observer=5)}):
                with pytest.raises(ValueError) as info:
                    mod.DecentralizedPeerToPeer([Quad(0.0), Quad(1.0)], [], aggregator=agg,
                                                topology=mod.Topology.complete(2), **kw)
                out.append(str(info.value))
            for kw in ({"interval": 0}, {"max_missed": 0}, {"startup_grace": -1}):
                with pytest.raises(ValueError) as info:
                    mod.HeartbeatPolicy(**kw)
                out.append(str(info.value))
            return out

        msgs.append(_run(scenario()))
    assert msgs[0] == msgs[1]
