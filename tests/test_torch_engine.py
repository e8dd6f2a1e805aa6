"""The port's graph engine (``byzpy_tpu_torch.engine.graph``), its actor
layer (``engine.actor``: the ``thread`` and ``cuda`` backends, channels,
the factory) and ``configs.actor`` against the JAX package's, on the CPU.

The same graphs of ``CallableOp``s and operator classes go through both
packages' ``NodeScheduler``, ``ParallelScheduler``, ``ExecutionSession``,
``GraphBuilder`` and ``run_operator``: outputs are equal (plain Python
values exactly; the median bit for bit) and so are the error messages.
The ``cuda`` backend is checked here only for what it does without CUDA
(it raises); its stream discipline is checked on the card
(``tests/test_torch_cuda.py``). Every wait is bounded
(``asyncio.wait_for``), so no test can hang.
"""

import asyncio
import os
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import byzpy_tpu.aggregators as JAgg
import byzpy_tpu.configs.actor as jconfigs
import byzpy_tpu.engine.graph as J
from byzpy_tpu.engine.graph import operator as joperator
import byzpy_tpu_torch
import byzpy_tpu_torch.aggregators as PAgg
import byzpy_tpu_torch.configs.actor as pconfigs
import byzpy_tpu_torch.engine.graph as P
from byzpy_tpu_torch.engine.actor import ActorRef, open_channel, resolve_backend, spawn_actor
from byzpy_tpu_torch.engine.actor.backends.cuda import CudaActorBackend
from byzpy_tpu_torch.engine.actor.factory import parse_spec
from byzpy_tpu_torch.engine.graph import operator as poperator
from byzpy_tpu_torch.engine.graph import pool as ppool
from byzpy_tpu_torch.ops import kernels
from byzpy_tpu_torch.utils.cuda_graph import GraphCaptureError, LaunchingActors

WAIT_S = 60


def _run(coro, timeout=WAIT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _both(fn):
    """``fn(package)`` for both packages: (port result, JAX result)."""
    return fn(P), fn(J)


def _error(fn, exc=Exception):
    with pytest.raises(exc) as info:
        fn()
    return type(info.value).__name__, str(info.value)


# ---------------------------------------------------------------------------
# graphs, schedulers, sessions, the builder
# ---------------------------------------------------------------------------


def _diamond(m):
    """a -> (b, c) -> d, plus an independent e: plain Python arithmetic."""
    return m.ComputationGraph(
        [
            m.GraphNode("a", m.CallableOp(lambda x: x + 1, name="a"), {"x": m.GraphInput("x")}),
            m.GraphNode("b", m.CallableOp(lambda v: v * 2, name="b"), {"v": "a"}),
            m.GraphNode("c", m.CallableOp(lambda v, y: v - y, name="c"),
                        {"v": "a", "y": m.GraphInput("y")}),
            m.GraphNode("d", m.CallableOp(lambda p, q: (p, q, p * q), name="d"), {"p": "b", "q": "c"}),
            m.GraphNode("e", m.CallableOp(lambda y: -y, name="e"), {"y": m.graph_input("y")}),
        ],
        outputs=["d", "e", "a"],
    )


@pytest.mark.parametrize("scheduler", ["NodeScheduler", "ParallelScheduler",
                                       "MessageAwareNodeScheduler"])
@pytest.mark.parametrize("pool", [None, 1, 3])
def test_schedulers_give_the_jax_outputs(scheduler, pool):
    def run(m):
        async def go():
            if pool is None:
                return await getattr(m, scheduler)(_diamond(m)).run({"x": 4, "y": 3})
            async with m.ActorPool(m.ActorPoolConfig(backend="thread", count=pool)) as p:
                return await getattr(m, scheduler)(_diamond(m), pool=p).run({"x": 4, "y": 3})
        return _run(go())

    ours, ref = _both(run)
    assert ours == ref == {"d": (10, 2, 20), "e": -3, "a": 5}


def test_graph_errors_match_jax():
    def cases(m):
        op = m.CallableOp(lambda x: x, name="op")
        out = []
        out.append(_error(lambda: m.ComputationGraph([])))
        out.append(_error(lambda: m.ComputationGraph([m.GraphNode("a", op), m.GraphNode("a", op)])))
        out.append(_error(lambda: m.ComputationGraph([m.GraphNode("a", op, {"x": "b"}),
                                                      m.GraphNode("b", op, {"x": "a"})])))
        out.append(_error(lambda: m.ComputationGraph([m.GraphNode("a", op)], outputs=["z"])))
        g = m.ComputationGraph([m.GraphNode("a", op, {"x": "nowhere"})])
        out.append(_error(lambda: g.required_inputs()))
        for sched in (m.NodeScheduler, m.ParallelScheduler):
            out.append(_error(lambda: _run(sched(m.ComputationGraph(
                [m.GraphNode("a", op, {"x": m.GraphInput("missing")})])).run({}))))
            out.append(_error(lambda: _run(sched(g).run({}))))
            out.append(_error(lambda: _run(sched(m.ComputationGraph(
                [m.GraphNode("a", op, {"x": m.GraphInput.from_message("t")})])).run({}))))
        out.append(_error(lambda: m.GraphBuilder().build()))
        b = m.GraphBuilder()
        out.append(_error(lambda: b.input("g").apply(op)))
        b2 = m.GraphBuilder()
        b2.input("g").apply(op, input_key="g")
        out.append(_error(lambda: b2.build([b2.input("g")])))
        out.append(_error(lambda: _run(m.OperatorExecutor(op).run(3))))
        return out

    ours, ref = _both(cases)
    assert ours == ref


def test_graph_structure_matches_jax():
    def structure(m):
        g = _diamond(m)
        return ([n.name for n in g.nodes_in_order()], sorted(g.dependencies("d")),
                sorted(g.required_inputs()), g.outputs)

    ours, ref = _both(structure)
    assert ours == ref


def test_session_caches_and_reruns_as_jax():
    def run(m):
        calls = []

        def node(name, fn, inputs):
            def wrapped(**kw):
                calls.append(name)
                return fn(**kw)
            return m.GraphNode(name, m.CallableOp(wrapped, name=name), inputs)

        g = m.ComputationGraph([node("a", lambda x: x * 3, {"x": m.GraphInput("x")}),
                                node("b", lambda v: v + 1, {"v": "a"})], outputs=["b"])

        async def go():
            s = m.ExecutionSession()
            first = await s.execute(g, {"x": 2})
            second = await s.execute(g, {"x": 100})
            s.invalidate(["b"])
            third = await s.execute(g, {"x": 100})
            s.invalidate()
            s.seed("a", 10)
            fourth = await s.execute(g, {"x": 100})
            fut = s.execute_async(g, {"x": 1}, use_cache=False)
            assert await fut.wait(timeout=WAIT_S)
            fifth = await fut.result()
            return first, second, third, fourth, fifth, sorted(s.cached_nodes), list(calls)

        return _run(go())

    ours, ref = _both(run)
    assert ours == ref
    assert ours[:5] == ({"b": 7}, {"b": 7}, {"b": 7}, {"b": 11}, {"b": 4})


def test_execution_future_cancel_and_timeout():
    def run(m):
        async def go():
            s = m.ExecutionSession()
            g = m.ComputationGraph([m.GraphNode("slow", m.CallableOp(
                lambda: asyncio.sleep(30), name="slow"))])
            fut = s.execute_async(g)
            timed_out = await fut.wait(timeout=0.05)
            cancelled = fut.cancel()
            finished = await fut.wait(timeout=5)
            return timed_out, cancelled, finished, fut.done()
        return _run(go())

    ours, ref = _both(run)
    assert ours == ref == (False, True, True, True)


def test_graph_builder_and_run_operator_with_classes():
    """A builder pipeline of two classes and ``run_operator`` on a thread
    pool give the JAX package's values (the median bit for bit, the
    trimmed mean within rtol 1e-6, atol 1e-7)."""
    x = np.random.default_rng(3).normal(size=(7, 50)).astype(np.float32)

    def run(m, agg_mod, conv, kw):
        b = m.GraphBuilder()
        out = b.input("gradients").apply(agg_mod.CoordinateWiseMedian(chunk_size=8, **kw),
                                         name="median")
        graph = b.build(out)
        assert graph.outputs == ["median"]
        rows = [conv(r) for r in x]

        async def go():
            async with m.ActorPool(m.ActorPoolConfig(backend="thread", count=2)) as pool:
                med = await m.NodeScheduler(graph, pool=pool).run({"gradients": rows})
                tm = await m.run_operator(agg_mod.CoordinateWiseTrimmedMean(1, chunk_size=8, **kw),
                                          rows, pool=pool)
            tm_direct = await m.run_operator(agg_mod.CoordinateWiseTrimmedMean(1, **kw), rows)
            return np.asarray(med["median"]), np.asarray(tm), np.asarray(tm_direct)

        return _run(go())

    ours = run(P, PAgg, torch.from_numpy, {"device": "cpu"})
    ref = run(J, JAgg, jnp.asarray, {})
    np.testing.assert_array_equal(ours[0], ref[0])
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ours[1], ours[2])
    assert byzpy_tpu_torch.run_operator is P.run_operator
    assert byzpy_tpu_torch.OperatorExecutor is P.OperatorExecutor


def test_operator_executor_reuses_its_pool_and_graphs():
    def run(m):
        op = m.RemoteCallableOp(lambda gradients: sum(gradients), name="sum")
        op.input_key = "gradients"

        async def go():
            ex = m.OperatorExecutor(op, pool_config=m.ActorPoolConfig(backend="thread", count=2))
            a = await ex.run([1, 2, 3])
            pool = ex._pool
            b = await ex.run({"gradients": [4, 5]})
            same = ex._pool is pool and len(ex._graph_cache) == 1
            await ex.close()
            return a, b, same, ex._pool is None
        return _run(go())

    ours, ref = _both(run)
    assert ours == ref == (6, 9, True, True)


def test_make_single_operator_graph_and_remote_op():
    def run(m):
        op = m.RemoteCallableOp(lambda v: v * 10, name="ten", affinity="cpu", max_retries=1)
        g = m.make_single_operator_graph(op, input_keys={"v": "value"}, node_name="n")

        async def go():
            direct = await m.NodeScheduler(g).run({"value": 2})
            async with m.ActorPool(m.ActorPoolConfig(backend="thread", count=2)) as pool:
                pooled = await m.NodeScheduler(g, pool=pool).run({"value": 3})
            return direct, pooled, list(op.create_subtasks({"v": 1}, context=m.OpContext("n")))[0].name
        return _run(go())

    ours, ref = _both(run)
    assert ours == ref == ({"n": 20}, {"n": 30}, "ten")


# ---------------------------------------------------------------------------
# windowed subtasks, retry, affinity
# ---------------------------------------------------------------------------


class _SleepPool:
    """A pool stand-in that runs a subtask after a delay it names."""

    size = 2

    def __init__(self):
        self.peak = 0
        self.live = 0

    async def run_subtask(self, st):
        self.live += 1
        self.peak = max(self.peak, self.live)
        try:
            await asyncio.sleep(st.args[0])
            if st.args[1]:
                raise RuntimeError(f"subtask {st.name} failed")
            return st.name
        finally:
            self.live -= 1


@pytest.mark.parametrize("limit", [0, 1, 3])
def test_windowed_order_and_semaphore_release_on_failure(limit):
    def run(m, operator_mod):
        async def go():
            pool = _SleepPool()
            delays = [0.03, 0.0, 0.02, 0.01, 0.0, 0.02]
            tasks = [m.SubTask(fn=None, args=(d, False), name=f"t{i}") for i, d in enumerate(delays)]
            sem = asyncio.Semaphore(2)
            ok = await operator_mod.run_subtasks_windowed(pool, tasks, limit=limit, semaphore=sem)
            bad = tasks[:2] + [m.SubTask(fn=None, args=(0.0, True), name="bad")] + tasks[2:]
            try:
                await operator_mod.run_subtasks_windowed(pool, bad, limit=limit, semaphore=sem)
                failure = None
            except RuntimeError as exc:
                failure = str(exc)
            peak = pool.peak
            return ok, failure, sem._value, peak <= (2 if limit == 0 else min(2, limit))
        return _run(go())

    ours, ref = run(P, poperator), run(J, joperator)
    assert ours == ref
    assert ours[0] == [f"t{i}" for i in range(6)] and ours[1] == "subtask bad failed"
    assert ours[2] == 2 and ours[3]


def test_operator_window_and_affinities_from_metadata():
    """``_run_subtasks`` assigns the scheduler's worker affinities round
    robin to subtasks without one and keeps at most ``pool.size * 8`` (or
    ``max_subtasks_inflight``) in flight."""
    def run(m):
        class Fan(m.Operator):
            supports_subtasks = True
            max_subtasks_inflight = 2

            def create_subtasks(self, inputs, *, context):
                for i in range(5):
                    yield m.SubTask(fn=lambda i=i: (i, threading.current_thread().name), name=str(i),
                                    affinity="gpu" if i == 4 else None)

            def reduce_subtasks(self, partials, inputs, *, context):
                return [(i, "gpuw" in name) for i, name in partials]

        async def go():
            cfgs = [m.ActorPoolConfig(backend="thread", count=1, capabilities=["gpu"], name="gpuw"),
                    m.ActorPoolConfig(backend="thread", count=2, name="cpuw")]
            async with m.ActorPool(cfgs) as pool:
                ctx = m.OpContext("fan", {"worker_affinities": ["gpu"], "pool_size": pool.size})
                return await Fan().run({}, context=ctx, pool=pool)
        return _run(go())

    ours, ref = _both(run)
    assert ours == ref == [(i, True) for i in range(5)]


def test_retry_and_affinity_match_jax():
    def run(m):
        attempts = {"n": 0}

        def flaky(k):
            attempts["n"] += 1
            if attempts["n"] <= k:
                raise ValueError(f"attempt {attempts['n']}")
            return attempts["n"], threading.current_thread().name.split("-")[1]

        async def go():
            cfgs = [m.ActorPoolConfig(backend="thread", count=1, capabilities=["gpu"], name="g"),
                    m.ActorPoolConfig(backend="thread", count=2, name="c")]
            async with m.ActorPool(cfgs) as pool:
                out = [await pool.run_subtask(m.SubTask(fn=flaky, args=(2,), max_retries=2,
                                                        affinity="gpu"))]
                attempts["n"] = 0
                try:
                    await pool.run_subtask(m.SubTask(fn=flaky, args=(2,), max_retries=1))
                except ValueError as exc:
                    out.append(str(exc))
                names = await pool.run_many([m.SubTask(fn=lambda: threading.current_thread().name,
                                                       affinity="tpu-or-nothing")] * 3)
                out.append(len(names))
                out.append(sorted(pool.worker_capabilities.items()))
                out.append(pool.has_capability("gpu"))
                out.append(_error(lambda: pool.worker("nope"))[1])
            return out
        return _run(go())

    ours, ref = _both(run)
    assert ours == ref
    assert ours[0] == (3, "g") and ours[1] == "attempt 2"


def test_pool_waiters_rotation_and_lifecycle():
    """More subtasks than workers queue as waiters and all finish; a
    stopped pool refuses work; ``close`` cancels waiters."""
    def run(m):
        async def go():
            pool = m.ActorPool(m.ActorPoolConfig(backend="thread", count=2))
            refused = _error_async(pool.run_subtask(m.SubTask(fn=lambda: 1)))
            await pool.start()
            await pool.start()
            out = await pool.run_many([m.SubTask(fn=lambda i=i: (time.sleep(0.005), i)[1])
                                       for i in range(9)])
            size, names = pool.size, pool.worker_names
            await pool.close()
            await pool.close()
            return await refused, out, size, len(names)
        return _run(go())

    ours, ref = _both(run)
    assert ours == ref
    assert ours[0] == ("RuntimeError", "pool not started") and ours[1] == list(range(9))


async def _error_async(coro):
    try:
        await coro
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return type(exc).__name__, str(exc)
    return None


def test_message_aware_scheduler_cache_bound_and_trigger():
    def run(m):
        async def go():
            g = m.ComputationGraph([
                m.GraphNode("msg", m.MessageTriggerOp("grad", field="v")),
                m.GraphNode("twice", m.CallableOp(lambda v: v * 2, name="twice"), {"v": "msg"}),
                m.GraphNode("from_source", m.CallableOp(lambda w: w, name="w"),
                            {"w": m.GraphInput.from_message("side")}),
            ], outputs=["twice", "from_source"])
            s = m.MessageAwareNodeScheduler(g, max_cached_per_type=3)
            for i in range(5):
                await s.deliver_message("grad", {"v": i})
            await s.deliver_message("side", "hello")
            pending = s.pending_message_count("grad")
            out = await s.run()
            left = [await s.wait_for_message("grad") for _ in range(2)]
            waiter = asyncio.ensure_future(s.wait_for_message("late"))
            await asyncio.sleep(0)
            await s.deliver_message("late", "now")
            late = await waiter
            timeout = None
            try:
                await s.wait_for_message("never", timeout=0.01)
            except TimeoutError as exc:
                timeout = str(exc)
            no_sched = await _error_async(m.MessageTriggerOp("x").compute({}, context=m.OpContext("n")))
            s.swap_graph(m.ComputationGraph([m.GraphNode("k", m.CallableOp(lambda: 7, name="k"))]))
            swapped = await s.run()
            return pending, out, left, late, timeout, no_sched, swapped
        return _run(go())

    ours, ref = _both(run)
    assert ours == ref
    assert ours[0] == 3 and ours[1] == {"twice": 4, "from_source": "hello"} and ours[2] == [{"v": 3}, {"v": 4}]


def test_parallel_scheduler_runs_branches_concurrently_with_a_node_gate():
    def run(m, gate):
        live, peak = [0], [0]

        async def branch(v):
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            await asyncio.sleep(0.02)
            live[0] -= 1
            return v + 1

        nodes = [m.GraphNode(f"b{i}", m.CallableOp(branch, name=f"b{i}"), {"v": m.GraphInput("v")})
                 for i in range(4)]
        nodes.append(m.GraphNode("sum", m.CallableOp(lambda **kw: sum(kw.values()), name="sum"),
                                 {f"b{i}": f"b{i}" for i in range(4)}))
        g = m.ComputationGraph(nodes, outputs=["sum"])
        out = _run(m.ParallelScheduler(g, max_concurrent_nodes=gate).run({"v": 1}))
        return out, peak[0]

    for gate, peak in ((0, 4), (2, 2)):
        ours, ref = run(P, gate), run(J, gate)
        assert ours == ref == ({"sum": 8}, peak)


# ---------------------------------------------------------------------------
# channels, actors, backends, configs
# ---------------------------------------------------------------------------


def test_actor_pool_channel_matches_jax():
    def run(m):
        async def go():
            async with m.ActorPool(m.ActorPoolConfig(backend="thread", count=3, name="w")) as pool:
                ch = await pool.open_channel("gossip")
                a, b, c = pool.worker_names
                await ch.send(a, b, [1, 2])
                got_b = await ch.recv(b)
                await ch.broadcast(a, "hi")
                got = [await asyncio.wait_for(ch.recv(w), 5) for w in (b, c)]
                return pool.worker_names, got_b, got, ch.name
        return _run(go())

    ours, ref = _both(run)
    assert ours == ref
    assert ours[1] == {"sender": "w-0-0", "payload": [1, 2]}


def test_thread_actor_ref_channels_and_router():
    class Counter:
        def __init__(self, start):
            self.n = start
            self.thread = threading.current_thread().name

        def add(self, k):
            self.n += k
            return self.n, threading.current_thread().name

        async def add_async(self, k):
            await asyncio.sleep(0)
            return self.add(k)

    async def go():
        a = await spawn_actor(resolve_backend("thread"), Counter, 5)
        async with ActorRef(resolve_backend("thread", actor_id="peer")) as peer:
            await peer.backend.construct(Counter, 0)
            n1, t1 = await a.add(2)
            n2, t2 = await a.add_async(3)
            ch = await open_channel(a.backend, "box")
            await ch.send({"x": torch.ones(2)}, to=peer.endpoint)
            got = await peer.channel("box").recv()
            await ch.send("self")
            mine = await ch.recv()
            with pytest.raises(LookupError, match="no route"):
                await ch.send(1, to=type(peer.endpoint)("thread", "local", "ghost"))
            # the TCP transport dials (one try here): a closed loopback port refuses
            os.environ["BYZPY_TPU_TORCH_TCP_RETRIES"] = "1"
            try:
                with pytest.raises(RuntimeError, match="retry budget spent"):
                    await ch.send(1, to=type(peer.endpoint)("tcp", "127.0.0.1:1", "far"))
            finally:
                os.environ.pop("BYZPY_TPU_TORCH_TCP_RETRIES", None)
        await a.backend.close()
        with pytest.raises(RuntimeError, match="not started"):
            await a.add(1)
        return n1, n2, t1 == t2, got, mine, a.endpoint.scheme

    n1, n2, same_thread, got, mine, scheme = _run(go())
    assert (n1, n2, same_thread, mine, scheme) == (7, 10, True, "self", "thread")
    assert torch.equal(got["x"], torch.ones(2))


def test_backend_specs_configs_and_capabilities(monkeypatch):
    assert parse_spec("thread") == ("thread", None)
    assert parse_spec("cuda") == ("cuda", 0) and parse_spec("cuda:3") == ("cuda", 3)
    # the out-of-process specs build without starting anything (PR 24)
    for spec, scheme in (("process", "process"), ("tcp://127.0.0.1:7777", "tcp")):
        assert resolve_backend(spec).scheme == scheme
        with pconfigs.use_actor(spec):
            assert pconfigs.get_actor() == spec
        assert P.ActorPool(P.ActorPoolConfig(backend=spec)).size == 1
    for spec in ("tpu", "tpu:0", "gpu", "cuda:x", ""):
        with pytest.raises(ValueError):
            resolve_backend(spec)
        with pytest.raises(ValueError):
            pconfigs.set_actor(spec)
    # the JAX package's messages for what both packages refuse
    for spec in ("", "bogus"):
        assert _error(lambda: pconfigs.set_actor(spec)) == _error(lambda: jconfigs.set_actor(spec))
    assert pconfigs.get_actor() == jconfigs.get_actor() == "thread"
    with pconfigs.use_actor("cuda:1"):
        assert pconfigs.get_actor() == "cuda:1"
        assert P.ActorPoolConfig().resolved_backend() == "cuda:1"
    assert pconfigs.get_actor() == "thread"
    pconfigs.set_actor("thread")
    assert ppool._infer_capabilities("cuda") == frozenset({"gpu"})
    assert ppool._infer_capabilities("cuda:2") == frozenset({"gpu"})
    assert ppool._infer_capabilities("thread") == frozenset({"cpu"})
    assert P.ActorPoolConfig(capabilities=["x"]).resolved_capabilities() == frozenset({"x"})
    assert ppool._IN_PROCESS_SCHEMES == {"thread", "cuda"}
    assert "cloudpickle" not in sys.modules or not hasattr(ppool, "cloudpickle")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_backend(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CudaActorBackend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.ActorPool(P.ActorPoolConfig(backend="cuda", count=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(P.run_operator(PAgg.CoordinateWiseMedian(device="cpu"), torch.zeros(3, 4),
                            pool_config=P.ActorPoolConfig(backend="cuda", count=2)))


def test_cuda_backend_device_range(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="device_index 1 out of range; 1 devices visible"):
        CudaActorBackend(device_index=1)
    with pytest.raises(ValueError, match="out of range"):
        resolve_backend("cuda:2")


def test_exports_match_jax():
    import byzpy_tpu.engine.actor as jactor
    import byzpy_tpu_torch.engine.actor as pactor

    assert sorted(P.__all__) == sorted(J.__all__)
    assert set(jactor.__all__) <= set(pactor.__all__)
    assert sorted(pconfigs.__all__) == sorted(jconfigs.__all__)
    assert P.select_adaptive_chunk_size(100_000, 8192, pool_size=4) == 6250


@pytest.mark.parametrize("total,configured,pool", [(100_000, 8192, 4), (64, 32, 4), (193, 16, 2),
                                                   (9, 2, 4), (10, 10, 0), (0, 5, 3), (7, 3, 6)])
def test_adaptive_chunk_size_matches_jax(total, configured, pool, monkeypatch):
    from byzpy_tpu.engine.graph.chunking import select_adaptive_chunk_size as jsize

    assert P.select_adaptive_chunk_size(total, configured, pool_size=pool) == jsize(
        total, configured, pool_size=pool)
    # the overrides, under the port's own names
    monkeypatch.setenv("BYZPY_TPU_TORCH_CHUNK_MIN_PER_WORKER", "1")
    monkeypatch.setenv("BYZPY_TPU_CHUNK_MIN_PER_WORKER", "1")
    assert P.select_adaptive_chunk_size(total, configured, pool_size=pool) == jsize(
        total, configured, pool_size=pool)


# ---------------------------------------------------------------------------
# launch counters and the capture guard under concurrent actors
# ---------------------------------------------------------------------------


def test_launch_counts_exact_under_concurrent_threads():
    """Threads bumping one counter through ``count_launch`` (a short switch
    interval to provoke interleaving) lose no count."""
    key, threads, per = "gram", 12, 4000
    before = kernels.launch_counts[key]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [kernels.count_launch(key) for _ in range(per)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=WAIT_S)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts[key] - before == threads * per
    kernels.launch_counts[key] = before


def test_capture_and_actor_calls_exclude_each_other():
    guard = LaunchingActors()
    with guard.call():
        assert guard.calls == 1
        with pytest.raises(GraphCaptureError, match="cuda actor call"):
            with guard.capture("ps_train_step"):
                pass
    with guard.capture("ps_train_step"):
        with pytest.raises(RuntimeError, match="capture is in progress"):
            with guard.call():
                pass
    with guard.call(), guard.call():
        assert guard.calls == 2
    assert guard.calls == 0
    with guard.capture("x"):
        pass
