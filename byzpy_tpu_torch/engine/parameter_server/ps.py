"""Byzantine-robust parameter-server orchestrator.

Counterpart of ``byzpy_tpu/engine/parameter_server/ps.py`` (behavior
parity: ``byzpy/engine/parameter_server/ps.py:103-144``). One round:
gather the honest gradients, hand them to the byzantine nodes, optionally
pre-aggregate, aggregate robustly (inline, through the fused
pre-aggregated pipeline, or scheduled on an actor pool), then fan the
aggregate out to every node's ``apply_server_gradient``. Options: the
elastic round (``elastic=``, :mod:`.elastic`) and the overlapped round
(``overlap=``, :mod:`..overlap`: arrival-order folding and cross-round
prefetch).

This is the actor-mode server for nodes in ``thread`` and ``cuda``
actors or plain objects; ``byzpy_tpu_torch.parallel.ps`` runs the same
semantics as one fused step when every node fits one card.

Streams. A ``cuda`` actor computes on its own stream, and the PS folds
and aggregates on the caller's current stream. The actor backend makes
the caller's stream wait on an event recorded at the end of each call and
gives the returned tensors ``record_stream(caller)``
(``engine/actor/backends/cuda.py``), so a gradient is complete on the
caller's stream before the round touches it, and its memory stays
reserved until the round's work on it is done. A call that an elastic
timeout abandons never returns (see :mod:`.elastic`). Under prefetch,
round ``r + 1``'s gradients are in flight on the actors' streams while
round ``r`` returns; :meth:`ParameterServer.flush` settles them, and
:meth:`ParameterServer.close` cancels and awaits every chain, so neither
leaves an asyncio task behind. A CUDA-graph capture refuses while any
actor call runs (``utils.cuda_graph.launching_actors``).

``update_sharding=`` feature-shards the inline aggregate over the default
mesh (``configs.mesh``), the reference's :214-280: see
:class:`ParameterServer`. The small-payload host placement of
``utils.placement`` is not ported (ROADMAP C).
"""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, Awaitable, Callable, Dict, List, Optional, Sequence

import torch

from ...aggregators.base import Aggregator
from ...observability import metrics as obs_metrics
from ...observability import runtime as obs_runtime
from ...observability import tracing as obs_tracing
from ...pre_aggregators.base import PreAggregator
from ...utils.trees import stack_gradients
from ..graph.executor import OperatorExecutor
from ..graph.pool import ActorPool, ActorPoolConfig
from ..overlap import OverlapConfig, RoundOverlapStats, gather_arrival_order, now, settle_all
from .elastic import (
    ElasticPolicy,
    ElasticState,
    QuorumLostError,
    call_node,
    elastic_gather,
    elastic_settle,
    node_id,
)


async def _invoke(obj: Any, method: str, *args: Any) -> Any:
    """``obj.method(*args)``, awaited when it returns an awaitable."""
    return await call_node(obj, method, args)


async def _gather_all(coros) -> List[Any]:
    """Run coroutines concurrently, let all settle, then raise the first
    failure by input order (:func:`~..overlap.settle_all`)."""
    return await settle_all(list(coros))


def _publish_round_metrics(mode: str, seconds: float) -> None:
    """One closed round into the registry (callers check the switch)."""
    reg = obs_metrics.registry()
    reg.counter("byzpy_ps_rounds_total", help="actor-mode ParameterServer rounds completed",
                labels={"mode": mode}).inc()
    reg.histogram("byzpy_ps_round_seconds",
                  help="actor-mode ParameterServer wall seconds per round").observe(seconds)


class ParameterServer:
    """Robust-aggregation training coordinator over honest and byzantine
    nodes.

    ``honest_nodes`` expose ``honest_gradient_for_next_batch()`` and
    ``apply_server_gradient(g)``, ``byzantine_nodes``
    ``byzantine_gradient_for_next_batch(honest)`` and
    ``apply_server_gradient(g)``, sync or async (plain
    :class:`~byzpy_tpu_torch.engine.node.base.Node` objects or
    :class:`~byzpy_tpu_torch.engine.node.actors.NodeActor` handles).
    ``aggregator`` is the robust :class:`Aggregator`; with ``pool`` or
    ``pool_config`` it runs through the graph engine's
    :class:`OperatorExecutor` (its subtask fan-out), else inline.
    ``pre_aggregator`` transforms the gradient list first; an (NNM, ARC or
    Clipping) -> (Multi-)Krum pair runs as one fused call
    (``aggregators.pipelines.fused_pipeline_matrix_fn``). ``elastic`` and
    ``overlap`` turn on the elastic and the overlapped rounds.

    ``update_sharding`` (a ``parallel.ps.ShardedUpdateConfig``, a mode
    string, a bool, or ``None``) feature-shards the inline aggregate: when
    the policy resolves on (``"on"``, or ``"auto"`` with more than one
    rank in the default mesh's group), the plain aggregator and the fused
    pipeline run on this rank's columns of the stacked ``(n, d)`` matrix
    through their sharded forms (``parallel.feature_sharded``; their sums
    over ``d`` all-reduced over every axis of the default mesh) and every
    rank reads the all-gathered aggregate. Without a default mesh there is
    one device and nothing to shard: the aggregate runs as it is, as on the
    reference's one-device feature mesh. A pool-scheduled aggregate stays
    unsharded, and ``None`` is off. The contract is SPMD: every rank
    runs the same ``ParameterServer`` over the same gradients, round for
    round (the mesh round's contract, ROADMAP C).
    """

    def __init__(
        self,
        honest_nodes: Sequence[Any],
        byzantine_nodes: Sequence[Any] = (),
        *,
        aggregator: Aggregator,
        pre_aggregator: Optional[PreAggregator] = None,
        pool: Optional[ActorPool] = None,
        pool_config: Optional[ActorPoolConfig | Sequence[ActorPoolConfig]] = None,
        elastic: Optional[ElasticPolicy] = None,
        overlap: Optional[OverlapConfig] = None,
        update_sharding: Any = None,
    ) -> None:
        if not honest_nodes:
            raise ValueError("ParameterServer needs at least one honest node")
        if elastic is not None and elastic.min_quorum > len(honest_nodes):
            raise ValueError(
                f"min_quorum={elastic.min_quorum} exceeds the honest node count "
                f"({len(honest_nodes)}) — no round could ever meet it")
        if update_sharding is not None:
            from ...parallel.ps import as_sharded_update

            as_sharded_update(update_sharding)  # validate eagerly
        self._update_sharding = update_sharding
        self.honest_nodes = list(honest_nodes)
        self.byzantine_nodes = list(byzantine_nodes)
        self.aggregator = aggregator
        self.pre_aggregator = pre_aggregator
        self.elastic = elastic
        self.elastic_state = ElasticState()
        self.overlap = overlap
        self.last_overlap_stats: Optional[RoundOverlapStats] = None
        # prefetch chains: apply -> compute, dispatched at the end of round
        # r and collected at the start of round r + 1
        self._pending_honest: Optional[List["asyncio.Task"]] = None
        self._pending_elastic: Optional[Dict[str, "asyncio.Task"]] = None
        # run() sets this for its last round, so training consumes exactly
        # the serial schedule's batches
        self._suppress_prefetch = False
        self._executor = (
            OperatorExecutor(aggregator, pool=pool, pool_config=pool_config)
            if (pool is not None or pool_config is not None) else None)
        # the fused pipeline, resolved once; pool-scheduled aggregation keeps
        # the two steps (the executor owns that flow)
        self._fused_pipeline = None
        if self._executor is None and pre_aggregator is not None:
            from ...aggregators.pipelines import fused_pipeline_matrix_fn

            self._fused_pipeline = fused_pipeline_matrix_fn(pre_aggregator, aggregator)
        self.rounds_completed = 0

    # -- round pieces (ref: ps.py:89-101) ------------------------------------

    async def _stream_honest(self) -> List[Any]:
        """Honest gradients, concurrently, in ``honest_nodes`` order."""
        return await _gather_all(
            _invoke(node, "honest_gradient_for_next_batch") for node in self.honest_nodes)

    async def _stream_byzantine(self, honest_grads: List[Any]) -> List[Any]:
        if not self.byzantine_nodes:
            return []
        return await _gather_all(
            _invoke(node, "byzantine_gradient_for_next_batch", honest_grads)
            for node in self.byzantine_nodes)

    def _feature_group(self):
        """``(mesh, axes, ranks)`` of the sharded aggregate when the
        ``update_sharding`` policy resolves on over the default mesh's every
        axis, else ``None`` (as without a default mesh)."""
        from ...configs.mesh import get_default_mesh

        mesh = get_default_mesh()
        if self._update_sharding is None or mesh is None:
            return None
        from ...parallel.collectives import axis_size
        from ...parallel.ps import as_sharded_update

        axes = tuple(mesh.mesh_dim_names)
        ranks = axis_size(axes, mesh=mesh)
        if not as_sharded_update(self._update_sharding).resolve(ranks):
            return None
        return mesh, axes, ranks

    def _sharded(self, fn: Callable, matrix: Any, where) -> Any:
        """``fn``'s sharded form on this rank's columns of ``matrix``, the
        aggregate all-gathered: the whole ``(d,)`` vector on every rank."""
        from ...parallel.collectives import all_gather, axis_index
        from ...parallel.feature_sharded import FeatureGroup, sharded_form

        mesh, axes, ranks = where
        d = matrix.shape[1]
        d_loc = -(-d // ranks)
        lo = axis_index(axes, mesh=mesh) * d_loc
        cols = matrix[:, lo:lo + d_loc]
        if cols.shape[1] != d_loc:  # the last rank's columns pad with zeros
            cols = torch.nn.functional.pad(cols, (0, d_loc - cols.shape[1]))
        local = sharded_form(fn, FeatureGroup(mesh, axes))(cols.contiguous())
        return all_gather(local, axes, mesh=mesh)[:d]

    async def _aggregate(self, gradients: List[Any]) -> Any:
        where = self._feature_group()
        if self.pre_aggregator is not None:
            if self._fused_pipeline is not None:
                matrix, unravel = stack_gradients(gradients, device=self.aggregator.device)
                self.pre_aggregator.validate_n(matrix.shape[0])
                self.aggregator.validate_n(matrix.shape[0])
                with obs_tracing.device_span("ps.aggregate", track="ps", mode="fused_pipeline"):
                    if where is not None:
                        return unravel(self._sharded(self._fused_pipeline, matrix, where))
                    return unravel(self._fused_pipeline(matrix))
            gradients = self.pre_aggregator.pre_aggregate(gradients)
        if self._executor is not None:
            with obs_tracing.span("ps.aggregate", track="ps", mode="pool"):
                return await self._executor.run(gradients)
        if where is not None:
            matrix, unravel = stack_gradients(gradients, device=self.aggregator.device)
            self.aggregator.validate_n(matrix.shape[0])
            with obs_tracing.device_span("ps.aggregate", track="ps", mode="feature_sharded"):
                return unravel(self._sharded(self.aggregator, matrix, where))
        with obs_tracing.device_span("ps.aggregate", track="ps"):
            return self.aggregator.aggregate(gradients)

    # -- the adaptive adversaries' public feed --------------------------------

    def _adaptive_observers(self) -> List[Any]:
        """Local byzantine node objects whose class defines
        ``observe_round``. Actor handles are left out: a ``NodeActor``
        turns any attribute into an RPC, so a probe would find the method
        on every remote node."""
        return [node for node in self.byzantine_nodes
                if callable(getattr(type(node), "observe_round", None))]

    def _publish_public_state(self, aggregated: Any) -> None:
        """Feed the closed round's public outcome (the broadcast aggregate
        and the round counter) to the adaptive byzantine nodes."""
        observers = self._adaptive_observers()
        if not observers:
            return
        from ...attacks.adaptive import PublicRoundState

        state = PublicRoundState(round_id=self.rounds_completed, aggregate=aggregated,
                                 server_round=self.rounds_completed + 1)
        for node in observers:
            node.observe_round(state)

    # -- the elastic round ---------------------------------------------------

    def _rotation(self, role: str, nodes: Sequence[Any], external: set):
        """``(node_id, node)`` pairs of this round: non-suspects and the
        suspects due for a probe; external suspects are skipped."""
        policy, state = self.elastic, self.elastic_state
        out = []
        for i, node in enumerate(nodes):
            nid = node_id(role, i)
            if nid in external:
                state.note(self.rounds_completed, nid, "skipped_external")
                continue
            if state.due_for_probe(nid, policy):
                out.append((nid, node))
        return out

    async def _resync_gate(self, rotation: List[Any], round_no: int) -> List[Any]:
        """Suspects due for a probe receive the policy's ``resync`` payload
        first; only those whose resync lands stay in the rotation, so a
        restarted worker's first counted gradient is computed on the
        current parameters. A no-op without ``resync`` or suspects."""
        policy, state = self.elastic, self.elastic_state
        if policy.resync is None:
            return rotation
        probes = [(nid, n) for nid, n in rotation if nid in state.suspects]
        if not probes:
            return rotation
        payload = policy.resync()
        for nid, _ in probes:
            state.note(round_no, nid, "resync")
        ok = await elastic_gather(probes, policy.resync_method, (payload,),
                                  policy=policy, state=state, round_no=round_no)
        ok_ids = {nid for nid, _ in ok}
        probe_ids = {nid for nid, _ in probes}
        return [(nid, n) for nid, n in rotation if nid not in probe_ids or nid in ok_ids]

    async def _elastic_chain_apply_compute(self, node: Any, aggregated: Any) -> Any:
        """Prefetch chain with the elastic timeout on each leg: apply round
        ``r``'s update, then compute round ``r + 1``'s gradient."""
        timeout = self.elastic.call_timeout
        await call_node(node, "apply_server_gradient", (aggregated,), timeout=timeout)
        return await call_node(node, "honest_gradient_for_next_batch", (), timeout=timeout)

    async def _elastic_round(self) -> Any:
        t0 = now()
        with obs_tracing.span("ps.round", track="ps", round=self.rounds_completed, mode="elastic"):
            aggregated = await self._elastic_round_inner()
            if obs_runtime.STATE.enabled:
                _publish_round_metrics("elastic", now() - t0)
            return aggregated

    async def _elastic_round_inner(self) -> Any:
        policy, state = self.elastic, self.elastic_state
        rnd = self.rounds_completed
        external = set(policy.external_suspects()) if policy.external_suspects is not None else set()
        rotation = await self._resync_gate(self._rotation("honest", self.honest_nodes, external), rnd)
        pending = self._pending_elastic or {}
        self._pending_elastic = None
        settle_pairs: List[Any] = []
        fresh_pairs: List[Any] = []
        for nid, node in rotation:
            task = pending.pop(nid, None)
            if task is not None:
                settle_pairs.append((nid, task))
            else:
                fresh_pairs.append((nid, node))
        # chains of nodes that left the rotation meanwhile: abandoned, their
        # exceptions retrieved
        for task in pending.values():
            task.cancel()
            task.add_done_callback(lambda t: t.cancelled() or t.exception())
        collected: Dict[str, Any] = dict(await elastic_settle(settle_pairs, state=state, round_no=rnd))
        collected.update(await elastic_gather(
            fresh_pairs, "honest_gradient_for_next_batch", (),
            policy=policy, state=state, round_no=rnd))
        # rotation order, as the path without prefetch
        honest_pairs = [(nid, collected[nid]) for nid, _ in rotation if nid in collected]
        if len(honest_pairs) < policy.min_quorum:
            raise QuorumLostError(
                f"round {rnd}: {len(honest_pairs)} honest gradients < "
                f"min_quorum={policy.min_quorum} (suspects: {sorted(state.suspects)})")
        honest = [g for _, g in honest_pairs]
        byz_pairs = await elastic_gather(
            await self._resync_gate(self._rotation("byzantine", self.byzantine_nodes, external), rnd),
            "byzantine_gradient_for_next_batch", (honest,),
            policy=policy, state=state, round_no=rnd)
        aggregated = await self._aggregate(honest + [g for _, g in byz_pairs])
        self._publish_public_state(aggregated)
        # the fan-out is best effort; suspects and external suspects get none
        all_pairs = ([(node_id("honest", i), n) for i, n in enumerate(self.honest_nodes)]
                     + [(node_id("byzantine", i), n) for i, n in enumerate(self.byzantine_nodes)])
        live = [(nid, n) for nid, n in all_pairs
                if nid not in state.suspects and nid not in external]
        with obs_tracing.span("ps.broadcast", track="ps"):
            if self._prefetch_depth() > 0:
                honest_ids = {node_id("honest", i) for i in range(len(self.honest_nodes))}
                live_honest = [(nid, n) for nid, n in live if nid in honest_ids]
                live_byz = [(nid, n) for nid, n in live if nid not in honest_ids]
                self._pending_elastic = {
                    nid: asyncio.ensure_future(self._elastic_chain_apply_compute(n, aggregated))
                    for nid, n in live_honest}
                await elastic_gather(live_byz, "apply_server_gradient", (aggregated,),
                                     policy=policy, state=state, round_no=rnd)
            else:
                await elastic_gather(live, "apply_server_gradient", (aggregated,),
                                     policy=policy, state=state, round_no=rnd)
        self.rounds_completed += 1
        return aggregated

    # -- the overlapped round ------------------------------------------------

    def _prefetch_depth(self) -> int:
        if self.overlap is None or self._suppress_prefetch:
            return 0
        return self.overlap.prefetch_depth

    def _stream_enabled(self) -> bool:
        """Arrival-order folding needs the aggregator to own the whole
        reduction: pre-aggregation and the pool keep the barrier."""
        return (self.overlap is not None and self.overlap.stream
                and self.pre_aggregator is None and self._executor is None
                and getattr(self.aggregator, "supports_streaming", False))

    async def _chain_apply_compute(self, node: Any, aggregated: Any) -> Any:
        """This node's round ``r`` apply, then at once its round ``r + 1``
        gradient, without waiting for any other node."""
        await _invoke(node, "apply_server_gradient", aggregated)
        return await _invoke(node, "honest_gradient_for_next_batch")

    async def _plain_round(self) -> Any:
        """The round under an :class:`OverlapConfig`: arrival-order
        ingestion (folding when streaming) and a prefetching fan-out."""
        stream = self._stream_enabled()
        stats = RoundOverlapStats(mode="stream" if stream else "barrier")
        with obs_tracing.span("ps.round", track="ps", round=self.rounds_completed, mode=stats.mode):
            t0 = now()
            n_h = len(self.honest_nodes)
            fold_state = (self.aggregator.fold_init(n_h + len(self.byzantine_nodes))
                          if stream else None)
            arrivals: Dict[int, float] = {}

            def ingest(offset: int):
                def cb(i: int, grad: Any) -> None:
                    slot = offset + i
                    arrivals[slot] = now()
                    if fold_state is not None:
                        # on the caller's stream, which already waits on the
                        # actor's work (module docstring)
                        with obs_tracing.span("ps.fold", track="ps", slot=slot):
                            self.aggregator.fold(fold_state, slot, grad)
                        stats.observe_lag(now() - arrivals[slot])
                return cb

            pending = self._pending_honest
            self._pending_honest = None
            honest_aws = (pending if pending is not None
                          else [_invoke(node, "honest_gradient_for_next_batch")
                                for node in self.honest_nodes])
            with obs_tracing.span("ps.gather", track="ps"):
                honest = await gather_arrival_order(honest_aws, on_item=ingest(0))
                byz: List[Any] = []
                if self.byzantine_nodes:
                    byz = await gather_arrival_order(
                        [_invoke(node, "byzantine_gradient_for_next_batch", honest)
                         for node in self.byzantine_nodes],
                        on_item=ingest(n_h))
            if stream:
                with obs_tracing.device_span("ps.fold_finalize", track="ps"):
                    aggregated = self.aggregator.fold_finalize(fold_state)
            else:
                t_consume = now()
                for t in arrivals.values():
                    stats.observe_lag(t_consume - t)
                aggregated = await self._aggregate(honest + byz)
            self._publish_public_state(aggregated)
            with obs_tracing.span("ps.broadcast", track="ps"):
                if self._prefetch_depth() > 0:
                    self._pending_honest = [
                        asyncio.ensure_future(self._chain_apply_compute(node, aggregated))
                        for node in self.honest_nodes]
                    if self.byzantine_nodes:
                        await _gather_all(_invoke(node, "apply_server_gradient", aggregated)
                                          for node in self.byzantine_nodes)
                else:
                    await _gather_all(_invoke(node, "apply_server_gradient", aggregated)
                                      for node in self.honest_nodes + self.byzantine_nodes)
            stats.round_seconds = now() - t0
            self.last_overlap_stats = stats
            self.rounds_completed += 1
            if obs_runtime.STATE.enabled:
                _publish_round_metrics(stats.mode, stats.round_seconds)
            return aggregated

    async def flush(self) -> None:
        """Settle the outstanding prefetch chains: every node has then
        applied the last aggregate (a chain's failure raises here). The
        next-round gradients they computed stay buffered for the next
        ``round()``."""
        if self._pending_honest:
            await settle_all(self._pending_honest)
        if self._pending_elastic:
            # elastic failures are suspicion events, recorded when the next
            # round collects these chains
            await asyncio.gather(*self._pending_elastic.values(), return_exceptions=True)

    # -- public API ----------------------------------------------------------

    async def round(self) -> Any:
        """One training round; returns the aggregated gradient (ref:
        ``ps.py:103-144``)."""
        if self.elastic is not None:
            return await self._elastic_round()
        if self.overlap is not None:
            return await self._plain_round()
        t0 = now()
        with obs_tracing.span("ps.round", track="ps", round=self.rounds_completed, mode="serial"):
            with obs_tracing.span("ps.gather", track="ps"):
                honest = await self._stream_honest()
                byz = await self._stream_byzantine(honest)
            aggregated = await self._aggregate(honest + byz)
            self._publish_public_state(aggregated)
            with obs_tracing.span("ps.broadcast", track="ps"):
                await _gather_all(_invoke(node, "apply_server_gradient", aggregated)
                                  for node in self.honest_nodes + self.byzantine_nodes)
            self.rounds_completed += 1
            if obs_runtime.STATE.enabled:
                _publish_round_metrics("serial", now() - t0)
            return aggregated

    async def run(
        self,
        rounds: int,
        *,
        on_round: Optional[Callable[[int, Any], Optional[Awaitable[None]]]] = None,
    ) -> None:
        """Run ``rounds`` rounds, ``on_round(i, aggregated)`` after each.
        Under prefetch the last round dispatches nothing ahead and any
        chains left by direct ``round()`` calls are flushed, so the nodes
        end in the serial schedule's state."""
        for i in range(rounds):
            self._suppress_prefetch = i == rounds - 1
            try:
                aggregated = await self.round()
            finally:
                self._suppress_prefetch = False
            if on_round is not None:
                out = on_round(i, aggregated)
                if inspect.isawaitable(out):
                    await out
        await self.flush()

    async def close(self) -> None:
        """Cancel and await every prefetch chain, then close an owned
        executor pool. No task of the server is left pending."""
        for task in (self._pending_honest or []) + list((self._pending_elastic or {}).values()):
            task.cancel()
            try:
                await task
            except BaseException:  # noqa: BLE001 - teardown, best effort
                pass
        self._pending_honest = None
        self._pending_elastic = None
        if self._executor is not None:
            await self._executor.close()

    async def __aenter__(self) -> "ParameterServer":
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()


__all__ = ["ParameterServer"]
