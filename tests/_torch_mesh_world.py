"""Gloo worlds for the mesh tests: spawned ranks running named cases.

Not a test module (no ``test_`` prefix): ``tests/test_torch_collectives.py``,
``tests/test_torch_mesh_ps.py``, ``tests/test_torch_comms.py`` and
``tests/test_torch_mesh_gossip.py`` start a :class:`World` of 2 or 4 ranks
once a module and send it case names. A rank joins a gloo group through a
``file://`` rendezvous in the test's temporary directory (no fixed port,
so parallel test workers never collide), builds a 1-D ``nodes`` mesh on
the CPU and runs each case function of this module on its own part of the
data, returning numpy arrays and plain values; a case that takes
``grid=(nodes, data)`` runs on a 2-D ``(nodes, data)`` mesh of the same
ranks instead, made once a rank (:func:`grid_of`). A rank runs one intra-op
thread. This module imports no JAX and nothing of the
JAX package, so a rank never loads them; the JAX package's reference runs
in the test process.
"""

from __future__ import annotations

import datetime
import functools
import multiprocessing as mp
import os
import queue
import traceback
from typing import Any, Dict, List

import numpy as np
import torch

CASE_TIMEOUT_S = 240

# -- the world -------------------------------------------------------------


def _rank_main(rank: int, size: int, init: str, cmd_q, res_q) -> None:  # pragma: no cover - a rank
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=CASE_TIMEOUT_S))
    from byzpy_tpu_torch.parallel.mesh import node_mesh

    mesh = node_mesh(device="cpu")
    try:
        while True:
            item = cmd_q.get()
            if item is None:
                break
            name, kwargs = item
            try:
                out = globals()[name](mesh, rank, size, **kwargs)
                res_q.put((rank, True, out))
            except Exception:  # noqa: BLE001 - sent to the test process
                res_q.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``size`` spawned ranks on the CPU, one gloo group."""

    def __init__(self, size: int, rdzv_dir: str) -> None:
        ctx = mp.get_context("spawn")
        self.size = size
        self._cmd = [ctx.Queue() for _ in range(size)]
        self._res = ctx.Queue()
        init = f"file://{os.path.join(rdzv_dir, 'rendezvous')}"
        env = {"CUDA_VISIBLE_DEVICES": ""}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            self._procs = [ctx.Process(target=_rank_main, args=(r, size, init, self._cmd[r], self._res),
                                       daemon=True) for r in range(size)]
            for p in self._procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def run(self, name: str, **kwargs: Any) -> List[Any]:
        """Run case ``name`` on every rank; the results in rank order."""
        for q in self._cmd:
            q.put((name, kwargs))
        out: Dict[int, Any] = {}
        errors = []
        while len(out) + len(errors) < self.size:
            try:
                rank, ok, value = self._res.get(timeout=CASE_TIMEOUT_S)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                raise TimeoutError(f"case {name}: no answer in {CASE_TIMEOUT_S} s (dead ranks: "
                                   f"{dead})") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"case {name} failed\n" + "\n".join(errors))
        return [out[r] for r in range(self.size)]

    def close(self) -> None:
        for q in self._cmd:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in self._procs)


# -- data ------------------------------------------------------------------


_GRIDS: Dict[Any, Any] = {}


def grid_of(shape):
    """This rank's ``(nodes, data)`` mesh of ``shape``, made at its first
    use (every rank reaches it in the same case) and kept."""
    from byzpy_tpu_torch.parallel.mesh import grid_mesh

    shape = tuple(shape)
    if shape not in _GRIDS:
        _GRIDS[shape] = grid_mesh(*shape, device="cpu")
    return _GRIDS[shape]


def local_inputs(seed: int, size: int, shape, kind: str = "normal") -> np.ndarray:
    """``(size, *shape)`` float32: rank ``r``'s input is row ``r``.
    ``kind="int"`` gives small integers (sums of them are exact in any
    order)."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(-8, 9, size=(size, *shape)).astype(np.float32)
    return rng.normal(size=(size, *shape)).astype(np.float32)


# -- the collectives' cases -----------------------------------------------


def collective(mesh, rank, size, *, op: str, seed: int, shape, kind: str = "normal",
               kw: Dict[str, Any] = None):
    """``op`` of ``parallel.collectives`` on this rank's input."""
    from byzpy_tpu_torch.parallel import collectives as C

    x = torch.from_numpy(local_inputs(seed, size, shape, kind)[rank])
    out = getattr(C, op)(x, "nodes", mesh=mesh, **(kw or {}))
    return out.numpy()


def reshard(mesh, rank, size, *, seed: int, shape, src, dst, precision=None, ef: bool = False):
    """``reshard_q`` (``ef``: ``reshard_q_ef`` from a zero residual, twice)
    of this rank's block of a whole ``shape`` tensor, between the layouts
    named by the specs ``src`` and ``dst`` (``None``: replicated)."""
    from byzpy_tpu_torch.parallel import collectives as C
    from byzpy_tpu_torch.parallel.mesh import replicated, sharding

    full = torch.from_numpy(local_inputs(seed, 1, shape)[0])

    def layout(spec):
        return replicated(mesh) if spec is None else sharding(mesh, *spec)

    def block(t, spec):
        for dim, entry in enumerate(spec or ()):
            if entry == "nodes":
                return torch.chunk(t, size, dim=dim)[rank].contiguous()
        return t

    x = block(full, src)
    if not ef:
        return C.reshard_q(x, layout(src), layout(dst), precision=precision).numpy()
    r = torch.zeros_like(x)
    outs = []
    for _ in range(2):
        y, r = C.reshard_q_ef(x, r, layout(src), layout(dst), precision=precision)
        outs.append((y.numpy(), r.numpy()))
    return outs


def sharded(mesh, rank, size, *, seed: int, shape, which: str):
    """``sharded_fn`` / ``allreduce_sharded`` over a whole tensor."""
    from byzpy_tpu_torch.parallel import collectives as C

    x = torch.from_numpy(local_inputs(seed, 1, shape, "int")[0])
    if which == "allreduce":
        return C.allreduce_sharded(mesh, x).numpy()
    if which == "colsum":
        fn = C.sharded_fn(mesh, "nodes", lambda s: C.all_reduce_sum(s.sum(0), "nodes"),
                          in_spec=(None, "nodes"), out_spec=("nodes",))
        return fn(x).numpy()
    fn = C.sharded_fn(mesh, "nodes", lambda s: s * 2.0 + 1.0)
    return fn(x).numpy()


def traffic(mesh, rank, size, *, seed: int):
    """The traffic record of a few collectives."""
    from byzpy_tpu_torch.parallel import collectives as C
    from byzpy_tpu_torch.parallel.comms import collective_traffic

    x = torch.from_numpy(local_inputs(seed, size, (4, 512))[rank])

    def run():
        C.all_gather(x, "nodes", mesh=mesh)
        C.all_reduce_sum(x, "nodes", mesh=mesh)
        C.all_to_all(x, "nodes", split_axis=1, concat_axis=0, mesh=mesh)
        C.reduce_scatter_sum(x, "nodes", mesh=mesh)
        C.neighbor_shift(x, "nodes", mesh=mesh)
        C.all_gather_q(x, "nodes", precision="int8", mesh=mesh)

    rec = collective_traffic(run)
    return [(op.opcode, op.dtype, op.result_bytes, op.group_size) for op in rec["ops"]], \
        rec["per_opcode_bytes"], rec["wire_bytes_per_device"]


# -- the PS round's cases -------------------------------------------------

D_IN, D_OUT, N_NODES, BATCH = 100, 8, 8, 16


def linear_data(seed: int = 0, *, n_nodes: int = N_NODES, d_in: int = D_IN):
    """A linear bundle whose gradients are exact in f32 in both packages:
    ``loss = mean((x @ w) * y)`` has the gradient ``x^T y / (B * D_OUT)``
    (``x`` in {-1, 0, 1}, ``y`` multiples of 1/64), independent of ``w``;
    with a dyadic learning rate and momentum every step stays exact."""
    rng = np.random.default_rng(seed)
    w = (rng.integers(-32, 33, size=(d_in, D_OUT)) / 64.0).astype(np.float32)
    xs = rng.integers(-1, 2, size=(n_nodes, BATCH, d_in)).astype(np.float32)
    ys = (rng.integers(-64, 65, size=(n_nodes, BATCH, D_OUT)) / 64.0).astype(np.float32)
    return w, xs, ys


def linear_loss(p, x, y):
    return torch.mean((x @ p["w"]) * y)


def port_aggregate(name: str, f: int = 2, q: int = 4):
    """The port's aggregate (or ``(pre_aggregate, aggregate)``) by name."""
    from byzpy_tpu_torch.ops import preagg, robust

    table = {
        "trimmed": functools.partial(robust.trimmed_mean, f=f),
        "median": robust.coordinate_median,
        "meamed": functools.partial(robust.mean_of_medians, f=f),
        "mean": functools.partial(torch.mean, dim=0),
        "multi_krum": functools.partial(robust.multi_krum, f=f, q=q),
        "krum": functools.partial(robust.krum, f=f),
        "cge": functools.partial(robust.cge, f=f),
        "monna": functools.partial(robust.monna, f=f),
        "geomed": functools.partial(robust.geometric_median, max_iter=64),
        "cclip": functools.partial(robust.centered_clipping, c_tau=0.05, M=5),
        "nnm_mk": functools.partial(robust.nnm_multi_krum, f_nnm=f, f=f, q=q),
        "clip_mk": functools.partial(robust.clipped_multi_krum, tau=0.05, f=f, q=q),
        "arc_mk": functools.partial(robust.arc_multi_krum, f_arc=f, f=f, q=q),
        "clip+trimmed": (functools.partial(preagg.clip_rows, threshold=0.05),
                         functools.partial(robust.trimmed_mean, f=f)),
        "nnm+trimmed": (functools.partial(preagg.nnm, f=f),
                        functools.partial(robust.trimmed_mean, f=f)),
        "arc+trimmed": (functools.partial(preagg.arc_clip, f=f),
                        functools.partial(robust.trimmed_mean, f=f)),
        "caf": functools.partial(robust.caf, f=f),
        "bucketing": (functools.partial(preagg.bucket_means, perm=torch.arange(N_NODES),
                                        bucket_size=2),
                      functools.partial(robust.trimmed_mean, f=1)),
    }
    return table[name]


def _empire(honest, generator):
    from byzpy_tpu_torch.ops import attack_ops

    return attack_ops.empire(honest)


def _mimic(honest, generator):
    from byzpy_tpu_torch.ops import attack_ops

    return attack_ops.mimic(honest, epsilon=0)


ATTACKS = {"empire": _empire, "mimic": _mimic}


def port_step(mesh, agg: str, *, n_byz: int = 2, lr: float = 0.125, momentum: float = 0.5,
              comm=None, su=None, gather=None, gather_ef: bool = False, comm_ef: bool = False,
              adam: bool = False, seed: int = 0, attack: str = "empire",
              n_nodes: int = N_NODES, d_in: int = D_IN, f: int = 2, q: int = 4,
              compiled: bool = False):
    """``build_ps_train_step`` of the linear bundle (``mesh=None``: the
    single-device round; ``compiled``: ``jit_ps_train_step``)."""
    from byzpy_tpu_torch.models import ModelBundle
    from byzpy_tpu_torch.parallel import Adam, CommPrecision, PSStepConfig, ShardedUpdateConfig
    from byzpy_tpu_torch.parallel.ps import build_ps_train_step, jit_ps_train_step

    w, xs, ys = linear_data(seed, n_nodes=n_nodes, d_in=d_in)
    bundle = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)},
                         loss_fn=linear_loss)
    cfg = PSStepConfig(n_nodes=n_nodes, n_byzantine=n_byz, learning_rate=lr, momentum=momentum)
    fn = port_aggregate(agg, f, q)
    pre, fn = fn if isinstance(fn, tuple) else (None, fn)
    kw = {}
    if su is not None or gather is not None:
        kw["sharded_update"] = ShardedUpdateConfig(
            mode=su or "on",
            param_gather_precision=None if gather is None else CommPrecision(
                gather, error_feedback=gather_ef))
    if comm is not None:
        kw["comm_precision"] = CommPrecision(comm, error_feedback=comm_ef)
    if adam:
        kw["optimizer"] = Adam(1e-3)
    if compiled:
        kw["donate"] = False
    build = jit_ps_train_step if compiled else build_ps_train_step
    step, opt = build(bundle, fn, cfg, attack=ATTACKS[attack], pre_aggregate=pre, mesh=mesh, **kw)
    return step, opt, bundle.params, torch.from_numpy(xs), torch.from_numpy(ys)


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numpy().copy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree


def ps_round(mesh, rank, size, *, agg: str, steps: int = 3, grid=None, **kw):
    """``steps`` mesh rounds (on the ``(nodes, data)`` mesh ``grid``
    where given): each step's parameters, metrics and this rank's
    optimizer state, as numpy."""
    step, opt, params, xs, ys = port_step(grid_of(grid) if grid else mesh, agg, **kw)
    out = {"opt0": _np(opt), "steps": []}
    for _ in range(steps):
        params, opt, metrics = step(params, opt, xs, ys)
        out["steps"].append({"w": params["w"].numpy().copy(),
                             "metrics": {k: float(v) for k, v in metrics.items()},
                             "opt": _np(opt)})
    return out


def ps_traffic(mesh, rank, size, *, agg: str = "trimmed", grid=None, **kw):
    """One mesh round's traffic record: wire bytes by opcode, the ops (with
    their dtypes), and the bytes of this rank's carried state before it."""
    from byzpy_tpu_torch.parallel.comms import collective_traffic, measured_opt_state_bytes

    step, opt, params, xs, ys = port_step(grid_of(grid) if grid else mesh, agg, **kw)
    rec = collective_traffic(step, params, opt, xs, ys)
    ops = [(op.opcode, op.dtype, op.result_bytes, op.group_size) for op in rec["ops"]]
    return rec["per_opcode_bytes"], ops, measured_opt_state_bytes(opt)


def refusals(mesh, rank, size):
    """Every door of the mesh slice: the message of each that raises, and
    ``None`` for each that builds."""
    from byzpy_tpu_torch.aggregators import CAF, CoordinateWiseTrimmedMean
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer
    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.models import ModelBundle
    from byzpy_tpu_torch.parallel import gossip
    from byzpy_tpu_torch.parallel import ps as P

    w, _, _ = linear_data()
    bundle = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)},
                         loss_fn=linear_loss)
    cfg = P.PSStepConfig(n_nodes=N_NODES, n_byzantine=2)
    out = {}

    def catch(name, fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as exc:
            out[name] = (type(exc).__name__, str(exc))
        else:
            out[name] = None

    catch("grid_round", lambda: P.build_ps_train_step(bundle, port_aggregate("trimmed"), cfg,
                                                      mesh=grid_of((size // 2, 2))))
    catch("jit_mesh", lambda: P.jit_ps_train_step(bundle, port_aggregate("trimmed"), cfg,
                                                  mesh=mesh))
    catch("serving", lambda: P.build_serving_ps_step(bundle, None, mesh=mesh))
    catch("ragged_serving", lambda: P.build_ragged_serving_ps_step(bundle, None, row_capacity=8,
                                                                   mesh=mesh))
    gcfg = gossip.GossipStepConfig(n_nodes=N_NODES, n_byzantine=2)
    catch("gossip", lambda: gossip.build_gossip_train_step(
        bundle, port_aggregate("trimmed"), Topology.complete(N_NODES), gcfg, mesh=mesh,
        update_sharding="on"))
    catch("jit_gossip", lambda: gossip.jit_gossip_train_step(
        bundle, port_aggregate("trimmed"), Topology.complete(N_NODES), gcfg, mesh=mesh))
    catch("ring_gossip", lambda: gossip.build_ring_gossip_train_step(
        bundle, port_aggregate("median"), gossip.GossipStepConfig(n_nodes=size, n_byzantine=1),
        mesh, k=1))
    catch("actor_ps", lambda: ParameterServer([object()], aggregator=CoordinateWiseTrimmedMean(f=0,
                                                                                              device="cpu"),
                                              update_sharding="on"))
    for name in ("caf", "bucketing"):
        catch(name, lambda name=name: port_step(mesh, name))
    catch("unknown", lambda: P.build_ps_train_step(bundle, lambda m: m.mean(0), cfg, mesh=mesh))
    catch("actor_ps_caf", lambda: _actor_round(mesh, CAF(f=2, device="cpu"), "on"))
    catch("uneven_nodes", lambda: P.build_ps_train_step(
        bundle, port_aggregate("trimmed"), P.PSStepConfig(n_nodes=size * 2 + 1, n_byzantine=1),
        mesh=mesh))
    return out


def mesh_api(mesh, rank, size):
    """``parallel.mesh`` and ``configs.mesh`` in a rank: the meshes' shapes
    and names, the layouts' placements, the default mesh."""
    from byzpy_tpu_torch.configs import get_default_mesh, set_default_mesh, use_mesh
    from byzpy_tpu_torch.parallel import collectives as C
    from byzpy_tpu_torch.parallel import mesh as M

    out = {"init_again": M.init_process_group(), "init_twice": M.init_process_group(
        "file:///nonexistent", size, rank)}
    grid = M.make_mesh([-1, 2], ("nodes", "data"), device="cpu")
    feat = M.feature_mesh(device="cpu")
    out["grid"] = (tuple(grid.mesh.shape), grid.mesh_dim_names, M.node_axis(grid))
    out["feat"] = (tuple(feat.mesh.shape), feat.mesh_dim_names, M.node_axis(feat))
    out["grid_mesh"] = tuple(M.grid_mesh(size // 2, 2, device="cpu").mesh.shape)
    lay = M.sharding(grid, "nodes", ("data",))
    out["placements"] = [str(p) for p in lay.placements]
    out["sharded_dims"] = (lay.sharded_dim("nodes"), lay.sharded_dim("data"),
                           M.replicated(grid).sharded_dim("nodes"))
    for bad in (lambda: M.make_mesh([size + 1], device="cpu"),
                lambda: M.make_mesh([-1, -1], ("nodes", "data"), device="cpu"),
                lambda: M.sharding(mesh, "feat")):
        try:
            bad()
            out.setdefault("errors", []).append(None)
        except ValueError as exc:
            out.setdefault("errors", []).append(str(exc)[:40])
    assert get_default_mesh() is None
    created = get_default_mesh(create=False)
    with use_mesh(mesh):
        out["default_is_mesh"] = get_default_mesh() is mesh
        # collectives resolve the axis against the default mesh
        out["axis"] = (C.axis_size("nodes"), C.axis_index("nodes"))
    set_default_mesh(mesh)
    try:
        out["set_default"] = get_default_mesh() is mesh
    finally:
        set_default_mesh(None)
    out["cleared"] = created is None and get_default_mesh() is None
    return out


# -- the gossip rounds' cases ----------------------------------------------

GOSSIP_NODES, GOSSIP_BYZ, GOSSIP_LR = 8, 2, 0.125


def port_gossip_aggregate(name: str):
    from byzpy_tpu_torch.ops import robust

    return {
        "median": robust.coordinate_median,
        "trimmed": functools.partial(robust.trimmed_mean, f=1),
        "multi_krum": functools.partial(robust.multi_krum, f=1, q=2),
        "nnm_mk": functools.partial(robust.nnm_multi_krum, f_nnm=1, f=1, q=2),
        "geomed": functools.partial(robust.geometric_median, max_iter=16),
    }[name]


def gossip_round(mesh, rank, size, *, agg: str, su=None, comm=None, steps: int = 3, k: int = 3,
                 grid=None, compiled: bool = False):
    """``steps`` rounds of the mesh gossip step on ``Topology.ring(8, k)``
    (``compiled``: ``jit_gossip_train_step``): this rank's rows after each
    step and the honest losses. The byzantine nodes mimic honest node 0."""
    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.models import ModelBundle
    from byzpy_tpu_torch.parallel import gossip

    w, xs, ys = linear_data(n_nodes=GOSSIP_NODES)
    bundle = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)},
                         loss_fn=linear_loss)
    cfg = gossip.GossipStepConfig(GOSSIP_NODES, GOSSIP_BYZ, GOSSIP_LR)
    kw = dict(attack=_mimic, comm_precision=comm, mesh=grid_of(grid) if grid else mesh,
              update_sharding=su)
    if compiled:
        step, init = gossip.jit_gossip_train_step(bundle, port_gossip_aggregate(agg),
                                                  Topology.ring(GOSSIP_NODES, k), cfg,
                                                  donate=False, **kw)
    else:
        step, init = gossip.build_gossip_train_step(bundle, port_gossip_aggregate(agg),
                                                    Topology.ring(GOSSIP_NODES, k), cfg, **kw)
    theta, out = init(), []
    for _ in range(steps):
        theta, metrics = step(theta, torch.from_numpy(xs), torch.from_numpy(ys))
        out.append((theta.numpy().copy(), float(metrics["honest_loss"])))
    return out


def ring_exchange_case(mesh, rank, size, *, k: int, int8: bool = False):
    """``ring_exchange`` of this rank's vector (its rank, or int8 codes and
    scales of a seeded row)."""
    from byzpy_tpu_torch.parallel import gossip
    from byzpy_tpu_torch.parallel.quantization import quantize_blockwise

    if not int8:
        return gossip.ring_exchange(torch.full((4,), float(rank)), k, axis_name="nodes",
                                    mesh=mesh).numpy()
    q = quantize_blockwise(torch.from_numpy(local_inputs(7, size, (600,))[rank]), block=256)
    return (gossip.ring_exchange(q.values, k, axis_name="nodes", mesh=mesh).numpy(),
            gossip.ring_exchange(q.scales, k, axis_name="nodes", mesh=mesh).numpy())


def ring_round(mesh, rank, size, *, agg: str = "median", su=None, comm=None, gather=None,
               k: int = 2, steps: int = 3):
    """``steps`` rounds of ``build_ring_gossip_train_step`` (one node a
    rank, the last byzantine, no attack: it sends ``-half``): this rank's
    row after each step and the honest loss."""
    from byzpy_tpu_torch.models import ModelBundle
    from byzpy_tpu_torch.parallel import ShardedUpdateConfig, gossip

    w, xs, ys = linear_data(n_nodes=size)
    bundle = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)},
                         loss_fn=linear_loss)
    sharded = su if gather is None else ShardedUpdateConfig(su, param_gather_precision=gather)
    step, init = gossip.build_ring_gossip_train_step(
        bundle, port_gossip_aggregate(agg), gossip.GossipStepConfig(size, 1, GOSSIP_LR), mesh,
        k=k, comm_precision=comm, update_sharding=sharded)
    theta, out = init(), []
    for _ in range(steps):
        theta, loss = step(theta, torch.from_numpy(xs), torch.from_numpy(ys))
        out.append((theta.numpy().copy(), float(loss)))
    return out


# -- the actor PS with the sharded update ----------------------------------


class _GradNode:
    def __init__(self, grad):
        self.grad = grad

    def honest_gradient_for_next_batch(self):
        return [self.grad]

    def apply_server_gradient(self, grad):
        pass


def _actor_round(mesh, aggregator, update_sharding, pre=None):
    import asyncio

    from byzpy_tpu_torch.configs import use_mesh
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer

    rng = np.random.default_rng(0)
    grads = [torch.from_numpy(rng.normal(size=4096).astype(np.float32)) for _ in range(N_NODES)]
    ps = ParameterServer([_GradNode(g) for g in grads], aggregator=aggregator, pre_aggregator=pre,
                         update_sharding=update_sharding)
    with use_mesh(mesh):
        return asyncio.run(ps.round())


def actor_ps(mesh, rank, size, *, which: str, mode):
    """One ``ParameterServer`` round over 8 seeded 4,096-wide gradients,
    every rank the same (the SPMD contract), under the default mesh
    ``mesh``: the trimmed mean, or NNM -> Multi-Krum (the fused pipeline)."""
    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean, MultiKrum
    from byzpy_tpu_torch.pre_aggregators import NearestNeighborMixing

    if which == "trimmed":
        agg, pre = CoordinateWiseTrimmedMean(f=2, device="cpu"), None
    else:
        agg, pre = MultiKrum(f=2, q=4, device="cpu"), NearestNeighborMixing(f=2, device="cpu")
    out = _actor_round(mesh, agg, mode, pre)
    return out[0].numpy()


def compiled_equals_eager(mesh, rank, size, *, kind: str):
    """The compiled mesh step on CPU tensors against the eager one: each
    step's parameters (PS) or rows (gossip) from both, as numpy."""
    if kind == "ps":
        out = []
        for compiled in (False, True):
            step, opt, params, xs, ys = port_step(mesh, "trimmed", su="on", compiled=compiled)
            ws = []
            for _ in range(3):
                params, opt, _ = step(params, opt, xs, ys)
                ws.append(params["w"].numpy().copy())
            out.append(ws)
        return out
    return [[t for t, _ in gossip_round(mesh, rank, size, agg="trimmed", su="on",
                                        compiled=compiled)] for compiled in (False, True)]


def ring_wrong_size(mesh, rank, size):
    from byzpy_tpu_torch.models import ModelBundle
    from byzpy_tpu_torch.parallel import gossip

    w, _, _ = linear_data()
    bundle = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)},
                         loss_fn=linear_loss)
    try:
        gossip.build_ring_gossip_train_step(bundle, port_gossip_aggregate("median"),
                                            gossip.GossipStepConfig(size + 1, 1), mesh)
    except ValueError as exc:
        return str(exc)
    return "built"


def grid_odd_batch(mesh, rank, size):
    step, opt, params, xs, ys = port_step(grid_of((size // 2, 2)), "trimmed", n_nodes=4, n_byz=1,
                                          f=1)
    try:
        step(params, opt, xs[:, :BATCH - 1], ys[:, :BATCH - 1])
    except ValueError as exc:
        return str(exc)
    return "ran"


# -- collectives over two mesh axes -----------------------------------------

GRID_AXES = ("nodes", "data")


def _grid_block(t, spec, shape, rank):
    """This rank's block of a whole tensor under ``spec`` on the grid
    ``shape``: ``"nodes"`` splits over the first axis, a tuple of both
    over the product, nodes major."""
    for dim, entry in enumerate(spec or ()):
        if entry == "nodes":
            return torch.chunk(t, shape[0], dim=dim)[rank // shape[1]].contiguous()
        if entry == GRID_AXES:
            return torch.chunk(t, shape[0] * shape[1], dim=dim)[rank].contiguous()
    return t


def grid_collective(mesh, rank, size, *, op: str, seed: int, shape, kind: str = "normal",
                    kw: Dict[str, Any] = None, grid=(2, 2)):
    """``op`` of ``parallel.collectives`` over both axes of the grid."""
    from byzpy_tpu_torch.parallel import collectives as C

    x = torch.from_numpy(local_inputs(seed, size, shape, kind)[rank])
    return getattr(C, op)(x, GRID_AXES, mesh=grid_of(grid), **(kw or {})).numpy()


def grid_reshard(mesh, rank, size, *, seed: int, shape, src, dst, precision=None, grid=(2, 2)):
    """``reshard_q`` of this rank's block of a whole tensor between layouts
    of the grid (specs with ``"nodes"`` or ``("nodes", "data")``)."""
    from byzpy_tpu_torch.parallel import collectives as C
    from byzpy_tpu_torch.parallel.mesh import replicated, sharding

    g = grid_of(grid)
    full = torch.from_numpy(local_inputs(seed, 1, shape)[0])

    def layout(spec):
        return replicated(g) if spec is None else sharding(g, *spec)

    x = _grid_block(full, src, grid, rank)
    return C.reshard_q(x, layout(src), layout(dst), precision=precision).numpy()
