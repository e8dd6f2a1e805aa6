"""Gloo worlds for the mesh tests: spawned ranks running named cases.

Not a test module (no ``test_`` prefix): ``tests/test_torch_collectives.py``,
``tests/test_torch_mesh_ps.py`` and ``tests/test_torch_comms.py`` start a
:class:`World` of 2 or 4 ranks once a module and send it case names. A
rank joins a gloo group through a ``file://`` rendezvous in the test's
temporary directory (no fixed port, so parallel test workers never
collide), builds a 1-D ``nodes`` mesh on the CPU and runs each case
function of this module on its own part of the data, returning numpy
arrays and plain values. This module imports no JAX and nothing of the
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


def port_aggregate(name: str):
    """The port's aggregate (or ``(pre_aggregate, aggregate)``) by name."""
    from byzpy_tpu_torch.ops import preagg, robust

    f = 2
    table = {
        "trimmed": functools.partial(robust.trimmed_mean, f=f),
        "median": robust.coordinate_median,
        "meamed": functools.partial(robust.mean_of_medians, f=f),
        "mean": functools.partial(torch.mean, dim=0),
        "multi_krum": functools.partial(robust.multi_krum, f=f, q=4),
        "krum": functools.partial(robust.krum, f=f),
        "cge": functools.partial(robust.cge, f=f),
        "monna": functools.partial(robust.monna, f=f),
        "geomed": functools.partial(robust.geometric_median, max_iter=64),
        "cclip": functools.partial(robust.centered_clipping, c_tau=0.05, M=5),
        "nnm_mk": functools.partial(robust.nnm_multi_krum, f_nnm=f, f=f, q=4),
        "clip_mk": functools.partial(robust.clipped_multi_krum, tau=0.05, f=f, q=4),
        "arc_mk": functools.partial(robust.arc_multi_krum, f_arc=f, f=f, q=4),
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
              n_nodes: int = N_NODES, d_in: int = D_IN):
    """``build_ps_train_step`` of the linear bundle (``mesh=None``: the
    single-device round)."""
    from byzpy_tpu_torch.models import ModelBundle
    from byzpy_tpu_torch.parallel import Adam, CommPrecision, PSStepConfig, ShardedUpdateConfig
    from byzpy_tpu_torch.parallel.ps import build_ps_train_step

    w, xs, ys = linear_data(seed, n_nodes=n_nodes, d_in=d_in)
    bundle = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)},
                         loss_fn=linear_loss)
    cfg = PSStepConfig(n_nodes=n_nodes, n_byzantine=n_byz, learning_rate=lr, momentum=momentum)
    fn = port_aggregate(agg)
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
    step, opt = build_ps_train_step(bundle, fn, cfg, attack=ATTACKS[attack], pre_aggregate=pre,
                                    mesh=mesh, **kw)
    return step, opt, bundle.params, torch.from_numpy(xs), torch.from_numpy(ys)


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numpy().copy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree


def ps_round(mesh, rank, size, *, agg: str, steps: int = 3, **kw):
    """``steps`` mesh rounds: each step's parameters, metrics and this
    rank's optimizer state, as numpy."""
    step, opt, params, xs, ys = port_step(mesh, agg, **kw)
    out = {"opt0": _np(opt), "steps": []}
    for _ in range(steps):
        params, opt, metrics = step(params, opt, xs, ys)
        out["steps"].append({"w": params["w"].numpy().copy(),
                             "metrics": {k: float(v) for k, v in metrics.items()},
                             "opt": _np(opt)})
    return out


def ps_traffic(mesh, rank, size, *, agg: str = "trimmed", **kw):
    """One mesh round's traffic record: wire bytes by opcode, the ops (with
    their dtypes), and the bytes of this rank's carried state before it."""
    from byzpy_tpu_torch.parallel.comms import collective_traffic, measured_opt_state_bytes

    step, opt, params, xs, ys = port_step(mesh, agg, **kw)
    rec = collective_traffic(step, params, opt, xs, ys)
    ops = [(op.opcode, op.dtype, op.result_bytes, op.group_size) for op in rec["ops"]]
    return rec["per_opcode_bytes"], ops, measured_opt_state_bytes(opt)


def refusals(mesh, rank, size):
    """Every door of the mesh slice that still raises: the message of each."""
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer
    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.models import ModelBundle
    from byzpy_tpu_torch.parallel import gossip
    from byzpy_tpu_torch.parallel import ps as P
    from byzpy_tpu_torch.parallel.mesh import make_mesh

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

    grid = make_mesh([1, size], ("nodes", "data"), device="cpu")
    catch("grid_round", lambda: P.build_ps_train_step(bundle, port_aggregate("trimmed"), cfg,
                                                      mesh=grid))
    catch("jit_mesh", lambda: P.jit_ps_train_step(bundle, port_aggregate("trimmed"), cfg,
                                                  mesh=mesh))
    catch("serving", lambda: P.build_serving_ps_step(bundle, None, mesh=mesh))
    catch("ragged_serving", lambda: P.build_ragged_serving_ps_step(bundle, None, row_capacity=8,
                                                                   mesh=mesh))
    gcfg = gossip.GossipStepConfig(n_nodes=N_NODES, n_byzantine=2)
    catch("gossip", lambda: gossip.build_gossip_train_step(
        bundle, port_aggregate("trimmed"), Topology.complete(N_NODES), gcfg, mesh=mesh))
    catch("jit_gossip", lambda: gossip.jit_gossip_train_step(
        bundle, port_aggregate("trimmed"), Topology.complete(N_NODES), gcfg, mesh=mesh))
    catch("ring_gossip", lambda: gossip.build_ring_gossip_train_step(bundle, mesh=mesh))
    catch("actor_ps", lambda: ParameterServer([object()], aggregator=None, update_sharding="on"))
    for name in ("caf", "bucketing"):
        catch(name, lambda name=name: port_step(mesh, name))
    catch("unknown", lambda: P.build_ps_train_step(bundle, lambda m: m.mean(0), cfg, mesh=mesh))
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
