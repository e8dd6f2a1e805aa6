"""The mesh PS round (``build_ps_train_step(mesh=...)``) over gloo worlds
of 2 and 4 ranks on the CPU, against the JAX package's mesh round on a
CPU mesh of the same size.

The bundle is linear with a loss whose gradient does not depend on the
weights (``tests/_torch_mesh_world.py:linear_data``): every node's
gradient is exact in f32 in both packages, the learning rate (1/8) and
momentum (1/2) are dyadic, and the byzantine nodes mimic honest node 0,
so the coordinate-wise aggregators' rounds are exact and must agree bit
for bit (tolerance 0). The Gram, norm and distance families (under the
Empire attack, a mean of six rows) sum over ``d`` in another order (a
partial sum a rank and an all-reduce, against XLA's), as does Adam's square
root, so they are held within rtol 1e-5, atol 1e-6 after 3 steps. The
honest loss is a metric of ``x @ w``, summed in another order: within
rtol 1e-5. The compressed transpose
and gather are held within the codec's bound: one code step of the
largest block a step. The JAX package's own cases
(``tests/test_sharded_update.py:89-249``,
``tests/test_quantized_collectives.py:200,288``) are here as the port's:
sharded = replicated bit for bit, Adam, the geometric aggregator, the
padded opt state, the compressed gather bounded and not compounding, and
every door that still raises.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from _torch_mesh_world import BATCH, N_NODES, World, linear_data, port_step
from jax.sharding import Mesh

from byzpy_tpu.models.bundle import ModelBundle as JBundle
from byzpy_tpu.ops import attack_ops as jattack
from byzpy_tpu.ops import preagg as jpreagg
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu.parallel import ps as jps
from byzpy_tpu.parallel.quantization import CommPrecision as JCommPrecision

SIZES = [2, 4]
STEPS = 3
F = 2
EXACT = ["trimmed", "median", "mean"]
CLOSE = ["meamed", "multi_krum", "krum", "cge", "monna", "geomed", "cclip", "nnm_mk", "clip_mk", "arc_mk",
         "clip+trimmed", "nnm+trimmed", "arc+trimmed"]
RTOL, ATOL = 1e-5, 1e-6
CODE_STEP = {"bf16": 2.0 ** -7, "int8": 1 / 127, "s4": 1 / 7, "fp8": 32 / 448}


@pytest.fixture(scope="module", params=SIZES, ids=lambda k: f"world{k}")
def world(request, tmp_path_factory):
    w = World(request.param, str(tmp_path_factory.mktemp(f"rdzv{request.param}")))
    yield w
    w.close()


def _ref_aggregate(name):
    table = {
        "trimmed": lambda m: jrobust.trimmed_mean(m, f=F),
        "median": jrobust.coordinate_median,
        "meamed": lambda m: jrobust.mean_of_medians(m, f=F),
        "mean": lambda m: jnp.mean(m, axis=0),
        "multi_krum": lambda m: jrobust.multi_krum(m, f=F, q=4),
        "krum": lambda m: jrobust.krum(m, f=F),
        "cge": lambda m: jrobust.cge(m, f=F),
        "monna": lambda m: jrobust.monna(m, f=F),
        "geomed": lambda m: jrobust.geometric_median(m, max_iter=64),
        "cclip": lambda m: jrobust.centered_clipping(m, c_tau=0.05, M=5),
        "nnm_mk": lambda m: jrobust.nnm_multi_krum(m, f_nnm=F, f=F, q=4),
        "clip_mk": lambda m: jrobust.clipped_multi_krum(m, tau=0.05, f=F, q=4),
        "arc_mk": lambda m: jrobust.arc_multi_krum(m, f_arc=F, f=F, q=4),
        "clip+trimmed": (lambda m: jpreagg.clip_rows(m, threshold=0.05),
                         lambda m: jrobust.trimmed_mean(m, f=F)),
        "nnm+trimmed": (lambda m: jpreagg.nnm(m, f=F), lambda m: jrobust.trimmed_mean(m, f=F)),
        "arc+trimmed": (lambda m: jpreagg.arc_clip(m, f=F), lambda m: jrobust.trimmed_mean(m, f=F)),
    }
    return table[name]


def ref_round(k, agg, *, steps=STEPS, comm=None, comm_ef=False, su=None, gather=None,
              gather_ef=False, adam=False, attack="empire"):
    """The JAX package's mesh round of the same bundle and data on a
    ``k``-device CPU mesh, jitted: each step's weights and metrics, and
    the carried state."""
    w, xs, ys = linear_data()
    bundle = JBundle(apply_fn=lambda p, x: x @ p["w"], params={"w": jnp.asarray(w)},
                     loss_fn=lambda p, x, y: jnp.mean((x @ p["w"]) * y))
    cfg = jps.PSStepConfig(n_nodes=N_NODES, n_byzantine=2, learning_rate=0.125, momentum=0.5)
    fn = _ref_aggregate(agg)
    pre, fn = fn if isinstance(fn, tuple) else (None, fn)
    kw = {}
    if su is not None or gather is not None:
        kw["sharded_update"] = jps.ShardedUpdateConfig(
            mode=su or "on", param_gather_precision=None if gather is None else JCommPrecision(
                gather, error_feedback=gather_ef))
    if comm is not None:
        kw["comm_precision"] = JCommPrecision(comm, error_feedback=comm_ef)
    if adam:
        kw["optimizer"] = optax.adam(1e-3)
    step, opt = jps.build_ps_train_step(
        bundle, fn, cfg, pre_aggregate=pre,
        attack=(lambda h, key: jattack.empire(h)) if attack == "empire" else (
            lambda h, key: jattack.mimic(h, epsilon=0)),
        mesh=Mesh(np.array(jax.devices()[:k]), ("nodes",)), **kw)
    step = jax.jit(step)
    params, key, out = bundle.params, jax.random.PRNGKey(0), {"opt0": opt, "steps": []}
    for _ in range(steps):
        params, opt, metrics = step(params, opt, jnp.asarray(xs), jnp.asarray(ys), key)
        out["steps"].append({"w": np.asarray(params["w"]),
                             "metrics": {m: float(v) for m, v in metrics.items()}, "opt": opt})
    return out


def _same_on_every_rank(results):
    for r in results[1:]:
        for a, b in zip(results[0]["steps"], r["steps"]):
            np.testing.assert_array_equal(a["w"], b["w"])
            assert a["metrics"] == b["metrics"]
    return results[0]


def _compare(got, want, *, rtol=0.0, atol=0.0, metric_rtol=1e-5, slack=None):
    for s, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        tol = atol + (0.0 if slack is None else slack * (s + 1))
        if rtol == 0.0 and tol == 0.0:
            np.testing.assert_array_equal(g["w"], w["w"], err_msg=f"step {s + 1}")
        else:
            np.testing.assert_allclose(g["w"], w["w"], rtol=rtol, atol=tol, err_msg=f"step {s + 1}")
        assert set(g["metrics"]) == set(w["metrics"])
        for m in g["metrics"]:
            np.testing.assert_allclose(g["metrics"][m], w["metrics"][m],
                                       rtol=metric_rtol if slack is None else 1e-2,
                                       err_msg=f"step {s + 1} {m}")


def _port_no_mesh(agg, **kw):
    step, opt, params, xs, ys = port_step(None, agg, **kw)
    out = []
    for _ in range(STEPS):
        params, opt, _ = step(params, opt, xs, ys)
        out.append(params["w"].numpy().copy())
    return out


# -- the coordinate-wise aggregators: bit for bit ------------------------------


@pytest.mark.parametrize("su", ["off", "on"])
@pytest.mark.parametrize("agg", EXACT)
def test_coordinate_wise_round_matches_the_reference_bitwise(world, agg, su):
    got = _same_on_every_rank(world.run("ps_round", agg=agg, su=su, attack="mimic"))
    _compare(got, ref_round(world.size, agg, su=su, attack="mimic"))


@pytest.mark.parametrize("agg", ["trimmed", "median"])
def test_mesh_round_equals_the_single_device_round_bitwise(world, agg):
    """The port's mesh round (sharded update on and off) equals its own
    ``mesh=None`` round, bit for bit, and so does the replicated update."""
    single = _port_no_mesh(agg)
    for su in ("off", "on"):
        got = _same_on_every_rank(world.run("ps_round", agg=agg, su=su))
        for s, w in enumerate(single):
            np.testing.assert_array_equal(got["steps"][s]["w"], w, err_msg=f"{su} step {s + 1}")


# -- the Gram, norm and distance families: within f32 rounding ------------------


@pytest.mark.parametrize("agg", CLOSE)
def test_row_coupled_round_matches_the_reference(world, agg):
    got = _same_on_every_rank(world.run("ps_round", agg=agg, su="on"))
    _compare(got, ref_round(world.size, agg, su="on"), rtol=RTOL, atol=ATOL)


def test_sharded_geometric_aggregator_matches_replicated(world):
    """The reference's ``test_ps_sharded_geometric_aggregator``: Multi-Krum
    with the sharded update on and off agree (here bit for bit: both
    read the same all-reduced Gram)."""
    on = _same_on_every_rank(world.run("ps_round", agg="multi_krum", su="on"))
    off = _same_on_every_rank(world.run("ps_round", agg="multi_krum", su="off"))
    _compare(on, off)


# -- Adam ---------------------------------------------------------------------


def test_adam_sharded_equals_replicated_and_matches_the_reference(world):
    """Adam's state sharded and replicated agree within the reference's own
    tolerance (rtol 1e-6, atol 1e-7: PyTorch's CPU square root takes
    another path on a vector's tail than on its body, so a shard's
    elements can round apart by an ulp), and the reference's round within
    the Adam tolerance above."""
    on = _same_on_every_rank(world.run("ps_round", agg="trimmed", su="on", adam=True))
    off = _same_on_every_rank(world.run("ps_round", agg="trimmed", su="off", adam=True))
    _compare(on, off, rtol=1e-6, atol=1e-7)
    _compare(on, ref_round(world.size, "trimmed", su="on", adam=True), rtol=RTOL, atol=ATOL)
    # both moments carried over this rank's shard, the count a scalar
    flat, inner = on["steps"][-1]["opt"]
    assert set(inner) == {"count", "mu", "nu"}
    assert inner["mu"].shape == inner["nu"].shape == flat.shape
    assert int(inner["count"]) == STEPS


# -- the padded opt state ----------------------------------------------------------


@pytest.mark.parametrize("gather", [None, "int8"])
def test_opt_state_is_this_ranks_shard_of_the_reference_padding(world, gather):
    k = world.size
    d = linear_data()[0].size
    results = world.run("ps_round", agg="trimmed", su="on", gather=gather, steps=1)
    want = ref_round(k, "trimmed", su="on", gather=gather, steps=1)
    ref_flat0 = np.asarray(want["opt0"][0])
    grid = k * (256 if gather else 1)
    assert ref_flat0.shape[0] == -(-d // grid) * grid
    flat0 = np.concatenate([r["opt0"][0] for r in results])
    np.testing.assert_array_equal(flat0, ref_flat0)
    flat1 = np.concatenate([r["steps"][0]["opt"][0] for r in results])
    # the pad tail starts, and stays, exactly zero
    assert not flat1[d:].any()
    if gather is None:
        np.testing.assert_array_equal(flat1, np.asarray(want["steps"][0]["opt"][0]))


# -- the compressed fabric --------------------------------------------------------


def _code_slack(mode):
    """What one code step of the largest gradient block moves the weights
    by a step: lr / (1 - momentum) x the step x |g|max."""
    _, xs, ys = linear_data()
    g = np.einsum("nbi,nbo->nio", xs, ys) / (BATCH * ys.shape[-1])
    return 0.125 / 0.5 * CODE_STEP[mode] * float(np.abs(g).max()) * 1.01


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("mode", ["int8", "fp8", "s4"])
def test_compressed_transpose_matches_the_reference(world, mode, ef):
    """The gradient transpose as codes: step 1 bit for bit (the codes of
    exact gradients are equal, a trimmed mean of 4 decoded values sums
    them in another order: within 2 ulp), later steps within the codec
    bound; every rank's error-feedback residual norm is the reference's."""
    got = _same_on_every_rank(world.run("ps_round", agg="trimmed", su="on", comm=mode,
                                        comm_ef=ef))
    want = ref_round(world.size, "trimmed", su="on", comm=mode, comm_ef=ef)
    _compare(got, want, atol=1e-7, slack=_code_slack(mode))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compressed_gather_bounded_and_not_compounding(world, mode):
    """The reference's ``test_compressed_param_gather_error_bounded_not_
    compounding``: the gathered replica deviates from the f32 round within
    one round's bound, uniform in the round count, since each rank's exact
    shard stays in the carried state."""
    f32 = _same_on_every_rank(world.run("ps_round", agg="trimmed", su="on", steps=4))
    q = _same_on_every_rank(world.run("ps_round", agg="trimmed", su="on", gather=mode, steps=4))
    scale = np.abs(f32["steps"][-1]["w"]).max()
    per_value = {"bf16": 1 / 128, "int8": 1 / 127}[mode]
    dev1 = np.abs(q["steps"][0]["w"] - f32["steps"][0]["w"]).max()
    dev4 = np.abs(q["steps"][3]["w"] - f32["steps"][3]["w"]).max()
    assert 0 < dev1 <= per_value * scale * 2, (dev1, scale)
    assert dev4 <= per_value * scale * 4, (dev4, scale)
    # the exact shards never went through the codec
    exact = np.concatenate([r["steps"][3]["opt"][0] for r in
                            world.run("ps_round", agg="trimmed", su="on", steps=4)])
    d = f32["steps"][-1]["w"].size
    np.testing.assert_array_equal(exact[:d], f32["steps"][3]["w"].reshape(-1))


@pytest.mark.parametrize("mode", ["int8", "s4"])
def test_compressed_gather_with_error_feedback_matches_the_reference(world, mode):
    got = _same_on_every_rank(world.run("ps_round", agg="trimmed", su="on", gather=mode,
                                        gather_ef=True))
    want = ref_round(world.size, "trimmed", su="on", gather=mode, gather_ef=True)
    _compare(got, want, atol=1e-7, slack=_code_slack(mode))


# -- the doors that still raise -------------------------------------------------------


def test_every_unported_door_raises_naming_roadmap_a7(world):
    """The doors that still raise name the ROADMAP item that holds them:
    CAF, bucketing and unknown callables in the mesh round and the actor
    PS, A.7; the serving builders' ``mesh=``, A.6. The training mesh's
    doors build (``tests/test_torch_mesh_gossip.py``)."""
    unported = {"caf": "A.7", "bucketing": "A.7", "unknown": "A.7", "actor_ps_caf": "A.7",
                "serving": "A.6", "ragged_serving": "A.6"}
    for result in world.run("refusals"):
        assert result["uneven_nodes"][0] == "ValueError"
        for door, item in unported.items():
            caught = result[door]
            assert caught is not None, f"{door} did not raise"
            kind, message = caught
            assert kind == "NotImplementedError" and f"ROADMAP {item}" in message, (door, message)


def test_new_modules_import_no_jax():
    """The mesh slice's modules are inside the package scan of
    ``tests/test_torch_ps.py`` and import none of JAX or the JAX package."""
    repo = Path(__file__).resolve().parent.parent / "byzpy_tpu_torch"
    forbidden = {"jax", "jaxlib", "flax", "optax", "cloudpickle", "byzpy_tpu"}
    for rel in ("parallel/mesh.py", "parallel/collectives.py", "parallel/comms.py",
                "parallel/feature_sharded.py", "parallel/ps.py", "configs/mesh.py",
                "engine/legacy/transport.py", "engine/legacy/runner.py",
                "engine/node/mesh_context.py", "utils/robust_study.py", "cli.py"):
        tree = ast.parse((repo / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not [m for m in names if m.split(".")[0] in forbidden], (rel, names)
