"""The compiled steps, ``optimizer=`` and ``grad_dtype=`` against the JAX
package, on the CPU.

``Adam`` against ``optax.adam``; the PS round with ``optimizer=`` against
the reference's; BASELINE config #5's pipeline (bf16 ResNet-50-style
gradients, Empire rows, centred clipping) at a small size against the
reference's ``build_ps_train_step`` with ``mesh=None``; the serving steps
with ``optimizer=``; and the three ``jit_*`` twins, which run the eager
step on CPU tensors (their CUDA-graph capture is held to the eager step on
the card, ``tests/test_torch_cuda.py``). Inputs come from numpy under a
seed; each tolerance is stated where it is used.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byzpy_tpu.models import nets as jnets
from byzpy_tpu.ops import attack_ops as jattack
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu.parallel import ps as jps
from byzpy_tpu_torch.models import ModelBundle, convert, nets
from byzpy_tpu_torch.ops import attack_ops, kernels, robust
from byzpy_tpu_torch.parallel import (
    SGD,
    Adam,
    CommPrecision,
    PSStepConfig,
    build_ps_train_step,
    build_ragged_serving_ps_step,
    build_serving_ps_step,
    jit_ps_train_step,
    jit_ragged_serving_ps_step,
    jit_serving_ps_step,
)
from byzpy_tpu_torch.utils import cuda_graph

CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(-1).view(torch.uint8)


def _same_bits(a, b) -> bool:
    """Two structures of tensors (dicts, tuples) equal bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same_bits, a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kw", [{}, {"b1": 0.8, "b2": 0.99, "eps": 1e-6}])
def test_adam_matches_optax(kw):
    """Three steps of ``Adam`` on a flat vector against ``optax.adam`` with
    the same hyperparameters: parameters and both moments within 2 f32 ulps
    of their magnitude (``b ** t`` is one ``pow`` in each package, which may
    round differently), the step count exact and a device tensor."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(257,)).astype(np.float32)
    grads = [rng.normal(size=(257,)).astype(np.float32) for _ in range(3)]
    opt = Adam(1e-2, **kw)
    ref = optax.adam(1e-2, **kw)
    p, state = torch.from_numpy(p0), None
    state = opt.init(p)
    assert state["count"].dtype == torch.int32 and state["count"].shape == ()
    jp, jstate = jnp.asarray(p0), ref.init(jnp.asarray(p0))
    for g in grads:
        p, state = opt.step(p, torch.from_numpy(g), state)
        upd, jstate = ref.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=2 ** -22, atol=0)
        np.testing.assert_allclose(state["mu"].numpy(), np.asarray(jstate[0].mu), rtol=2 ** -22)
        np.testing.assert_allclose(state["nu"].numpy(), np.asarray(jstate[0].nu), rtol=2 ** -22)
    assert int(state["count"]) == int(jstate[0].count) == 3


def _mlp_round(n=4, b=1, batch=6, seed=1):
    jb = jnets.mnist_mlp(seed=seed, hidden=16)
    bundle = nets.make_bundle(nets.MLP(784, (16, 10)), device=CPU)
    bundle.params = convert.ordered_like(convert.from_flax(_np_tree(jb.params), device=CPU),
                                         bundle.params)
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, batch, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(n, batch)).astype(np.int32)
    return jb, bundle, xs, ys


def test_ps_step_with_adam_matches_the_reference():
    """Two PS steps with ``optimizer=Adam(1e-3)`` (MLP, 4 nodes of which 1
    sign-flips the honest mean, trimmed mean) against the reference's
    ``build_ps_train_step(optimizer=optax.adam(1e-3))``: parameters within
    rtol 1e-4, atol 1e-5 (the PS tests' tolerance), the count 2."""
    jb, bundle, xs, ys = _mlp_round()
    cfg = PSStepConfig(n_nodes=4, n_byzantine=1)
    jcfg = jps.PSStepConfig(n_nodes=4, n_byzantine=1)
    step, opt = build_ps_train_step(
        bundle, lambda m: robust.trimmed_mean(m, f=1), cfg, optimizer=Adam(1e-3),
        attack=lambda h, g: attack_ops.sign_flip(h.mean(dim=0)))
    jstep, jopt = jps.build_ps_train_step(
        jb, lambda m: jrobust.trimmed_mean(m, f=1), jcfg, optimizer=optax.adam(1e-3),
        attack=lambda h, k: jattack.sign_flip(h.mean(axis=0)))
    params, jparams = bundle.params, jb.params
    for s in range(2):
        params, opt, _ = step(params, opt, torch.from_numpy(xs), torch.from_numpy(ys).long())
        jparams, jopt, _ = jax.jit(jstep)(jparams, jopt, jnp.asarray(xs), jnp.asarray(ys),
                                          jax.random.PRNGKey(0))
        ref = convert.from_flax(_np_tree(jparams), device=CPU)
        for k, v in params.items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {s + 1} {k}")
    assert int(opt["count"]) == 2


# BASELINE config #5 at a small size: the ImageNet stem and bottleneck blocks
# of ResNet-50 in bf16, 32 filters, one block a stage, 32 x 32 inputs
CONFIG5_N, CONFIG5_BYZ, CONFIG5_BATCH, CONFIG5_HW = 4, 1, 2, 32
# centred clipping's threshold: the step-1 rows sit 8.2-9.2 from their mean
# here, so the first iteration clips some rows and not all (checked below)
CONFIG5_CTAU = 9.0


def test_config5_pipeline_matches_the_reference():
    """``tests/test_baseline_config5.py``'s pipeline at a small size with
    ``mesh=None``: bf16 ResNet (ImageNet stem, bottleneck blocks) gradients
    cast to bf16 (``grad_dtype``), Empire rows, centred clipping (M = 3),
    lr 0.01. Two steps of the port against the reference's (jitted):
    parameters within 5e-4 absolute (they move 3e-3 and 8e-3 from the
    start; the bf16 gradients differ by bf16 roundings in other orders, and
    the largest difference after two steps is 1.5e-4), the honest loss
    within rtol 1e-3 and the aggregate's norm within rtol 5e-3; the
    aggregator sees bf16 rows and clips some of them, not all."""
    jm = jnets.ResNet(stage_sizes=(1, 1), block_cls=jnets.BottleneckBlock, num_classes=10,
                      num_filters=32, small_input=False, dtype=jnp.bfloat16)
    jb = jnets.make_bundle(jm, (1, CONFIG5_HW, CONFIG5_HW, 3), seed=0)
    bundle = nets.make_bundle(nets.ResNet((1, 1), nets.BottleneckBlock, 10, 32, False,
                                          dtype=torch.bfloat16), device=CPU)
    bundle.params = convert.ordered_like(convert.from_flax(_np_tree(jb.params), device=CPU),
                                         bundle.params)
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(CONFIG5_N, CONFIG5_BATCH, CONFIG5_HW, CONFIG5_HW, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(CONFIG5_N, CONFIG5_BATCH)).astype(np.int32)
    seen = []

    def aggregate(m):
        if not seen:
            mf = m.float()
            seen.append((m.dtype, torch.linalg.vector_norm(mf - mf.mean(dim=0), dim=1)))
        return robust.centered_clipping(m, c_tau=CONFIG5_CTAU, M=3)

    cfg = PSStepConfig(n_nodes=CONFIG5_N, n_byzantine=CONFIG5_BYZ, learning_rate=0.01)
    step, opt = build_ps_train_step(bundle, aggregate, cfg,
                                    attack=lambda h, g: attack_ops.empire(h),
                                    grad_dtype=torch.bfloat16)
    jcfg = jps.PSStepConfig(n_nodes=CONFIG5_N, n_byzantine=CONFIG5_BYZ, learning_rate=0.01)
    jstep, jopt = jps.build_ps_train_step(
        jb, partial(jrobust.centered_clipping, c_tau=CONFIG5_CTAU, M=3), jcfg,
        attack=lambda h, k: jattack.empire(h), grad_dtype=jnp.bfloat16)
    jstep = jax.jit(jstep)
    params, jparams = bundle.params, jb.params
    for s in range(2):
        params, opt, metrics = step(params, opt, torch.from_numpy(xs), torch.from_numpy(ys).long())
        jparams, jopt, jmetrics = jstep(jparams, jopt, jnp.asarray(xs), jnp.asarray(ys),
                                        jax.random.PRNGKey(0))
        ref = convert.from_flax(_np_tree(jparams), device=CPU)
        for k, v in params.items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=5e-4,
                                       err_msg=f"step {s + 1} {k}")
        np.testing.assert_allclose(float(metrics["honest_loss"]), float(jmetrics["honest_loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(metrics["agg_grad_norm"]),
                                   float(jmetrics["agg_grad_norm"]), rtol=5e-3)
    dtype, dists = seen[0]
    assert dtype == torch.bfloat16
    assert 0 < int((dists > CONFIG5_CTAU).sum()) < CONFIG5_N


def test_grad_dtype_sets_the_error_feedback_residual():
    """With ``grad_dtype`` and an error-feedback wire, the carried residual
    has the gradient dtype (ref ``ps.py:324``) and the step returns it so."""
    _, bundle, xs, ys = _mlp_round()
    cfg = PSStepConfig(n_nodes=4, n_byzantine=1)
    step, opt = build_ps_train_step(bundle, robust.coordinate_median, cfg,
                                    grad_dtype=torch.bfloat16,
                                    comm_precision=CommPrecision("int8", error_feedback=True))
    d = sum(v.numel() for v in bundle.params.values())
    assert opt[1]["transpose"].dtype == torch.bfloat16 and opt[1]["transpose"].shape == (4, d)
    params, opt, metrics = step(bundle.params, opt, torch.from_numpy(xs), torch.from_numpy(ys).long())
    assert opt[1]["transpose"].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in params.values())
    assert torch.isfinite(metrics["ef_transpose_norm"])


def _linear(seed=0):
    from byzpy_tpu.models.bundle import ModelBundle as JBundle

    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(64, 8)) * 0.1).astype(np.float32)
    ours = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)},
                       loss_fn=lambda p, x, y: torch.mean((x @ p["w"] - y) ** 2))
    ref = JBundle(apply_fn=lambda p, x: x @ p["w"], params={"w": jnp.asarray(w)},
                  loss_fn=lambda p, x, y: jnp.mean((x @ p["w"] - y) ** 2))
    return ours, ref


def test_serving_step_with_adam_matches_the_reference():
    """The bucketed serving step with ``optimizer=Adam(1e-2)`` (masked
    trimmed mean, 6 rows in a bucket of 8) against the reference's
    ``build_serving_ps_step(optimizer=optax.adam(1e-2))`` over two steps:
    parameters within 2 f32 ulps of their magnitude."""
    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean

    ours, ref = _linear()
    rng = np.random.default_rng(2)
    matrix = np.zeros((8, 512), np.float32)
    matrix[:6] = rng.normal(size=(6, 512))
    valid = np.arange(8) < 6
    weights = valid.astype(np.float32)
    step, opt = build_serving_ps_step(
        ours, CoordinateWiseTrimmedMean(1, device=CPU).masked_matrix_fn(), optimizer=Adam(1e-2))
    jstep, jopt = jps.build_serving_ps_step(
        ref, lambda m, v: jrobust.masked_trimmed_mean(m, v, f=1), optimizer=optax.adam(1e-2))
    params, jparams = ours.params, ref.params
    for _ in range(2):
        params, opt, _ = step(params, opt, torch.from_numpy(matrix), torch.from_numpy(valid),
                              torch.from_numpy(weights))
        jparams, jopt, _ = jax.jit(jstep)(jparams, jopt, jnp.asarray(matrix), jnp.asarray(valid),
                                          jnp.asarray(weights))
        np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]), rtol=2 ** -22,
                                   atol=2 ** -22 * float(np.abs(np.asarray(jparams["w"])).max()))
    assert int(opt["count"]) == 2


def test_ps_twin_on_cpu_is_the_eager_step():
    """``jit_ps_train_step`` on CPU tensors is the eager step, bit for bit,
    with and without donation; ``opt_state0`` is the builder's; nothing is
    captured and no replay is counted."""
    _, bundle, xs, ys = _mlp_round()
    cfg = PSStepConfig(n_nodes=4, n_byzantine=1)
    args = dict(attack=lambda h, g: attack_ops.empire(h))
    eager, opt0 = build_ps_train_step(bundle, robust.coordinate_median, cfg, **args)
    kernels.reset_launch_counts()
    for donate in (True, False):
        twin, topt0 = jit_ps_train_step(bundle, robust.coordinate_median, cfg, donate=donate, **args)
        assert isinstance(twin, cuda_graph.CapturedStep) and _same_bits(opt0, topt0)
        pe, oe, pt, ot = bundle.params, opt0, bundle.params, topt0
        for _ in range(2):
            pe, oe, me = eager(pe, oe, torch.from_numpy(xs), torch.from_numpy(ys).long())
            pt, ot, mt = twin(pt, ot, torch.from_numpy(xs), torch.from_numpy(ys).long())
            assert _same_bits((pe, oe, me), (pt, ot, mt))
        assert not twin.graphs and twin.last_capture is None
    assert kernels.launch_counts["graph_replay:ps_train_step"] == 0
    with pytest.raises(TypeError, match="DeviceMesh"):
        jit_ps_train_step(bundle, robust.coordinate_median, cfg, mesh=object())


def test_ps_twin_keeps_the_error_feedback_state_structure():
    """With an error-feedback wire and Adam, the twin's ``opt_state0`` is
    ``(adam_state, {"transpose": residual})`` as the builder's, and its
    steps equal the eager steps bit for bit."""
    _, bundle, xs, ys = _mlp_round()
    cfg = PSStepConfig(n_nodes=4, n_byzantine=1)
    args = dict(comm_precision=CommPrecision("int8", error_feedback=True), optimizer=Adam(1e-3),
                grad_dtype=torch.bfloat16)
    eager, opt0 = build_ps_train_step(bundle, robust.coordinate_median, cfg, **args)
    twin, topt0 = jit_ps_train_step(bundle, robust.coordinate_median, cfg, **args)
    assert isinstance(topt0, tuple) and list(topt0[0]) == ["count", "mu", "nu"]
    assert list(topt0[1]) == ["transpose"] and topt0[1]["transpose"].dtype == torch.bfloat16
    assert _same_bits(opt0, topt0)
    pe, oe, pt, ot = bundle.params, opt0, bundle.params, topt0
    for _ in range(2):
        pe, oe, me = eager(pe, oe, torch.from_numpy(xs), torch.from_numpy(ys).long())
        pt, ot, mt = twin(pt, ot, torch.from_numpy(xs), torch.from_numpy(ys).long())
        assert _same_bits((pe, oe, me), (pt, ot, mt))


def test_serving_twins_on_cpu_are_the_eager_steps():
    """``jit_serving_ps_step`` (bucket 8) and ``jit_ragged_serving_ps_step``
    (capacity 8) on CPU tensors equal their eager steps bit for bit, Adam
    state included, and keep their builders' ``opt_state0``."""
    from byzpy_tpu_torch.aggregators import MultiKrum

    ours, _ = _linear()
    rng = np.random.default_rng(3)
    flat = torch.zeros((8, 512))
    flat[:6] = torch.from_numpy(rng.normal(size=(6, 512)).astype(np.float32))
    valid = torch.arange(8) < 6
    weights = valid.float()
    agg = MultiKrum(1, 3, device=CPU)
    for build, twin_of, inputs, kw in (
            (build_serving_ps_step, jit_serving_ps_step, (flat, valid, weights),
             dict(masked_aggregate=agg.masked_matrix_fn())),
            (build_ragged_serving_ps_step, jit_ragged_serving_ps_step,
             (flat, torch.zeros(1, dtype=torch.int32), torch.tensor([6], dtype=torch.int32), weights),
             dict(ragged_aggregate=agg.ragged_matrix_fn(), row_capacity=8))):
        fn = kw.pop("masked_aggregate", None) or kw.pop("ragged_aggregate")
        eager, opt0 = build(ours, fn, optimizer=Adam(1e-2), **kw)
        twin, topt0 = twin_of(ours, fn, optimizer=Adam(1e-2), **kw)
        assert _same_bits(opt0, topt0)
        pe, oe, pt, ot = ours.params, opt0, ours.params, topt0
        for _ in range(2):
            pe, oe, me = eager(pe, oe, *inputs)
            pt, ot, mt = twin(pt, ot, *inputs)
            assert _same_bits((pe, oe, me), (pt, ot, mt))
        assert not twin.graphs


def test_builders_take_any_optimizer_with_the_protocol():
    """An ``SGD`` passed as ``optimizer=`` gives the default step; an object
    without ``init`` / ``step`` raises ``TypeError``."""
    _, bundle, xs, ys = _mlp_round()
    cfg = PSStepConfig(n_nodes=4, n_byzantine=1)
    a, oa = build_ps_train_step(bundle, robust.coordinate_median, cfg)
    b, ob = build_ps_train_step(bundle, robust.coordinate_median, cfg,
                                optimizer=SGD(cfg.learning_rate, momentum=cfg.momentum))
    x, y = torch.from_numpy(xs), torch.from_numpy(ys).long()
    assert _same_bits(a(bundle.params, oa, x, y), b(bundle.params, ob, x, y))
    with pytest.raises(TypeError, match="init"):
        build_ps_train_step(bundle, robust.coordinate_median, cfg, optimizer=object())


def test_capture_guard_names_the_host_reading_callable(monkeypatch):
    """Outside a capture the guard is transparent. Inside one (simulated
    here: the CPU has no stream capture), a capture error raised by the
    callable becomes ``GraphCaptureError`` naming its role and saying that
    it reads the host; any other failure names the callable too."""
    def reads(m):
        raise RuntimeError("CUDA error: operation not permitted when stream is capturing")

    def copies(m):
        raise RuntimeError("Cannot copy between CPU and CUDA tensors during CUDA graph capture "
                           "unless the CPU tensor is pinned.")

    def breaks(m):
        raise ValueError("bad shape")

    ok = cuda_graph.capture_guard(lambda m: m + 1, "aggregate")
    assert ok(1) == 2
    monkeypatch.setattr(cuda_graph, "_capturing", lambda: True)
    for fn, role in ((reads, "aggregate"), (copies, "attack")):
        with pytest.raises(cuda_graph.GraphCaptureError,
                           match=rf"the {role} callable .*{fn.__name__} reads the host"):
            cuda_graph.capture_guard(fn, role)(0)
    with pytest.raises(cuda_graph.GraphCaptureError, match="breaks failed while the step"):
        cuda_graph.capture_guard(breaks, "pre_aggregate")(0)
    assert cuda_graph.capture_guard(None, "attack") is None
