"""The port's PS round (``byzpy_tpu_torch``: data, models, conversion, the
round itself) against the JAX package, on the CPU.

Inputs come from numpy with a seed and go to both packages; parameters are
compared after ``models.convert``, never as flat vectors (each package
ravels in its own order).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.models import data as jdata
from byzpy_tpu.models import nets as jnets
from byzpy_tpu.ops import attack_ops as jattack
from byzpy_tpu.ops import preagg as jpreagg
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu.parallel import ps as jps
from byzpy_tpu_torch.models import (
    from_flax,
    ordered_like,
    synthetic_classification,
    to_flax,
)
from byzpy_tpu_torch.models import nets
from byzpy_tpu_torch.ops import attack_ops, preagg, robust
from byzpy_tpu_torch.parallel import PSStepConfig, build_ps_train_step
from byzpy_tpu_torch.utils import device as device_mod

REPO = Path(__file__).resolve().parent.parent


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port_bundle(jbundle, module):
    """Port bundle holding the JAX bundle's parameters."""
    bundle = nets.make_bundle(module, device="cpu")
    bundle.params = ordered_like(from_flax(_np_tree(jbundle.params), device="cpu"), bundle.params)
    return bundle


def test_synthetic_classification_bit_for_bit():
    x, y = synthetic_classification(n_samples=96, seed=3, device="cpu")
    jx, jy = jdata.synthetic_classification(n_samples=96, seed=3)
    assert x.dtype == torch.float32 and x.shape == (96, 28, 28, 1)
    np.testing.assert_array_equal(x.numpy().view(np.uint32), np.asarray(jx).view(np.uint32))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("which", ["cnn", "mlp"])
def test_convert_round_trips(which):
    jb = jnets.mnist_cnn(seed=1) if which == "cnn" else jnets.mnist_mlp(seed=1)
    module = nets.SmallCNN() if which == "cnn" else nets.MLP()
    tree = _np_tree(jb.params)
    params = from_flax(tree, device="cpu")
    # names and shapes line up with the port's module
    ordered_like(params, dict(module.named_parameters()))
    back = to_flax(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("which", ["cnn", "mlp"])
def test_forward_matches_flax(which):
    """SmallCNN (full width, d = 421,642) and MLP logits within 1e-5."""
    jb = jnets.mnist_cnn(seed=2) if which == "cnn" else jnets.mnist_mlp(seed=2)
    bundle = _port_bundle(jb, nets.SmallCNN() if which == "cnn" else nets.MLP())
    if which == "cnn":
        assert sum(p.numel() for p in bundle.params.values()) == 421_642
    x = np.random.default_rng(0).normal(size=(8, 28, 28, 1)).astype(np.float32)
    ours = bundle.apply(bundle.params, torch.from_numpy(x)).detach().numpy()
    ref = np.asarray(jb.apply_fn(jb.params, jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_loss_matches_optax():
    jb = jnets.mnist_mlp(seed=4)
    bundle = _port_bundle(jb, nets.MLP())
    x, y = synthetic_classification(n_samples=16, seed=5, device="cpu")
    jx, jy = jdata.synthetic_classification(n_samples=16, seed=5)
    np.testing.assert_allclose(
        float(bundle.loss(x, y)), float(jb.loss(jx, jy)), rtol=1e-6
    )


AGGREGATORS = {
    "median": (robust.coordinate_median, jrobust.coordinate_median),
    "trimmed": (
        lambda m: robust.trimmed_mean(m, f=1),
        lambda m: jrobust.trimmed_mean(m, f=1),
    ),
    "krum": (
        lambda m: robust.multi_krum(m, f=1, q=2),
        lambda m: jrobust.multi_krum(m, f=1, q=2),
    ),
}


@pytest.mark.parametrize("agg", sorted(AGGREGATORS))
def test_ps_steps_match_jax(agg):
    """3 PS steps of SmallCNN (n=4 nodes, 1 byzantine sign-flipping the
    honest mean, batch 8): parameters within rtol 1e-4, atol 1e-5 of the
    JAX round after every step (f32 convolutions summed in another order)."""
    n, n_byz, batch = 4, 1, 8
    ours_agg, ref_agg = AGGREGATORS[agg]
    jb = jnets.mnist_cnn(seed=0)
    bundle = _port_bundle(jb, nets.SmallCNN())
    jx, jy = jdata.synthetic_classification(n_samples=3 * n * batch, seed=3)
    x, y = synthetic_classification(n_samples=3 * n * batch, seed=3, device="cpu")
    cfg = PSStepConfig(n_nodes=n, n_byzantine=n_byz)
    jcfg = jps.PSStepConfig(n_nodes=n, n_byzantine=n_byz)
    step, opt = build_ps_train_step(
        bundle, ours_agg, cfg, attack=lambda h, g: attack_ops.sign_flip(h.mean(0))
    )
    jstep, jopt = jps.build_ps_train_step(
        jb, ref_agg, jcfg,
        attack=lambda h, key: jattack.sign_flip(jnp.mean(h, axis=0)),
    )
    jstep = jax.jit(jstep)
    params, jparams = bundle.params, jb.params
    key = jax.random.PRNGKey(0)
    for s in range(3):
        sl = slice(s * n * batch, (s + 1) * n * batch)
        params, opt, metrics = step(
            params, opt, x[sl].reshape(n, batch, 28, 28, 1), y[sl].reshape(n, batch)
        )
        jparams, jopt, jmetrics = jstep(
            jparams, jopt, jx[sl].reshape(n, batch, 28, 28, 1), jy[sl].reshape(n, batch), key
        )
        ref = from_flax(_np_tree(jparams), device="cpu")
        for k, v in params.items():
            np.testing.assert_allclose(
                v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=f"step {s} {k}"
            )
        for m in ("honest_loss", "agg_grad_norm"):
            np.testing.assert_allclose(float(metrics[m]), float(jmetrics[m]), rtol=1e-4)


# The pre-aggregated configurations, as (pre_aggregate, aggregate) pairs of
# the port and of the JAX package, at n = 4 nodes of which 1 byzantine.
# TAU = 10.0 is the JAX entry point's clip (__graft_entry__.py); it clips
# 1-3 of the 4 rows at these models' first steps.
TAU = 10.0
PRE_CONFIGS = {
    "clip+trimmed": (
        (lambda m: preagg.clip_rows(m, threshold=TAU), lambda m: robust.trimmed_mean(m, f=1)),
        (lambda m: jpreagg.clip_rows(m, threshold=TAU), lambda m: jrobust.trimmed_mean(m, f=1)),
    ),
    "nnm+median": (
        (lambda m: preagg.nnm(m, f=1), robust.coordinate_median),
        (lambda m: jpreagg.nnm(m, f=1), jrobust.coordinate_median),
    ),
    "nnm_multi_krum": (
        (None, lambda m: robust.nnm_multi_krum(m, f_nnm=1, f=1, q=2)),
        (None, lambda m: jrobust.nnm_multi_krum(m, f_nnm=1, f=1, q=2)),
    ),
    "clipped_multi_krum": (
        (None, lambda m: robust.clipped_multi_krum(m, tau=TAU, f=1, q=2)),
        (None, lambda m: jrobust.clipped_multi_krum(m, tau=TAU, f=1, q=2)),
    ),
    "arc_multi_krum": (
        (None, lambda m: robust.arc_multi_krum(m, f_arc=1, f=1, q=2)),
        (None, lambda m: jrobust.arc_multi_krum(m, f_arc=1, f=1, q=2)),
    ),
}


@pytest.mark.parametrize("which", ["cnn", "mlp"])
@pytest.mark.parametrize("config", sorted(PRE_CONFIGS))
def test_pre_aggregated_ps_steps_match_jax(config, which):
    """2 PS steps of SmallCNN and of the MLP with each pre-aggregated
    configuration (n=4 nodes, 1 byzantine sign-flipping the honest mean,
    batch 8): parameters within rtol 1e-4, atol 1e-5 of the JAX round
    after every step, as for the plain aggregators. The JAX package takes
    its two-step path on the CPU and the port its fused one."""
    n, n_byz, batch = 4, 1, 8
    (pre, agg), (jpre, jagg) = PRE_CONFIGS[config]
    jb = jnets.mnist_cnn(seed=0) if which == "cnn" else jnets.mnist_mlp(seed=0)
    bundle = _port_bundle(jb, nets.SmallCNN() if which == "cnn" else nets.MLP())
    jx, jy = jdata.synthetic_classification(n_samples=2 * n * batch, seed=3)
    x, y = synthetic_classification(n_samples=2 * n * batch, seed=3, device="cpu")
    step, opt = build_ps_train_step(
        bundle, agg, PSStepConfig(n_nodes=n, n_byzantine=n_byz), pre_aggregate=pre,
        attack=lambda h, g: attack_ops.sign_flip(h.mean(0)),
    )
    jstep, jopt = jps.build_ps_train_step(
        jb, jagg, jps.PSStepConfig(n_nodes=n, n_byzantine=n_byz), pre_aggregate=jpre,
        attack=lambda h, key: jattack.sign_flip(jnp.mean(h, axis=0)),
    )
    jstep = jax.jit(jstep)
    params, jparams = bundle.params, jb.params
    key = jax.random.PRNGKey(0)
    for s in range(2):
        sl = slice(s * n * batch, (s + 1) * n * batch)
        params, opt, metrics = step(
            params, opt, x[sl].reshape(n, batch, 28, 28, 1), y[sl].reshape(n, batch)
        )
        jparams, jopt, jmetrics = jstep(
            jparams, jopt, jx[sl].reshape(n, batch, 28, 28, 1), jy[sl].reshape(n, batch), key
        )
        ref = from_flax(_np_tree(jparams), device="cpu")
        for k, v in params.items():
            np.testing.assert_allclose(
                v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=f"step {s} {k}"
            )
        for m in ("honest_loss", "agg_grad_norm"):
            np.testing.assert_allclose(float(metrics[m]), float(jmetrics[m]), rtol=1e-4)


def _caf_start(jb, bundle):
    """The JAX package's CAF start vector (``caf(seed=0)``'s draw over the
    JAX round's flat gradient) in the port's flat order: each package
    ravels the parameters in its own order, so the draw is unraveled into
    the flax tree, converted, and raveled as the port's round does."""
    from byzpy_tpu.utils.trees import ravel_pytree_fn

    ravel, unravel = ravel_pytree_fn(jb.params)
    d = ravel(jb.params).shape[0]
    v = jax.random.normal(jax.random.PRNGKey(0), (d,), dtype=jnp.float32)
    tree = ordered_like(from_flax(_np_tree(unravel(v)), device="cpu"), bundle.params)
    return torch.cat([t.reshape(-1) for t in tree.values()])


# The centre-seeking and coordinate aggregators, as (port, JAX) pairs at
# n = 4 nodes of which 1 byzantine; CAF's port entry takes its start vector.
CENTRE_CONFIGS = {
    "meamed": (lambda m: robust.mean_of_medians(m, f=1), lambda m: jrobust.mean_of_medians(m, f=1)),
    "geometric_median": (robust.geometric_median, jrobust.geometric_median),
    "centered_clipping": (lambda m: robust.centered_clipping(m, c_tau=TAU, M=10),
                          lambda m: jrobust.centered_clipping(m, c_tau=TAU, M=10)),
    "cge": (lambda m: robust.cge(m, f=1), lambda m: jrobust.cge(m, f=1)),
    "monna": (lambda m: robust.monna(m, f=1, reference_index=0),
              lambda m: jrobust.monna(m, f=1, reference_index=0)),
    "caf": (lambda v: (lambda m: robust.caf(m, f=1, v_init=v)), lambda m: jrobust.caf(m, f=1)),
}


@pytest.mark.parametrize("agg", sorted(CENTRE_CONFIGS))
def test_centre_ps_steps_match_jax(agg):
    """2 PS steps of SmallCNN with each centre-seeking or coordinate
    aggregator (n=4 nodes, 1 byzantine sign-flipping the honest mean, batch
    8): parameters within rtol 1e-4, atol 1e-5 of the JAX round after every
    step, as for the other aggregators. CAF's power iteration starts from
    the JAX round's own draw, carried into the port's flat order."""
    n, n_byz, batch = 4, 1, 8
    ours_agg, ref_agg = CENTRE_CONFIGS[agg]
    jb = jnets.mnist_cnn(seed=0)
    bundle = _port_bundle(jb, nets.SmallCNN())
    if agg == "caf":
        ours_agg = ours_agg(_caf_start(jb, bundle))
    jx, jy = jdata.synthetic_classification(n_samples=2 * n * batch, seed=3)
    x, y = synthetic_classification(n_samples=2 * n * batch, seed=3, device="cpu")
    step, opt = build_ps_train_step(
        bundle, ours_agg, PSStepConfig(n_nodes=n, n_byzantine=n_byz),
        attack=lambda h, g: attack_ops.sign_flip(h.mean(0)),
    )
    jstep, jopt = jps.build_ps_train_step(
        jb, ref_agg, jps.PSStepConfig(n_nodes=n, n_byzantine=n_byz),
        attack=lambda h, key: jattack.sign_flip(jnp.mean(h, axis=0)),
    )
    jstep = jax.jit(jstep)
    params, jparams = bundle.params, jb.params
    key = jax.random.PRNGKey(0)
    for s in range(2):
        sl = slice(s * n * batch, (s + 1) * n * batch)
        params, opt, metrics = step(
            params, opt, x[sl].reshape(n, batch, 28, 28, 1), y[sl].reshape(n, batch)
        )
        jparams, jopt, jmetrics = jstep(
            jparams, jopt, jx[sl].reshape(n, batch, 28, 28, 1), jy[sl].reshape(n, batch), key
        )
        ref = from_flax(_np_tree(jparams), device="cpu")
        for k, v in params.items():
            np.testing.assert_allclose(
                v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=f"step {s} {k}"
            )
        for m in ("honest_loss", "agg_grad_norm"):
            np.testing.assert_allclose(float(metrics[m]), float(jmetrics[m]), rtol=1e-4)


def test_ps_rejects_bad_config():
    bundle = nets.mnist_mlp(device="cpu")
    with pytest.raises(ValueError, match="n_byzantine"):
        build_ps_train_step(bundle, robust.coordinate_median, PSStepConfig(n_nodes=2, n_byzantine=2))


def test_sgd_momentum_matches_optax_trace():
    """Step 1's trace is the gradient (dampening 0), then g + 0.9 * trace."""
    import optax

    from byzpy_tpu_torch.parallel import SGD

    rng = np.random.default_rng(0)
    p0 = rng.normal(size=64).astype(np.float32)
    grads = rng.normal(size=(3, 64)).astype(np.float32)
    opt = SGD(0.05, momentum=0.9)
    p, st = torch.from_numpy(p0), opt.init(torch.from_numpy(p0))
    jopt = optax.sgd(0.05, momentum=0.9)
    jp = jnp.asarray(p0)
    jst = jopt.init(jp)
    for g in grads:
        p, st = opt.step(p, torch.from_numpy(g), st)
        u, jst = jopt.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, u)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


# ---------------------------------------------------------------------------
# the compressed gradient hop (comm_precision)
# ---------------------------------------------------------------------------

# The single-leaf linear bundle of test_quantized_collectives.py:276 with
# dyadic data (inputs in {-1, 0, 1}, weights and targets multiples of 1/64,
# B * d_out = 128): every node's first gradient is exact in f32 in both
# packages, so the step-1 gradient matrices, and so the codes, are equal
# bit for bit. d = 100 x 8 = 800: three 256-blocks and a partial one.
D_IN, D_OUT, LIN_N, LIN_B = 100, 8, 8, 16


def _linear_bundles(seed=0):
    from byzpy_tpu.models.bundle import ModelBundle as JBundle

    from byzpy_tpu_torch.models import ModelBundle

    rng = np.random.default_rng(seed)
    w = (rng.integers(-32, 33, size=(D_IN, D_OUT)) / 64.0).astype(np.float32)
    xs = rng.integers(-1, 2, size=(LIN_N, LIN_B, D_IN)).astype(np.float32)
    ys = (rng.integers(-64, 65, size=(LIN_N, LIN_B, D_OUT)) / 64.0).astype(np.float32)
    ours = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)},
                       loss_fn=lambda p, x, y: torch.mean((x @ p["w"] - y) ** 2))
    ref = JBundle(apply_fn=lambda p, x: x @ p["w"], params={"w": jnp.asarray(w)},
                  loss_fn=lambda p, x, y: jnp.mean((x @ p["w"] - y) ** 2))
    return ours, ref, xs, ys


def _one_device_mesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]), ("nodes",))


COMPRESSED_AGGS = {
    "trimmed": (lambda m: robust.trimmed_mean(m, f=1), lambda m: jrobust.trimmed_mean(m, f=1)),
    "multi_krum": (lambda m: robust.multi_krum(m, f=1, q=4), lambda m: jrobust.multi_krum(m, f=1, q=4)),
}
# one code step of each mode relative to its block's absmax (int8: absmax
# / 127; s4: absmax / 7; fp8: the top binade's ulp, 32 / 448 and 8192 /
# 57344; bf16: the value's own ulp, bounded by 2^-7 of the absmax)
CODE_STEP = {"off": 0.0, "bf16": 2.0 ** -7, "int8": 1 / 127, "s4": 1 / 7, "fp8": 32 / 448,
             "fp8_e5m2": 8192 / 57344}


def _slack(bundle, params, xs, ys, cfg, mode):
    """What one flipped code per coordinate at the next step can move the
    parameters by, from then on: lr / (1 - momentum) x one code step of the
    largest block (its absmax bounds every block's; the byzantine row, a
    sign-flipped mean, is no larger)."""
    from torch.func import grad, vmap

    g = vmap(grad(bundle.loss_fn), in_dims=(None, 0, 0))(
        params, torch.from_numpy(xs), torch.from_numpy(ys))["w"]
    return cfg.learning_rate / (1 - cfg.momentum) * CODE_STEP[mode] * float(g.abs().max()) * 1.01


def _comm_precisions(mode, ef=False):
    from byzpy_tpu.parallel import quantization as jq

    from byzpy_tpu_torch.parallel import CommPrecision

    return CommPrecision(mode, error_feedback=ef), jq.CommPrecision(mode, error_feedback=ef)


@pytest.mark.parametrize("mode", ["off", "bf16", "int8", "fp8", "fp8_e5m2", "s4"])
@pytest.mark.parametrize("agg", sorted(COMPRESSED_AGGS))
def test_ps_compressed_round_matches_jax_one_device_mesh(agg, mode):
    """3 PS steps of the linear bundle (8 nodes, 1 byzantine sign-flipping
    the mean of the decoded honest rows) against the JAX round on a
    one-device mesh with the same ``comm_precision``. Step 1: parameters
    within a few f32 ulp (rtol 1e-6, atol 1e-8; the codes are equal, the
    aggregators sum in another order). Later steps: within that plus lr /
    (1 - momentum) x one code step of the largest block per step (the
    step-1 parameters differ in their last bits, so a later gradient
    value can cross a rounding boundary and flip one code)."""
    ours_b, ref_b, xs, ys = _linear_bundles()
    ours_agg, ref_agg = COMPRESSED_AGGS[agg]
    p, jp = _comm_precisions(mode)
    cfg, jcfg = PSStepConfig(n_nodes=LIN_N, n_byzantine=1), jps.PSStepConfig(n_nodes=LIN_N, n_byzantine=1)
    step, opt = build_ps_train_step(ours_b, ours_agg, cfg, comm_precision=p,
                                    attack=lambda h, g: attack_ops.sign_flip(h.mean(0)))
    jstep, jopt = jps.build_ps_train_step(
        ref_b, ref_agg, jcfg, mesh=_one_device_mesh(), comm_precision=jp,
        attack=lambda h, key: jattack.sign_flip(jnp.mean(h, axis=0)))
    jstep = jax.jit(jstep)
    params, jparams = ours_b.params, ref_b.params
    slack = 0.0
    for s in range(3):
        params, opt, metrics = step(params, opt, torch.from_numpy(xs), torch.from_numpy(ys))
        jparams, jopt, jmetrics = jstep(jparams, jopt, jnp.asarray(xs), jnp.asarray(ys),
                                        jax.random.PRNGKey(0))
        want = np.asarray(jparams["w"])
        np.testing.assert_allclose(params["w"].numpy(), want, rtol=1e-6, atol=1e-8 + slack,
                                   err_msg=f"step {s + 1}")
        for m in ("honest_loss", "agg_grad_norm"):
            np.testing.assert_allclose(float(metrics[m]), float(jmetrics[m]),
                                       rtol=1e-6 if s == 0 else 1e-4)
        slack += _slack(ours_b, params, xs, ys, cfg, mode)


def _error_feedback_round(mode):
    """``mode`` with error feedback for 3 steps: ``opt_state0`` is ``(base,
    {"transpose": zeros(n, d)})`` as in the reference; the step-1 residual
    rows equal the reference's within one ulp of the decoded values (the
    jitted reference contracts ``xc - codes * scale`` into a fused
    multiply-add), ``ef_transpose_norm`` within 1e-5, the parameters as in
    the test above."""
    from torch.func import grad, vmap

    ours_b, ref_b, xs, ys = _linear_bundles(seed=1)
    p, jp = _comm_precisions(mode, ef=True)
    ours_agg, ref_agg = COMPRESSED_AGGS["trimmed"]
    cfg, jcfg = PSStepConfig(n_nodes=LIN_N, n_byzantine=1), jps.PSStepConfig(n_nodes=LIN_N, n_byzantine=1)
    step, opt = build_ps_train_step(ours_b, ours_agg, cfg, comm_precision=p,
                                    attack=lambda h, g: attack_ops.sign_flip(h.mean(0)))
    jstep, jopt = jps.build_ps_train_step(
        ref_b, ref_agg, jcfg, mesh=_one_device_mesh(), comm_precision=jp,
        attack=lambda h, key: jattack.sign_flip(jnp.mean(h, axis=0)))
    assert isinstance(opt, tuple) and set(opt[1]) == set(jopt[1]) == {"transpose"}
    assert tuple(opt[1]["transpose"].shape) == jopt[1]["transpose"].shape == (LIN_N, D_IN * D_OUT)
    assert not bool(opt[1]["transpose"].any())
    jstep = jax.jit(jstep)
    params, jparams = ours_b.params, ref_b.params
    slack = 0.0
    for s in range(3):
        params, opt, metrics = step(params, opt, torch.from_numpy(xs), torch.from_numpy(ys))
        jparams, jopt, jmetrics = jstep(jparams, jopt, jnp.asarray(xs), jnp.asarray(ys),
                                        jax.random.PRNGKey(0))
        np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]), rtol=1e-6,
                                   atol=1e-8 + slack, err_msg=f"step {s + 1}")
        res, jres = opt[1]["transpose"].numpy(), np.asarray(jopt[1]["transpose"])
        if s == 0:
            # one ulp of the decoded rows, which are within a code step of
            # the raw gradients (exact in both packages at step 1)
            g = vmap(grad(ours_b.loss_fn), in_dims=(None, 0, 0))(
                ours_b.params, torch.from_numpy(xs), torch.from_numpy(ys))["w"].reshape(LIN_N, -1)
            np.testing.assert_array_less(np.abs(res - jres), 2 * np.spacing(np.abs(g.numpy())) + 1e-30)
        np.testing.assert_allclose(float(metrics["ef_transpose_norm"]),
                                   float(jmetrics["ef_transpose_norm"]), rtol=1e-5 if s == 0 else 1e-3)
        assert float(metrics["ef_transpose_norm"]) > 0.0
        slack += _slack(ours_b, params, xs, ys, cfg, mode)


def test_ps_error_feedback_matches_jax_one_device_mesh():
    """int8 with error feedback (:func:`_error_feedback_round`)."""
    _error_feedback_round("int8")


def test_ps_s4_error_feedback_matches_jax_one_device_mesh():
    """s4 with error feedback (B16 + B17 on the card), as int8's."""
    _error_feedback_round("s4")


@pytest.mark.parametrize("which", ["linear", "mlp"])
def test_ps_comm_off_is_bit_identical(which):
    """``comm_precision`` None, ``"off"`` or ``CommPrecision()`` leave the
    round bit-identical to the round built without it, parameters,
    optimizer state and metrics, over 2 steps."""
    from byzpy_tpu_torch.parallel import CommPrecision

    if which == "linear":
        bundle, _, xs, ys = _linear_bundles(seed=2)
        xs, ys = torch.from_numpy(xs), torch.from_numpy(ys)
    else:
        bundle = nets.mnist_mlp(device="cpu")
        x, y = synthetic_classification(n_samples=4 * 8, seed=3, device="cpu")
        xs, ys = x.reshape(4, 8, 28, 28, 1), y.reshape(4, 8)
    n = xs.shape[0]
    runs = []
    for kw in ({}, {"comm_precision": None}, {"comm_precision": "off"},
               {"comm_precision": CommPrecision("off", error_feedback=True)}):
        step, opt = build_ps_train_step(bundle, robust.coordinate_median,
                                        PSStepConfig(n_nodes=n, n_byzantine=1), **kw)
        params, out = bundle.params, []
        for _ in range(2):
            params, opt, metrics = step(params, opt, xs, ys)
            out.append((params, opt, metrics))
        runs.append(out)
    for other in runs[1:]:
        for (p0, o0, m0), (p1, o1, m1) in zip(runs[0], other):
            assert all(torch.equal(p0[k], p1[k]) for k in p0)
            assert all(torch.equal(o0[k], o1[k]) for k in o0)
            assert set(m0) == set(m1) and all(torch.equal(m0[k], m1[k]) for k in m0)


def _smallcnn_within_codec_bound(mode):
    """SmallCNN ravels in another order in each package, so a 256-block
    groups other coordinates and the codes differ (ROADMAP C): one step of
    ``mode`` (4 nodes, 1 byzantine, batch 8) is held within rtol 1e-4,
    atol 1e-5 plus lr x both packages' codec bounds (absmax / 254 each for
    int8, / 14 for s4, absmax the largest gradient value)."""
    from torch.func import grad_and_value, vmap

    n, batch = 4, 8
    jb = jnets.mnist_cnn(seed=0)
    bundle = _port_bundle(jb, nets.SmallCNN())
    jx, jy = jdata.synthetic_classification(n_samples=n * batch, seed=3)
    x, y = synthetic_classification(n_samples=n * batch, seed=3, device="cpu")
    xs, ys = x.reshape(n, batch, 28, 28, 1), y.reshape(n, batch)
    agg, jagg = AGGREGATORS["trimmed"]
    step, opt = build_ps_train_step(bundle, agg, PSStepConfig(n_nodes=n, n_byzantine=1),
                                    attack=lambda h, g: attack_ops.sign_flip(h.mean(0)),
                                    comm_precision=mode)
    jstep, jopt = jps.build_ps_train_step(
        jb, jagg, jps.PSStepConfig(n_nodes=n, n_byzantine=1), mesh=_one_device_mesh(),
        comm_precision=mode, attack=lambda h, key: jattack.sign_flip(jnp.mean(h, axis=0)))
    grads, _ = vmap(grad_and_value(bundle.loss_fn), in_dims=(None, 0, 0))(bundle.params, xs, ys)
    absmax = max(float(g.abs().max()) for g in grads.values())
    params, _, metrics = step(bundle.params, opt, xs, ys)
    jparams, _, jmetrics = jax.jit(jstep)(jb.params, jopt, jx.reshape(n, batch, 28, 28, 1),
                                          jy.reshape(n, batch), jax.random.PRNGKey(0))
    ref = from_flax(_np_tree(jparams), device="cpu")
    bound = PSStepConfig(n_nodes=n).learning_rate * 2 * absmax / {"int8": 254, "s4": 14}[mode]
    for k, v in params.items():
        excess = (v - ref[k]).abs() - (1e-5 + 1e-4 * ref[k].abs() + bound)
        assert float(excess.max()) <= 0.0, k
    np.testing.assert_allclose(float(metrics["honest_loss"]), float(jmetrics["honest_loss"]),
                               rtol=1e-4)


def test_ps_smallcnn_int8_within_codec_bound():
    _smallcnn_within_codec_bound("int8")


def test_ps_smallcnn_s4_within_codec_bound():
    _smallcnn_within_codec_bound("s4")


def test_ps_s4_raises_not_implemented():
    """s4 raised ``NotImplementedError`` until B16/B17 came; the round now
    builds, with error feedback's residual slot, as int8 and fp8 do (its
    bits are held by the ``s4`` cases of
    ``test_ps_compressed_round_matches_jax_one_device_mesh`` and by
    ``test_ps_s4_error_feedback_matches_jax_one_device_mesh``)."""
    from byzpy_tpu_torch.parallel import CommPrecision

    bundle, _, _, _ = _linear_bundles()
    _, opt = build_ps_train_step(bundle, robust.coordinate_median, PSStepConfig(n_nodes=LIN_N),
                                 comm_precision="s4")
    assert isinstance(opt, dict)
    _, opt = build_ps_train_step(bundle, robust.coordinate_median, PSStepConfig(n_nodes=LIN_N),
                                 comm_precision=CommPrecision("s4", error_feedback=True))
    assert tuple(opt[1]["transpose"].shape) == (LIN_N, sum(v.numel() for v in bundle.params.values()))


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cloudpickle", "byzpy_tpu", "yaml", "ml_dtypes"}


def _port_sources():
    files = sorted((REPO / "byzpy_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """No module of byzpy_tpu_torch, nor chip_smoke.py, imports JAX, flax,
    optax, cloudpickle, PyYAML, ml_dtypes or the JAX package (the card's
    host has none of them); the scan covers the operator
    classes, the attack classes, the subset-search aggregators, the
    engine (graphs, schedulers, sessions, pools, the actor backends and
    the chunked fan-out), the compressed wire fabric, the serving tier,
    the models and data helpers, the compiled steps' CUDA-graph capture,
    and the out-of-process tier (process and remote actors, the TCP
    transport, the shm store, the wire's frames, the process and remote
    node contexts, the retry policy)."""
    files = _port_sources()
    assert len(files) > 10 and (REPO / "chip_smoke.py").exists()
    assert REPO / "byzpy_tpu_torch" / "ops" / "preagg.py" in files
    for sub in ("aggregators", "aggregators/geometric_wise", "aggregators/coordinate_wise",
                "aggregators/norm_wise", "pre_aggregators", "engine", "engine/graph",
                "engine/actor", "engine/actor/backends", "engine/peer_to_peer", "serving",
                "attacks", "configs", "engine/storage", "engine/actor/transports", "engine/node",
                "resilience", "analysis", "forensics", "observability"):
        assert REPO / "byzpy_tpu_torch" / sub / "__init__.py" in files, sub
    for module in ("aggregators/base.py", "aggregators/geometric_wise/krum.py",
                   "aggregators/pipelines.py", "pre_aggregators/bucketing.py",
                   "engine/graph/operator.py", "engine/graph/subtask.py",
                   "engine/peer_to_peer/topology.py", "ops/codec_kernels.py",
                   "parallel/quantization.py", "parallel/collectives.py", "parallel/gossip.py",
                   "parallel/ps.py", "ops/robust.py", "ops/kernels.py", "serving/buckets.py",
                   "serving/staleness.py", "serving/queue.py", "serving/cohort.py",
                   "utils/combinatorics.py", "aggregators/geometric_wise/smea.py",
                   "aggregators/geometric_wise/minimum_diameter_average.py",
                   "attacks/base.py", "attacks/adaptive.py", "attacks/gaussian.py",
                   "attacks/label_flip.py", "engine/actor/wire.py", "utils/cuda_graph.py",
                   "utils/trees.py", "models/nets.py", "models/data.py", "models/convert.py",
                   "engine/graph/pool.py", "engine/graph/scheduler.py",
                   "engine/graph/parallel_scheduler.py", "engine/graph/session.py",
                   "engine/graph/lazy.py", "engine/graph/executor.py", "engine/graph/ops.py",
                   "engine/graph/graph.py", "engine/graph/chunking.py", "engine/actor/base.py",
                   "engine/actor/channels.py", "engine/actor/router.py",
                   "engine/actor/factory.py", "engine/actor/backends/thread.py",
                   "engine/actor/backends/cuda.py", "configs/actor.py",
                   "aggregators/chunked.py", "attacks/chunked.py",
                   "engine/actor/backends/process.py", "engine/actor/backends/remote.py",
                   "engine/actor/transports/tcp.py", "engine/actor/ipc.py",
                   "engine/storage/native_store.py", "engine/node/process_context.py",
                   "engine/node/remote.py", "resilience/retry.py", "resilience/breaker.py",
                   "resilience/durable.py", "analysis/sanitize.py", "forensics/evidence.py",
                   "forensics/trust.py", "forensics/plane.py", "forensics/audit.py",
                   "observability/jitstats.py", "observability/metrics.py",
                   "observability/tracing.py", "utils/checkpoint.py", "serving/credits.py",
                   "serving/frontend.py", "serving/ragged.py"):
        assert REPO / "byzpy_tpu_torch" / module in files, module
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {m}" for m in names if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_classification(n_samples=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nets.mnist_mlp()
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_stack_gradients_round_trip_and_errors():
    """Rows are each dictionary raveled in key order; unravel inverts; the
    input errors are the JAX package's."""
    from byzpy_tpu.utils import trees as jtrees
    from byzpy_tpu_torch.utils import stack_gradients

    rng = np.random.default_rng(0)
    grads = [
        {"w": torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(size=(2,)).astype(np.float32))}
        for _ in range(4)
    ]
    matrix, unravel = stack_gradients(grads)
    assert matrix.shape == (4, 8)
    for g, row in zip(grads, matrix):
        np.testing.assert_array_equal(row.numpy(), torch.cat([g["w"].reshape(-1), g["b"]]).numpy())
        back = unravel(row)
        assert all(torch.equal(back[k], g[k]) for k in g)
    for bad in ([], torch.zeros(2, 3, 4)):
        with pytest.raises(ValueError) as ours:
            stack_gradients(bad)
        with pytest.raises(ValueError) as ref:
            jtrees.stack_gradients(bad if isinstance(bad, list) else jnp.zeros((2, 3, 4)))
        assert str(ours.value).split(";")[0] == str(ref.value).split(";")[0]
    with pytest.raises(ValueError, match="same length"):
        stack_gradients([{"w": torch.zeros(3)}, {"w": torch.zeros(4)}])
