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
# package rules
# ---------------------------------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "byzpy_tpu"}


def _port_sources():
    files = sorted((REPO / "byzpy_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """No module of byzpy_tpu_torch, nor chip_smoke.py, imports JAX, flax,
    optax or the JAX package; the scan covers the operator classes and the
    engine."""
    files = _port_sources()
    assert len(files) > 10 and (REPO / "chip_smoke.py").exists()
    assert REPO / "byzpy_tpu_torch" / "ops" / "preagg.py" in files
    for sub in ("aggregators", "aggregators/geometric_wise", "aggregators/coordinate_wise",
                "aggregators/norm_wise", "pre_aggregators", "engine", "engine/graph"):
        assert REPO / "byzpy_tpu_torch" / sub / "__init__.py" in files, sub
    for module in ("aggregators/base.py", "aggregators/geometric_wise/krum.py",
                   "aggregators/pipelines.py", "pre_aggregators/bucketing.py",
                   "engine/graph/operator.py", "engine/graph/subtask.py"):
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
