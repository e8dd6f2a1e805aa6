"""BASELINE config #4's pieces in the port against the JAX package, on the
CPU: the ResNets' ``norm=``, config #4's gossip round (ring(8, 2), NNM
then the geometric median) at a narrow ResNet-18, CAF's fixed-pass loop,
the masked Weiszfeld mode of B7's loop and the compiled gossip step's CPU
path.

Parameters cross between the packages through ``models.convert``: the two
ravel orders differ (flax sorts its tree, the port follows
``named_parameters``). Inputs are made with numpy from a seed. Each
tolerance is stated where it is used.
"""

import functools
import math
from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from byzpy_tpu.engine.peer_to_peer.topology import Topology as JTopology
from byzpy_tpu.models import nets as jnets
from byzpy_tpu.ops import preagg as jpreagg
from byzpy_tpu.ops import robust as jrobust
from byzpy_tpu.parallel import gossip as jgossip
from byzpy_tpu.utils.trees import ravel_pytree_fn
from byzpy_tpu_torch.engine.peer_to_peer import Topology
from byzpy_tpu_torch.models import convert, nets
from byzpy_tpu_torch.ops import kernels, preagg, robust
from byzpy_tpu_torch.parallel import (
    GossipStepConfig,
    build_gossip_train_step,
    jit_gossip_train_step,
)
from byzpy_tpu_torch.utils.cuda_graph import CapturedStep

CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _perturbed(params, seed):
    """``params`` with every leaf moved by 0.1 N(0, 1), so GroupNorm's
    scales and biases are off 1 and 0."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [a + 0.1 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)])


# ---------------------------------------------------------------------------
# norm= on the ResNets
# ---------------------------------------------------------------------------

# 12 filters: 32 groups do not divide them, gcd(32, 12) = 4 do
FILTERS = 12
GROUPS = math.gcd(32, FILTERS)


def _norms():
    return (partial(fnn.GroupNorm, num_groups=GROUPS),
            functools.partial(nets.GroupNorm, num_groups=GROUPS))


def _norm_modules(which):
    """(flax module, port module, NHWC input shape, whether the port module
    takes NCHW) for each ``norm=`` case."""
    jnorm, tnorm = _norms()
    if which == "resnet":
        return (jnets.ResNet(stage_sizes=(1, 1), num_classes=10, num_filters=FILTERS, norm=jnorm),
                nets.ResNet((1, 1), nets.ResNetBlock, 10, FILTERS, norm=tnorm), (4, 8, 8, 3), False)
    if which == "resnet_bottleneck":
        return (jnets.ResNet(stage_sizes=(1, 1), block_cls=jnets.BottleneckBlock, num_classes=10,
                             num_filters=FILTERS, small_input=False, norm=jnorm),
                nets.ResNet((1, 1), nets.BottleneckBlock, 10, FILTERS, False, norm=tnorm),
                (4, 16, 16, 3), False)
    if which == "basic_block":
        # a projected block: stride 2 and 24 -> 12 channels
        return (jnets.ResNetBlock(filters=FILTERS, strides=(2, 2), norm=jnorm),
                nets.ResNetBlock(2 * FILTERS, FILTERS, 2, norm=tnorm), (4, 8, 8, 2 * FILTERS), True)
    return (jnets.BottleneckBlock(filters=FILTERS, strides=(2, 2), norm=jnorm),
            nets.BottleneckBlock(FILTERS, FILTERS, 2, norm=tnorm), (4, 8, 8, FILTERS), True)


@pytest.mark.parametrize("which", ["resnet", "resnet_bottleneck", "basic_block", "bottleneck_block"])
def test_norm_factory_matches_flax(which):
    """``norm=partial(GroupNorm, num_groups=4)`` at 12 filters against flax's
    ``norm=partial(nn.GroupNorm, num_groups=4)``: the output and every
    parameter's gradient of a scalar loss (the ResNets' cross-entropy, a
    block's sum of squares), the flax parameters converted into the port.
    f32: outputs within 1e-5 (rtol and atol), each gradient within 1e-4 of
    its leaf's largest |value| (the convolutions and GroupNorm reductions
    sum in other orders)."""
    jm, tm, shape, nchw = _norm_modules(which)
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    ours = convert.ordered_like(convert.from_flax(_np_tree(params), device=CPU),
                                dict(tm.named_parameters()))
    assert all(isinstance(m, nets.GroupNorm) and m.num_groups == GROUPS
               for name, m in tm.named_modules() if name.rsplit(".", 1)[-1].startswith("groupnorm"))
    xt = torch.from_numpy(x)
    if nchw:
        xt = xt.permute(0, 3, 1, 2)

    def tout(p):
        out = torch.func.functional_call(tm, p, (xt,))
        return out.permute(0, 2, 3, 1) if nchw else out

    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    np.testing.assert_allclose(tout(ours).detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    y = np.array([1, 3, 5, 7])

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x))
        if nchw:
            return jnp.sum(out * out)
        return optax.softmax_cross_entropy_with_integer_labels(out, jnp.asarray(y)).mean()

    jgrads = convert.from_flax(_np_tree(jax.jit(jax.grad(jloss))(params)), device=CPU)
    leaves = {k: v.clone().requires_grad_(True) for k, v in ours.items()}
    out = tout(leaves)
    loss = (out * out).sum() if nchw else torch.nn.functional.cross_entropy(out, torch.from_numpy(y))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for k, g in grads.items():
        assert float((g - jgrads[k]).abs().max()) <= 1e-4 * float(jgrads[k].abs().max()), k


def test_groupnorm_refuses_groups_that_do_not_divide():
    """32 groups (the default) at 12 channels raise, as before; a count
    that divides them builds; the default ``norm`` is the 32-group
    ``GroupNorm`` (the same parameters, bit for bit, as passing it); and
    ``cifar_resnet18`` hands ``norm=`` to every norm layer at its full
    width."""
    with pytest.raises(ValueError, match="32 groups do not divide 12 channels"):
        nets.GroupNorm(12)
    assert nets.GroupNorm(12, num_groups=4).num_groups == 4
    with pytest.raises(ValueError):
        nets.ResNet18(num_filters=12)
    default = nets.make_bundle(nets.ResNet18(num_filters=32), seed=0, device=CPU)
    explicit = nets.make_bundle(nets.ResNet18(num_filters=32, norm=nets.GroupNorm), seed=0,
                                device=CPU)
    assert list(default.params) == list(explicit.params)
    assert all(torch.equal(default.params[k], explicit.params[k]) for k in default.params)
    wide = nets.cifar_resnet18(seed=0, device=CPU,
                               norm=functools.partial(nets.GroupNorm, num_groups=16))
    norms = [m for m in wide.module.modules() if isinstance(m, nets.GroupNorm)]
    assert len(norms) == 1 + 8 * 2 + 3 and all(m.num_groups == 16 for m in norms)
    assert sum(int(v.numel()) for v in wide.params.values()) == 11_173_962


# ---------------------------------------------------------------------------
# config #4's gossip round at a narrow ResNet-18
# ---------------------------------------------------------------------------

N_NODES, N_BYZ, LR = 8, 1, 0.05
# examples/p2p/resnet_cifar_gossip.py at 4 filters (gcd(32, 4) = 4 groups),
# 8 x 8 images, 4 a node
C4_FILTERS, C4_HW, C4_BATCH = 4, 8, 4


def _c4_port_aggregate(m):
    mixed = preagg.nnm(m, f=min(N_BYZ, m.shape[0] - 1))
    return robust.geometric_median(mixed, max_iter=32)


def _c4_ref_aggregate(m):
    mixed = jpreagg.nnm(m, f=min(N_BYZ, m.shape[0] - 1))
    return jrobust.geometric_median(mixed, max_iter=32)


def _to_port_rows(jtheta, jparams, example):
    """The reference's ``(n, d)`` theta in the port's flat order."""
    _, unravel = ravel_pytree_fn(jparams)
    rows = []
    for row in np.asarray(jtheta):
        tree = jax.tree_util.tree_map(np.asarray, unravel(jnp.asarray(row)))
        p = convert.ordered_like(convert.from_flax(tree, device=CPU), example)
        rows.append(torch.cat([v.reshape(-1) for v in p.values()]))
    return torch.stack(rows)


@pytest.fixture(scope="module")
def config4_rounds():
    """Two config #4 rounds of each package from the same parameters and
    batches: the port's thetas and honest losses, the reference's thetas
    in the port's order and its losses."""
    groups = math.gcd(32, C4_FILTERS)
    jm = jnets.ResNet18(num_classes=10, num_filters=C4_FILTERS,
                        norm=partial(fnn.GroupNorm, num_groups=groups))
    jparams = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, C4_HW, C4_HW, 3))), 7)
    jb = jnets.ModelBundle(apply_fn=jm.apply, params=jparams)
    tm = nets.ResNet18(num_classes=10, num_filters=C4_FILTERS,
                       norm=functools.partial(nets.GroupNorm, num_groups=groups))
    bundle = nets.make_bundle(tm, seed=0, device=CPU)
    bundle.params = convert.ordered_like(convert.from_flax(_np_tree(jparams), device=CPU),
                                         bundle.params)
    rng = np.random.default_rng(11)
    batches = [(rng.normal(size=(N_NODES, C4_BATCH, C4_HW, C4_HW, 3)).astype(np.float32),
                rng.integers(0, 10, size=(N_NODES, C4_BATCH)).astype(np.int32)) for _ in range(2)]
    step, init = build_gossip_train_step(bundle, _c4_port_aggregate, Topology.ring(N_NODES, 2),
                                         GossipStepConfig(N_NODES, N_BYZ, LR))
    jstep, jinit = jgossip.build_gossip_train_step(
        jb, _c4_ref_aggregate, JTopology.ring(N_NODES, 2),
        jgossip.GossipStepConfig(n_nodes=N_NODES, n_byzantine=N_BYZ, learning_rate=LR))
    jstep = jax.jit(jstep)
    theta, jtheta = init(), jinit()
    ours, ref = [], []
    for xs, ys in batches:
        theta, metrics = step(theta, torch.from_numpy(xs), torch.from_numpy(ys).long())
        jtheta, jmetrics = jstep(jtheta, jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(0))
        ours.append((theta.clone(), float(metrics["honest_loss"])))
        ref.append((_to_port_rows(jtheta, jparams, bundle.params), float(jmetrics["honest_loss"])))
    return ours, ref


@pytest.mark.parametrize("rounds", [1, 2])
def test_config4_gossip_rounds_match_jax(config4_rounds, rounds):
    """Config #4 (ring(8, 2), node 7 byzantine without an attack, NNM with f
    = 1 then ``geometric_median(max_iter=32)``, lr 0.05) at a narrow
    ResNet-18, one and two rounds: every node's parameters within rtol
    1e-4 and atol 1e-5 of the reference's (the convolutions, B8's mixing
    and the Weiszfeld sums take other orders; a step length near tol may
    stop the two loops an iteration apart, which moves the centre by less
    than tol); the honest loss within rtol 1e-5."""
    ours, ref = config4_rounds
    theta, loss = ours[rounds - 1]
    want, jloss = ref[rounds - 1]
    assert theta.shape == want.shape
    assert bool(torch.isfinite(theta).all())
    assert bool(((theta - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)


def test_config4_full_width_first_step_overshoots_in_both_packages():
    """At config #4's full width (64 filters, gcd(32, 64) = 32 groups) and lr
    0.05, one plain SGD step from the reference's initial parameters on node
    0's first batch of the example's data raises its loss on the second
    batch about 3.5-fold, in the reference and in the port alike: the
    example's 10-step descent assertion does not hold at this width in the
    reference either (the card's phase 4h checks the descent later in the
    run). The port's losses within rtol 1e-3 of the reference's (the
    convolutions sum in another order, and the step carries it into the
    second loss)."""
    from byzpy_tpu.models import data as jdata

    groups = math.gcd(32, 64)
    jm = jnets.ResNet18(num_classes=10, norm=partial(fnn.GroupNorm, num_groups=groups))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    x, y = jdata.synthetic_classification(n_samples=N_NODES * 32 * 4, input_shape=(32, 32, 3),
                                          seed=0)
    xs, ys = jdata.ShardedDataset(x, y, n_nodes=N_NODES).stacked_shards()
    batches = [(np.asarray(xs[0, 32 * b:32 * (b + 1)]), np.asarray(ys[0, 32 * b:32 * (b + 1)]))
               for b in range(2)]

    def jloss(p, xb, yb):
        return optax.softmax_cross_entropy_with_integer_labels(jm.apply(p, xb), yb).mean()

    l0, grads = jax.jit(jax.value_and_grad(jloss))(params, *batches[0])
    l1 = jax.jit(jloss)(jax.tree_util.tree_map(lambda a, g: a - LR * g, params, grads), *batches[1])
    tm = nets.ResNet18(num_classes=10, norm=functools.partial(nets.GroupNorm, num_groups=groups))
    ours = convert.ordered_like(convert.from_flax(_np_tree(params), device=CPU),
                                dict(tm.named_parameters()))

    def tloss(p, b):
        xb, yb = batches[b]
        out = torch.func.functional_call(tm, p, (torch.from_numpy(xb.copy()),))
        return torch.nn.functional.cross_entropy(out, torch.from_numpy(yb.astype(np.int64)))

    leaves = {k: v.clone().requires_grad_(True) for k, v in ours.items()}
    t0 = tloss(leaves, 0)
    tgrads = torch.autograd.grad(t0, list(leaves.values()))
    with torch.no_grad():
        t1 = tloss({k: v - LR * g for (k, v), g in zip(ours.items(), tgrads)}, 1)
    np.testing.assert_allclose([float(t0), float(t1)], [float(l0), float(l1)], rtol=1e-3)
    assert float(l1) > 3.0 * float(l0) and float(t1) > 3.0 * float(t0)


def test_compiled_gossip_step_on_the_cpu_is_the_eager_step():
    """``jit_gossip_train_step`` on CPU tensors: a ``CapturedStep`` with one
    state argument that runs the eager step, bit for bit, with no graph and
    no replay counted; ``state_args`` below 1 is refused."""
    bundle = nets.mnist_mlp(hidden=8, seed=0, device=CPU)
    topo, cfg = Topology.ring(N_NODES, 2), GossipStepConfig(N_NODES, 2, LR)
    agg = functools.partial(robust.trimmed_mean, f=1)
    eager, init = build_gossip_train_step(bundle, agg, topo, cfg)
    compiled, cinit = jit_gossip_train_step(bundle, agg, topo, cfg)
    assert isinstance(compiled, CapturedStep) and compiled.state_args == 1
    assert compiled.counter == "graph_replay:gossip_train_step"
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.normal(size=(N_NODES, 4, 28, 28, 1)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, size=(N_NODES, 4)))
    kernels.reset_launch_counts()
    te, tc = init(), cinit()
    assert torch.equal(te, tc)
    for _ in range(2):
        te, me = eager(te, xs, ys)
        tc, mc = compiled(tc, xs, ys)
        assert torch.equal(te, tc) and torch.equal(me["honest_loss"], mc["honest_loss"])
    assert not compiled.graphs and kernels.launch_counts["graph_replay:gossip_train_step"] == 0
    with pytest.raises(ValueError, match="state_args"):
        CapturedStep(eager, name="gossip_train_step", donate=True, state_args=0)


# ---------------------------------------------------------------------------
# CAF's fixed passes
# ---------------------------------------------------------------------------


def _caf_host_loop(x, *, f, v_init, power_iters=3):
    """CAF as the port ran it before its passes were fixed: the reference's
    ``while_loop`` with its condition read on the host each pass. Returns
    ``(best_mu, passes)``."""
    n, _ = x.shape
    v0 = v_init.to(x.dtype)
    v0 = v0 / torch.linalg.vector_norm(v0).clamp(min=1e-12)

    def eigenpair(diffs, w):
        vec = v0
        for _ in range(power_iters):
            nxt = torch.sum((w * (diffs @ vec))[:, None] * diffs, dim=0)
            nn = torch.linalg.vector_norm(nxt)
            vec = torch.where(nn > 1e-12, nxt / nn.clamp(min=1e-30), vec)
        proj = diffs @ vec
        return torch.sum(w * proj * proj) / torch.sum(w).clamp(min=1e-12), vec

    w = torch.ones((n,), dtype=x.dtype)
    best_mu = torch.mean(x, dim=0)
    best_lam = torch.full((), torch.finfo(torch.float32).max, dtype=x.dtype)
    stop = torch.zeros((), dtype=torch.bool)
    it = 0
    while it < 4 * n and bool((~stop) & (torch.sum(w) > n - 2 * f)):
        mu = torch.sum(w[:, None] * x, dim=0) / torch.sum(w)
        diffs = x - mu[None, :]
        lam, vec = eigenpair(diffs, w)
        better = lam < best_lam
        best_lam = torch.where(better, lam, best_lam)
        best_mu = torch.where(better, mu, best_mu)
        proj = diffs @ vec
        tau = proj * proj
        tau_max = torch.max(torch.where(w > 0.0, tau, -float("inf")))
        degenerate = tau_max <= 1e-12
        w_new = torch.clamp(w * (1.0 - tau / tau_max.clamp(min=1e-30)), min=0.0)
        w = torch.where(degenerate, w, w_new)
        stop = degenerate | (torch.sum(w) <= 0.0)
        it += 1
    return best_mu, it


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _jax_draw(d, seed=0):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (d,), dtype=jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,f,case", [(8, 2, "normal"), (13, 3, "outliers"), (9, 4, "ties"),
                                      (6, 2, "degenerate"), (10, 2, "nonfinite"), (5, 0, "normal")])
def test_caf_fixed_passes_are_the_host_loop_bit_for_bit(n, f, case, dtype):
    """The fixed ``min(2f, 4n)`` predicated passes give the host loop's mean
    and pass count bit for bit (a pass after the stop changes no bit), on
    normal rows, scaled outliers, repeated rows, identical rows (the
    degenerate stop), rows holding NaN and inf, and f = 0 (no pass); and
    the reference's ``caf`` within rtol 1e-4 / atol 1e-5 (f32, finite: its
    power iteration sums in XLA's order) with its own start vector."""
    rng = np.random.default_rng(n * 31 + f)
    d = 40
    x = rng.normal(size=(n, d)).astype(np.float32)
    if case == "outliers":
        x[:f] *= 30.0
    elif case == "ties":
        x[: n // 2] = x[0]
    elif case == "degenerate":
        x[:] = x[0]
    elif case == "nonfinite":
        x[0, 3], x[1, 5] = np.nan, np.inf
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    v = torch.from_numpy(_jax_draw(d))
    want, passes = _caf_host_loop(xt, f=f, v_init=v)
    out = robust.caf(xt, f=f, v_init=v)
    assert torch.equal(_bits(out), _bits(want))
    assert isinstance(robust.last_iterations["caf"], torch.Tensor)
    assert int(robust.last_iterations["caf"]) == passes <= min(2 * f, 4 * n)
    if dtype == "float32" and case != "nonfinite":
        ref = np.asarray(jrobust.caf(jnp.asarray(x), f=f))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


class _CountingLax:
    """``jax.lax`` with ``while_loop`` run as a Python loop that counts its
    trips (every other name is ``jax.lax``'s)."""

    def __init__(self):
        self.trips = 0

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def while_loop(self, cond, body, state):
        while bool(cond(state)):
            state = body(state)
            self.trips += 1
        return state


@settings(max_examples=40, deadline=None, derandomize=True)
@given(n=st.integers(3, 12), data=st.data())
def test_reference_caf_never_passes_2f(n, data):
    """The reference's CAF loop (its own ``cond`` and ``body``, counted)
    never takes more than ``min(2f, 4n)`` passes, on rows drawn from small
    integers (ties, repeats) scaled by powers of two: the bound the fixed
    pass count rests on."""
    f = data.draw(st.integers(0, (n - 1) // 2), label="f")
    d = data.draw(st.integers(1, 6), label="d")
    vals = data.draw(st.lists(st.integers(-4, 4), min_size=n * d, max_size=n * d), label="x")
    scale = data.draw(st.sampled_from([2.0**-10, 1.0, 2.0**10]), label="scale")
    x = jnp.asarray(np.array(vals, np.float32).reshape(n, d) * scale)
    counting = _CountingLax()
    original = jrobust.lax
    jrobust.lax = counting
    try:
        jrobust.caf.__wrapped__(x, f=f)
    finally:
        jrobust.lax = original
    assert counting.trips <= min(2 * f, 4 * n)


# ---------------------------------------------------------------------------
# the masked Weiszfeld mode of B7's loop
# ---------------------------------------------------------------------------


def _masked_host_loop(x, valid, z, *, tol, max_iter, eps=1e-12):
    """The masked geometric median's loop as the port ran it before B7's
    masked mode: one host read of the step length (``torch.sum`` in
    ``x``'s dtype) an iteration, the distances by ``row_sq_dists``, the
    numerator and denominator B11's row chains. Returns ``(z, steps)``."""
    zprev = z
    one = torch.ones((), dtype=torch.float32)
    eps_t = torch.full((), eps, dtype=torch.float32)
    ones_col = torch.ones(x.shape[0])
    tol_t = torch.tensor(tol, dtype=x.dtype)
    it = 0
    while it < max_iter:
        if it > 0:
            delta = torch.sqrt(torch.sum((z - zprev) ** 2))
            if not bool(delta > tol_t):
                break
        dist = torch.sqrt(kernels.row_sq_dists(x, z))
        w = robust._masked_weights(valid, one / torch.maximum(dist, eps_t), x.dtype)
        num = robust._contract_rows(w, x)
        den = robust._contract_rows(ones_col, w[:, None])[0]
        z, zprev = num / den, z
        it += 1
    return z, it


MASKED_CASES = [(8, 8, 2_000, "float32"), (16, 6, 3_001, "float32"), (16, 13, 1_025, "bfloat16"),
                (8, 3, 1_500, "float16"), (64, 29, 1_000, "float32"), (13, 13, 700, "bfloat16")]


@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("n,m,d,dtype", MASKED_CASES)
def test_masked_weiszfeld_plain_is_the_host_loop(n, m, d, dtype, specials):
    """``kernels.center_loop_plain(mode="masked_weiszfeld")`` against the
    host loop it replaces, from the masked median: the centre bit for bit
    (NaN where it is NaN) and the same iteration count, at tol 1e-6 and a
    forced 7 steps (tol 0), on padded cohorts of f32, bf16 and f16 rows,
    and on rows holding NaN and +-inf (valid or padding). The step length
    now sums in B7's column order, where the host loop summed by
    ``torch.sum``; only its comparison with tol reads it."""
    rng = np.random.default_rng(n * 7 + m)
    x = np.zeros((n, d), np.float32)
    x[:m] = rng.normal(size=(m, d)) * rng.choice([0.5, 1.0, 4.0], size=(m, 1))
    if specials:
        x[0, 1], x[m - 1, 2], x[n - 1, 3] = np.nan, np.inf, -np.inf
    valid = np.zeros(n, bool)
    valid[:m] = True
    rng.shuffle(valid)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    vt = torch.from_numpy(valid)
    z0 = robust._masked_median_rows(xt, vt)
    for tol, max_iter in ((1e-6, 256), (0.0, 7)):
        want, steps = _masked_host_loop(xt, vt, z0, tol=tol, max_iter=max_iter)
        z, it = kernels.center_loop_plain(xt, z0, mode="masked_weiszfeld", valid=vt, tol=tol,
                                          max_iter=max_iter)
        nan = torch.isnan(want.float())
        assert torch.equal(torch.isnan(z.float()), nan)
        assert torch.equal(_bits(z)[~nan], _bits(want)[~nan])
        assert int(it) == steps and it.dtype == torch.int32
        # the wrapper takes the plain version on the CPU, and the robust
        # function is that call from the masked median
        zw, itw = kernels.center_loop(xt, z0, mode="masked_weiszfeld", valid=vt, tol=tol,
                                      max_iter=max_iter)
        assert torch.equal(_bits(zw), _bits(z)) and int(itw) == steps
    out = robust.masked_geometric_median(xt, vt)
    want, steps = _masked_host_loop(xt, vt, z0, tol=1e-6, max_iter=256)
    nan = torch.isnan(want.float())
    assert torch.equal(_bits(out)[~nan], _bits(want)[~nan])
    assert int(robust.last_iterations["geometric_median"]) == steps


def _masked_clip_host_loop(x, valid, v, *, c_tau, M, eps=1e-12):
    """The masked centred clipping's loop as the port ran it before B7's
    masked_clip mode: each step ``row_sq_dists``, the clipped weights
    rounded to ``x``'s dtype, B11's row chain over ``x - v`` and the
    rounded reciprocal of the valid rows' count."""
    inv = robust._masked_recip(robust._masked_count(valid), x.dtype)
    one = torch.ones((), dtype=torch.float32)
    eps_t = torch.full((), eps, dtype=torch.float32)
    c_tau_t = torch.full((), c_tau, dtype=torch.float32)
    for _ in range(M):
        dist = torch.sqrt(kernels.row_sq_dists(x, v))
        w = robust._masked_weights(valid, torch.minimum(one, c_tau_t / torch.maximum(dist, eps_t)),
                                   x.dtype)
        v = v + robust._contract_rows(w, x - v[None, :]) * inv
    return v


@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("n,m,d,dtype", MASKED_CASES)
def test_masked_clip_plain_is_the_host_loop(n, m, d, dtype, specials):
    """``kernels.center_loop_plain(mode="masked_clip")`` against the host
    loop it replaces, from the masked mean: the centre bit for bit (NaN
    where it is NaN) after M = 1, 3 and 10 steps, M steps counted, on padded
    cohorts of f32, bf16 and f16 rows (some clipped, some not) and on rows
    holding NaN and +-inf (valid or padding); the wrapper takes it on the
    CPU, ``robust.masked_centered_clipping`` is that loop from its start,
    and the padded loop equals the compacted one."""
    rng = np.random.default_rng(n * 11 + m)
    x = np.zeros((n, d), np.float32)
    x[:m] = rng.normal(size=(m, d)) * rng.choice([0.5, 1.0, 4.0], size=(m, 1))
    if specials:
        x[0, 1], x[m - 1, 2], x[n - 1, 3] = np.nan, np.inf, -np.inf
    valid = np.zeros(n, bool)
    valid[:m] = True
    rng.shuffle(valid)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    vt = torch.from_numpy(valid)
    c_tau = 1.5 * math.sqrt(d)
    v0 = robust.masked_mean(xt, vt)
    for M in (1, 3, 10):
        want = _masked_clip_host_loop(xt, vt, v0, c_tau=c_tau, M=M)
        z, it = kernels.center_loop_plain(xt, v0, mode="masked_clip", valid=vt, c_tau=c_tau,
                                          max_iter=M)
        nan = torch.isnan(want.float())
        assert torch.equal(torch.isnan(z.float()), nan)
        assert torch.equal(_bits(z)[~nan], _bits(want)[~nan])
        assert int(it) == M and it.dtype == torch.int32
        zw, itw = kernels.center_loop(xt, v0, mode="masked_clip", valid=vt, c_tau=c_tau, max_iter=M)
        assert torch.equal(_bits(zw), _bits(z)) and int(itw) == M
    out = robust.masked_centered_clipping(xt, vt, c_tau=c_tau, M=10)
    want = _masked_clip_host_loop(xt, vt, v0, c_tau=c_tau, M=10)
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(out.float()), nan)
    assert torch.equal(_bits(out)[~nan], _bits(want)[~nan])
    if not specials:
        keep = torch.from_numpy(np.flatnonzero(valid))
        compact, _ = kernels.center_loop(xt.index_select(0, keep).contiguous(), v0,
                                         mode="masked_clip", valid=torch.ones(m, dtype=torch.bool),
                                         c_tau=c_tau, max_iter=10)
        assert torch.equal(_bits(compact), _bits(out))


def test_masked_clip_checks_its_inputs():
    """``valid`` is required in the masked_clip mode, as a bool row flag;
    the one-step phases refuse the mode; M = 0 copies the start."""
    xt = torch.from_numpy(np.random.default_rng(5).normal(size=(6, 300)).astype(np.float32))
    valid = torch.ones(6, dtype=torch.bool)
    v0 = xt[0].clone()
    with pytest.raises(ValueError, match="valid is given exactly"):
        kernels.center_loop(xt, v0, mode="masked_clip")
    with pytest.raises(ValueError, match="bool"):
        kernels.center_loop(xt, v0, mode="masked_clip", valid=valid.float())
    with pytest.raises(ValueError, match="whole loop"):
        kernels.weighted_center_step(xt, v0, mode="masked_clip")
    z, it = kernels.center_loop(xt, v0, mode="masked_clip", valid=valid, max_iter=0)
    assert torch.equal(_bits(z), _bits(v0)) and int(it) == 0
    assert torch.equal(robust.masked_centered_clipping(xt, valid, c_tau=1.0, M=0),
                       robust.masked_mean(xt, valid))


def test_masked_weiszfeld_padded_is_compacted_and_checks_its_inputs():
    """Padding rows (zeros, weight 0) leave every step and the count as the
    compacted cohort's, bit for bit; ``valid`` is required exactly in the
    masked mode, as a bool row flag, and the one-step phases refuse the
    mode."""
    rng = np.random.default_rng(4)
    x = np.zeros((16, 3_000), np.float32)
    x[:11] = rng.normal(size=(11, 3_000))
    valid = torch.zeros(16, dtype=torch.bool)
    valid[:11] = True
    xt = torch.from_numpy(x)
    z0 = robust._masked_median_rows(xt, valid)
    z, it = kernels.center_loop(xt, z0, mode="masked_weiszfeld", valid=valid)
    zc, itc = kernels.center_loop(xt[:11].contiguous(), z0, mode="masked_weiszfeld",
                                  valid=torch.ones(11, dtype=torch.bool))
    assert torch.equal(_bits(z), _bits(zc)) and int(it) == int(itc) > 1
    with pytest.raises(ValueError, match="valid is given exactly"):
        kernels.center_loop(xt, z0, mode="masked_weiszfeld")
    with pytest.raises(ValueError, match="valid is given exactly"):
        kernels.center_loop(xt, z0, mode="weiszfeld", valid=valid)
    with pytest.raises(ValueError, match="bool"):
        kernels.center_loop(xt, z0, mode="masked_weiszfeld", valid=valid.float())
    with pytest.raises(ValueError, match="whole loop"):
        kernels.weighted_center_step(xt, z0, mode="masked_weiszfeld")
