"""The port's serving tier (``byzpy_tpu_torch.serving``) and its bucketed
update step (``parallel.ps.build_serving_ps_step``) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed. Clients' gradients are pytrees,
each raveled by its own package (the two ravel orders differ), and the
parameters are compared after ``models.convert``, never as flat vectors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from byzpy_tpu import aggregators as J
from byzpy_tpu.models import nets as jnets
from byzpy_tpu.models.bundle import ModelBundle as JBundle
from byzpy_tpu.parallel import ps as jps
from byzpy_tpu.serving import buckets as jbuckets
from byzpy_tpu.serving import cohort as jcohort
from byzpy_tpu.serving import queue as jqueue
from byzpy_tpu.serving import staleness as jstaleness
from byzpy_tpu_torch import aggregators as T
from byzpy_tpu_torch.models import ModelBundle, from_flax, nets, ordered_like
from byzpy_tpu_torch.parallel import build_serving_ps_step
from byzpy_tpu_torch.serving import (
    BucketLadder,
    CohortAggregator,
    StalenessPolicy,
    Submission,
    build_cohort,
)
from byzpy_tpu_torch.utils import ravel_fn


def _raises_alike(ours, ref):
    """Both calls raise the same exception type with the same message, or
    both return equal values."""
    try:
        want = ref()
    except Exception as exc:  # noqa: BLE001 - the reference's own error
        with pytest.raises(type(exc)) as got:
            ours()
        assert str(got.value) == str(exc)
        return
    assert ours() == want


@pytest.mark.parametrize("cap,min_bucket", [(8, 2), (64, 8), (100, 8), (5, 5), (1, 1), (0, 2),
                                            (4, 8), (8, 0)])
def test_bucket_ladder_matches_jax(cap, min_bucket):
    """Sizes, cap, ``bucket_for`` over 0 .. cap + 2 and every error, as in
    the reference."""
    _raises_alike(lambda: BucketLadder(cap, min_bucket=min_bucket).sizes,
                  lambda: jbuckets.BucketLadder(cap, min_bucket=min_bucket).sizes)
    if cap <= 0 or min_bucket <= 0 or min_bucket > cap:
        return
    ours, ref = BucketLadder(cap, min_bucket=min_bucket), jbuckets.BucketLadder(cap, min_bucket=min_bucket)
    assert ours.cap == ref.cap
    for m in range(0, ref.cap + 3):
        _raises_alike(lambda: ours.bucket_for(m), lambda: ref.bucket_for(m))


@pytest.mark.parametrize("kw", [dict(), dict(kind="exponential", gamma=0.5),
                                dict(kind="exponential", gamma=0.3, cutoff=2),
                                dict(kind="polynomial", alpha=1.0), dict(kind="polynomial", alpha=2.5),
                                dict(kind="bad"), dict(gamma=0.0), dict(alpha=-1.0),
                                dict(cutoff=-1)])
def test_staleness_policy_matches_jax(kw):
    """The same discounts (exactly: the same float arithmetic), admissions
    and errors; ``discount(0)`` and ``discount(-1)`` are exactly 1.0."""
    _raises_alike(lambda: repr(StalenessPolicy(**kw)), lambda: repr(jstaleness.StalenessPolicy(**kw)))
    try:
        ref = jstaleness.StalenessPolicy(**kw)
    except ValueError:
        return
    ours = StalenessPolicy(**kw)
    for delta in range(-2, 7):
        assert ours.discount(delta) == ref.discount(delta)
        assert ours.admits(delta) == ref.admits(delta)
    assert ours.discount(0) == 1.0 and ours.discount(-1) == 1.0


def test_submission_matches_jax():
    fields = [f.name for f in Submission.__dataclass_fields__.values()]
    assert fields == [f.name for f in jqueue.Submission.__dataclass_fields__.values()]
    s = Submission(client="c", round_submitted=3, gradient=np.zeros(2), arrived_s=1.5)
    assert (s.seq, s.wal_id, s.wire_inflation) == (None, None, None)


def _submissions(grads, rounds, make):
    return [make(client=f"c{i}", round_submitted=r, gradient=g, arrived_s=10.0 - i,
                 wire_inflation=None if i % 2 else 1.0)
            for i, (g, r) in enumerate(zip(grads, rounds))]


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("m,cap,ladder", [(5, 8, True), (13, 64, True), (6, 8, False), (1, 8, True)])
def test_build_cohort_matches_jax(m, cap, ladder, as_tensor):
    """``matrix``, ``valid``, ``weights``, clients, first arrival and
    inflations exactly as the reference's, with rows given as numpy arrays
    or as tensors, every fourth submission one round stale."""
    rng = np.random.default_rng(m)
    grads = [rng.normal(size=37).astype(np.float32) for _ in range(m)]
    rounds = [6 if i % 4 else 5 for i in range(m)]
    pol, jpol = StalenessPolicy("exponential", gamma=0.5), jstaleness.StalenessPolicy("exponential", gamma=0.5)
    rows = [torch.from_numpy(g) for g in grads] if as_tensor else grads
    ours = build_cohort(_submissions(rows, rounds, Submission), 6,
                        BucketLadder(cap, min_bucket=8) if ladder else None, pol, device="cpu")
    ref = jcohort.build_cohort(_submissions(grads, rounds, jqueue.Submission), 6,
                               jbuckets.BucketLadder(cap, min_bucket=8) if ladder else None, jpol)
    assert (ours.bucket, ours.m) == (ref.bucket, ref.m)
    np.testing.assert_array_equal(ours.matrix.numpy().view(np.uint32), ref.matrix.view(np.uint32))
    np.testing.assert_array_equal(ours.valid, ref.valid)
    np.testing.assert_array_equal(ours.weights.view(np.uint32), ref.weights.view(np.uint32))
    assert ours.clients == ref.clients and ours.first_arrival_s == ref.first_arrival_s
    assert ours.wire_inflations == ref.wire_inflations


def test_build_cohort_quantized_raises_and_bad_sizes_match():
    """``quantized=True`` raised ``NotImplementedError`` until the quantized
    layout came; on dense rows it now takes the dense layout, as the
    reference's does (the quantized layout is held in
    ``tests/test_torch_ragged.py``). Bad sizes raise as before."""
    subs = [Submission(client="a", round_submitted=0, gradient=np.ones(4, np.float32), arrived_s=0.0)]
    cohort = build_cohort(subs, 0, BucketLadder(8), StalenessPolicy(), quantized=True, device="cpu")
    assert not cohort.quantized and cohort.bucket == BucketLadder(8).bucket_for(1)
    assert torch.equal(cohort.matrix[0], torch.ones(4))
    with pytest.raises(ValueError, match="exceeds the bucket cap"):
        build_cohort(subs * 9, 0, BucketLadder(8), StalenessPolicy(), device="cpu")


@pytest.mark.parametrize("name", ["trimmed", "multikrum", "median"])
def test_cohort_aggregator_matches_jax(name):
    """``CohortAggregator.aggregate`` of one cohort with stale rows: the
    rows are scaled by the same f32 weights, then the masked program runs;
    bit for bit the reference's (d = 200: every column is one XLA:CPU
    row chain, and these aggregators' sorts and selections are exact)."""
    make = {"trimmed": (lambda: T.CoordinateWiseTrimmedMean(1, device="cpu"),
                        lambda: J.CoordinateWiseTrimmedMean(f=1)),
            "multikrum": (lambda: T.MultiKrum(1, 2, device="cpu"), lambda: J.MultiKrum(f=1, q=2)),
            "median": (lambda: T.CoordinateWiseMedian(device="cpu"), lambda: J.CoordinateWiseMedian())}
    rng = np.random.default_rng(7)
    grads = [(rng.normal(size=200) * s).astype(np.float32) for s in rng.uniform(0.1, 50, 6)]
    rounds = [4, 3, 4, 2, 4, 4]
    pol, jpol = StalenessPolicy("exponential", gamma=0.5), jstaleness.StalenessPolicy("exponential", gamma=0.5)
    ours = CohortAggregator(make[name][0]()).aggregate(
        build_cohort(_submissions(grads, rounds, Submission), 4, BucketLadder(8), pol, device="cpu"))
    ref = jcohort.CohortAggregator(make[name][1]()).aggregate(
        jcohort.build_cohort(_submissions(grads, rounds, jqueue.Submission), 4,
                             jbuckets.BucketLadder(8), jpol))
    np.testing.assert_array_equal(ours.numpy().view(np.uint32), np.asarray(ref).view(np.uint32))


def test_fresh_cohort_bit_identical_through_the_staleness_path():
    """Every row fresh: weights exactly 1.0, and the cohort's aggregate is
    the policy-free masked aggregate bit for bit; a stale row changes it."""
    agg = T.CoordinateWiseTrimmedMean(1, device="cpu")
    rng = np.random.default_rng(17)
    grads = [rng.normal(size=64).astype(np.float32) for _ in range(5)]
    pol = StalenessPolicy("exponential", gamma=0.25)
    fresh = build_cohort(_submissions(grads, [4] * 5, Submission), 4, BucketLadder(8), pol, device="cpu")
    assert (fresh.weights[:5] == 1.0).all()
    out = CohortAggregator(agg).aggregate(fresh)
    assert torch.equal(out, agg.aggregate_masked(fresh.matrix, fresh.valid))
    stale = build_cohort(_submissions(grads, [4, 3, 4, 4, 4], Submission), 4, BucketLadder(8), pol,
                         device="cpu")
    assert not torch.equal(CohortAggregator(agg).aggregate(stale), out)


# ---------------------------------------------------------------------------
# the bucketed update step
# ---------------------------------------------------------------------------

MASKED = {
    "trimmed": (lambda: T.CoordinateWiseTrimmedMean(1, device="cpu"), lambda: J.CoordinateWiseTrimmedMean(f=1)),
    "median": (lambda: T.CoordinateWiseMedian(device="cpu"), lambda: J.CoordinateWiseMedian()),
    "multikrum": (lambda: T.MultiKrum(1, 2, device="cpu"), lambda: J.MultiKrum(f=1, q=2)),
    "meamed": (lambda: T.MeanOfMedians(1, device="cpu"), lambda: J.MeanOfMedians(f=1)),
    "cge": (lambda: T.ComparativeGradientElimination(1, device="cpu"),
            lambda: J.ComparativeGradientElimination(f=1)),
    "monna": (lambda: T.MoNNA(1, device="cpu"), lambda: J.MoNNA(f=1)),
    "geomed": (lambda: T.GeometricMedian(device="cpu"), lambda: J.GeometricMedian()),
    "clip": (lambda: T.CenteredClipping(c_tau=10.0, device="cpu"), lambda: J.CenteredClipping(c_tau=10.0)),
}
LR, MOM = 0.05, 0.9


def _linear_bundles(seed=0):
    """A single-leaf linear model in both packages (d = 64 x 8 = 512)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(64, 8)) * 0.1).astype(np.float32)
    ours = ModelBundle(module=torch.nn.Module(), params={"w": torch.from_numpy(w)},
                       loss_fn=lambda p, x, y: torch.mean((x @ p["w"] - y) ** 2))
    ref = JBundle(apply_fn=lambda p, x: x @ p["w"], params={"w": jnp.asarray(w)},
                  loss_fn=lambda p, x, y: jnp.mean((x @ p["w"] - y) ** 2))
    return ours, ref


def _padded(rows, bucket):
    m, d = rows.shape
    matrix = np.zeros((bucket, d), np.float32)
    matrix[:m] = rows
    valid = np.zeros(bucket, bool)
    valid[:m] = True
    return matrix, valid


@pytest.mark.parametrize("name", sorted(MASKED))
def test_serving_step_matches_jax_on_the_linear_bundle(name):
    """Two steps of ``build_serving_ps_step`` against ``jit_serving_ps_step``
    on a single-leaf model (the flat vector is the leaf in both packages),
    cohort of 5 in a bucket of 8, one stale row (weight 0.5): parameters
    within 1 ulp of the largest parameter at step 1 (jit fuses the
    momentum multiply-add into an FMA; ``tests/test_serving.py`` allows the
    same), 2 ulp at step 2; the iterative aggregators within their f32
    tolerance (``tests/test_torch_masked.py``) carried through lr. The
    metrics agree, ``cohort_m`` exactly."""
    ours_b, ref_b = _linear_bundles()
    agg, jagg = MASKED[name][0](), MASKED[name][1]()
    step, opt = build_serving_ps_step(ours_b, agg.masked_matrix_fn(), learning_rate=LR, momentum=MOM)
    jstep, jopt = jps.jit_serving_ps_step(ref_b, jagg.masked_matrix_fn(), learning_rate=LR, momentum=MOM)
    rng = np.random.default_rng(3)
    params, jparams = ours_b.params, ref_b.params
    for s in range(2):
        rows = (rng.normal(size=(5, 512)) * rng.uniform(0.5, 5.0, size=(5, 1))).astype(np.float32)
        matrix, valid = _padded(rows, 8)
        weights = valid.astype(np.float32)
        weights[1] = 0.5
        params, opt, metrics = step(params, opt, torch.from_numpy(matrix), torch.from_numpy(valid),
                                    torch.from_numpy(weights))
        jparams, jopt, jmetrics = jstep(jparams, jopt, jnp.asarray(matrix), jnp.asarray(valid),
                                        jnp.asarray(weights))
        want = np.asarray(jparams["w"])
        ulp = float(np.spacing(np.max(np.abs(want))))
        atol = (s + 1) * ulp + (LR * (s + 1) * 4e-4 if name in ("geomed", "clip") else 0.0)
        np.testing.assert_allclose(params["w"].numpy(), want, rtol=0, atol=atol, err_msg=f"step {s + 1}")
        assert int(metrics["cohort_m"]) == int(jmetrics["cohort_m"]) == 5
        np.testing.assert_allclose(float(metrics["agg_grad_norm"]), float(jmetrics["agg_grad_norm"]),
                                   rtol=1e-5)


def _port_bundle(jbundle, module):
    bundle = nets.make_bundle(module, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jbundle.params))
    bundle.params = ordered_like(from_flax(tree, device="cpu"), bundle.params)
    return bundle


@pytest.mark.parametrize("name", ["trimmed", "multikrum", "median", "geomed"])
def test_serving_step_matches_jax_on_the_mlp(name):
    """Three steps of the serving step on an MLP (784 -> 16 -> 10), the
    clients' gradients computed and raveled by each package from the same
    numpy batches (9 clients in a bucket of 16, the last two
    sign-flipping the honest mean, every fourth one round stale):
    parameters within rtol 1e-4, atol 1e-5 of the JAX step's after every
    step, as the PS rounds' tests allow."""
    jb = jnets.mnist_mlp(seed=0, hidden=16)
    bundle = _port_bundle(jb, nets.MLP(features=(16, 10)))
    agg, jagg = MASKED[name][0](), MASKED[name][1]()
    step, opt = build_serving_ps_step(bundle, agg.masked_matrix_fn())
    jstep, jopt = jps.jit_serving_ps_step(jb, jagg.masked_matrix_fn())
    ravel, _ = ravel_fn(bundle.params)
    jgrad = jax.jit(jax.grad(jb.loss_fn))
    rng = np.random.default_rng(11)
    params, jparams = bundle.params, jb.params
    m, bucket, byz = 9, 16, 2
    pol = StalenessPolicy("exponential", gamma=0.5)
    weights = np.zeros(bucket, np.float32)
    weights[:m] = [pol.discount(1 if i % 4 == 3 else 0) for i in range(m)]
    valid = np.arange(bucket) < m
    for s in range(3):
        xs = rng.normal(size=(m - byz, 8, 28, 28, 1)).astype(np.float32)
        ys = rng.integers(0, 10, size=(m - byz, 8))
        ours_rows, ref_rows = [], []
        for i in range(m - byz):
            g = torch.func.grad(bundle.loss_fn)(params, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
            ours_rows.append(ravel(g))
            ref_rows.append(np.asarray(ravel_pytree(jgrad(jparams, jnp.asarray(xs[i]), jnp.asarray(ys[i])))[0]))
        ours_m = torch.stack(ours_rows)
        ours_m = torch.cat([ours_m, (-ours_m.mean(0)).expand(byz, -1)])
        ref_m = np.stack(ref_rows)
        ref_m = np.concatenate([ref_m, np.repeat(-ref_m.mean(0, keepdims=True), byz, 0)])
        matrix, jmatrix = torch.zeros((bucket, ours_m.shape[1])), np.zeros((bucket, ref_m.shape[1]), np.float32)
        matrix[:m], jmatrix[:m] = ours_m, ref_m
        params, opt, metrics = step(params, opt, matrix, torch.from_numpy(valid), torch.from_numpy(weights))
        jparams, jopt, jmetrics = jstep(jparams, jopt, jnp.asarray(jmatrix), jnp.asarray(valid),
                                        jnp.asarray(weights))
        ref = from_flax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        for k, v in params.items():
            np.testing.assert_allclose(v.detach().numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {s + 1} {k}")
        assert int(metrics["cohort_m"]) == m


@pytest.mark.parametrize("bucket", [8, 16, 64])
@pytest.mark.parametrize("name", sorted(MASKED))
def test_serving_step_padded_equals_compacted_bitwise(name, bucket):
    """The port's serving step on a cohort of 7 padded into a bucket gives
    the parameters, momentum and metrics of the same cohort at bucket ==
    m, bit for bit."""
    ours_b, _ = _linear_bundles()
    step, opt = build_serving_ps_step(ours_b, MASKED[name][0]().masked_matrix_fn())
    rows = (np.random.default_rng(bucket).normal(size=(7, 512)) * 3).astype(np.float32)
    weights = np.float32([1.0, 0.5, 1.0, 1.0, 0.25, 1.0, 1.0])
    matrix, valid = _padded(rows, bucket)
    w_pad = np.zeros(bucket, np.float32)
    w_pad[:7] = weights
    p1, o1, m1 = step(ours_b.params, opt, torch.from_numpy(matrix), torch.from_numpy(valid),
                      torch.from_numpy(w_pad))
    p2, o2, m2 = step(ours_b.params, opt, torch.from_numpy(rows), torch.ones(7, dtype=torch.bool),
                      torch.from_numpy(weights))
    assert torch.equal(p1["w"].view(torch.int32), p2["w"].view(torch.int32))
    assert torch.equal(o1["trace"].view(torch.int32), o2["trace"].view(torch.int32))
    assert torch.equal(m1["agg_grad_norm"], m2["agg_grad_norm"]) and int(m1["cohort_m"]) == 7


def test_serving_step_weight_one_keeps_the_bits():
    """A weight of 1.0 leaves the step's bits as the unscaled masked
    aggregate's step; another weight changes them."""
    ours_b, _ = _linear_bundles()
    agg = T.CoordinateWiseTrimmedMean(1, device="cpu")
    step, opt = build_serving_ps_step(ours_b, agg.masked_matrix_fn())
    rows = np.random.default_rng(1).normal(size=(6, 512)).astype(np.float32)
    matrix, valid = _padded(rows, 8)
    x, v = torch.from_numpy(matrix), torch.from_numpy(valid)
    p1, _, _ = step(ours_b.params, opt, x, v, v.float())
    direct = agg.masked_matrix_fn()(x, v)
    expect = ours_b.params["w"] + (direct.reshape(64, 8) * -LR)
    assert torch.equal(p1["w"], expect)
    w = v.float()
    w[2] = 0.5
    p2, _, _ = step(ours_b.params, opt, x, v, w)
    assert not torch.equal(p1["w"], p2["w"])


def test_serving_step_rejects_what_is_not_ported():
    ours_b, _ = _linear_bundles()
    fn = T.CoordinateWiseMedian(device="cpu").masked_matrix_fn()
    with pytest.raises(TypeError, match="init"):
        build_serving_ps_step(ours_b, fn, optimizer=object())
    with pytest.raises(NotImplementedError):
        build_serving_ps_step(ours_b, fn, mesh=object())


def test_serving_step_stages_are_profiler_ranges():
    """The reference's named scopes are torch.profiler ranges of the same
    names."""
    from torch.profiler import ProfilerActivity, profile

    ours_b, _ = _linear_bundles()
    step, opt = build_serving_ps_step(ours_b, T.CoordinateWiseMedian(device="cpu").masked_matrix_fn())
    matrix, valid = _padded(np.ones((3, 512), np.float32), 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(ours_b.params, opt, torch.from_numpy(matrix), torch.from_numpy(valid),
             torch.from_numpy(valid.astype(np.float32)))
    names = {e.key for e in prof.key_averages()}
    assert {"serving.staleness_scale", "serving.masked_aggregate", "serving.opt_update"} <= names
