"""The operator classes' pool paths (``aggregators/chunked.py``,
``attacks/chunked.py``, MDA's and SMEA's fan-out) against the JAX
package's pool paths and against the port's own direct path, on the CPU,
on ``thread`` pools of 2 and 4, same numpy inputs.

Tolerances, stated per class in ``AGGREGATORS`` and ``ATTACKS``:

* the port's pool path against its direct path: bit for bit for the
  coordinate-wise work (median, trimmed mean, MeaMed feature chunks;
  Empire, sign flip, mimic, inf spans; each column is reduced alone),
  the same subset for MDA and SMEA, and bit for bit for the row scorers
  (Krum, Multi-Krum, MoNNA, CGE: the pool's scores come from row
  products, the direct path's from the Gram, and both select the same
  rows, whose mean both take with B4's row sweep,
  ``robust.selection_sweep_mean``); the barriered geometric median and
  centred clipping within rtol 1e-4, atol 1e-5 (a loop of row-block sums
  against B7's loop: ``tests/test_torch_robust.py``'s tolerance for the
  loops); Little within rtol 1e-6, atol 3e-6 (its means reduce over
  column views);
* against the JAX package's pool path: the median bit for bit, the
  selections and sums within rtol 1e-6, atol 1e-7 (a few ulps), Little
  within rtol 1e-6, atol 3e-6 (``tests/test_torch_attacks.py``), the
  loops within rtol 1e-4, atol 1e-5, the subset searches the same
  subset;
* Gaussian by seed determinism and moments (PyTorch cannot reproduce
  ``jax.random``'s bits).

Every wait is bounded (``asyncio.wait_for``).
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import byzpy_tpu.aggregators as J
import byzpy_tpu.attacks as JA
from byzpy_tpu.engine.graph import ActorPoolConfig as JPoolConfig
from byzpy_tpu.engine.graph import run_operator as jax_run_operator
import byzpy_tpu_torch.aggregators as P
import byzpy_tpu_torch.attacks as PA
from byzpy_tpu_torch.attacks.chunked import mix_seed
from byzpy_tpu_torch.engine.graph import ActorPool, ActorPoolConfig, OpContext, run_operator

CPU = "cpu"
N, D = 9, 193
WAIT_S = 120
EXACT = (0.0, 0.0)
SELECTION = (1e-6, 1e-7)
LOOP = (1e-4, 1e-5)
LITTLE = (1e-6, 3e-6)


def _rows(seed=0, n=N, d=D):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    x[-2:] *= np.float32(4.0)  # two outlying rows, so that selections matter
    return x


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, WAIT_S))


def _close(ours, ref, tol):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = ref.numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    if tol == EXACT:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=tol[0], atol=tol[1])


# (name, port constructor, JAX constructor, tolerance against the direct
# path, tolerance against the JAX pool path)
AGGREGATORS = [
    ("median", lambda: P.CoordinateWiseMedian(chunk_size=16, device=CPU),
     lambda: J.CoordinateWiseMedian(chunk_size=16), EXACT, EXACT),
    ("trimmed", lambda: P.CoordinateWiseTrimmedMean(2, chunk_size=16, device=CPU),
     lambda: J.CoordinateWiseTrimmedMean(2, chunk_size=16), EXACT, SELECTION),
    ("meamed", lambda: P.MeanOfMedians(2, chunk_size=16, device=CPU),
     lambda: J.MeanOfMedians(2, chunk_size=16), EXACT, SELECTION),
    ("multi_krum", lambda: P.MultiKrum(2, 3, chunk_size=2, device=CPU),
     lambda: J.MultiKrum(2, 3, chunk_size=2), EXACT, SELECTION),
    ("krum", lambda: P.Krum(2, chunk_size=2, device=CPU), lambda: J.Krum(2, chunk_size=2),
     EXACT, SELECTION),
    ("monna", lambda: P.MoNNA(2, reference_index=3, chunk_size=2, device=CPU),
     lambda: J.MoNNA(2, reference_index=3, chunk_size=2), EXACT, SELECTION),
    ("cge", lambda: P.ComparativeGradientElimination(2, chunk_size=2, device=CPU),
     lambda: J.ComparativeGradientElimination(2, chunk_size=2), EXACT, SELECTION),
    ("geomed", lambda: P.GeometricMedian(device=CPU), lambda: J.GeometricMedian(), LOOP, LOOP),
    ("geomed_mean", lambda: P.GeometricMedian(init="mean", tol=1e-5, device=CPU),
     lambda: J.GeometricMedian(init="mean", tol=1e-5), LOOP, LOOP),
    ("clip", lambda: P.CenteredClipping(c_tau=6.0, device=CPU),
     lambda: J.CenteredClipping(c_tau=6.0), LOOP, LOOP),
    ("clip_median", lambda: P.CenteredClipping(c_tau=6.0, M=4, init="median", device=CPU),
     lambda: J.CenteredClipping(c_tau=6.0, M=4, init="median"), LOOP, LOOP),
    ("mda", lambda: P.MinimumDiameterAveraging(2, device=CPU),
     lambda: J.MinimumDiameterAveraging(2), EXACT, SELECTION),
    ("mda_ranges", lambda: P.MinimumDiameterAveraging(2, seed_prefix=0, chunk_size=5, device=CPU),
     lambda: J.MinimumDiameterAveraging(2, seed_prefix=0, chunk_size=5), None, SELECTION),
    ("mda_seeds", lambda: P.MinimumDiameterAveraging(2, seed_prefix=3, seeds_per_task=2,
                                                     device=CPU),
     lambda: J.MinimumDiameterAveraging(2, seed_prefix=3, seeds_per_task=2), EXACT, SELECTION),
    ("smea", lambda: P.SMEA(2, chunk_size=7, device=CPU), lambda: J.SMEA(2, chunk_size=7),
     EXACT, SELECTION),
]


@pytest.mark.parametrize("workers", [2, 4])
@pytest.mark.parametrize("case", AGGREGATORS, ids=[c[0] for c in AGGREGATORS])
def test_aggregator_pool_path_matches_jax_and_direct(case, workers):
    name, ours_ctor, ref_ctor, tol_direct, tol_jax = case
    x = _rows(seed=workers)
    ours = ours_ctor()
    pooled = _run(run_operator(ours, [torch.from_numpy(r) for r in x],
                               pool_config=ActorPoolConfig(backend="thread", count=workers)))
    ref = _run(jax_run_operator(ref_ctor(), [jnp.asarray(r) for r in x],
                                pool_config=JPoolConfig(backend="thread", count=workers)))
    _close(pooled, ref, tol_jax)
    if tol_direct is not None:
        # MDA's brute-force range scoring (seed_prefix=0) ranks subsets by
        # the JAX package's range scorer, not its exact search
        _close(pooled, ours_ctor().aggregate(torch.from_numpy(x)), tol_direct)
    if name.startswith(("mda", "smea")):
        direct = ours_ctor()
        direct.aggregate(torch.from_numpy(x))
        if tol_direct is not None:
            assert torch.equal(ours.last_selection.sort().values, direct.last_selection.sort().values)


def test_subtask_fan_out_counts_and_views():
    """The fan-out's shape: feature chunks are column views of one matrix
    (no copy), row scorers get the whole matrix and a row range, the
    barriered blocks are row views, and the subtask counts follow the
    reference's adaptive sizing (BASELINE config #1: 16 chunks of 6,250
    columns at 10 x 100,000 on a pool of 4; config #2: 16 ranges of 4 rows
    at 64 rows)."""
    x = torch.zeros((10, 100_000))
    ctx = OpContext("agg", {"pool_size": 4})
    tasks = list(P.CoordinateWiseMedian(device=CPU).create_subtasks({"gradients": x}, context=ctx))
    assert len(tasks) == 16 and tasks[0].name == "coordinate-wise-median-feat[0:6250]"
    assert all(t.args[0].data_ptr() == x[:, 6250 * i:].data_ptr() for i, t in enumerate(tasks))
    x = torch.zeros((64, 32))
    tasks = list(P.MultiKrum(8, 12, device=CPU).create_subtasks({"gradients": x}, context=ctx))
    assert len(tasks) == 16 and [t.args[1:] for t in tasks[:2]] == [(0, 4), (4, 8)]
    assert all(t.args[0] is x for t in tasks)


def test_barriered_blocks_are_views_and_one_worker_computes():
    """With one worker the barriered classes compute directly (B7's loop on
    the card); with two they pass row views of the stacked matrix."""
    x = torch.from_numpy(_rows(5))
    seen = []
    agg = P.GeometricMedian(device=CPU)
    original = type(agg)._barrier_chunk_fn

    def spy(block, center, **kw):
        seen.append(block.data_ptr())
        return original(block, center, **kw)

    saved = type(agg).__dict__["_barrier_chunk_fn"]
    type(agg)._barrier_chunk_fn = staticmethod(spy)
    try:
        one = _run(run_operator(agg, x, pool_config=ActorPoolConfig(backend="thread", count=1)))
        assert not seen
        _close(one, agg.aggregate(x), EXACT)
        _run(run_operator(agg, x, pool_config=ActorPoolConfig(backend="thread", count=2)))
    finally:
        type(agg)._barrier_chunk_fn = saved
    assert set(seen) <= {x[i].data_ptr() for i in range(x.shape[0])} and len(set(seen)) > 1


# (name, port constructor, JAX constructor, inputs kind, tolerance against
# the direct path, tolerance against the JAX pool path)
ATTACKS = [
    ("empire", lambda: PA.EmpireAttack(scale=-1.1, device=CPU), lambda: JA.EmpireAttack(scale=-1.1),
     "honest", EXACT, SELECTION),
    ("little", lambda: PA.LittleAttack(2, device=CPU), lambda: JA.LittleAttack(2), "honest",
     LITTLE, LITTLE),
    ("mimic", lambda: PA.MimicAttack(epsilon=3, device=CPU), lambda: JA.MimicAttack(epsilon=3),
     "honest", EXACT, EXACT),
    ("inf", lambda: PA.InfAttack(device=CPU), lambda: JA.InfAttack(), "honest", EXACT, EXACT),
    ("sign_flip", lambda: PA.SignFlipAttack(scale=-2.0, device=CPU),
     lambda: JA.SignFlipAttack(scale=-2.0), "base", EXACT, EXACT),
]


@pytest.mark.parametrize("workers", [2, 4])
@pytest.mark.parametrize("case", ATTACKS, ids=[c[0] for c in ATTACKS])
def test_attack_pool_path_matches_jax_and_direct(case, workers):
    name, ours_ctor, ref_ctor, kind, tol_direct, tol_jax = case
    x = _rows(seed=10 + workers, d=1000)
    ours, ref = ours_ctor(), ref_ctor()
    ours.chunk_size = ref.chunk_size = 64
    if kind == "honest":
        mine, theirs = {"honest_grads": [torch.from_numpy(r) for r in x]}, {
            "honest_grads": [jnp.asarray(r) for r in x]}
    else:
        mine, theirs = {"base_grad": torch.from_numpy(x[0])}, {"base_grad": jnp.asarray(x[0])}
    pooled = _run(run_operator(ours, mine, pool_config=ActorPoolConfig(backend="thread",
                                                                        count=workers)))
    jpooled = _run(jax_run_operator(ref, theirs, pool_config=JPoolConfig(backend="thread",
                                                                          count=workers)))
    _close(pooled, jpooled, tol_jax)
    _close(pooled, ours.apply(**mine), tol_direct)


def test_gaussian_fan_out_by_seed_and_moments():
    """Each span from a generator seeded from (seed, fan-out, span): the
    same seed replays the same fan-outs, a second fan-out draws afresh, and
    the draws are N(mu, sigma^2) by their moments."""
    x = [torch.zeros(20_000) for _ in range(4)]

    def fan_outs(seed):
        atk = PA.GaussianAttack(mu=0.5, sigma=2.0, seed=seed, device=CPU)
        atk.chunk_size = 1024
        cfg = ActorPoolConfig(backend="thread", count=3)
        return [_run(run_operator(atk, {"honest_grads": x}, pool_config=cfg)) for _ in range(2)]

    a, b = fan_outs(7), fan_outs(7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], fan_outs(8)[0])
    for v in a:
        assert abs(float(v.mean()) - 0.5) < 5 * 2.0 / np.sqrt(v.numel())
        assert abs(float(v.std()) - 2.0) < 0.05
    assert mix_seed(7, 1) != mix_seed(7, 2) and 0 <= mix_seed(7, 1) < 2**63


def test_chunked_classes_need_inputs_as_the_jax_ones():
    """Missing inputs raise the JAX package's errors on the pool path."""
    ctx = OpContext("atk", {"pool_size": 2})
    for ours, ref, key in ((PA.EmpireAttack(device=CPU), JA.EmpireAttack(), "honest_grads"),
                           (PA.SignFlipAttack(device=CPU), JA.SignFlipAttack(), "base_grad")):
        with pytest.raises(ValueError) as mine:
            ours.create_subtasks({}, context=ctx)
        with pytest.raises(ValueError) as theirs:
            ref.create_subtasks({}, context=ctx)
        assert str(mine.value) == str(theirs.value) and key in str(mine.value)
    with pytest.raises(ValueError) as mine:
        PA.MimicAttack(epsilon=9, device=CPU).create_subtasks(
            {"honest_grads": [torch.zeros(3)] * 2}, context=ctx)
    with pytest.raises(ValueError) as theirs:
        JA.MimicAttack(epsilon=9).create_subtasks({"honest_grads": [jnp.zeros(3)] * 2}, context=ctx)
    assert str(mine.value) == str(theirs.value)


def test_pool_path_keeps_nested_structure():
    """A pooled aggregate of nested gradients unravels to the first
    gradient's structure, as the direct path's does, without a second
    stack."""
    x = _rows(9)
    grads = [{"a": torch.from_numpy(r[:40]).reshape(4, 10), "b": [torch.from_numpy(r[40:])]}
             for r in x]
    agg = P.CoordinateWiseTrimmedMean(1, chunk_size=16, device=CPU)

    async def pooled():
        async with ActorPool(ActorPoolConfig(backend="thread", count=2)) as pool:
            return await run_operator(agg, grads, pool=pool)

    out, direct = _run(pooled()), agg.aggregate(grads)
    assert out["a"].shape == (4, 10) and out["b"][0].shape == (D - 40,)
    _close(out["a"], direct["a"], EXACT)
    _close(out["b"][0], direct["b"][0], EXACT)
