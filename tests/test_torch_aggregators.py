"""The port's operator classes (``byzpy_tpu_torch.aggregators``,
``byzpy_tpu_torch.pre_aggregators``) against the JAX package's, on the CPU.

The same seeded numpy gradients go to both packages. Nested inputs use
dictionaries whose keys are already sorted, so the port's flat order (key
insertion order) and the JAX package's (sorted keys) coincide and CAF's
start vector means the same in both. Tolerances, stated per class in
``CLASSES``: the median is bitwise; the selections (trimmed mean,
MeaMed, Krum, Multi-Krum, CGE, MoNNA) rtol 1e-6, atol 1e-7 (sums taken in
another order); the loops (geometric median, centred clipping, CAF) rtol
1e-4, atol 1e-5 (``tests/test_torch_robust.py``'s tolerance for their
functions). The incremental folds (Krum, Multi-Krum, trimmed mean, CGE)
accumulate in arrival order: rtol 1e-5, atol 1e-6 against the barrier
path, as ``tests/test_overlap_stream.py`` holds the JAX folds.
"""

import asyncio
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as jax_ravel

import byzpy_tpu.aggregators as J
import byzpy_tpu.pre_aggregators as JP
from byzpy_tpu.aggregators.pipelines import fused_pipeline_matrix_fn as jax_fused
from byzpy_tpu.utils import trees as jtrees
import byzpy_tpu_torch.aggregators as P
import byzpy_tpu_torch.pre_aggregators as PP
from byzpy_tpu_torch.aggregators import fused_pipeline_matrix_fn
from byzpy_tpu_torch.aggregators.base import ravel_gradient
from byzpy_tpu.engine.graph import OpContext as JOpContext
from byzpy_tpu_torch.engine.graph import ActorPool, ActorPoolConfig, OpContext
from byzpy_tpu_torch.ops import robust
from byzpy_tpu_torch.utils import ravel_pytree, stack_gradients, unstack_rows

N, D = 9, 193
CPU = "cpu"


def _rows(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=d).astype(np.float32) for _ in range(n)]


def _nest(row: np.ndarray) -> dict:
    """A (193,) row as a nested structure with sorted keys and a list."""
    return {"a": row[:20].reshape(4, 5), "b": {"c": row[20:33], "d": [row[33:].reshape(8, 20)]}}


INPUT_KINDS = ["tensors_1d", "nested_dicts", "matrix", "numpy"]


def _inputs(kind: str, rows):
    """(port input, JAX input) of the same gradients."""
    if kind == "tensors_1d":
        return [torch.from_numpy(r) for r in rows], [jnp.asarray(r) for r in rows]
    if kind == "nested_dicts":
        port = [jax.tree_util.tree_map(torch.from_numpy, _nest(r)) for r in rows]
        return port, [jax.tree_util.tree_map(jnp.asarray, _nest(r)) for r in rows]
    if kind == "matrix":
        return torch.from_numpy(np.stack(rows)), jnp.asarray(np.stack(rows))
    return list(rows), list(rows)


def _flat_port(out) -> np.ndarray:
    return ravel_pytree(out)[0].numpy()


def _flat_jax(out) -> np.ndarray:
    return np.asarray(jax_ravel(out)[0])


def _jax_caf_draw(d: int) -> np.ndarray:
    """The JAX CAF class's start vector (``seed=0``), before normalization."""
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (d,), dtype=jnp.float32))


# name -> (port class, JAX class, rtol, atol, kind of fold): "slot" folds
# replay the barrier matrix and are bitwise; "incremental" ones are held
# within rtol 1e-5, atol 1e-6
CLASSES = {
    "median": (lambda: P.CoordinateWiseMedian(device=CPU), J.CoordinateWiseMedian, 0.0, 0.0, "slot"),
    "trimmed_mean": (lambda: P.CoordinateWiseTrimmedMean(2, device=CPU),
                     lambda: J.CoordinateWiseTrimmedMean(2), 1e-6, 1e-7, "incremental"),
    "meamed": (lambda: P.MeanOfMedians(2, device=CPU), lambda: J.MeanOfMedians(2), 1e-6, 1e-7,
               "slot"),
    "multi_krum": (lambda: P.MultiKrum(2, 3, device=CPU), lambda: J.MultiKrum(2, 3), 1e-6, 1e-7,
                   "incremental"),
    "krum": (lambda: P.Krum(2, device=CPU), lambda: J.Krum(2), 1e-6, 1e-7, "incremental"),
    "cge": (lambda: P.ComparativeGradientElimination(2, device=CPU),
            lambda: J.ComparativeGradientElimination(2), 1e-6, 1e-7, "incremental"),
    "monna": (lambda: P.MoNNA(2, reference_index=1, device=CPU),
              lambda: J.MoNNA(2, reference_index=1), 1e-6, 1e-7, "slot"),
    "geometric_median": (lambda: P.GeometricMedian(device=CPU), J.GeometricMedian, 1e-4, 1e-5,
                         "slot"),
    "centered_clipping": (lambda: P.CenteredClipping(c_tau=1.0, device=CPU),
                          lambda: J.CenteredClipping(c_tau=1.0), 1e-4, 1e-5, "slot"),
    "caf": (lambda: P.CAF(2, v_init=_jax_caf_draw(D), device=CPU), lambda: J.CAF(2), 1e-4, 1e-5,
            "slot"),
}


# ---------------------------------------------------------------------------
# utils/trees: the structures the classes take
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_stack_gradients_takes_plain_tensors_of_any_rank(rank):
    """A list of plain tensors stacks to (n, d) and unravels to one input's
    shape (an IndexError on 1-D tensors before the classes were ported)."""
    shape = (3, 2, 2)[:rank]
    m, unravel = stack_gradients([torch.ones(shape), torch.zeros(shape)])
    assert m.shape == (2, int(np.prod(shape)))
    assert unravel(m[0]).shape == shape
    assert torch.equal(unravel(m[0]), torch.ones(shape))
    ref, _ = jtrees.stack_gradients([jnp.ones(shape), jnp.zeros(shape)])
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref))


def test_stack_gradients_nested_structures_round_trip():
    """Nested dictionaries, lists and tuples round-trip leaf for leaf; a
    dictionary is read by the first gradient's keys, whatever its own key
    order; numpy leaves become tensors on the requested device."""
    rows = _rows(1, n=3)
    grads = [{"z": {"b": torch.from_numpy(r[:4]), "a": (torch.from_numpy(r[4:10].reshape(2, 3)),)},
              "y": [r[10:12]]} for r in rows]
    grads[2] = {"y": grads[2]["y"], "z": {"a": grads[2]["z"]["a"], "b": grads[2]["z"]["b"]}}
    m, unravel = stack_gradients(grads, device=CPU)
    assert m.shape == (3, 12) and m.dtype == torch.float32
    for g, back in zip(grads, unstack_rows(m, unravel)):
        assert list(back) == ["z", "y"] and list(back["z"]) == ["b", "a"]
        assert isinstance(back["z"]["a"], tuple) and isinstance(back["y"], list)
        assert torch.equal(back["z"]["b"], g["z"]["b"])
        assert torch.equal(back["z"]["a"][0], g["z"]["a"][0])
        np.testing.assert_array_equal(back["y"][0].numpy(), g["y"][0])
    with pytest.raises(ValueError, match="same structure"):
        stack_gradients([{"w": torch.zeros(3)}, [torch.zeros(3)]])


def test_stack_gradients_dtypes():
    """Rows that are not floating become float32 (``trees.py:56-57``);
    mixed leaf dtypes promote and unravel casts each floating leaf back."""
    m, _ = stack_gradients([np.arange(3, dtype=np.int32), np.ones(3, np.int32)])
    assert m.dtype == torch.float32
    g = {"h": torch.ones(2, dtype=torch.bfloat16), "s": torch.ones(1)}
    m, unravel = stack_gradients([g, g])
    assert m.dtype == torch.float32
    back = unravel(m[0])
    assert back["h"].dtype == torch.bfloat16 and back["s"].dtype == torch.float32
    row, unravel = ravel_gradient(np.arange(4, dtype=np.int64).reshape(2, 2), CPU)
    assert row.dtype == torch.float32 and unravel(row).shape == (2, 2)


# ---------------------------------------------------------------------------
# aggregate, aggregate_stream
# ---------------------------------------------------------------------------


def _assert_close(ours: np.ndarray, ref: np.ndarray, rtol: float, atol: float) -> None:
    if rtol == 0 and atol == 0:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", INPUT_KINDS)
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_aggregate_matches_jax_class(name, kind):
    """``aggregate`` returns the structure of one input, on the class's
    device, within the class's tolerance of the JAX class."""
    make, make_jax, rtol, atol, _ = CLASSES[name]
    ours_in, jax_in = _inputs(kind, _rows(3))
    out = make().aggregate(ours_in)
    ref = make_jax().aggregate(jax_in)
    if kind == "nested_dicts":
        assert list(out) == ["a", "b"] and out["a"].shape == (4, 5)
        assert out["b"]["c"].shape == (13,) and out["b"]["d"][0].shape == (8, 20)
    else:
        assert isinstance(out, torch.Tensor) and out.shape == (D,)
    assert all(t.device.type == "cpu" for t in jax.tree_util.tree_leaves(out))
    _assert_close(_flat_port(out), _flat_jax(ref), rtol, atol)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_aggregate_stream_equals_per_round_aggregate(name):
    """``aggregate_stream`` over K = 3 rounds equals ``aggregate`` of each
    round (the same kernels' plain versions, round by round), and the JAX
    class's stream within the class's tolerance."""
    make, make_jax, rtol, atol, _ = CLASSES[name]
    agg = make()
    rounds = [_rows(10 + k) for k in range(3)]
    outs = agg.aggregate_stream([[torch.from_numpy(r) for r in rs] for rs in rounds])
    refs = make_jax().aggregate_stream([[jnp.asarray(r) for r in rs] for rs in rounds])
    assert len(outs) == 3 and agg.aggregate_stream([]) == []
    for rs, out, ref in zip(rounds, outs, refs):
        np.testing.assert_array_equal(out.numpy(), agg.aggregate(rs).numpy())
        _assert_close(out.numpy(), np.asarray(ref), rtol, atol)


# ---------------------------------------------------------------------------
# arrival-order folds
# ---------------------------------------------------------------------------


def _fold(agg, grads, order, n=N):
    state = agg.fold_init(n)
    for i in order:
        agg.fold(state, i, grads[i])
    return agg.fold_finalize(state), state


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_fold_matches_aggregate_and_jax_fold(name):
    """Three shuffled arrival orders: bitwise equal to the class's own
    ``aggregate`` for the slot-buffer folds, within rtol 1e-5, atol 1e-6
    for the incremental ones; against the JAX class fed the same order
    within the larger of that and the class's tolerance."""
    make, make_jax, rtol, atol, fold_kind = CLASSES[name]
    agg, jagg = make(), make_jax()
    grads = _rows(4)
    ref = agg.aggregate([torch.from_numpy(g) for g in grads]).numpy()
    jgrads = [jnp.asarray(g) for g in grads]
    for trial in range(3):
        order = list(range(N))
        random.Random(trial).shuffle(order)
        out, _ = _fold(agg, [torch.from_numpy(g) for g in grads], order)
        jout, _ = _fold(jagg, jgrads, order)
        if fold_kind == "slot":
            np.testing.assert_array_equal(out.numpy(), ref)
            _assert_close(out.numpy(), np.asarray(jout), rtol, atol)
        else:
            np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=max(rtol, 1e-5),
                                       atol=max(atol, 1e-6))


@pytest.mark.parametrize("name", ["median", "trimmed_mean", "multi_krum", "cge"])
def test_fold_takes_nested_gradients(name):
    """Each kind of fold state (slot buffer, extremes, Gram, norms) takes
    nested gradients and returns their structure."""
    make, _, _, _, _ = CLASSES[name]
    agg = make()
    grads = [jax.tree_util.tree_map(torch.from_numpy, _nest(r)) for r in _rows(5)]
    out, _ = _fold(agg, grads, [3, 0, 8, 1, 2, 7, 6, 5, 4])
    ref = agg.aggregate(grads)
    assert out["b"]["d"][0].shape == (8, 20)
    np.testing.assert_allclose(_flat_port(out), _flat_port(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("slots", [(0, 2, 3, 5, 8), (1, 2, 4, 5, 6, 7, 8)])
@pytest.mark.parametrize("which", ["multi_krum", "krum"])
def test_multi_krum_partial_round(which, slots):
    """m < n gradients folded into an n-slot state: the finalize gathers the
    arrived slots (rows and Gram entries) in slot order, matching
    ``aggregate`` of those rows and the JAX fold's partial round."""
    make, make_jax, _, _, _ = CLASSES[which]
    agg, jagg = make(), make_jax()
    grads = _rows(6)
    order = list(slots)
    random.Random(7).shuffle(order)
    out, state = _fold(agg, [torch.from_numpy(g) for g in grads], order)
    jout, _ = _fold(jagg, [jnp.asarray(g) for g in grads], order)
    assert state.slots.filled == len(slots) and state.gram.dtype == torch.float32
    ref = agg.aggregate([torch.from_numpy(grads[i]) for i in slots]).numpy()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)


def test_multi_krum_partial_round_validates_m():
    agg = P.MultiKrum(2, 3, device=CPU)
    state = agg.fold_init(N)
    for i in (4, 1, 6):
        agg.fold(state, i, _rows(0)[i])
    with pytest.raises(ValueError, match="f must satisfy 0 <= f < n-1"):
        agg.fold_finalize(state)


def test_trimmed_mean_nonfinite_fold_falls_back_bitwise():
    """An inf entry and a NaN entry in the fold: finalize reruns the exact
    sorted path on the kept rows, bitwise equal to ``aggregate`` and
    within the class's tolerance of the JAX fold; two NaN in a column
    outlast f = 1 and give NaN in both."""
    agg = P.CoordinateWiseTrimmedMean(1, device=CPU)
    jagg = J.CoordinateWiseTrimmedMean(1)
    grads = _rows(1, n=5)
    grads[2] = grads[2].copy()
    grads[2][7] = np.inf
    grads[3] = grads[3].copy()
    grads[3][11] = np.nan
    grads[4] = grads[4].copy()
    grads[4][13] = grads[1][13] = np.nan
    ref = agg.aggregate([torch.from_numpy(g) for g in grads]).numpy()
    out, state = _fold(agg, [torch.from_numpy(g) for g in grads], [4, 2, 0, 3, 1], n=5)
    jout, _ = _fold(jagg, [jnp.asarray(g) for g in grads], [4, 2, 0, 3, 1], n=5)
    assert bool(state.nonfinite)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref.view(np.uint32))
    # f = 1 trims a column's one NaN (it sorts last) and its one inf
    assert torch.isnan(out[13]) and np.isnan(np.asarray(jout)[13])
    assert int(torch.isnan(out).sum()) == 1
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-7)


def test_trimmed_mean_finite_fold_takes_the_extremes_path():
    agg = P.CoordinateWiseTrimmedMean(2, device=CPU)
    grads = [torch.from_numpy(g) for g in _rows(2)]
    out, state = _fold(agg, grads, list(range(N))[::-1])
    assert not bool(state.nonfinite)
    assert state.low.shape == (2, D) and state.high.shape == (2, D)
    srt = torch.sort(torch.stack(grads), dim=0).values
    assert torch.equal(state.low, srt[:2]) and torch.equal(state.high, srt[-2:])
    np.testing.assert_allclose(out.numpy(), robust.trimmed_mean(torch.stack(grads), f=2).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["median", "trimmed_mean", "multi_krum", "cge"])
def test_fold_slot_reuse_and_bounds_rejected(name):
    agg = CLASSES[name][0]()
    grads = _rows(n=5)
    state = agg.fold_init(5)
    agg.fold(state, 0, grads[0])
    with pytest.raises(ValueError, match="folded twice"):
        agg.fold(state, 0, grads[1])
    with pytest.raises(IndexError, match="outside"):
        agg.fold(state, 5, grads[1])
    with pytest.raises(IndexError, match="outside"):
        agg.fold(state, -1, grads[1])
    with pytest.raises(ValueError, match="same length"):
        agg.fold(state, 1, grads[1][:-1])
    with pytest.raises(ValueError, match="n >= 1"):
        agg.fold_init(0)


def _mixed_rows(seed=8, n=5):
    """(port rows, JAX rows): f32 at even slots, bf16 at odd ones."""
    grads = _rows(seed, n=n)
    port = [torch.from_numpy(g).to(torch.bfloat16) if i % 2 else torch.from_numpy(g)
            for i, g in enumerate(grads)]
    ref = [jnp.asarray(g, dtype=jnp.bfloat16) if i % 2 else jnp.asarray(g)
           for i, g in enumerate(grads)]
    return port, ref


def test_slot_fold_mixed_dtypes_promote_as_torch_stack():
    """A round whose rows arrive in two dtypes, a bf16 row first: the slot
    buffer is promoted in place as ``torch.stack`` promotes the barrier
    matrix (bitwise equal to ``aggregate``); the Gram fold shares that
    buffer and keeps an f32 Gram."""
    mixed, _ = _mixed_rows()
    med = P.CoordinateWiseMedian(device=CPU)
    out, state = _fold(med, mixed, [1, 0, 3, 2, 4], n=5)
    assert state.buffer.dtype == torch.float32 and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), med.aggregate(mixed).numpy())
    mk = P.MultiKrum(1, 2, device=CPU)
    out, state = _fold(mk, mixed, [1, 0, 3, 2, 4], n=5)
    assert state.slots.buffer.dtype == torch.float32 and state.gram.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), mk.aggregate(mixed).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("order", [[1, 0, 3, 2, 4], [0, 1, 2, 3, 4], [3, 4, 1, 2, 0]])
def test_trimmed_mean_fold_mixed_dtypes_promote(order):
    """The extremes fold promotes its running sum and extreme buffers with
    the slot buffer when a wider row arrives, so a bf16 row ahead of f32
    rows rounds none of them to bf16: an f32 result within rtol 1e-5, atol
    1e-6 of ``aggregate`` and of the JAX fold fed the same order. (Two
    bf16 rows ahead of every f32 row are summed in bf16, by both folds.)"""
    mixed, jmixed = _mixed_rows()
    agg = P.CoordinateWiseTrimmedMean(1, device=CPU)
    out, state = _fold(agg, mixed, order, n=5)
    assert not bool(state.nonfinite) and out.dtype == torch.float32
    assert state.total.dtype == state.low.dtype == state.high.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), agg.aggregate(mixed).numpy(), rtol=1e-5, atol=1e-6)
    jout, _ = _fold(J.CoordinateWiseTrimmedMean(1), jmixed, order, n=5)
    assert jout.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)


def test_multi_krum_bf16_fold_keeps_an_f32_gram():
    """16-bit rows fold into an f32 Gram (a bf16 matvec would round the
    dot products to bf16): within f32 rounding of the float64 Gram of the
    bf16 rows."""
    rows = [torch.from_numpy(g).to(torch.bfloat16) for g in _rows(9)]
    agg = P.MultiKrum(2, 3, device=CPU)
    out, state = _fold(agg, rows, [5, 3, 8, 0, 1, 7, 2, 6, 4])
    assert state.gram.dtype == torch.float32 and out.dtype == torch.bfloat16
    x64 = torch.stack(rows).double()
    norms = x64.norm(dim=1)
    assert torch.all((state.gram.double() - x64 @ x64.T).abs() <= 1e-6 * norms[:, None] * norms[None])


# ---------------------------------------------------------------------------
# constructors, validate_n, the operator protocol, devices
# ---------------------------------------------------------------------------

# (port constructor, JAX constructor, n); both must raise the same message
VALIDATE_N = [
    (lambda: P.MultiKrum(3, 1, device=CPU), lambda: J.MultiKrum(3, 1), 4),
    (lambda: P.MultiKrum(1, 4, device=CPU), lambda: J.MultiKrum(1, 4), 4),
    (lambda: P.Krum(3, device=CPU), lambda: J.Krum(3), 4),
    (lambda: P.CoordinateWiseTrimmedMean(2, device=CPU), lambda: J.CoordinateWiseTrimmedMean(2), 4),
    (lambda: P.MeanOfMedians(4, device=CPU), lambda: J.MeanOfMedians(4), 4),
    (lambda: P.ComparativeGradientElimination(4, device=CPU),
     lambda: J.ComparativeGradientElimination(4), 4),
    (lambda: P.MoNNA(2, device=CPU), lambda: J.MoNNA(2), 4),
    (lambda: P.MoNNA(1, reference_index=4, device=CPU), lambda: J.MoNNA(1, reference_index=4), 4),
    (lambda: P.CAF(2, device=CPU), lambda: J.CAF(2), 4),
    (lambda: PP.NearestNeighborMixing(4, device=CPU), lambda: JP.NearestNeighborMixing(4), 4),
    (lambda: PP.ARC(5, device=CPU), lambda: JP.ARC(5), 4),
]


@pytest.mark.parametrize("case", range(len(VALIDATE_N)))
def test_validate_n_messages_match_jax(case):
    ours_ctor, ref_ctor, n = VALIDATE_N[case]
    with pytest.raises(ValueError) as ours:
        ours_ctor().validate_n(n)
    with pytest.raises(ValueError) as ref:
        ref_ctor().validate_n(n)
    assert str(ours.value) == str(ref.value)


BAD_CONSTRUCTORS = [
    ("MultiKrum", (-1, 2), {}), ("MultiKrum", (1, 0), {}), ("MultiKrum", (1, 2), {"chunk_size": 0}),
    ("Krum", (-1,), {}), ("CoordinateWiseMedian", (), {"chunk_size": 0}),
    ("CoordinateWiseTrimmedMean", (-1,), {}), ("MeanOfMedians", (-2,), {}),
    ("ComparativeGradientElimination", (1,), {"chunk_size": -3}),
    ("MoNNA", (1,), {"reference_index": -1}), ("GeometricMedian", (), {"tol": 0.0}),
    ("GeometricMedian", (), {"init": "zero"}), ("CenteredClipping", (), {"c_tau": -1.0}),
    ("CenteredClipping", (), {"c_tau": 1.0, "M": 0}), ("CAF", (1,), {"power_iters": 0}),
    ("Clipping", (-1.0,), {}), ("ARC", (-1,), {}), ("Bucketing", (0,), {}),
    ("NearestNeighborMixing", (-1,), {}),
]


# (class, positional arguments, its default chunk_size)
CHUNKED = [(P.MultiKrum, (1, 2), 32), (P.Krum, (1,), 32), (P.MoNNA, (1,), 32),
           (P.ComparativeGradientElimination, (1,), 32), (P.CoordinateWiseMedian, (), 8192),
           (P.CoordinateWiseTrimmedMean, (1,), 8192), (P.MeanOfMedians, (1,), 8192)]


@pytest.mark.parametrize("cls,args,default", CHUNKED, ids=lambda c: getattr(c, "__name__", None))
def test_chunk_size_other_than_default_raises(cls, args, default):
    """``chunk_size`` sizes the pool subtasks: a value other than the
    default is accepted, and the class fans out the JAX class's subtasks,
    as many and with the same names, without a pool (the configured size)
    and at a pool of 4 (the adaptive size)."""
    assert cls(*args, device=CPU).chunk_size == default
    ours, ref = cls(*args, chunk_size=7, device=CPU), getattr(J, cls.__name__)(*args, chunk_size=7)
    assert ours.chunk_size == 7
    rows = _rows(3)
    for pool_size in (0, 4):
        md = {"pool_size": pool_size}
        mine = list(ours.create_subtasks({"gradients": [torch.from_numpy(r) for r in rows]},
                                         context=OpContext("agg", md)))
        theirs = list(ref.create_subtasks({"gradients": [jnp.asarray(r) for r in rows]},
                                          context=JOpContext("agg", md)))
        assert [t.name for t in mine] == [t.name for t in theirs]
        assert len(mine) > 1


@pytest.mark.parametrize("cls,args,kwargs", BAD_CONSTRUCTORS)
def test_constructor_errors_match_jax(cls, args, kwargs):
    port_mod, jax_mod = (PP, JP) if hasattr(PP, cls) else (P, J)
    with pytest.raises(ValueError) as ours:
        getattr(port_mod, cls)(*args, **kwargs, device=CPU)
    with pytest.raises(ValueError) as ref:
        getattr(jax_mod, cls)(*args, **kwargs)
    assert str(ours.value) == str(ref.value)


ALL_CLASSES = [P.CoordinateWiseMedian, P.CoordinateWiseTrimmedMean, P.MeanOfMedians, P.MultiKrum,
               P.Krum, P.MoNNA, P.GeometricMedian, P.CenteredClipping,
               P.ComparativeGradientElimination, P.CAF, PP.Clipping, PP.ARC, PP.Bucketing,
               PP.NearestNeighborMixing]
ARGS = {P.CoordinateWiseTrimmedMean: (1,), P.MeanOfMedians: (1,), P.MultiKrum: (1, 2), P.Krum: (1,),
        P.MoNNA: (1,), P.ComparativeGradientElimination: (1,), P.CAF: (1,), PP.Clipping: (1.0,),
        PP.ARC: (1,), PP.Bucketing: (2,), PP.NearestNeighborMixing: (1,)}
KWARGS = {P.CenteredClipping: {"c_tau": 1.0}}


@pytest.mark.parametrize("cls", ALL_CLASSES, ids=lambda c: c.__name__)
def test_classes_default_to_cuda_and_keep_the_jax_names(cls, monkeypatch):
    """Every class has the JAX class's name and subtask flags (fan-out,
    barriered), and resolves ``device=None`` to the card: without one it
    raises, and ``device="cpu"`` is the caller's explicit choice."""
    args, kwargs = ARGS.get(cls, ()), KWARGS.get(cls, {})
    jcls = getattr(JP if cls.__module__.startswith("byzpy_tpu_torch.pre") else J, cls.__name__)
    ours = cls(*args, **kwargs, device=CPU)
    assert ours.name == jcls(*args, **kwargs).name
    assert ours.device == torch.device("cpu")
    assert ours.supports_subtasks == jcls.supports_subtasks
    assert ours.supports_barriered_subtasks == jcls.supports_barriered_subtasks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(*args, **kwargs)


def test_operator_protocol():
    """``compute`` reads the input key; ``run`` without a pool computes, and
    on a ``thread`` pool of two fans out the Krum row scores, selects the
    direct path's rows and averages them as the direct path does (B4's
    row sweep): the direct result, bit for bit."""
    agg = P.MultiKrum(1, 2, device=CPU)
    grads = [torch.from_numpy(g) for g in _rows(0, n=5)]
    ctx = OpContext(node_name="agg")
    direct = agg.aggregate(grads)
    assert torch.equal(agg.compute({"gradients": grads}, context=ctx), direct)
    assert torch.equal(asyncio.run(agg.run({"gradients": grads}, context=ctx, pool=None)), direct)

    async def pooled():
        async with ActorPool(ActorPoolConfig(backend="thread", count=2)) as pool:
            pctx = OpContext(node_name="agg", metadata={"pool_size": pool.size})
            return await asyncio.wait_for(agg.run({"gradients": grads}, context=pctx, pool=pool), 60)

    assert torch.equal(asyncio.run(pooled()), direct)
    with pytest.raises(KeyError, match="gradients"):
        agg.compute({"vectors": grads}, context=ctx)
    with pytest.raises(TypeError, match="sequence"):
        agg.compute({"gradients": 3}, context=ctx)
    assert agg.matrix_fn()(torch.stack(grads)).shape == (D,)
    pre = PP.Clipping(1.0, device=CPU)
    assert len(pre.compute({"vectors": grads}, context=ctx)) == 5


def test_caf_seed_draws_from_a_torch_generator():
    """CAF without ``v_init`` draws its start from a ``torch.Generator``
    seeded with ``seed``: the same draw on every call."""
    grads = [torch.from_numpy(g) for g in _rows(2)]
    x = torch.stack(grads)
    v = torch.randn((D,), generator=torch.Generator().manual_seed(5))
    agg = P.CAF(2, seed=5, device=CPU)
    out = agg.aggregate(grads)
    np.testing.assert_array_equal(out.numpy(), robust.caf(x, f=2, v_init=v).numpy())
    np.testing.assert_array_equal(agg.aggregate(grads).numpy(), out.numpy())


# ---------------------------------------------------------------------------
# fused pipelines
# ---------------------------------------------------------------------------


class _MyMultiKrum(P.MultiKrum):
    pass


class _MyNNM(PP.NearestNeighborMixing):
    pass


PIPELINES = {
    "nnm": (lambda: PP.NearestNeighborMixing(2, device=CPU), lambda: JP.NearestNeighborMixing(2)),
    "clip": (lambda: PP.Clipping(12.0, device=CPU), lambda: JP.Clipping(12.0)),
    "arc": (lambda: PP.ARC(2, device=CPU), lambda: JP.ARC(2)),
}


@pytest.mark.parametrize("krum", ["multi_krum", "krum"])
@pytest.mark.parametrize("pre", sorted(PIPELINES))
def test_fused_pipeline_for_exact_types(pre, krum):
    """Exact types give the fused callable: within rtol 1e-5, atol 1e-6 of
    the JAX package's fused callable on the same matrix."""
    make_pre, make_jpre = PIPELINES[pre]
    make_agg, make_jagg = CLASSES[krum][:2]
    fn = fused_pipeline_matrix_fn(make_pre(), make_agg())
    jfn = jax_fused(make_jpre(), make_jagg())
    assert fn is not None and jfn is not None
    x = np.stack(_rows(11)) * np.linspace(0.5, 2.0, N, dtype=np.float32)[:, None]
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), np.asarray(jfn(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pair", ["subclass_agg", "subclass_pre", "clip_zero", "other_agg",
                                  "bucketing"])
def test_fused_pipeline_none(pair):
    """A subclass (whose hooks a fused kernel would bypass), Clipping(0),
    an aggregator or pre-aggregator without a fused kernel: ``None``."""
    pre, agg = {
        "subclass_agg": (PP.NearestNeighborMixing(1, device=CPU), _MyMultiKrum(1, 2, device=CPU)),
        "subclass_pre": (_MyNNM(1, device=CPU), P.MultiKrum(1, 2, device=CPU)),
        "clip_zero": (PP.Clipping(0.0, device=CPU), P.MultiKrum(1, 2, device=CPU)),
        "other_agg": (PP.NearestNeighborMixing(1, device=CPU), P.CoordinateWiseMedian(device=CPU)),
        "bucketing": (PP.Bucketing(2, device=CPU), P.Krum(1, device=CPU)),
    }[pair]
    assert fused_pipeline_matrix_fn(pre, agg) is None


# ---------------------------------------------------------------------------
# pre-aggregators
# ---------------------------------------------------------------------------

PRE_CLASSES = {
    "clipping": (lambda: PP.Clipping(12.0, device=CPU), lambda: JP.Clipping(12.0), 9),
    "arc": (lambda: PP.ARC(2, device=CPU), lambda: JP.ARC(2), 9),
    "nnm": (lambda: PP.NearestNeighborMixing(2, device=CPU), lambda: JP.NearestNeighborMixing(2), 9),
    "bucketing": (lambda: PP.Bucketing(2, perm=[3, 1, 4, 0, 8, 5, 2, 7, 6], device=CPU),
                  lambda: JP.Bucketing(2, perm=[3, 1, 4, 0, 8, 5, 2, 7, 6]), 5),
}


@pytest.mark.parametrize("kind", ["tensors_1d", "nested_dicts"])
@pytest.mark.parametrize("name", sorted(PRE_CLASSES))
def test_pre_aggregate_matches_jax_class(name, kind):
    """Each pre-aggregator returns a list of gradients shaped like the
    inputs (bucketing: one per bucket) within rtol 1e-5, atol 1e-6 of the
    JAX class (``tests/test_torch_preagg.py``'s tolerance); its stream
    equals its per-round transform."""
    make, make_jax, m = PRE_CLASSES[name]
    rows = [r * s for r, s in zip(_rows(12), np.linspace(0.5, 2.0, N, dtype=np.float32))]
    ours_in, jax_in = _inputs(kind, rows)
    outs, refs = make().pre_aggregate(ours_in), make_jax().pre_aggregate(jax_in)
    assert len(outs) == len(refs) == m
    for out, ref in zip(outs, refs):
        if kind == "nested_dicts":
            assert out["b"]["d"][0].shape == (8, 20)
        np.testing.assert_allclose(_flat_port(out), _flat_jax(ref), rtol=1e-5, atol=1e-6)
    pre = make()
    stream = pre.pre_aggregate_stream([ours_in, ours_in])
    assert len(stream) == 2 and pre.pre_aggregate_stream([]) == []
    for a, b in zip(stream[1], make().pre_aggregate(ours_in)):
        np.testing.assert_array_equal(_flat_port(a), _flat_port(b))


def test_bucketing_permutations():
    """An explicit ``perm`` of the wrong length raises the JAX message;
    without one the class draws ``torch.randperm`` from its generator, a
    fresh permutation each call."""
    grads = [torch.from_numpy(g) for g in _rows(0, n=6)]
    with pytest.raises(ValueError) as ours:
        PP.Bucketing(2, perm=[0, 1, 2], device=CPU).pre_aggregate(grads)
    with pytest.raises(ValueError) as ref:
        JP.Bucketing(2, perm=[0, 1, 2]).pre_aggregate([g.numpy() for g in grads])
    assert str(ours.value) == str(ref.value)
    b = PP.Bucketing(3, seed=4, device=CPU)
    gen = torch.Generator().manual_seed(4)
    x = torch.stack(grads)
    for _ in range(2):
        perm = torch.randperm(6, generator=gen)
        expect = x[perm].reshape(2, 3, D).mean(dim=1)
        out = torch.stack(b.pre_aggregate(grads))
        np.testing.assert_allclose(out.numpy(), expect.numpy(), rtol=1e-6, atol=1e-7)
