"""The ragged door's segmented sort-reduce (``kernels.segmented_sort_reduce``,
its plain version, ``ops.ragged.ragged_trimmed_mean`` / ``ragged_median``)
and the sort family's route, on the CPU.

The plain version is held bit for bit to the JAX package's segmented
programs (``byzpy_tpu/ops/ragged.py``, their plain ``lax.sort`` and
windowed ``einsum`` path) and to the port's masked door, cohort by cohort:
every value is a sorted input or an ascending f32 chain over the same
sorted values on all sides (d a multiple of 8: XLA:CPU's row einsum is one
FMA chain there). The kernel itself runs on the card only
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.ops import ragged as jragged
from byzpy_tpu_torch import aggregators as T
from byzpy_tpu_torch.ops import kernels, ragged, robust

D = 64

# name -> (cohort sizes, padding slots, spare capacity rows, data kind)
CASES = {
    "padding": ((5, 9, 7), 2, 3, "normal"),
    "one_row": ((1, 4, 3, 2), 1, 0, "normal"),
    "tight_f2": ((5, 8, 12), 0, 2, "normal"),
    "tight_f8": ((17, 20, 40), 1, 1, "normal"),
    "full_128": ((128,), 0, 0, "normal"),
    "ties": ((6, 13, 29, 64), 1, 16, "ties"),
}
# (case, f): every real cohort keeps 2f < m; m = 2f + 1 in the tight cases
TRIMMED = [("padding", 0), ("padding", 1), ("padding", 2), ("one_row", 0), ("tight_f2", 2),
           ("tight_f8", 8), ("full_128", 0), ("full_128", 8), ("ties", 0), ("ties", 2)]


def _batch(name, seed=0):
    """``(flat, seg, offsets, lengths, n_real)`` of one case as numpy."""
    sizes, pad, spare, kind = CASES[name]
    rng = np.random.default_rng(seed)
    C, fill = len(sizes) + pad, sum(sizes)
    flat = np.zeros((fill + spare, D), np.float32)
    seg = np.full(fill + spare, C, np.int32)
    offsets = np.full(C, fill, np.int32)
    lengths = np.zeros(C, np.int32)
    off = 0
    for c, m in enumerate(sizes):
        if kind == "ties":
            rows = rng.integers(-2, 3, size=(m, D)).astype(np.float32) * np.float32(0.375)
            rows[rng.random((m, D)) < 0.2] = -0.0
        else:
            rows = (rng.normal(size=(m, D)) * rng.uniform(0.1, 50.0, size=(m, 1))).astype(np.float32)
        flat[off:off + m], seg[off:off + m] = rows, c
        offsets[c], lengths[c] = off, m
        off += m
    return flat, seg, offsets, lengths, len(sizes)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("name,f", TRIMMED)
def test_plain_trimmed_mean_matches_jax_bitwise(name, f):
    flat, seg, offsets, lengths, n = _batch(name)
    got = kernels.segmented_sort_reduce_plain(*_t(flat, offsets, lengths), mode="trimmed", f=f)
    want = jragged.ragged_trimmed_mean(*_j(flat, seg, offsets, lengths), f=f, n_cohorts=len(offsets))
    np.testing.assert_array_equal(_bits(got[:n]), _bits(want)[:n])
    assert not got[n:].any(), "a padding slot gives zeros"


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_median_matches_jax_bitwise(name):
    flat, seg, offsets, lengths, n = _batch(name, seed=1)
    got = kernels.segmented_sort_reduce_plain(*_t(flat, offsets, lengths), mode="median")
    want = jragged.ragged_median(*_j(flat, seg, offsets, lengths), n_cohorts=len(offsets))
    np.testing.assert_array_equal(_bits(got[:n]), _bits(want)[:n])
    assert not got[n:].any(), "a padding slot gives zeros"


@pytest.mark.parametrize("name,f", TRIMMED + [(name, None) for name in sorted(CASES)])
def test_plain_equals_the_masked_door_per_cohort(name, f):
    """Each cohort's row is the masked program's aggregate of that cohort in
    the whole batch (``seg == c``), bit for bit."""
    flat, seg, offsets, lengths, n = _batch(name, seed=2)
    x, s = _t(flat, seg)
    mode = "median" if f is None else "trimmed"
    got = kernels.segmented_sort_reduce(*_t(flat, offsets, lengths), mode=mode, f=f or 0)
    for c in range(n):
        valid = s == c
        want = (robust.masked_coordinate_median(x, valid) if f is None
                else robust.masked_trimmed_mean(x, valid, f=f))
        assert torch.equal(got[c].view(torch.int32), want.view(torch.int32)), (name, c)


def test_the_segmented_programs_are_the_kernel_and_ignore_segment_sum():
    flat, seg, offsets, lengths, n = _batch("padding", seed=3)
    args = _t(flat, seg, offsets, lengths)

    def no_contraction(x, w):
        raise AssertionError("a sorted operand is no wire row: segment_sum is not read")

    tm = ragged.ragged_trimmed_mean(*args, f=1, n_cohorts=len(offsets), segment_sum=no_contraction)
    assert torch.equal(tm, kernels.segmented_sort_reduce_plain(*_t(flat, offsets, lengths),
                                                               mode="trimmed", f=1))
    med = ragged.ragged_median(*args, n_cohorts=len(offsets))
    assert torch.equal(med, kernels.segmented_sort_reduce_plain(*_t(flat, offsets, lengths),
                                                                mode="median"))


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(ragged, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(ragged, name, spy)
    return calls


@pytest.mark.parametrize("cls", ["trimmed", "median"])
def test_route_is_the_door_on_the_cpu_and_the_segmented_program_on_the_card(monkeypatch, cls):
    """The reference's ``_on_tpu()`` split: a CPU instance's ragged program
    is the generic masked door; an instance whose device is CUDA returns
    the segmented program (run here on CPU tensors, so through the plain
    version), and both give JAX's segmented bits."""
    make = {"trimmed": lambda: T.CoordinateWiseTrimmedMean(2, device="cpu"),
            "median": lambda: T.CoordinateWiseMedian(device="cpu")}[cls]
    segmented = {"trimmed": "ragged_trimmed_mean", "median": "ragged_median"}[cls]
    door_calls = _spy(monkeypatch, "ragged_via_masked")
    seg_calls = _spy(monkeypatch, segmented)
    flat, seg, offsets, lengths, n = _batch("ties", seed=4)
    args, C = _t(flat, seg, offsets, lengths), len(offsets)
    if cls == "trimmed":
        want = jragged.ragged_trimmed_mean(*_j(flat, seg, offsets, lengths), f=2, n_cohorts=C)
    else:
        want = jragged.ragged_median(*_j(flat, seg, offsets, lengths), n_cohorts=C)
    agg = make()
    on_cpu = agg.ragged_matrix_fn()(*args, n_cohorts=C)[0]
    assert door_calls == ["ragged_via_masked"] and seg_calls == []
    agg.device = torch.device("cuda")
    on_card, score, keep = agg.ragged_matrix_fn()(*args, n_cohorts=C)
    assert seg_calls == [segmented] and door_calls == ["ragged_via_masked"]
    assert score is None and keep is None and not agg.ragged_coalesce
    np.testing.assert_array_equal(_bits(on_card[:n]), _bits(want)[:n])
    np.testing.assert_array_equal(_bits(on_cpu[:n]), _bits(want)[:n])


def test_slots_of_length_zero_and_outside_the_rows():
    """A padding slot gives zeros whatever its offset; a slot whose rows
    leave ``[0, R)`` gives the canonical NaN; no cohort gives ``(0, d)``."""
    flat = torch.from_numpy(_batch("padding")[0])
    R = flat.shape[0]
    offsets = torch.tensor([0, R, R - 2, -1, 3], dtype=torch.int32)
    lengths = torch.tensor([4, 0, 3, 2, -1], dtype=torch.int32)
    for mode in ("trimmed", "median"):
        out = kernels.segmented_sort_reduce(flat, offsets, lengths, mode=mode, f=1)
        assert not out[1].any() and not torch.signbit(out[1]).any()
        assert (out[2:].view(torch.int32) == 0x7FC00000).all()
        want = kernels.segmented_sort_reduce(flat, offsets[:1], lengths[:1], mode=mode, f=1)
        assert torch.equal(out[0], want[0])
    empty = kernels.segmented_sort_reduce(flat, offsets[:0], lengths[:0], mode="median")
    assert tuple(empty.shape) == (0, D)


def test_nonfinite_rows_sort_as_the_keys_order_them():
    """On rows holding +-inf and NaN the plain version keeps the key order
    (-inf < finite < +inf < NaN): a NaN inside the window or the middle
    poisons the cohort's column, an inf trimmed away does not, and a row
    outside the cohort never enters it."""
    x = torch.zeros((7, 8))
    x[:5, 0] = torch.tensor([1.0, 2.0, 3.0, float("inf"), 4.0])
    x[:5, 1] = torch.tensor([1.0, float("nan"), 3.0, float("nan"), 4.0])
    x[:5, 2] = torch.tensor([float("-inf"), 2.0, float("inf"), 5.0, 4.0])
    x[5:, 3] = float("nan")  # the second cohort's rows
    offsets = torch.tensor([0, 5], dtype=torch.int32)
    lengths = torch.tensor([5, 2], dtype=torch.int32)
    tm = kernels.segmented_sort_reduce(x, offsets, lengths, mode="trimmed", f=1)
    third = torch.tensor(1.0) / 3
    assert tm[0, 0] == 9.0 * third and tm[0, 2] == 11.0 * third and tm[0, 3] == 0.0
    assert tm[0, 1].isnan() and tm[0, 1].view(torch.int32) == 0x7FC00000
    med = kernels.segmented_sort_reduce(x, offsets, lengths, mode="median")
    assert med[0, 0] == 3.0 and med[0, 1] == 4.0 and med[0, 2] == 4.0 and med[0, 3] == 0.0
    assert med[1, 3].isnan() and not med[1, :3].any()


def test_wrapper_checks_and_counts_nothing_on_the_cpu():
    flat, _, offsets, lengths, _ = _batch("padding")
    x, o, ln = _t(flat, offsets, lengths)
    before = dict(kernels.launch_counts)
    kernels.segmented_sort_reduce(x, o, ln, mode="trimmed", f=1)
    wide = torch.zeros((129, 8))
    kernels.segmented_sort_reduce(wide, o[:1], ln[:1], mode="median")  # the plain version has no cap
    assert kernels.launch_counts == before
    with pytest.raises(ValueError, match="float32"):
        kernels.segmented_sort_reduce(x.to(torch.bfloat16), o, ln, mode="median")
    with pytest.raises(ValueError, match="int32"):
        kernels.segmented_sort_reduce(x, o.long(), ln, mode="median")
    with pytest.raises(ValueError, match="lengths"):
        kernels.segmented_sort_reduce(x, o, ln[:-1], mode="median")
    with pytest.raises(ValueError, match="mode"):
        kernels.segmented_sort_reduce(x, o, ln, mode="mean")
    with pytest.raises(ValueError, match="f must be"):
        kernels.segmented_sort_reduce(x, o, ln, mode="trimmed", f=-1)
