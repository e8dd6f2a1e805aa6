"""The column-sort engine of B1 and the segmented sort-reduce
(``csrc/column_sort.cuh``), on the CPU.

* ``kernels.column_runs``, the rule that splits a slot's column tiles into
  the runs a block walks: every tile in exactly one run, no run empty, the
  grid inside the card's launch limits, about one wave of blocks a slot;
* the 16-bit sort keys the engine keeps for bf16 and f16 rows: over every
  bit pattern, they order as the f32 keys of the up-cast values do and map
  back to the same f32 values, so the sorted sequence and the reduce's
  input are those of the f32 keys;
* B1's plain version against the Pallas kernel (interpret mode) at the
  shapes the ring adds: f16 rows, odd d, n at and past each network width.

``tests/test_torch_cuda.py -k "sorted_reduce or segmented or column_sort"``
holds the kernels to their plain versions on the card, at the runs this
rule picks and at others.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzpy_tpu.ops import pallas_kernels as pk
from byzpy_tpu_torch.ops import kernels

H100_SMS = 132
GRID_X_MAX = 2**31 - 1


@pytest.mark.parametrize("sms", [1, 78, H100_SMS, 5 * H100_SMS])
@pytest.mark.parametrize("d", [1, 37, 128, 129, 50_001, 421_642, 1_048_576, 2**31 - 1])
def test_column_runs_cover_every_tile_once_inside_the_grid(d, sms):
    t, runs = kernels.column_runs(d, sms)
    tiles = -(-d // kernels._SORT_TILE)
    assert t >= 1 and runs >= 1
    # run r takes tiles [r t, min((r + 1) t, tiles)): all of them, none empty
    assert runs * t >= tiles and (runs - 1) * t < tiles
    covered = np.zeros(min(tiles, 10_000), dtype=np.int64)
    for r in range(runs):
        lo, hi = r * t, min((r + 1) * t, tiles)
        assert lo < hi
        covered[min(lo, len(covered)):min(hi, len(covered))] += 1
    assert (covered == 1).all()
    assert runs <= GRID_X_MAX
    # a slot's runs fill at most one wave of resident blocks, and more than
    # half of it unless the tiles run out first
    want = kernels._SORT_BLOCKS_PER_SM * sms
    if tiles <= want:
        assert (t, runs) == (1, tiles)
    else:
        assert want / 2 < runs <= want


def test_column_runs_at_the_timed_shapes():
    """The runs of the shapes chip_smoke.py times, on the H100's 132 SMs at
    the kernels' three blocks an SM: the main path's 8 x 421,642 round
    (3,295 tiles) and the headline's 1,048,576 columns, one wave of blocks a
    slot."""
    assert kernels.column_runs(421_642, H100_SMS) == (9, 367)
    assert kernels.column_runs(1_048_576, H100_SMS) == (21, 391)


@pytest.mark.parametrize("args", [(0, 1), (10, 0)])
def test_column_runs_reject_empty_sizes(args):
    with pytest.raises(ValueError):
        kernels.column_runs(*args)


# bits of +inf and of the canonical quiet NaN, by 16-bit dtype
KEYS16 = {torch.bfloat16: (0x7F80, 0x7FC0), torch.float16: (0x7C00, 0x7E00)}


def _keys16(bits: np.ndarray, dtype) -> np.ndarray:
    """column_sort.cuh:Keys16::raw: NaN to the canonical quiet NaN, then the
    magnitude bits of negatives flipped, as an int32."""
    inf, qnan = KEYS16[dtype]
    v = bits.astype(np.int16).astype(np.int32)
    v = np.where((v & 0x7FFF) > inf, qnan, v)
    return np.where(v < 0, v ^ 0x7FFF, v)


def _keys16_bits(keys: np.ndarray) -> np.ndarray:
    """column_sort.cuh:Keys16::bits, the dtype's bits of a key."""
    return np.where(keys < 0, keys ^ 0x7FFF, keys).astype(np.uint16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_16_bit_keys_order_as_the_f32_keys_of_the_up_cast(dtype):
    bits = np.arange(1 << 16, dtype=np.uint16)
    vals = torch.from_numpy(bits.view(np.int16).copy()).view(dtype)
    k32 = kernels.float_sort_keys(vals.float()).numpy().astype(np.int64)
    k16 = _keys16(bits, dtype).astype(np.int64)
    # one order: sorting by either key sorts the other, and equal keys are
    # equal keys (every NaN is the one canonical key in both)
    order = np.argsort(k16, kind="stable")
    assert (np.diff(k32[order]) >= 0).all()
    assert ((np.diff(k16[order]) == 0) == (np.diff(k32[order]) == 0)).all()
    # and a key maps back to the f32 value of the f32 key, bit for bit
    back = torch.from_numpy(_keys16_bits(k16).view(np.int16).copy()).view(dtype).float()
    want = kernels.keys_to_float(torch.from_numpy(k32.astype(np.int32)))
    assert torch.equal(back.view(torch.int32), want.view(torch.int32))


def _matrix(rng, shape):
    """Normal rows; a NaN, a +-inf pair and a -0.0 column where n allows."""
    x = rng.normal(size=shape).astype(np.float32)
    if shape[1] >= 2:
        x[:, 0, 1] = np.nan
        x[:, 1, 2] = np.inf
        x[:, 0, 3] = -np.inf
        x[:, :, 5] = -0.0
    return x


@pytest.mark.parametrize("n", [1, 9, 33])
def test_sorted_reduce_f16_median_at_odd_d_bitwise(n):
    """B1's median of f16 rows (16-bit keys on the card) at odd d, whose
    rows start at every 2-byte alignment: bitwise the Pallas kernel."""
    x = _matrix(np.random.default_rng(n), (2, n, 301))
    ours = kernels.sorted_reduce_stream(torch.from_numpy(x).half(), mode="median")
    ref = pk.sorted_reduce_stream_pallas(jnp.asarray(x).astype(jnp.float16), mode="median", tile=128,
                                         interpret=True)
    assert ours.dtype == torch.float16
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))
