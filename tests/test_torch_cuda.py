"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from byzpy_tpu_torch.ops import kernels


def _matrix(rng, shape, *, specials=True):
    """Normal data; with ``specials``, a few columns hold NaN / +-inf / -0."""
    x = rng.normal(size=shape).astype(np.float32)
    if specials:
        x[..., 0, 1] = np.nan
        x[..., 1, 2] = np.inf
        x[..., 0, 3] = -np.inf
        x[..., :2, 4] = [np.inf, -np.inf]
        x[..., :, 5] = -0.0
    return x


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
CANONICAL_NAN = {torch.float32: (torch.int32, 0x7FC00000), torch.bfloat16: (torch.int16, 0x7FC0),
                 torch.float16: (torch.int16, 0x7E00)}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality, NaN payloads included."""
    ints = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def _all_canonical_nan(t: torch.Tensor) -> bool:
    ints, bits = CANONICAL_NAN[t.dtype]
    return bool((t.view(ints) == torch.tensor(bits, dtype=torch.int64).to(ints)).all())


def _pre_rows(seed, K, n, d, device, dtype=torch.float32):
    """Normal rows, every third x5 so clipping engages (norms ~sqrt(d) and
    ~5 sqrt(d))."""
    x = _matrix(np.random.default_rng(seed), (K, n, d), specials=False)
    x[:, ::3] *= 5.0
    return torch.from_numpy(x).to(device, dtype)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [3, 8, 13, 64, 128])
def test_cuda_sorted_reduce_matches_plain(cuda_device, n, dt):
    x = torch.from_numpy(_matrix(np.random.default_rng(n), (2, n, 1000))).to(cuda_device, DTYPES[dt])
    med = kernels.sorted_reduce_stream(x, mode="median")
    ref = kernels.sorted_reduce_stream_plain(x, mode="median")
    assert torch.equal(med.view(torch.int16 if dt == "bf16" else torch.int32),
                       ref.view(torch.int16 if dt == "bf16" else torch.int32))
    f = (n - 1) // 3
    tm = kernels.sorted_reduce_stream(x, mode="trimmed", f=f)
    tref = kernels.sorted_reduce_stream_plain(x, mode="trimmed", f=f)
    torch.testing.assert_close(tm, tref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 16, 64, 128])
def test_cuda_gram_and_selection_match_plain(cuda_device, n):
    x = torch.from_numpy(_matrix(np.random.default_rng(n), (2, n, 5000), specials=False))
    x = x.to(cuda_device)
    g = kernels.gram(x)
    ref = kernels.gram_plain(x)
    norms = torch.linalg.vector_norm(x, dim=2)
    assert torch.all((g - ref).abs() <= 1e-5 * norms[:, :, None] * norms[:, None, :])
    assert torch.equal(g, g.transpose(1, 2))
    f, q = max(0, n // 4), max(1, n // 3)
    for mode in ("krum", "cge", "monna"):
        w = kernels.selection_weights(g, f=f, q=q, mode=mode)
        assert torch.equal(w, kernels.selection_weights_plain(g, f=f, q=q, mode=mode))
        out = kernels.weighted_rows(x, w)
        torch.testing.assert_close(out, kernels.weighted_rows_plain(x, w), rtol=0, atol=0)


# (n, K, d): every network width (n = 1 .. 128), one and three rounds, and
# d at the order's edges: no columns, one part-filled tile, a chunk short
# of 512, tails of 8, 9 and 11 columns past a tile, the SmallCNN width and
# one less; odd d puts 16-bit rows at odd elements, so row starts take
# every alignment
GRAM_ORDER_CASES = [(1, 1, 7), (1, 3, 421_642), (5, 3, 5001), (8, 1, 421_642), (8, 3, 0),
                    (13, 1, 421_641), (16, 1, 511), (16, 3, 5000), (17, 1, 7), (17, 3, 5003),
                    (64, 1, 421_641), (64, 3, 5000), (100, 1, 5001), (100, 3, 511),
                    (128, 1, 421_642), (128, 3, 5003)]


def _gram_order_equal(g: torch.Tensor, ref: torch.Tensor) -> bool:
    """Bit for bit, NaN at the same places (the card's NaN payload is its own)."""
    nan = torch.isnan(g)
    return bool(torch.equal(nan, torch.isnan(ref))
                and torch.equal(g[~nan].view(torch.int32), ref[~nan].view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,K,d", GRAM_ORDER_CASES)
def test_cuda_gram_equals_its_split_k_order_bitwise(cuda_device, n, K, d, dt):
    """B3 equals ``gram_split_k_plain`` at the card's chunking bit for bit,
    one launch a call and the same bits on every run: on rows holding NaN,
    +-inf and -0.0, with one row all NaN; and on a contiguous view 4 bytes
    into its storage, so every row starts 4 bytes off its usual alignment."""
    x = torch.from_numpy(_matrix(np.random.default_rng(n + K + d), (K, max(n, 2), max(d, 6)),
                                 specials=n >= 2)[:, :n, :d].copy()).to(cuda_device, DTYPES[dt])
    if n >= 5 and d:
        x[-1, n - 1] = float("nan")
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    chunk, _ = kernels.gram_chunks(d, K, sms)
    ref = kernels.gram_split_k_plain(x, chunk)
    if d == 0:
        assert torch.equal(kernels.gram(x), ref)
        return
    g = _count_one("gram", lambda: kernels.gram(x))
    assert _gram_order_equal(g, ref)
    for _ in range(2):
        assert torch.equal(kernels.gram(x).view(torch.int32), g.view(torch.int32))
    step = 4 // x.element_size()
    storage = torch.empty(x.numel() + step, dtype=x.dtype, device=cuda_device)
    shifted = storage[step:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != x.data_ptr() % 16
    assert torch.equal(_count_one("gram", lambda: kernels.gram(shifted)).view(torch.int32),
                       g.view(torch.int32))


@pytest.mark.cuda
def test_cuda_rejects_what_the_kernels_do_not_take(cuda_device):
    """n > 128 raises NotImplementedError; a strided tensor raises; nothing
    falls back to the plain version."""
    wide = torch.zeros((1, 129, 64), device=cuda_device)
    for call in (
        lambda: kernels.sorted_reduce_stream(wide),
        lambda: kernels.gram(wide),
        lambda: kernels.selection_mean_stream(wide, f=1, q=2),
    ):
        with pytest.raises(NotImplementedError):
            call()
    strided = torch.zeros((1, 64, 8), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.sorted_reduce_stream(strided)


@pytest.mark.cuda
def test_cuda_launch_counts_and_empty_inputs(cuda_device):
    kernels.reset_launch_counts()
    x = torch.randn((2, 8, 300), device=cuda_device)
    kernels.sorted_reduce_stream(x, mode="median")
    kernels.selection_mean_stream(x, f=2, q=3)
    expected = dict.fromkeys(kernels.launch_counts, 0)
    expected.update({"sorted_reduce:median": 1, "gram": 1, "selection_weights:krum": 1,
                     "weighted_rows": 1})
    assert kernels.launch_counts == expected
    # each wrapper counts its own launch when called directly
    w = kernels.selection_weights(kernels.gram(x), f=2, q=3, mode="cge")
    kernels.weighted_rows(x, w)
    assert kernels.launch_counts["gram"] == 2
    assert kernels.launch_counts["selection_weights:cge"] == 1
    assert kernels.launch_counts["weighted_rows"] == 2
    assert kernels.sorted_reduce_stream(torch.zeros((0, 8, 300), device=cuda_device)).shape == (0, 300)
    assert kernels.gram(torch.zeros((1, 8, 0), device=cuda_device)).abs().sum() == 0
    assert sum(kernels.launch_counts.values()) == 7


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 8, 300), (2, 8, 0)], ids=["K0", "d0"])
def test_cuda_empty_inputs_launch_nothing(cuda_device, shape):
    """K = 0 or d = 0 launches no kernel, so no count moves."""
    x = torch.zeros(shape, device=cuda_device)
    kernels.reset_launch_counts()
    for mode in ("krum", "cge", "monna"):
        assert kernels.selection_mean_stream(x, f=2, q=3, mode=mode).shape == (shape[0], shape[2])
    assert kernels.sorted_reduce_stream(x, mode="median").shape == (shape[0], shape[2])
    assert kernels.sorted_reduce_stream(x, mode="trimmed", f=2).shape == (shape[0], shape[2])
    assert kernels.gram(x).shape == (shape[0], 8, 8)
    assert kernels.weighted_rows(x, torch.zeros(shape[:2], device=cuda_device)).shape == (shape[0], shape[2])
    if shape[0] == 0:
        assert kernels.selection_weights(torch.zeros((0, 8, 8), device=cuda_device), f=2, q=3).shape == (0, 8)
    assert all(v == 0 for v in kernels.launch_counts.values())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["krum", "cge", "monna"])
def test_cuda_selection_never_picks_a_nan_row(cuda_device, mode):
    x = torch.from_numpy(_matrix(np.random.default_rng(5), (1, 13, 2000), specials=False))
    x[0, 4] = float("nan")
    x = x.to(cuda_device)
    g = kernels.gram(x)
    w = kernels.selection_weights(g, f=3, q=5, mode=mode, reference_index=1)
    assert float(w[0, 4]) == 0.0
    assert torch.equal(w, kernels.selection_weights_plain(g, f=3, q=5, mode=mode, reference_index=1))
    assert bool(torch.isfinite(kernels.selection_mean_stream(x, f=3, q=5, mode=mode, reference_index=1)).all())


# ---------------------------------------------------------------------------
# B8 NNM, B9 NNM -> selection mean, B10 clip / ARC -> selection mean
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [3, 8, 13, 64, 128])
def test_cuda_nnm_matches_plain(cuda_device, n, dt):
    """B8: the selection state equal to the plain version's on the same
    Gram; the mixing sweep bitwise equal to its plain version, alone and
    in the whole call."""
    x = _pre_rows(n, 2, n, 3000, cuda_device, DTYPES[dt])
    f = n // 4
    g = kernels.gram(x)
    mask, st = kernels.nnm_weights(g, k=n - f)
    mask_p, st_p = kernels.nnm_weights_plain(g, k=n - f)
    assert torch.equal(mask, mask_p) and torch.equal(st, st_p)
    assert torch.all(mask.sum(dim=1) == n - f)
    out = kernels.mix_rows(x, mask, st, k=n - f)
    assert _bits_equal(out, kernels.mix_rows_plain(x, mask, st, k=n - f))
    assert _bits_equal(kernels.nnm_stream(x, f=f), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [3, 8, 13, 64, 128])
@pytest.mark.parametrize(("K", "d"), [(3, 37), (3, 50_001), (2, 421_642)],
                         ids=["below_a_tile", "odd_d", "main_path_d"])
def test_cuda_mix_rows_edges_match_plain(cuda_device, K, d, n, dt):
    """B8's mixing sweep bitwise against its plain version where its design
    has edges: d below one column tile, rows that start off a 16-byte
    boundary (d odd, or 2 mod 4), K = 3 rounds a block crosses, every
    network width and dtype; an inf row and a NaN entry taint their
    selectors, whose outputs are the canonical NaN while the others stay
    finite."""
    x = _pre_rows(1000 + n, K, n, d, cuda_device, DTYPES[dt])
    x[0, n // 2] = float("inf")
    x[-1, n - 1, d // 2] = float("nan")
    k = n - n // 4
    mask, st = kernels.nnm_weights(kernels.gram(x), k=k)
    out = kernels.mix_rows(x, mask, st, k=k)
    assert _bits_equal(out, kernels.mix_rows_plain(x, mask, st, k=k))
    poisoned = st[:, :, None].expand_as(out) != 0
    assert _all_canonical_nan(out[poisoned])
    assert bool(torch.isfinite(out[~poisoned]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [3, 8, 13, 64, 128])
def test_cuda_mix_rows_never_adds_an_unselected_row(cuda_device, n, dt):
    """Under a hand-made 0/1 mask that selects neither an all-inf row nor a
    row holding NaN, every output stays finite: the sweep adds selected
    rows only (a 0/1 weight times inf would be NaN)."""
    K, d = 3, 50_001
    x = _pre_rows(2000 + n, K, n, d, cuda_device, DTYPES[dt])
    x[:, 0] = float("inf")
    x[:, n - 1, ::7] = float("nan")
    rng = np.random.default_rng(n)
    mask = torch.from_numpy((rng.random((K, n, n)) < 0.6).astype(np.float32)).to(cuda_device)
    mask[:, 0, :] = 0.0
    mask[:, n - 1, :] = 0.0
    st = torch.zeros((K, n), device=cuda_device)
    k = max(1, n - 1)
    out = kernels.mix_rows(x, mask, st, k=k)
    assert bool(torch.isfinite(out).all())
    assert _bits_equal(out, kernels.mix_rows_plain(x, mask, st, k=k))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["krum", "cge", "monna"])
@pytest.mark.parametrize("n", [3, 8, 13, 64, 128])
def test_cuda_nnm_selection_matches_plain(cuda_device, n, mode):
    """B9: weights bitwise equal to the plain version on the same Gram (the
    (n, n) products add 0/1-selected terms in the same order); n = 128
    needs the shared-memory opt-in; the sweep and the whole call."""
    x = _pre_rows(100 + n, 2, n, 3000, cuda_device)
    f_nnm, f, q = n // 4, max(0, (n - 3) // 4), max(1, n // 3)
    g = kernels.gram(x)
    kw = dict(k=n - f_nnm, f=f, q=q, mode=mode, reference_index=n // 2)
    w = kernels.nnm_selection_weights(g, **kw)
    assert _bits_equal(w, kernels.nnm_selection_weights_plain(g, **kw))
    assert torch.isfinite(w).all() and bool((w != 0).any())
    out = kernels.nnm_selection_mean_stream(x, f_nnm=f_nnm, f=f, q=q, mode=mode, reference_index=n // 2)
    assert _bits_equal(out, kernels.weighted_rows_plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("pre", ["clip", "arc"])
@pytest.mark.parametrize("mode", ["krum", "cge", "monna"])
@pytest.mark.parametrize("n", [3, 8, 13, 64, 128])
def test_cuda_clip_selection_matches_plain(cuda_device, n, mode, pre):
    """B10: weights bitwise equal to the plain version on the same Gram, in
    both modes; tau = 60 sits between the two row scales (~55 and ~274)."""
    from byzpy_tpu_torch.ops.preagg import arc_cut_off

    x = _pre_rows(200 + n, 2, n, 3000, cuda_device)
    f, q = max(0, (n - 3) // 4), max(1, n // 3)
    f_arc = n // 4
    g = kernels.gram(x)
    kw = dict(pre=pre, f=f, q=q, mode=mode, reference_index=n // 2)
    if pre == "clip":
        kw["tau"] = 60.0
    else:
        kw["cut_off"] = arc_cut_off(n, f_arc)
    w = kernels.clip_selection_weights(g, **kw)
    assert _bits_equal(w, kernels.clip_selection_weights_plain(g, **kw))
    assert torch.isfinite(w).all()
    sel = dict(f=f, q=q, mode=mode, reference_index=n // 2)
    if pre == "clip":
        out = kernels.clip_selection_mean_stream(x, tau=60.0, **sel)
    else:
        out = kernels.arc_selection_mean_stream(x, f_arc=f_arc, **sel)
    assert _bits_equal(out, kernels.weighted_rows_plain(x, w))


@pytest.mark.cuda
def test_cuda_b4_sweep_unchanged_by_the_nan_weight_rule(cuda_device):
    """The sweep now reads rows with w != 0 (NaN included); B4's weights are
    1/q or 0, so its output is the one the w > 0 rule gives."""
    x = _pre_rows(7, 2, 16, 5000, cuda_device, torch.bfloat16)
    w = kernels.selection_weights(kernels.gram(x), f=3, q=5)
    out = kernels.weighted_rows(x, w)
    acc = torch.zeros((2, 5000), device=cuda_device)
    for i in range(16):
        acc = acc + torch.where(w[:, i, None] > 0, x[:, i].float(), 0.0) * w[:, i, None]
    assert _bits_equal(out, kernels.canonical_nan(acc.to(torch.bfloat16)))


@pytest.mark.cuda
def test_cuda_picked_nonfinite_rows_give_canonical_nan(cuda_device):
    """A selection that takes a non-finite row writes NaN, as the positive
    quiet NaN of the dtype: B8 rows that mixed an inf row (f = 0: every row
    mixes every row), B9 and B10 weights and outputs when q takes the NaN
    row too."""
    for dtype in DTYPES.values():
        x = _pre_rows(3, 1, 6, 500, cuda_device, dtype)
        x[0, 1] = float("inf")
        assert _all_canonical_nan(kernels.nnm_stream(x, f=0))
        x[0, 1] = float("nan")
        for call in (
            lambda: kernels.nnm_selection_mean_stream(x, f_nnm=0, f=0, q=6, mode="cge"),
            lambda: kernels.clip_selection_mean_stream(x, tau=5.0, f=0, q=6, mode="cge"),
            lambda: kernels.arc_selection_mean_stream(x, f_arc=1, f=0, q=6, mode="cge"),
        ):
            assert _all_canonical_nan(call())
    g = kernels.gram(x.float())
    w = kernels.clip_selection_weights(g, pre="clip", tau=5.0, f=0, q=6, mode="cge")
    assert _all_canonical_nan(w)
    # a NaN row that is not selected leaves the output finite
    assert torch.isfinite(kernels.clip_selection_mean_stream(x.float(), tau=5.0, f=0, q=5, mode="cge")).all()


@pytest.mark.cuda
def test_cuda_pre_aggregated_launch_counts(cuda_device):
    """Each wrapper that launches counts one; the compositions count
    nothing themselves."""
    x = torch.randn((2, 8, 300), device=cuda_device)
    kernels.reset_launch_counts()
    kernels.nnm_stream(x, f=2)
    kernels.nnm_selection_mean_stream(x, f_nnm=2, f=2, q=3)
    kernels.clip_selection_mean_stream(x, tau=10.0, f=2, q=3)
    kernels.arc_selection_mean_stream(x, f_arc=2, f=2, q=3)
    expected = dict.fromkeys(kernels.launch_counts, 0)
    expected.update({"gram": 4, "nnm_weights": 1, "mix_rows": 1, "nnm_selection_weights:krum": 1,
                     "clip_selection_weights:clip": 1, "clip_selection_weights:arc": 1,
                     "weighted_rows": 3})
    assert kernels.launch_counts == expected


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 8, 300), (2, 8, 0)], ids=["K0", "d0"])
def test_cuda_pre_aggregated_empty_inputs_launch_nothing(cuda_device, shape):
    x = torch.zeros(shape, device=cuda_device)
    kernels.reset_launch_counts()
    assert kernels.nnm_stream(x, f=2).shape == shape
    for call in (
        lambda: kernels.nnm_selection_mean_stream(x, f_nnm=2, f=2, q=3),
        lambda: kernels.clip_selection_mean_stream(x, tau=1.0, f=2, q=3),
        lambda: kernels.arc_selection_mean_stream(x, f_arc=2, f=2, q=3),
    ):
        assert call().shape == (shape[0], shape[2])
    mask = torch.zeros((shape[0], 8, 8), device=cuda_device)
    st = torch.zeros((shape[0], 8), device=cuda_device)
    assert kernels.mix_rows(x, mask, st, k=6).shape == shape
    if shape[0] == 0:
        g = torch.zeros((0, 8, 8), device=cuda_device)
        assert kernels.nnm_weights(g, k=6)[0].shape == (0, 8, 8)
        assert kernels.nnm_selection_weights(g, k=6, f=2, q=3).shape == (0, 8)
        assert kernels.clip_selection_weights(g, pre="arc", cut_off=6, f=2, q=3).shape == (0, 8)
    assert all(v == 0 for v in kernels.launch_counts.values())


@pytest.mark.cuda
def test_cuda_pre_aggregated_reject_wide_n(cuda_device):
    wide = torch.zeros((1, 129, 64), device=cuda_device)
    for call in (
        lambda: kernels.nnm_stream(wide, f=1),
        lambda: kernels.nnm_selection_mean_stream(wide, f_nnm=1, f=1, q=2),
        lambda: kernels.clip_selection_mean_stream(wide, tau=1.0, f=1, q=2),
        lambda: kernels.arc_selection_mean_stream(wide, f_arc=1, f=1, q=2),
    ):
        with pytest.raises(NotImplementedError):
            call()


# ---------------------------------------------------------------------------
# B6 MeaMed, B7 centre step
# ---------------------------------------------------------------------------


def _meamed_rows(seed, K, n, d, device, dtype):
    """Normal rows with NaN / +-inf / -0 columns; columns from 8 on are
    quantized to halves, so many deviations tie at the cut."""
    x = _matrix(np.random.default_rng(seed), (K, n, d))
    x[..., 8:] = np.round(x[..., 8:] * 2.0) / 2.0
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [3, 8, 13, 64, 128])
def test_cuda_meamed_matches_plain(cuda_device, n, dt):
    """B6 bitwise equal to its plain version (the same selection, the
    selected values added in node order) at f = 0, n // 4 and n - 1, NaN
    canonical."""
    x = _meamed_rows(300 + n, 2, n, 3000, cuda_device, DTYPES[dt])
    for f in sorted({0, n // 4, n - 1}):
        out = kernels.meamed_stream(x, f=f)
        ref = kernels.meamed_stream_plain(x, f=f)
        assert _bits_equal(out, ref), (n, dt, f)
        assert bool(torch.isnan(out[:, 1]).all()) and _all_canonical_nan(out[torch.isnan(out)])


def _center_rows(seed, n, d, device, dtype):
    """Rows at two scales (every third x5) and a centre between them, so
    the clip takes some rows and not others."""
    x = _pre_rows(seed, 1, n, d, device, dtype)[0]
    z = kernels.sorted_reduce_stream_plain(x[None], mode="median")[0]
    return x, z


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [3, 8, 13, 64, 128])
@pytest.mark.parametrize("mode", ["weiszfeld", "clip"])
def test_cuda_center_step_matches_plain(cuda_device, mode, n, dt):
    """B7's one-step phases: the weights and alpha, the sweep on the same
    weights and the whole step bitwise equal to their plain versions (the
    distances sum in the kernel's order in both)."""
    x, z = _center_rows(400 + n, n, 5000, cuda_device, DTYPES[dt])
    kw = dict(mode=mode, c_tau=160.0)
    w, alpha = kernels.center_weights(x, z, **kw)
    w_p, alpha_p = kernels.center_weights_plain(x, z, **kw)
    assert _bits_equal(w, w_p) and _bits_equal(alpha, alpha_p)
    if mode == "clip" and n >= 8:
        assert 0 < int((w_p < w_p.max()).sum()) < n  # some rows clipped, not all
    assert _bits_equal(kernels.center_sweep(x, z, w, alpha), kernels.center_sweep_plain(x, z, w, alpha))
    assert _bits_equal(kernels.weighted_center_step(x, z, **kw),
                       kernels.weighted_center_step_plain(x, z, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["inf_row", "nan_entry"])
@pytest.mark.parametrize("mode", ["weiszfeld", "clip"])
def test_cuda_center_step_nonfinite_rows_poison_the_step(cuda_device, mode, case):
    """An all-inf row (weight 0, and 0 * inf = NaN) or one NaN entry makes
    the whole step NaN, canonical, in both modes and every dtype, as the
    reference's step does."""
    for dtype in DTYPES.values():
        x, z = _center_rows(9, 13, 700, cuda_device, dtype)
        if case == "inf_row":
            x[5] = float("inf")
        else:
            x[5, 17] = float("nan")
        out = kernels.weighted_center_step(x, z, mode=mode, c_tau=160.0)
        assert _all_canonical_nan(out)
        assert _bits_equal(out, kernels.weighted_center_step_plain(x, z, mode=mode, c_tau=160.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [1, 8, 13, 64, 128])
@pytest.mark.parametrize("mode", ["weiszfeld", "clip"])
def test_cuda_center_loop_matches_plain_bitwise(cuda_device, mode, n, dt):
    """The whole loop in one launch equals its plain version bit for bit:
    the centre and the iteration count, at d = 4 x 1024 + 3 (a ragged last
    chunk, rows starting off every alignment), run to its tolerance and to
    a forced count (tol = -1; clipping at M = 15 and 3)."""
    x, z = _center_rows(700 + n, n, 4 * 1024 + 3, cuda_device, DTYPES[dt])
    runs = ([dict(tol=1e-6, max_iter=256), dict(tol=-1.0, max_iter=13)] if mode == "weiszfeld"
            else [dict(max_iter=15), dict(max_iter=3)])
    for kw in runs:
        kernels.reset_launch_counts()
        out, its = kernels.center_loop(x, z, mode=mode, c_tau=160.0, **kw)
        assert kernels.launch_counts == dict(dict.fromkeys(kernels.launch_counts, 0),
                                             **{f"center_loop:{mode}": 1})
        ref, its_p = kernels.center_loop_plain(x, z, mode=mode, c_tau=160.0, **kw)
        assert its.device.type == "cuda" and its.dtype == torch.int32
        assert int(its) == int(its_p) >= 1, (int(its), int(its_p))
        assert _bits_equal(out, ref), (mode, n, dt, kw)
        if kw.get("tol", -1.0) == -1.0:
            assert int(its) == kw["max_iter"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["inf_row", "nan_entry"])
@pytest.mark.parametrize("mode", ["weiszfeld", "clip"])
def test_cuda_center_loop_nonfinite_rows(cuda_device, mode, case):
    """An all-inf row or one NaN entry: the loop's centre is all canonical
    NaN, bitwise the plain version's, and Weiszfeld stops after its forced
    first step (delta is NaN), as the reference's while_loop does."""
    for dtype in DTYPES.values():
        x, z = _center_rows(19, 13, 3000, cuda_device, dtype)
        if case == "inf_row":
            x[5] = float("inf")
        else:
            x[5, 17] = float("nan")
        out, its = kernels.center_loop(x, z, mode=mode, c_tau=160.0, max_iter=7)
        ref, its_p = kernels.center_loop_plain(x, z, mode=mode, c_tau=160.0, max_iter=7)
        assert _all_canonical_nan(out) and _bits_equal(out, ref)
        assert int(its) == int(its_p) == (1 if mode == "weiszfeld" else 7)


@pytest.mark.cuda
def test_cuda_center_loop_forces_its_first_step_at_large_z(cuda_device):
    """At |z| = 2^24 a step may leave z where it was: iteration 1 still runs
    (it == 0), and the loop matches its plain version bit for bit."""
    x = torch.full((5, 2048), 2.0 ** 24, device=cuda_device)
    x[0, :7] += 2.0
    z = x[1].clone()
    out, its = kernels.center_loop(x, z, mode="weiszfeld")
    ref, its_p = kernels.center_loop_plain(x, z, mode="weiszfeld")
    assert int(its) == int(its_p) >= 1 and _bits_equal(out, ref)


@pytest.mark.cuda
def test_cuda_center_loop_zero_steps_launch_nothing(cuda_device):
    x = torch.randn((8, 300), device=cuda_device)
    kernels.reset_launch_counts()
    for mode in ("weiszfeld", "clip"):
        out, its = kernels.center_loop(x, x[0].contiguous(), mode=mode, max_iter=0)
        assert _bits_equal(out, x[0]) and int(its) == 0
    assert all(v == 0 for v in kernels.launch_counts.values())


@pytest.mark.cuda
def test_cuda_centre_loops_read_the_host_at_most_once(cuda_device):
    """``robust.geometric_median`` makes one loop launch (and B1 for its
    start) and reads one value on the host, its iteration count;
    ``robust.centered_clipping`` makes one launch and no host read
    (PyTorch's sync debug mode warns once per synchronizing call)."""
    import warnings

    from byzpy_tpu_torch.ops import robust

    x = _center_rows(5, 8, 20_000, cuda_device, torch.float32)[0]
    for fn, reads, launches in (
        (lambda: robust.geometric_median(x), 1, {"sorted_reduce:median": 1, "center_loop:weiszfeld": 1}),
        (lambda: robust.centered_clipping(x, c_tau=160.0, M=10), 0, {"center_loop:clip": 1}),
    ):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert sum("synchroniz" in str(w.message) for w in caught) <= reads
        assert kernels.launch_counts == dict(dict.fromkeys(kernels.launch_counts, 0), **launches)


@pytest.mark.cuda
def test_cuda_centre_and_meamed_launch_counts(cuda_device):
    """Each launching wrapper counts one; the compositions and the robust
    entry points count nothing themselves; CGE and MoNNA reach B4's cge and
    monna modes; a centre-seeking loop is one B7 launch."""
    from byzpy_tpu_torch.ops import robust

    x = torch.randn((8, 300), device=cuda_device)
    kernels.reset_launch_counts()
    robust.mean_of_medians(x, f=2)
    robust.mean_of_medians_stream(x[None], f=2)
    kernels.weighted_center_step(x, x[0].contiguous(), mode="weiszfeld")
    robust.centered_clipping(x, c_tau=5.0, M=3)
    robust.cge(x, f=2)
    robust.monna_stream(x[None], f=2, reference_index=3)
    expected = dict.fromkeys(kernels.launch_counts, 0)
    expected.update({"meamed": 2, "center_loop:weiszfeld": 1, "center_loop:clip": 1,
                     "gram": 2, "selection_weights:cge": 1,
                     "selection_weights:monna": 1, "weighted_rows": 2})
    assert kernels.launch_counts == expected
    kernels.reset_launch_counts()
    robust.geometric_median(x)
    iters = robust.last_iterations["geometric_median"]
    assert 1 <= iters <= 256
    assert kernels.launch_counts["sorted_reduce:median"] == 1
    assert kernels.launch_counts["center_loop:weiszfeld"] == 1
    assert sum(kernels.launch_counts.values()) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 8, 300), (2, 8, 0)], ids=["K0", "d0"])
def test_cuda_meamed_and_centre_empty_inputs_launch_nothing(cuda_device, shape):
    x = torch.zeros(shape, device=cuda_device)
    kernels.reset_launch_counts()
    assert kernels.meamed_stream(x, f=2).shape == (shape[0], shape[2])
    if shape[0]:
        assert kernels.weighted_center_step(x[0], x[0, 0], mode="clip").shape == (0,)
        w, alpha = torch.zeros(8, device=cuda_device), torch.zeros(1, device=cuda_device)
        assert kernels.center_sweep(x[0], x[0, 0], w, alpha).shape == (0,)
    assert all(v == 0 for v in kernels.launch_counts.values())


@pytest.mark.cuda
def test_cuda_meamed_and_centre_reject_wide_n(cuda_device):
    wide = torch.zeros((129, 64), device=cuda_device)
    for call in (
        lambda: kernels.meamed_stream(wide[None], f=1),
        lambda: kernels.weighted_center_step(wide, wide[0].contiguous(), mode="weiszfeld"),
        lambda: kernels.center_loop(wide, wide[0].contiguous(), mode="weiszfeld"),
        lambda: kernels.center_loop(wide, wide[0].contiguous(), mode="clip", max_iter=3),
        lambda: kernels.center_weights(wide, wide[0].contiguous(), mode="clip"),
        lambda: kernels.center_sweep(wide, wide[0].contiguous(), torch.zeros(129, device=cuda_device),
                                     torch.zeros(1, device=cuda_device)),
    ):
        with pytest.raises(NotImplementedError):
            call()


# ---------------------------------------------------------------------------
# B5 selection mean from a given Gram, and the operator classes on the card
# ---------------------------------------------------------------------------


def _tie_heavy(x):
    """Duplicated and zero rows: scores that tie, broken by row index."""
    x = x.clone()
    x[:, 5] = x[:, 2]
    x[:, 7] = x[:, 2]
    x[:, [1, 3]] = 0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [8, 13, 64, 128])
@pytest.mark.parametrize("gram_from", ["b3", "fold"])
def test_cuda_selection_mean_from_gram_matches_plain(cuda_device, gram_from, n, dt):
    """B5 on a Gram from B3 or from the arrival-order fold (rows folded in
    a seeded order; 16-bit rows into an f32 Gram): the weights equal to the
    plain version's on the same Gram, the output bitwise equal to the plain
    sweep on the same weights, with tie-heavy rows; one
    ``selection_mean_from_gram:krum`` launch (B5's weights and sweep in one
    kernel), no Gram launch."""
    from byzpy_tpu_torch.ops import robust

    x = _tie_heavy(_pre_rows(500 + n, 1, n, 3000, cuda_device, DTYPES[dt]))[0].contiguous()
    if gram_from == "b3":
        g = kernels.gram(x[None])[0]
    else:
        buf = torch.zeros_like(x)
        g = torch.zeros((n, n), device=cuda_device)
        for i in np.random.default_rng(n).permutation(n):
            robust.gram_fold_update(buf, g, x[int(i)], int(i))
        assert torch.equal(buf, x)
    f, q = n // 4, max(1, n // 3)
    kernels.reset_launch_counts()
    out = kernels.selection_mean_from_gram(x, g, f=f, q=q)
    expected = dict.fromkeys(kernels.launch_counts, 0)
    expected.update({"selection_mean_from_gram:krum": 1})
    assert kernels.launch_counts == expected
    w = kernels.selection_weights(g[None], f=f, q=q)
    assert torch.equal(w, kernels.selection_weights_plain(g[None], f=f, q=q, mode="krum"))
    assert _bits_equal(out, kernels.weighted_rows_plain(x[None], w)[0])
    assert _bits_equal(out, kernels.selection_mean_from_gram_plain(x, g, f=f, q=q))


@pytest.mark.cuda
def test_cuda_selection_mean_from_gram_nonfinite_and_wide(cuda_device):
    """A selected inf row poisons the output (canonical NaN or inf, as the
    plain version); n > 128 raises."""
    x = _pre_rows(3, 1, 9, 500, cuda_device)[0].contiguous()
    x[4] = float("inf")
    g = kernels.gram(x[None])[0]
    out = kernels.selection_mean_from_gram(x, g, f=0, q=9, mode="cge")
    assert not torch.isfinite(out).any()
    assert _bits_equal(out, kernels.selection_mean_from_gram_plain(x, g, f=0, q=9, mode="cge"))
    wide = torch.zeros((129, 64), device=cuda_device)
    with pytest.raises(NotImplementedError):
        kernels.selection_mean_from_gram(wide, torch.zeros((129, 129), device=cuda_device), f=1, q=2)


@pytest.mark.cuda
def test_cuda_folded_multi_krum_runs_b5_not_the_gram(cuda_device):
    """``MultiKrum.fold`` / ``fold_finalize`` on the card: the finalize
    launches B5 (one ``selection_mean_from_gram:krum``, no
    ``selection_weights`` or ``weighted_rows`` launch) and no Gram (the
    fold built it by matvecs); the result is within rtol 1e-5, atol 1e-6
    of ``aggregate`` (which launches B3 and B4)."""
    from byzpy_tpu_torch.aggregators import MultiKrum

    agg = MultiKrum(2, 4)
    grads = [{"w": r[:2000].reshape(40, 50), "b": r[2000:]} for r in
             _pre_rows(8, 1, 8, 3000, cuda_device)[0]]
    state = agg.fold_init(8)
    kernels.reset_launch_counts()
    for i in (5, 0, 7, 2, 1, 6, 3, 4):
        agg.fold(state, i, grads[i])
    out = agg.fold_finalize(state)
    assert kernels.launch_counts["gram"] == 0
    assert kernels.launch_counts["selection_mean_from_gram:krum"] == 1
    assert kernels.launch_counts["selection_weights:krum"] == 0
    assert kernels.launch_counts["weighted_rows"] == 0
    ref = agg.aggregate(grads)
    assert kernels.launch_counts["gram"] == 1
    for k in ("w", "b"):
        assert out[k].is_cuda
        torch.testing.assert_close(out[k], ref[k], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_classes_default_to_the_card(cuda_device):
    """A class built with ``device=None`` lands on CUDA: numpy inputs move
    there, and so does the result."""
    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian
    from byzpy_tpu_torch.pre_aggregators import NearestNeighborMixing

    rows = [np.random.default_rng(i).normal(size=300).astype(np.float32) for i in range(6)]
    agg = CoordinateWiseMedian()
    assert agg.device.type == "cuda"
    kernels.reset_launch_counts()
    out = agg.aggregate(rows)
    assert out.is_cuda and kernels.launch_counts["sorted_reduce:median"] == 1
    mixed = NearestNeighborMixing(1).pre_aggregate(rows)
    assert len(mixed) == 6 and all(m.is_cuda for m in mixed)
    assert kernels.launch_counts["mix_rows"] == 1


# ---------------------------------------------------------------------------
# B13 / B14 / B15: the blockwise codecs
# ---------------------------------------------------------------------------


def _codec_rows(seed, rows, d, device, dtype):
    """Normal rows x3 holding NaN, +-inf, an all-zero first block and an
    all-zero row; the last block is partial unless the block divides d."""
    x = (np.random.default_rng(seed).normal(size=(rows, d)) * 3.0).astype(np.float32)
    x[0, 5], x[1, 3], x[0, d - 1] = np.nan, np.inf, -np.inf
    x[2, :100] = 0.0
    x[3] = 0.0
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [256, 100, 128])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("mode", ["int8", "fp8", "fp8_e5m2"])
def test_cuda_codecs_match_plain_bitwise(cuda_device, mode, dt, block):
    """B13 (int8) / B15 (fp8) codes and scales, and B14's decode into each
    dtype, equal their plain versions on the card bit for bit; each
    wrapper counts exactly its own launch."""
    from byzpy_tpu_torch.ops import codec_kernels as ck

    x = _codec_rows(block, 13, 5000, cuda_device, DTYPES[dt])
    kernels.reset_launch_counts()
    codes, scales = ck.encode_rows(x, block=block, mode=mode)
    pc, ps = ck.encode_rows_plain(x, block=block, mode=mode)
    assert codes.dtype == pc.dtype and torch.equal(codes.view(torch.uint8), pc.view(torch.uint8))
    assert _bits_equal(scales, ps) and scales.shape == (13, -(-5000 // block))
    for out_dt in DTYPES.values():
        dec = ck.decode_rows(codes, scales, block=block, dtype=out_dt)
        assert _bits_equal(dec, ck.decode_rows_plain(codes, scales, block=block, dtype=out_dt))
        assert bool(torch.isfinite(dec).all())
    dec_key = "dequantize:int8" if mode == "int8" else "dequantize:fp8"
    expected = dict.fromkeys(kernels.launch_counts, 0)
    expected.update({f"quantize:{mode}": 1, dec_key: 3})
    assert kernels.launch_counts == expected


@pytest.mark.cuda
def test_cuda_codec_api_launches_and_empty_inputs(cuda_device):
    """The public codec API on CUDA tensors: ``encode_blockwise`` launches
    one encode, ``dequantize_blockwise`` one decode; an empty input, and
    stochastic rounding (plain PyTorch, as in the reference), launch
    nothing; s4, which raised ``NotImplementedError`` until B16 / B17
    came, launches one B16 and one B17."""
    from byzpy_tpu_torch.parallel import quantization as q

    x = _codec_rows(1, 4, 700, cuda_device, torch.float32)
    kernels.reset_launch_counts()
    for mode in ("int8", "fp8", "fp8_e5m2"):
        qb = q.encode_blockwise(x.reshape(2, 2, 700), mode)
        assert qb.values.is_cuda and qb.values.shape == (2, 2, 700)
        assert q.dequantize_blockwise(qb).shape == (2, 2, 700)
    assert kernels.launch_counts["quantize:int8"] == 1
    assert kernels.launch_counts["quantize:fp8"] == 1
    assert kernels.launch_counts["quantize:fp8_e5m2"] == 1
    assert kernels.launch_counts["dequantize:int8"] == 1
    assert kernels.launch_counts["dequantize:fp8"] == 2
    kernels.reset_launch_counts()
    for shape in ((3, 0), (0, 5)):
        e = q.encode_blockwise(torch.zeros(shape, device=cuda_device), "int8")
        assert q.dequantize_blockwise(e).shape == shape
    s = q.quantize_blockwise(x, stochastic=True, generator=torch.Generator(device="cuda").manual_seed(0))
    assert s.values.is_cuda
    assert all(v == 0 for v in kernels.launch_counts.values())
    s4 = q.encode_blockwise(x, "s4")
    assert s4.values.is_cuda and q.dequantize_blockwise(s4).shape == x.shape
    assert kernels.launch_counts["quantize:s4"] == kernels.launch_counts["dequantize:s4"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        from byzpy_tpu_torch.ops import codec_kernels as ck

        ck.encode_rows(torch.zeros((64, 8), device=cuda_device).t(), block=4, mode="int8")


@pytest.mark.cuda
def test_cuda_compressed_rounds_launch_the_codecs(cuda_device):
    """The PS round with int8 launches one B13 and one B14 per step (the
    whole (n, d) matrix at once); the gossip round with int8 one B13 and
    one B14 per node."""
    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.models import mnist_mlp, synthetic_classification
    from byzpy_tpu_torch.ops import robust
    from byzpy_tpu_torch.parallel import (
        GossipStepConfig, PSStepConfig, build_gossip_train_step, build_ps_train_step,
    )

    bundle = mnist_mlp(hidden=16, device=cuda_device)
    x, y = synthetic_classification(n_samples=8 * 16, seed=1, device=cuda_device)
    xs, ys = x.reshape(8, 16, 28, 28, 1), y.reshape(8, 16)
    step, opt = build_ps_train_step(bundle, lambda m: robust.trimmed_mean(m, f=2),
                                    PSStepConfig(8, 2), comm_precision="int8")
    kernels.reset_launch_counts()
    params, opt, metrics = step(bundle.params, opt, xs, ys)
    assert kernels.launch_counts["quantize:int8"] == 1 and kernels.launch_counts["dequantize:int8"] == 1
    assert kernels.launch_counts["sorted_reduce:trimmed"] == 1
    gstep, init = build_gossip_train_step(bundle, robust.coordinate_median, Topology.ring(8, 2),
                                          GossipStepConfig(8, 1), comm_precision="int8")
    kernels.reset_launch_counts()
    theta, gm = gstep(init(), xs, ys)
    assert theta.is_cuda and bool(torch.isfinite(theta).all())
    assert kernels.launch_counts["quantize:int8"] == 1 and kernels.launch_counts["dequantize:int8"] == 8
    assert kernels.launch_counts["sorted_reduce:median"] == 8


# ---------------------------------------------------------------------------
# B11 segment sum, B2 column sort, the row reduction and the masked family
# ---------------------------------------------------------------------------


def _dispatch_weights(C, R, seed, device):
    """A ragged dispatch's weights: cohorts 0 .. C - 2 own consecutive row
    ranges (cohort 0 the first), the last cohort is an all-zero padding
    slot (at C = 1 the one cohort owns every row)."""
    rng = np.random.default_rng(seed)
    w = np.zeros((C, R), np.float32)
    owners = max(C - 1, 1)
    cuts = np.linspace(0, R, owners + 1).astype(int)
    for c in range(owners):
        w[c, cuts[c]:cuts[c + 1]] = rng.uniform(0.25, 2.0, size=cuts[c + 1] - cuts[c])
    return torch.from_numpy(w).to(device), int(cuts[1])


def _count_one(key, fn):
    before = kernels.launch_counts[key]
    out = fn()
    assert kernels.launch_counts[key] == before + 1, key
    return out


# (C, R, d): C across every cohort tile (1, 2, 4, 8, 16 and two or three
# tiles of 16), d at every alignment of a row start (odd d, d < 4, 421,641)
SEGMENT_CASES = [(1, 8, 5000), (1, 64, 421_641), (2, 300, 4999), (3, 13, 3), (4, 128, 421_641),
                 (5, 40, 4999), (8, 128, 5000), (9, 20, 1), (16, 64, 4997), (17, 33, 421_641),
                 (33, 12, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("C,R,d", SEGMENT_CASES)
def test_cuda_segment_sum_matches_plain_bitwise(cuda_device, C, R, d, dt):
    """B11 equals its plain version bit for bit (one FMA chain per output
    in row order), one launch a call: dense weights over rows holding NaN,
    +-inf and -0.0; a dispatch's block-diagonal weights with an all-zero
    padding slot while cohort 0 holds +-inf / NaN entries (every other
    cohort's chain adds 0 * inf = NaN there, so their NaN bits are pinned);
    and a fill below R as an int and as a device int32, the rows past it
    NaN and never read."""
    rng = np.random.default_rng(R + C + d)
    x = torch.from_numpy(_matrix(rng, (R, max(d, 6)))[:, :d].copy()).to(cuda_device, DTYPES[dt])
    dense = torch.from_numpy(rng.normal(size=(C, R)).astype(np.float32)).to(cuda_device)
    block, own = _dispatch_weights(C, R, C + d, cuda_device)
    xb = x.clone()
    xb[:own, : min(d, 3)] = float("inf")
    xb[own - 1, d // 2] = float("-inf")
    xb[0, d - 1] = float("nan")
    for xx, w in ((x, dense), (xb, block)):
        out = _count_one("segment_sum", lambda: kernels.segment_sum(xx, w))
        assert _bits_equal(out, kernels.segment_sum_plain(xx, w))
    fill = R // 2
    wz = dense.clone()
    wz[:, fill:] = 0
    xz, xg = x.clone(), x.clone()
    xz[fill:], xg[fill:] = 0, float("nan")
    ref = kernels.segment_sum_plain(xz, wz)
    for f in (fill, torch.tensor([fill], dtype=torch.int32, device=cuda_device)):
        assert _bits_equal(_count_one("segment_sum", lambda: kernels.segment_sum(xg, wz, fill=f)), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [1, 5, 8, 13, 64, 128])
def test_cuda_sort_columns_matches_plain_bitwise(cuda_device, n, dt):
    x = torch.from_numpy(_matrix(np.random.default_rng(n), (max(n, 6), 3000))[:n]).to(
        cuda_device, DTYPES[dt])
    before = kernels.launch_counts["sort_columns"]
    out = kernels.sort_columns(x)
    assert kernels.launch_counts["sort_columns"] == before + 1
    assert _bits_equal(out, kernels.sort_columns_plain(x))


@pytest.mark.cuda
def test_cuda_sort_columns_rejects_129_rows(cuda_device):
    x = torch.zeros((129, 10), device=cuda_device)
    with pytest.raises(NotImplementedError):
        kernels.sort_columns(x)
    from byzpy_tpu_torch.ops import robust

    with pytest.raises(NotImplementedError):
        robust.sort_rows(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,d", [(8, 421_642), (13, 5000), (64, 4097)])
def test_cuda_row_sq_dists_matches_plain_bitwise(cuda_device, n, d, dt):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(_matrix(rng, (n, d), specials=False)).to(cuda_device, DTYPES[dt])
    z = x[n // 2].clone()
    for zz in (None, z):
        assert _bits_equal(kernels.row_sq_dists(x, zz), kernels.row_sq_dists_plain(x, zz))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["median", "trimmed", "meamed", "multikrum", "cge", "monna",
                                  "geomed", "clip"])
def test_cuda_masked_class_padded_equals_compacted(cuda_device, name):
    """A masked class's padded program on the card equals its compacted one
    bit for bit, and launches B2 / B11 and none of B1, B4, B6, B7."""
    from byzpy_tpu_torch import aggregators as A

    make = {
        "median": lambda: A.CoordinateWiseMedian(), "trimmed": lambda: A.CoordinateWiseTrimmedMean(2),
        "meamed": lambda: A.MeanOfMedians(2), "multikrum": lambda: A.MultiKrum(2, 4),
        "cge": lambda: A.ComparativeGradientElimination(2), "monna": lambda: A.MoNNA(2),
        "geomed": lambda: A.GeometricMedian(), "clip": lambda: A.CenteredClipping(c_tau=50.0),
    }[name]
    agg = make()
    rng = np.random.default_rng(3)
    m, bucket, d = 13, 16, 20_000
    x = (rng.normal(size=(m, d)) * rng.uniform(0.5, 3.0, size=(m, 1))).astype(np.float32)
    padded = torch.zeros((bucket, d), device=cuda_device)
    padded[:m] = torch.from_numpy(x).to(cuda_device)
    valid = torch.zeros(bucket, dtype=torch.bool, device=cuda_device)
    valid[:m] = True
    kernels.reset_launch_counts()
    out = agg.masked_matrix_fn()(padded, valid)
    counts = dict(kernels.launch_counts)
    ref = agg.masked_matrix_fn()(padded[:m].contiguous(), valid[:m].contiguous())
    assert _bits_equal(out, ref)
    assert counts["segment_sum"] > 0 or name == "median"
    for k in ("sorted_reduce:median", "sorted_reduce:trimmed", "weighted_rows", "meamed",
              "center_sweep", "center_weights:weiszfeld", "center_weights:clip",
              "center_loop:weiszfeld", "center_loop:clip"):
        assert counts[k] == 0, (k, counts)


# ---------------------------------------------------------------------------
# B16 / B17: the s4 codec; B12: the fused-dequant segment sum
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("d", [5000, 4999])
@pytest.mark.parametrize("block", [256, 100, 32, 1024, 2])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
def test_cuda_s4_codec_matches_plain_bitwise(cuda_device, dt, block, d):
    """B16's packed codes and scales, and B17's decode into each dtype,
    equal their plain versions bit for bit (NaN, +-inf, zero blocks, odd d,
    d not a block multiple, word and byte stores); one launch each."""
    from byzpy_tpu_torch.ops import codec_kernels as ck

    x = _codec_rows(block, 13, d, cuda_device, DTYPES[dt])
    kernels.reset_launch_counts()
    packed, scales = ck.encode_rows_s4(x, block=block)
    pp, ps = ck.encode_rows_s4_plain(x, block=block)
    assert torch.equal(packed, pp) and _bits_equal(scales, ps)
    assert packed.shape == (13, -(-d // block) * block // 2)
    for out_dt in DTYPES.values():
        dec = ck.decode_rows_s4(packed, scales, block=block, d=d, dtype=out_dt)
        assert _bits_equal(dec, ck.decode_rows_s4_plain(packed, scales, block=block, d=d, dtype=out_dt))
        assert bool(torch.isfinite(dec).all())
    assert kernels.launch_counts["quantize:s4"] == 1 and kernels.launch_counts["dequantize:s4"] == 3
    zeros = torch.zeros((2, packed.shape[1]), dtype=torch.uint8, device=cuda_device)
    capacity = ck.decode_rows_s4(zeros, torch.zeros((2, scales.shape[1]), device=cuda_device),
                                 block=block, d=d)
    assert bool(torch.signbit(capacity).all()) and not capacity.any()


def _wire(mode, rows, d, block, device):
    from byzpy_tpu_torch.parallel import quantization as q

    x = (np.random.default_rng(rows + d).normal(size=(rows, d))
         * np.random.default_rng(1).uniform(0.1, 50.0, size=(rows, 1))).astype(np.float32)
    enc = q.encode_blockwise(torch.from_numpy(x).to(device), q.CommPrecision(mode, block=block))
    codes = enc.values if mode in ("int8", "s4") else enc.values.view(torch.uint8)
    return codes.contiguous(), enc.scales.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 8, 9, 16, 17, 33])
@pytest.mark.parametrize("mode", ["int8", "fp8", "fp8_e5m2", "s4"])
def test_cuda_segment_sum_dequant_matches_plain_bitwise(cuda_device, mode, C):
    """B12 equals its plain version (the plain decode, then B11's plain
    chain) bit for bit, one launch a call counted under its mode: code rows
    of odd width (every alignment of an int8 / fp8 row start) and blocks
    256, 100 and 32 (a word of codes across a block boundary); dense and a
    dispatch's block-diagonal weights with an all-zero padding slot while
    cohort 0's rows carry inf and NaN scales (the other cohorts' 0 * inf =
    NaN pinned); with and without staleness row weights; and a device fill
    below R, the rows past it NaN-scaled and never read."""
    R = 40
    gen = torch.Generator(device="cuda").manual_seed(C)
    dense = torch.randn((C, R), generator=gen, device=cuda_device)
    block_w, own = _dispatch_weights(C, R, C, cuda_device)
    omega = torch.where(torch.arange(R, device=cuda_device) % 4 == 1, 0.5, 1.0)
    key = f"segment_sum_dequant:{mode}"
    for d, block in ((5003, 256), (4999, 100), (1001, 32)):
        codes, scales = _wire(mode, R, d, block, cuda_device)
        bad = scales.clone()
        bad[0, 0], bad[own - 1, -1] = float("inf"), float("nan")
        for sc, w in ((scales, dense), (bad, block_w)):
            for rw in (None, omega):
                out = _count_one(key, lambda: kernels.segment_sum_dequant(
                    codes, sc, w, mode=mode, block=block, d=d, row_weights=rw))
                assert _bits_equal(out, kernels.segment_sum_dequant_plain(
                    codes, sc, w, mode=mode, block=block, d=d, row_weights=rw)), (d, block, rw is None)
        fill = R // 2
        wz = dense.clone()
        wz[:, fill:] = 0
        want = kernels.segment_sum_dequant_plain(codes, scales, wz, mode=mode, block=block, d=d,
                                                 row_weights=omega)
        nan_past = scales.clone()
        nan_past[fill:] = float("nan")
        got = _count_one(key, lambda: kernels.segment_sum_dequant(
            codes, nan_past, dense, mode=mode, block=block, d=d, row_weights=omega,
            fill=torch.tensor([fill], dtype=torch.int32, device=cuda_device)))
        assert _bits_equal(got, want), (d, block)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "int8", "fp8", "s4"])
@pytest.mark.parametrize("name", ["multikrum", "cge", "trimmed", "median"])
def test_cuda_ragged_executor_dispatch(cuda_device, name, mode):
    """One ragged dispatch of three cohorts (6, 13, 29 rows; every fourth
    stale) on the card: each cohort's vector equals ``CohortAggregator``'s
    bit for bit; a quantized Multi-Krum or CGE dispatch launches one decode
    and one B12 and no B11 for its final contraction; the sort family takes
    its segmented program, one segmented sort-reduce for the four cohort
    slots and no B2 or B11."""
    from byzpy_tpu_torch import aggregators as A
    from byzpy_tpu_torch.engine.actor import wire
    from byzpy_tpu_torch.serving import (
        CohortAggregator, RaggedExecutor, StalenessPolicy, Submission, build_cohort,
    )

    agg = {"multikrum": lambda: A.MultiKrum(2, 4), "cge": lambda: A.ComparativeGradientElimination(2),
           "trimmed": lambda: A.CoordinateWiseTrimmedMean(2), "median": lambda: A.CoordinateWiseMedian()}[name]()
    d, block = 20_000, 256
    cohorts = []
    for k, m in enumerate((6, 13, 29)):
        if mode == "dense":
            x = torch.randn((m, d), generator=torch.Generator(device="cuda").manual_seed(k), device=cuda_device)
            grads = [x[i] for i in range(m)]
        else:
            codes, scales = _wire(mode, m, d, block, cuda_device)
            grads = [wire.QuantizedWireArray(mode, codes[i], scales[i], block, (d,), "float32")
                     for i in range(m)]
        subs = [Submission(f"c{i}", 4 if i % 4 == 1 else 5, g, float(i)) for i, g in enumerate(grads)]
        cohorts.append(build_cohort(subs, 5, None, StalenessPolicy("exponential", gamma=0.5), quantized=True))
    ex = RaggedExecutor(agg, d, row_capacity=64, max_cohorts=4, with_evidence=False)
    kernels.reset_launch_counts()
    views = ex.aggregate(cohorts, ["a", "b", "c"])
    counts = dict(kernels.launch_counts)
    for view, cohort in zip(views, cohorts):
        assert _bits_equal(view.vector, CohortAggregator(agg).aggregate(cohort))
    if mode != "dense" and name in ("multikrum", "cge"):
        dec = "dequantize:s4" if mode == "s4" else f"dequantize:{'int8' if mode == 'int8' else 'fp8'}"
        assert counts[dec] == 1 and counts[f"segment_sum_dequant:{mode}"] == 1
        assert counts["segment_sum"] == (1 if name == "multikrum" else 0)
    if name in ("trimmed", "median"):
        assert counts["segmented_sort_reduce"] == 1
        assert counts["sort_columns"] == 0 and counts["segment_sum"] == 0


# (R, d, cohort sizes, padding slots): the executor's batch at SmallCNN's
# width (odd rows start 8-byte aligned; several tiles a block, the last run
# partial), an odd d (rows at every alignment) with a one-row and a 120-row
# cohort, d below one column tile, and slots of every network width,
# 65-128 rows among them, at an odd d
SEGMENTED = {
    "n_batch": (128, 421_642, (6, 13, 29, 64), 1),
    "odd_d": (128, 50_001, (1, 2, 5, 120), 0),
    "small": (16, 37, (3, 8, 5), 1),
    "mixed_widths": (128, 300_001, (65, 7, 33, 9, 1, 13), 2),
    "two_wide": (128, 90_003, (100, 28), 0),
}


def _segmented_batch(name, device, *, specials=False):
    R, d, sizes, pad = SEGMENTED[name]
    flat = torch.from_numpy(_matrix(np.random.default_rng(R + d), (R, d), specials=specials)).to(device)
    offsets = torch.full((len(sizes) + pad,), sum(sizes), dtype=torch.int32)
    lengths = torch.zeros(len(sizes) + pad, dtype=torch.int32)
    offsets[:len(sizes)] = torch.tensor(np.cumsum((0,) + sizes[:-1]), dtype=torch.int32)
    lengths[:len(sizes)] = torch.tensor(sizes, dtype=torch.int32)
    return flat, offsets.to(device), lengths.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,f", [("trimmed", 0), ("trimmed", 2), ("trimmed", 8), ("median", 0)])
@pytest.mark.parametrize("name", sorted(SEGMENTED))
def test_cuda_segmented_sort_reduce_matches_plain_bitwise(cuda_device, name, mode, f):
    flat, offsets, lengths = _segmented_batch(name, cuda_device)
    before = kernels.launch_counts["segmented_sort_reduce"]
    out = kernels.segmented_sort_reduce(flat, offsets, lengths, mode=mode, f=f)
    torch.cuda.synchronize()
    assert kernels.launch_counts["segmented_sort_reduce"] == before + 1
    assert _bits_equal(out, kernels.segmented_sort_reduce_plain(flat, offsets, lengths, mode=mode, f=f))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,f", [("trimmed", 0), ("trimmed", 2), ("median", 0)])
@pytest.mark.parametrize("name", ["odd_d", "small"])
def test_cuda_segmented_sort_reduce_nonfinite_rows(cuda_device, name, mode, f):
    """Rows holding NaN, +-inf and -0.0: NaN (canonical) where the plain
    version has NaN, the same bits everywhere else, and no fault."""
    flat, offsets, lengths = _segmented_batch(name, cuda_device, specials=True)
    flat[:, 7:10] = float("inf")
    flat[::3, 8] = float("nan")
    flat[:, 10] = float("nan")
    out = kernels.segmented_sort_reduce(flat, offsets, lengths, mode=mode, f=f)
    torch.cuda.synchronize()
    ref = kernels.segmented_sort_reduce_plain(flat, offsets, lengths, mode=mode, f=f)
    assert torch.equal(torch.isnan(out), torch.isnan(ref)) and bool(torch.isnan(ref).any())
    assert _all_canonical_nan(out[torch.isnan(out)])
    assert _bits_equal(out, ref)


@pytest.mark.cuda
def test_cuda_segmented_sort_reduce_rejects(cuda_device):
    offsets = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError):
        kernels.segmented_sort_reduce(torch.zeros((129, 10), device=cuda_device), offsets, lengths,
                                      mode="median")
    with pytest.raises(ValueError):
        kernels.segmented_sort_reduce(torch.zeros((8, 10), device=cuda_device, dtype=torch.bfloat16),
                                      offsets, lengths, mode="median")
    with pytest.raises(ValueError):
        kernels.segmented_sort_reduce(torch.zeros((10, 8), device=cuda_device).T, offsets, lengths,
                                      mode="trimmed")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,f", [("trimmed", 2), ("median", 0)])
@pytest.mark.parametrize("d", [37, 200_003])
def test_cuda_segmented_sort_reduce_empty_and_out_of_range_slots(cuda_device, d, mode, f):
    """Slots of length 0 write zeros and slots whose rows leave [0, R) NaN,
    reading nothing, among slots that sort (6, 70 and 1 rows, packed from
    row 0 as the plain version takes them): every slot bit for bit its plain
    version."""
    flat = torch.from_numpy(_matrix(np.random.default_rng(d), (128, d))).to(cuda_device)
    layout = [(0, 6), (6, 0), (-1, 4), (120, 10), (5, -3), (6, 70), (76, 1), (128, 0), (0, 129)]
    offsets = torch.tensor([o for o, _ in layout], dtype=torch.int32, device=cuda_device)
    lengths = torch.tensor([m for _, m in layout], dtype=torch.int32, device=cuda_device)
    out = kernels.segmented_sort_reduce(flat, offsets, lengths, mode=mode, f=f)
    torch.cuda.synchronize()
    ref = kernels.segmented_sort_reduce_plain(flat, offsets, lengths, mode=mode, f=f)
    assert _bits_equal(out, ref)
    assert bool((out[[1, 7]] == 0).all()) and _all_canonical_nan(out[[2, 3, 4, 8]])


# B1 on the column-sort engine: (d, why) -- several tiles a block with a
# partial last run; an odd d (f32 rows at 4-, 8- and 16-byte starts, 16-bit
# rows at 2-byte starts); d below one tile
ENGINE_D = {"runs": 100_003, "odd": 1001, "below_tile": 37}


def _engine_rows(seed, K, n, d, dtype, device):
    """Normal rows with a NaN, +-inf, a -0.0 column and ties; from n >= 3 a
    row of NaN over the first half of the columns and a row of +inf over the
    second, from n >= 2 a row of -inf over a third."""
    x = np.random.default_rng(seed).normal(size=(K, n, d)).astype(np.float32)
    x[:, 0, min(1, d - 1)] = np.nan
    x[:, -1, min(2, d - 1)] = np.inf
    x[:, :, min(5, d - 1)] = -0.0
    x[:, :, -1] = 1.0
    if n >= 2:
        x[:, 1, : d // 3] = -np.inf
    if n >= 3:
        x[:, 2, 7: d // 2] = np.nan
        x[:, n - 1, d // 2:] = np.inf
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("where", sorted(ENGINE_D))
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 33, 64, 65, 128])
def test_cuda_sorted_reduce_engine_bitwise(cuda_device, n, dt, where):
    """B1 at K = 3 rounds, every network width and its edges, f32 and the
    16-bit keys, NaN and +-inf rows: median and trimmed mean (f = (n - 1) //
    3 and 0) bit for bit their plain versions, NaN canonical, one launch a
    call."""
    d = ENGINE_D[where]
    x = _engine_rows(n * 7 + d, 3, n, d, DTYPES[dt], cuda_device)
    for mode, f in (("median", 0), ("trimmed", (n - 1) // 3), ("trimmed", 0)):
        before = kernels.launch_counts[f"sorted_reduce:{mode}"]
        out = kernels.sorted_reduce_stream(x, mode=mode, f=f)
        torch.cuda.synchronize()
        assert kernels.launch_counts[f"sorted_reduce:{mode}"] == before + 1
        assert _bits_equal(out, kernels.sorted_reduce_stream_plain(x, mode=mode, f=f)), (mode, f)
        assert _all_canonical_nan(out[torch.isnan(out)])


@pytest.mark.cuda
@pytest.mark.parametrize("start", [1, 2, 3, 5])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
def test_cuda_sorted_reduce_at_every_base_alignment(cuda_device, dt, start):
    """A contiguous input that starts ``start`` elements into its storage
    (its rows at every byte alignment the dtype allows), n = 8, 64 and 100:
    bit for bit the plain version."""
    for n in (8, 64, 100):
        x = _engine_rows(start + n, 2, n, 5003, DTYPES[dt], cuda_device)
        big = torch.empty(x.numel() + start, dtype=x.dtype, device=cuda_device)
        big[start:] = x.reshape(-1)
        xv = big[start:].view(x.shape)
        assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
        for mode, f in (("median", 0), ("trimmed", 2)):
            out = kernels.sorted_reduce_stream(xv, mode=mode, f=f)
            assert _bits_equal(out, kernels.sorted_reduce_stream_plain(x, mode=mode, f=f)), (n, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("run_tiles", [0, 1, 2, 7, 1000])
def test_cuda_column_sort_any_run_length(cuda_device, run_tiles):
    """B1 and the segmented sort-reduce through their C entry points at a
    given run length (``kernels.column_runs`` picks it on the path): every
    length gives the bits of the plain versions, the last run partial or a
    slot in one run; a length of 0 is refused (cudaErrorInvalidValue)."""
    from byzpy_tpu_torch.ops import _build

    d = 100_003
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    x = _engine_rows(run_tiles, 2, 33, d, torch.float32, cuda_device)
    out = torch.zeros((2, d), device=cuda_device)
    rc = _build.function("byz_sorted_reduce")(x.data_ptr(), out.data_ptr(), 2, 33, d, 1, 4,
                                              kernels._DTYPE_CODES[torch.float32], run_tiles, stream)
    flat = x.reshape(66, d)
    offsets = torch.tensor([0, 33, 40], dtype=torch.int32, device=cuda_device)
    lengths = torch.tensor([33, 26, 0], dtype=torch.int32, device=cuda_device)
    seg = torch.zeros((3, d), device=cuda_device)
    rc_seg = _build.function("byz_segmented_sort_reduce")(
        flat.data_ptr(), offsets.data_ptr(), lengths.data_ptr(), seg.data_ptr(), 66, 3, d, 0, 0,
        run_tiles, stream)
    torch.cuda.synchronize()
    if run_tiles == 0:
        assert rc == rc_seg == 1
        return
    assert rc == rc_seg == 0
    assert _bits_equal(out, kernels.sorted_reduce_stream_plain(x, mode="trimmed", f=4))
    assert _bits_equal(seg, kernels.segmented_sort_reduce_plain(flat, offsets, lengths, mode="median"))


# ---------------------------------------------------------------------------
# B9's weights as one block-wide pass; B6 on the column-sort engine
# ---------------------------------------------------------------------------

B9_N = [1, 2, 8, 9, 13, 64, 65, 127, 128]


def _b9_gram(seed, K, n, case, device):
    """A (K, n, n) Gram with ties or tainted rows. ``dup``: B3's Gram of rows
    repeated in groups of three (equal distances at NNM's cut and in Krum's
    sort); ``quantized``: small integers, not symmetric, so most keys tie;
    ``taint``: an inf row in round 0 and a NaN entry in the last round's
    last row."""
    if case == "quantized":
        rng = np.random.default_rng(seed)
        g = rng.integers(-3, 4, size=(K, n, n)).astype(np.float32)
        g[:, np.arange(n), np.arange(n)] = rng.integers(6, 9, size=(K, n))
        return torch.from_numpy(g).to(device)
    x = _pre_rows(seed, K, n, 600, torch.device("cpu"))
    if case == "dup":
        x = x[:, np.arange(n) // 3 * 3]
    else:
        x[0, n // 2] = float("inf")
        x[-1, n - 1, 5] = float("nan")
    return kernels.gram(x.contiguous().to(device))


def _b9_args(n, mode):
    """(f_nnm, f, q) sets for n: the usual ones, and q as large as the mode
    takes (every mixer picked: all NaN where one took a tainted row)."""
    f_nnm = n // 4
    if mode == "krum":
        f = max(0, min((n - 3) // 4, n - 2))
        return [(f_nnm, f, max(1, n // 3)), (f_nnm, f, n - f)]
    return [(f_nnm, 0, max(1, n // 3)), (f_nnm, 0, n)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dup", "quantized", "taint"])
@pytest.mark.parametrize("n", B9_N)
def test_cuda_nnm_selection_weights_block_bitwise(cuda_device, n, case):
    """B9's weights at K = 3 in all three modes, bit for bit the plain
    version on the same Gram: rows tied at NNM's cut and in Krum's sort, a
    Gram that is not symmetric, tainted rows (the whole round NaN, the
    canonical NaN, when q picks a mixer that took one), one launch a call."""
    g = _b9_gram(7 * n + len(case), 3, n, case, cuda_device)
    for mode in ("krum", "cge", "monna"):
        if mode == "krum" and n < 2:
            continue
        for f_nnm, f, q in _b9_args(n, mode):
            kw = dict(k=n - f_nnm, f=f, q=q, mode=mode, reference_index=(n - 1) // 2)
            before = kernels.launch_counts[f"nnm_selection_weights:{mode}"]
            w = kernels.nnm_selection_weights(g, **kw)
            torch.cuda.synchronize()
            assert kernels.launch_counts[f"nnm_selection_weights:{mode}"] == before + 1
            ref = kernels.nnm_selection_weights_plain(g, **kw)
            assert _bits_equal(w, ref), (mode, f_nnm, f, q)
            assert _all_canonical_nan(w[torch.isnan(w)])
            if case == "taint" and q == n and mode != "krum" and n > 1:
                assert bool(torch.isnan(w[0]).all())  # every mixer of round 0 took the inf row


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [1, 2, 9, 64, 65, 100, 128])
def test_cuda_meamed_engine_bitwise(cuda_device, n, dt):
    """B6 at K = 3, f = 0, n // 4 and n - 1, bit for bit its plain version,
    NaN canonical, one launch a call: an odd d, and rows that start an
    element past an aligned address (16-bit rows at odd elements); NaN and
    +-inf columns, values quantized to halves so deviations tie at the
    cut."""
    for d, start in ((5003, 0), (4099, 1)):
        x = _meamed_rows(n * 11 + d, 3, max(n, 2), d, cuda_device, DTYPES[dt])[:, :n].contiguous()
        big = torch.empty(x.numel() + start, dtype=x.dtype, device=cuda_device)
        big[start:] = x.reshape(-1)
        xv = big[start:].view(x.shape)
        for f in sorted({0, n // 4, n - 1}):
            before = kernels.launch_counts["meamed"]
            out = kernels.meamed_stream(xv, f=f)
            torch.cuda.synchronize()
            assert kernels.launch_counts["meamed"] == before + 1
            assert _bits_equal(out, kernels.meamed_stream_plain(x, f=f)), (d, start, f)
            assert _all_canonical_nan(out[torch.isnan(out)])


@pytest.mark.cuda
@pytest.mark.parametrize("run_tiles", [0, 1, 2, 7, 1000])
def test_cuda_meamed_any_run_length(cuda_device, run_tiles):
    """B6 through its C entry point at a given run length, at 33 and 100
    rows: every length gives the plain version's bits; 0 is refused."""
    from byzpy_tpu_torch.ops import _build

    d = 20_003
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for n in (33, 100):
        x = _meamed_rows(run_tiles + n, 2, n, d, cuda_device, torch.float32)
        out = torch.zeros((2, d), device=cuda_device)
        rc = _build.function("byz_meamed")(x.data_ptr(), out.data_ptr(), 2, n, d, n // 4,
                                           kernels._DTYPE_CODES[torch.float32], run_tiles, stream)
        torch.cuda.synchronize()
        if run_tiles == 0:
            assert rc == 1
            continue
        assert rc == 0
        assert _bits_equal(out, kernels.meamed_stream_plain(x, f=n // 4))


# ---------------------------------------------------------------------------
# B4's and B10's weights as one block-wide pass over the round's Gram
# ---------------------------------------------------------------------------

SEL_N = [3, 8, 13, 16, 17, 64, 100, 128]


def _sel_args(n, mode):
    """(f, q) sets for n: the usual ones, and q as large as the mode takes
    (every node selected: B10's weights all NaN where a non-finite row is
    among them)."""
    if mode == "krum":
        f = max(0, min((n - 3) // 4, n - 2))
        return [(f, max(1, n // 3)), (f, n - f)]
    return [(0, max(1, n // 3)), (0, n)]


def _launch_once(key, call):
    """``call()``'s result, asserting that it launched ``key`` once."""
    before = kernels.launch_counts[key]
    out = call()
    torch.cuda.synchronize()
    assert kernels.launch_counts[key] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dup", "quantized", "taint"])
@pytest.mark.parametrize("n", SEL_N)
def test_cuda_selection_weights_block_bitwise(cuda_device, n, case):
    """B4's weights at K = 3 in all three modes, bit for bit the plain
    version on the same Gram, one launch a call: rows repeated in threes
    (ties in Krum's sort and in the ranks), a Gram that is not symmetric,
    an inf row and a NaN entry (NaN scores rank last: never selected while
    q leaves them out)."""
    g = _b9_gram(11 * n + len(case), 3, n, case, cuda_device)
    for mode in ("krum", "cge", "monna"):
        for f, q in _sel_args(n, mode):
            kw = dict(f=f, q=q, mode=mode, reference_index=(n - 1) // 2)
            w = _launch_once(f"selection_weights:{mode}", lambda: kernels.selection_weights(g, **kw))
            assert _bits_equal(w, kernels.selection_weights_plain(g, **kw)), (mode, f, q)
            assert bool(((w == 0) | (w == 1.0 / q)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dup", "quantized", "taint"])
@pytest.mark.parametrize("n", SEL_N)
def test_cuda_clip_selection_weights_block_bitwise(cuda_device, n, case):
    """B10's weights at K = 3, clip and ARC in all three modes, bit for bit
    the plain version on the same Gram, one launch a call: tau a norm of
    the round (rows at the threshold), ARC's cut among repeated norms, a
    Gram that is not symmetric, an inf norm and a NaN row, which are never
    selected or else poison the round to the canonical NaN. (Where ARC's
    cut lands on the NaN norm, every clip factor is NaN, in the kernel and
    the plain version alike.)"""
    from byzpy_tpu_torch.ops.preagg import arc_cut_off

    g = _b9_gram(13 * n + len(case), 3, n, case, cuda_device)
    norms = torch.sqrt(torch.diagonal(g, dim1=1, dim2=2).clamp(min=0))
    tau = float(norms[1].nan_to_num(0.0, 0.0, 0.0).median()) or 1.0
    for pre in ("clip", "arc"):
        extra = dict(tau=tau) if pre == "clip" else dict(cut_off=arc_cut_off(n, n // 4))
        for mode in ("krum", "cge", "monna"):
            for f, q in _sel_args(n, mode):
                kw = dict(pre=pre, f=f, q=q, mode=mode, reference_index=(n - 1) // 2, **extra)
                key = f"clip_selection_weights:{pre}"
                w = _launch_once(key, lambda: kernels.clip_selection_weights(g, **kw))
                assert _bits_equal(w, kernels.clip_selection_weights_plain(g, **kw)), (pre, mode, f, q)
                if case == "taint" and q == n and n > 1:
                    assert _all_canonical_nan(w[0])  # the inf row is among the n selected


# ---------------------------------------------------------------------------
# B8's selection state as one block-wide pass; B5 in one launch
# ---------------------------------------------------------------------------

B8_N = [1, 2, 3, 7, 8, 9, 16, 17, 31, 33, 64, 100, 127, 128]


def _b8_gram(seed, K, n, case, device):
    """``_b9_gram``'s Grams, and ``zeros``: rows repeated in threes with
    rows 1 and 4 zero (ties at the cut among equal and zero distances)."""
    if case != "zeros":
        return _b9_gram(seed, K, n, case, device)
    x = _pre_rows(seed, K, n, 600, torch.device("cpu"))[:, np.arange(n) // 3 * 3]
    x[:, [i for i in (1, 4) if i < n]] = 0.0
    return kernels.gram(x.contiguous().to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dup", "zeros", "quantized", "taint"])
@pytest.mark.parametrize("n", B8_N)
def test_cuda_nnm_weights_block_bitwise(cuda_device, n, case):
    """B8's selection state at K = 1 and 3 and k = 1, n - n // 4 and n, bit
    for bit the plain version on the same Gram, one launch a call: rows
    tied at the cut (repeated and zero rows), a Gram that is not symmetric,
    an inf row and a NaN entry (every mixer that took one is tainted and
    the row is cleared from the mask)."""
    for K in (1, 3):
        g = _b8_gram(17 * n + K + len(case), K, n, case, cuda_device)
        for k in sorted({1, n - n // 4, n}):
            mask, st = _launch_once("nnm_weights", lambda: kernels.nnm_weights(g, k=k))
            mask_p, st_p = kernels.nnm_weights_plain(g, k=k)
            assert _bits_equal(mask, mask_p) and _bits_equal(st, st_p), (K, k)
            if case == "taint" and k == n and n > 1:
                assert bool((st[0] == 1.0).all())  # every mixer of round 0 took the inf row


def _b5_rows(seed, n, d, dt, start, device, *, nonfinite):
    """(n, d) rows of dtype dt that start ``start`` elements past an
    aligned address (a view into a larger buffer), and their contiguous
    copy; rows 2 and 5 repeat row 1, row 3 is zero; with ``nonfinite``, row
    n - 1 holds NaN entries and row n // 2 is all inf (never selected by
    Krum while q leaves them out; selected by CGE and MoNNA at q = n)."""
    x = _pre_rows(seed, 1, n, d, device, DTYPES[dt])[0]
    if n > 5:
        x[2], x[5], x[3] = x[1], x[1], 0.0
    if nonfinite and n > 2:
        x[n - 1, ::7] = float("nan")
        x[n // 2] = float("inf")
    big = torch.zeros(n * d + start, dtype=x.dtype, device=device)
    big[start:] = x.reshape(-1)
    return big[start:].view(n, d), x.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize(("n", "d"), [(8, 1), (8, 255), (8, 256), (8, 257), (8, 421_642), (13, 257),
                                      (64, 255), (64, 1_048_576), (100, 257), (128, 421_642)])
def test_cuda_selection_mean_from_gram_one_launch_bitwise(cuda_device, n, d, dt):
    """B5 in one launch, every mode and two q, rows at element offsets 0
    and 1 (16-bit rows at odd elements, f32 rows 4-byte aligned), with and
    without non-finite rows: bit for bit the plain version, and B4's two
    kernels (weights, then the row sweep) on the same inputs; exactly one
    ``selection_mean_from_gram:<mode>`` launch a call. The calls run one
    after another on one scratch, each selecting other rows than the one
    before, so a flag left set would hand a call the last call's rows."""
    for start in (0, 1):
        for nonfinite in (False, True):
            xv, x = _b5_rows(31 * n + start, n, d, dt, start, cuda_device, nonfinite=nonfinite)
            g = kernels.gram(x[None])[0]
            for mode in ("krum", "cge", "monna"):
                f = max(0, min((n - 3) // 4, n - 2)) if mode == "krum" else 0
                for q in sorted({max(1, n // 3), n - f}):
                    sel = dict(f=f, q=q, mode=mode, reference_index=(n - 1) // 2)
                    before = dict(kernels.launch_counts)
                    out = kernels.selection_mean_from_gram(xv, g, **sel)
                    torch.cuda.synchronize()
                    moved = {k: v - before[k] for k, v in kernels.launch_counts.items() if v != before[k]}
                    assert moved == {f"selection_mean_from_gram:{mode}": 1}
                    assert _bits_equal(out, kernels.selection_mean_from_gram_plain(x, g, **sel)), (start, mode, q)
                    w = kernels.selection_weights(g[None], **sel)
                    assert _bits_equal(out, kernels.weighted_rows(x[None], w)[0]), (start, mode, q)
                    assert _all_canonical_nan(out[torch.isnan(out)])


@pytest.mark.cuda
def test_cuda_selection_mean_from_gram_runs_in_a_second_stream(cuda_device):
    """B5 on a side stream: its own scratch, the plain version's bits,
    and the default stream's calls unaffected."""
    x = _pre_rows(41, 1, 64, 5000, cuda_device)[0].contiguous()
    g = kernels.gram(x[None])[0]
    ref = kernels.selection_mean_from_gram_plain(x, g, f=8, q=12)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out_side = kernels.selection_mean_from_gram(x, g, f=8, q=12)
    out = kernels.selection_mean_from_gram(x, g, f=8, q=12)
    torch.cuda.synchronize()
    assert _bits_equal(out_side, ref) and _bits_equal(out, ref)



# ---------------------------------------------------------------------------
# the subset-search aggregators (MDA, SMEA) on B3
# ---------------------------------------------------------------------------


def _host_reads(fn):
    """``(fn(), the synchronizing CUDA operations it made)``, counted by
    PyTorch's sync debug mode."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _subset_rows(n, d, seed, outliers):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    x[n - outliers:] *= 3.0
    return torch.from_numpy(x)


SUBSET_CASES = [(8, 421_642, 2, 2), (12, 5000, 3, 3), (16, 4096, 5, 4), (30, 2048, 10, 6)]
# f32 rounding of a score or distance at the magnitudes of these rows
SUBSET_RTOL = 1e-5


def _near_tie(card, cpu, score):
    """Where the two devices chose different subsets, the card's scores
    within f32 rounding of the CPU winner on the CPU's own scores
    (``score(subset)``): a near tie that the last bits of B3's Gram may
    break either way."""
    best = score(cpu)
    return score(card) <= best + SUBSET_RTOL * abs(best)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,f,outliers", SUBSET_CASES)
def test_cuda_mda_selects_the_cpu_ports_subset(cuda_device, n, d, f, outliers):
    from byzpy_tpu_torch.aggregators import MinimumDiameterAveraging

    x = _subset_rows(n, d, n * 7 + f, outliers)
    card, cpu = MinimumDiameterAveraging(f), MinimumDiameterAveraging(f, device="cpu")
    xc = x.to(cuda_device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out, reads = _host_reads(lambda: card.aggregate(xc))
    assert kernels.launch_counts["gram"] == 1 and reads == 1  # B3 once, its d2 read once
    ref = cpu.aggregate(x)
    got, want = card.last_selection.tolist(), cpu.last_selection.tolist()
    if got != want:
        from byzpy_tpu_torch.aggregators.geometric_wise.minimum_diameter_average import (
            _dists_for_search,
        )

        d2 = _dists_for_search(x)
        assert _near_tie(got, want, lambda c: float(d2[np.ix_(c, c)].max())), (got, want)
    else:
        torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,f,outliers", SUBSET_CASES[:3])
def test_cuda_smea_selects_the_cpu_ports_subset_with_no_host_read(cuda_device, n, d, f, outliers):
    from byzpy_tpu_torch.aggregators import SMEA
    from byzpy_tpu_torch.aggregators.geometric_wise.smea import _device_combos
    from byzpy_tpu_torch.ops import robust

    x = _subset_rows(n, d, n * 5 + f, outliers)
    card, cpu = SMEA(f), SMEA(f, device="cpu")
    xc = x.to(cuda_device)
    card.aggregate(xc)  # the combos and the schedule reach the card once
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out, reads = _host_reads(lambda: card.aggregate(xc))
    assert reads == 0 and kernels.launch_counts["gram"] == 1
    ref = cpu.aggregate(x)
    combos = _device_combos(n, n - f, torch.device("cpu"))
    scores_cpu = robust.subset_max_eigvals_jacobi(robust.gram_matrix(x), combos)
    got, want = card.last_selection.tolist(), cpu.last_selection.tolist()
    rank = {tuple(c): i for i, c in enumerate(combos.tolist())}
    assert got == want or _near_tie(got, want, lambda c: float(scores_cpu[rank[tuple(c)]])), (got, want)
    if got == want:
        torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(8, 6), (16, 11), (12, 3)])
def test_cuda_jacobi_scores_within_f32_of_the_cpu_port(cuda_device, n, m):
    from byzpy_tpu_torch.aggregators.geometric_wise.smea import _device_combos
    from byzpy_tpu_torch.ops import robust

    x = _subset_rows(n, 3000, n + m, 2)
    x[1, :] = float("inf") if m == 3 else x[1, :]
    g = robust.gram_matrix(x)
    combos = _device_combos(n, m, torch.device("cpu"))
    ref = robust.subset_max_eigvals_jacobi(g, combos)
    gc, cc = g.to(cuda_device), _device_combos(n, m, cuda_device)
    robust.subset_max_eigvals_jacobi(gc, cc)  # the schedule reaches the card once
    torch.cuda.synchronize()
    got, reads = _host_reads(lambda: robust.subset_max_eigvals_jacobi(gc, cc))
    assert reads == 0
    got = got.cpu()
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(got[fin], ref[fin], rtol=0,
                               atol=SUBSET_RTOL * float(ref[fin].abs().max()))
    assert torch.equal(got[~fin], ref[~fin])


@pytest.mark.cuda
def test_cuda_subset_search_inherits_b3s_row_cap(cuda_device):
    from byzpy_tpu_torch.aggregators import SMEA, MinimumDiameterAveraging

    x = torch.zeros((129, 64), device=cuda_device)
    for agg in (MinimumDiameterAveraging(100), SMEA(60)):
        with pytest.raises(NotImplementedError, match="at most 128 rows"):
            agg.aggregate(x)
