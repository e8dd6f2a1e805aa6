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
@pytest.mark.parametrize("mode", ["masked_weiszfeld", "masked_clip"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,m", [(1, 1), (8, 6), (13, 13), (64, 41), (128, 100)])
def test_cuda_masked_center_loop_matches_plain_bitwise(cuda_device, n, m, dt, mode):
    """B7's masked modes in one launch equal their plain version bit for
    bit with the iteration count (Weiszfeld: to tol 1e-6 and 9 forced steps;
    centred clipping: 10 and 1 steps, some rows clipped), on ``m`` valid
    rows shuffled among zero padding rows at d = 4 x 4096 + 5 (several of
    row_sq_dists' lanes a row, a ragged last chunk); the padded loop equals
    the compacted one; a NaN or +-inf in a valid row makes the centre
    canonical NaN after one step."""
    from byzpy_tpu_torch.ops import robust

    d = 4 * 4096 + 5
    gen = torch.Generator(device=cuda_device).manual_seed(n + m)
    x = torch.zeros((n, d), device=cuda_device)
    x[:m] = torch.randn((m, d), generator=gen, device=cuda_device) * (
        torch.rand((m, 1), generator=gen, device=cuda_device) * 4.0 + 0.25)
    x = x[torch.randperm(n, generator=gen, device=cuda_device)].to(DTYPES[dt]).contiguous()
    valid = (x != 0).any(dim=1)
    clip = mode == "masked_clip"
    z = robust.masked_mean(x, valid) if clip else robust._masked_median_rows(x, valid)
    runs = ((dict(c_tau=2.0 * d ** 0.5, max_iter=10), dict(c_tau=2.0 * d ** 0.5, max_iter=1)) if clip
            else (dict(tol=1e-6, max_iter=256), dict(tol=-1.0, max_iter=9)))
    for kw in runs:
        kernels.reset_launch_counts()
        out, its = kernels.center_loop(x, z, mode=mode, valid=valid, **kw)
        assert kernels.launch_counts == dict(dict.fromkeys(kernels.launch_counts, 0),
                                             **{f"center_loop:{mode}": 1})
        ref, its_p = kernels.center_loop_plain(x, z, mode=mode, valid=valid, **kw)
        assert its.device.type == "cuda" and its.dtype == torch.int32
        assert int(its) == int(its_p) >= 1, (int(its), int(its_p))
        assert _bits_equal(out, ref), (n, m, dt, kw)
    keep = valid.nonzero()[:, 0]
    compact, its_c = kernels.center_loop(x.index_select(0, keep).contiguous(), z, mode=mode,
                                         valid=torch.ones(m, dtype=torch.bool, device=cuda_device),
                                         **runs[0])
    out, its = kernels.center_loop(x, z, mode=mode, valid=valid, **runs[0])
    assert _bits_equal(out, compact) and int(its) == int(its_c)
    x[int(keep[0]), 3] = float("nan")
    x[int(keep[-1]), 4] = float("inf")
    kw = dict(runs[0], max_iter=7)
    out, its = kernels.center_loop(x, z, mode=mode, valid=valid, **kw)
    ref, its_p = kernels.center_loop_plain(x, z, mode=mode, valid=valid, **kw)
    assert _all_canonical_nan(out) and _bits_equal(out, ref)
    assert int(its) == int(its_p) == (7 if clip else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["masked_weiszfeld", "masked_clip"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("d", [1, 1_000, 4_095, 3 * 4096 + 17, 50_001])
def test_cuda_masked_center_loop_lane_groups_match_plain(cuda_device, d, n, dt, mode):
    """The masked modes' one-read pass (a block a group of 32 of
    row_sq_dists' lanes, walking its columns 4096 apart) equals the plain
    version bit for bit at a d below 4,096 (lanes and whole lane groups
    without a column), at a d whose last tile is ragged, and at one column;
    6 forced steps, 3 in 4 rows valid."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + n)
    x = (torch.randn((n, d), generator=gen, device=cuda_device)
         * torch.linspace(0.5, 3.0, n, device=cuda_device)[:, None]).to(DTYPES[dt])
    valid = torch.arange(n, device=cuda_device) % 4 != 1
    x[~valid] = 0
    z = x[0].clone()
    kw = dict(c_tau=1.5 * d ** 0.5) if mode == "masked_clip" else dict(tol=-1.0)
    out, its = kernels.center_loop(x, z, mode=mode, valid=valid, max_iter=6, **kw)
    ref, its_p = kernels.center_loop_plain(x, z, mode=mode, valid=valid, max_iter=6, **kw)
    assert int(its) == int(its_p) == 6 and _bits_equal(out, ref), (d, n, dt, mode)


@pytest.mark.cuda
def test_cuda_masked_geometric_median_reads_nothing_on_the_host(cuda_device):
    """``robust.masked_geometric_median`` is B2 (its median start) and one
    B7 launch, with no synchronizing call (sync debug mode ``error``), its
    count a device tensor."""
    from byzpy_tpu_torch.ops import robust

    x = torch.randn((64, 50_001), device=cuda_device)
    valid = torch.arange(64, device=cuda_device) < 29
    robust.masked_geometric_median(x, valid)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        robust.masked_geometric_median(x, valid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert {k: v for k, v in kernels.launch_counts.items() if v} == {
        "sort_columns": 1, "center_loop:masked_weiszfeld": 1}
    its = robust.last_iterations["geometric_median"]
    assert isinstance(its, torch.Tensor) and its.is_cuda and int(its) >= 1


@pytest.mark.cuda
def test_cuda_masked_centered_clipping_reads_nothing_on_the_host(cuda_device):
    """``robust.masked_centered_clipping`` is B11 (its mean start) and one
    launch of B7's masked_clip mode, with no synchronizing call (sync debug
    mode ``error``), and equals the loop's plain version from that start."""
    from byzpy_tpu_torch.ops import robust

    x = torch.randn((64, 50_001), device=cuda_device)
    valid = torch.arange(64, device=cuda_device) < 29
    robust.masked_centered_clipping(x, valid, c_tau=300.0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = robust.masked_centered_clipping(x, valid, c_tau=300.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert {k: v for k, v in kernels.launch_counts.items() if v} == {
        "segment_sum": 1, "center_loop:masked_clip": 1}
    ref, _ = kernels.center_loop_plain(x, robust.masked_mean(x, valid), mode="masked_clip",
                                       valid=valid, c_tau=300.0, max_iter=10)
    assert _bits_equal(out, ref)


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
    bit for bit, and launches B2 / B11 (the geometric median: B2 and B7's
    masked Weiszfeld mode; centred clipping: B11 and B7's masked clip mode)
    and none of B1, B4, B6 or B7's unmasked modes."""
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
    if name == "geomed":
        assert counts["center_loop:masked_weiszfeld"] == 1 and counts["segment_sum"] == 0
    elif name == "clip":
        assert counts["center_loop:masked_clip"] == 1 and counts["row_sq_dists"] == 0
    else:
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
    """A batch of any number of rows runs (the R cap is lifted); a slot of
    more than 128 rows writes NaN, never a wrong value; bf16 and a strided
    batch are refused."""
    offsets = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    lengths = torch.tensor([1, 129], dtype=torch.int32, device=cuda_device)
    flat = torch.ones((129, 10), device=cuda_device)
    out = kernels.segmented_sort_reduce(flat, offsets, lengths, mode="median")
    assert torch.equal(out[0], torch.ones(10, device=cuda_device))
    assert _all_canonical_nan(out[1])
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
    """B3 takes at most 128 rows; above them the classes' Gram is the gate's
    ``torch.matmul`` (no cap, no B3 launch) and the selection is the CPU
    run's."""
    from byzpy_tpu_torch.aggregators import SMEA, MinimumDiameterAveraging

    x = torch.from_numpy(_matrix(np.random.default_rng(3), (129, 64), specials=False))
    for cls in (MinimumDiameterAveraging, SMEA):
        before = kernels.launch_counts["gram"]
        agg = cls(1)
        got = agg.aggregate(x.to(cuda_device))
        assert kernels.launch_counts["gram"] == before
        ref_agg = cls(1, device="cpu")
        ref = ref_agg.aggregate(x)
        assert torch.equal(agg.last_selection.cpu(), ref_agg.last_selection)
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# more than 128 rows: the gate, the lifted segmented R, the process tier
# ---------------------------------------------------------------------------

NETWORK_COUNTERS = ("sorted_reduce:median", "sorted_reduce:trimmed", "gram", "meamed",
                    "selection_weights:krum", "selection_weights:cge", "selection_weights:monna",
                    "weighted_rows", "nnm_weights", "mix_rows", "center_loop:weiszfeld",
                    "center_loop:clip", "sort_columns")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["median", "trimmed", "meamed", "multi_krum", "cge", "nnm"])
def test_cuda_gate_launch_counts(cuda_device, name):
    """At 128 rows the network kernels launch; at 129 and 256 none does,
    and the card's result is the CPU run's (exact for the sort family and
    the selections, within f32 rounding of two Gram orders for NNM)."""
    from byzpy_tpu_torch.ops import preagg, robust

    fn = {"median": robust.coordinate_median,
          "trimmed": lambda x: robust.trimmed_mean(x, f=20),
          "meamed": lambda x: robust.mean_of_medians(x, f=20),
          "multi_krum": lambda x: robust.multi_krum(x, f=20, q=40),
          "cge": lambda x: robust.cge(x, f=20),
          "nnm": lambda x: preagg.nnm(x, f=20)}[name]
    for n in (128, 129, 256):
        x = torch.from_numpy(_matrix(np.random.default_rng(n), (n, 4096), specials=False))
        kernels.reset_launch_counts()
        got = fn(x.to(cuda_device))
        torch.cuda.synchronize()
        launched = {k for k in NETWORK_COUNTERS if kernels.launch_counts[k]}
        assert bool(launched) == (n <= 128), (n, launched)
        ref = fn(x)
        if name == "nnm" or n <= 128:
            torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(got.cpu(), ref), n


@pytest.mark.cuda
def test_cuda_ragged_executor_above_128_rows(cuda_device):
    """A capacity of 256 rows: slots of at most 128 run the segmented
    sort-reduce over the whole batch; a slot of 200 rows takes the torch
    path (long_slots) and is never NaN; both equal the CPU's masked door."""
    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian, CoordinateWiseTrimmedMean
    from byzpy_tpu_torch.serving import RaggedExecutor
    from byzpy_tpu_torch.serving.cohort import StalenessPolicy, build_cohort
    from byzpy_tpu_torch.serving.queue import Submission

    d = 512
    rng = np.random.default_rng(5)
    for make in (lambda dev: CoordinateWiseMedian(device=dev),
                 lambda dev: CoordinateWiseTrimmedMean(3, device=dev)):
        for sizes in ((100, 128), (200, 40)):
            rows = [rng.normal(size=(m, d)).astype(np.float32) for m in sizes]
            views = {}
            for dev in ("cuda", "cpu"):
                ex = RaggedExecutor(make(dev), d, 256, 2, with_evidence=False)
                cohorts = [build_cohort([Submission(f"c{i}", 0, torch.from_numpy(r), float(i))
                                         for i, r in enumerate(rs)], 0, None, StalenessPolicy(),
                                        device=dev) for rs in rows]
                kernels.reset_launch_counts()
                views[dev] = [v.vector.cpu() for v in ex.aggregate(cohorts, ["t", "t"])]
                if dev == "cuda":
                    torch.cuda.synchronize()
                    segmented = kernels.launch_counts["segmented_sort_reduce"]
                    assert segmented == (1 if max(sizes) <= 128 else 0), (sizes, segmented)
            for a, b in zip(views["cuda"], views["cpu"]):
                assert torch.isfinite(a).all()
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _child_median_and_builds(x):
    """In a process actor's child: the median on the child's card, and
    whether this process compiled any kernel (it loads the parent's)."""
    from byzpy_tpu_torch.ops import _build, robust

    out = robust.coordinate_median(x.to("cuda"))
    return out, dict(_build.build_log), torch.cuda.current_device()


class _Runner:
    def run(self, fn, *args):
        return fn(*args)


@pytest.mark.cuda
def test_cuda_process_actor_uses_the_card_and_the_parents_build(cuda_device):
    """A process actor on the card (the default child device): its median
    equals the parent's bit for bit, and the child compiled nothing (the
    parent built the kernels before it spawned)."""
    import asyncio

    from byzpy_tpu_torch.engine.actor.backends.process import ProcessActorBackend
    from byzpy_tpu_torch.engine.actor.base import spawn_actor
    from byzpy_tpu_torch.ops import robust

    x = torch.from_numpy(_matrix(np.random.default_rng(9), (64, 65536), specials=False))

    async def main():
        backend = ProcessActorBackend()
        try:
            ref = await spawn_actor(backend, _Runner)
            return await asyncio.wait_for(ref.run(_child_median_and_builds, x), 300)
        finally:
            await backend.close()

    out, log, device = asyncio.run(asyncio.wait_for(main(), 400))
    assert device == 0 and log == {}
    assert torch.equal(out, robust.coordinate_median(x.to(cuda_device)).cpu())


# ---------------------------------------------------------------------------
# compiled steps: CUDA-graph replays against the eager step
# ---------------------------------------------------------------------------


@pytest.fixture
def deterministic_cudnn(cuda_device):
    """cuDNN's deterministic algorithms, so that an eager step and a graph
    replay of it can be compared bit for bit."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32) = saved


def _flat_state(tree):
    from byzpy_tpu_torch.utils.trees import _spec

    leaves = []
    _spec(tree, leaves)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def _states_bits_equal(a, b) -> bool:
    la, lb = _flat_state(a), _flat_state(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def _smallcnn_round(device, n=8, batch=16):
    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification

    bundle = make_bundle(SmallCNN(), seed=0, device=device)
    x, y = synthetic_classification(n_samples=n * batch, seed=3, device=device)
    return bundle, x.reshape(n, batch, 28, 28, 1), y.reshape(n, batch)


def _compiled_aggregators():
    from byzpy_tpu_torch.aggregators import SMEA
    from byzpy_tpu_torch.ops import robust

    return {
        "median": robust.coordinate_median,
        "multi_krum": lambda m: robust.multi_krum(m, f=2, q=4),
        "centered_clipping": lambda m: robust.centered_clipping(m, c_tau=10.0, M=10),
        "smea": SMEA(2, device="cuda").matrix_fn(),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["median", "multi_krum", "centered_clipping", "smea"])
def test_cuda_compiled_ps_step_replays_bitwise(deterministic_cudnn, agg):
    """Five replays of ``jit_ps_train_step``'s graph (donated state) equal
    five eager steps from the same start bit for bit: parameters, momentum
    and metrics; the kernels count once, the replays under their key."""
    from byzpy_tpu_torch.ops import attack_ops
    from byzpy_tpu_torch.parallel import PSStepConfig, build_ps_train_step, jit_ps_train_step

    fn = _compiled_aggregators()[agg]
    bundle, xs, ys = _smallcnn_round("cuda")
    cfg = PSStepConfig(n_nodes=8, n_byzantine=2)

    def attack(honest, g):
        return attack_ops.sign_flip(honest.mean(dim=0))

    eager, opt0 = build_ps_train_step(bundle, fn, cfg, attack=attack)
    compiled, copt0 = jit_ps_train_step(bundle, fn, cfg, attack=attack)
    start = {k: v.clone() for k, v in bundle.params.items()}
    kernels.reset_launch_counts()
    pe, oe, pc, oc = bundle.params, opt0, bundle.params, copt0
    for s in range(5):
        pe, oe, me = eager(pe, oe, xs, ys)
        pc, oc, mc = compiled(pc, oc, xs, ys)
        assert _states_bits_equal((pe, oe, me), (pc, oc, mc)), f"step {s + 1}"
    assert kernels.launch_counts["graph_replay:ps_train_step"] == 5
    assert len(compiled.graphs) == 1
    recorded = compiled.last_capture["launches"]
    assert recorded and "graph_replay:ps_train_step" not in recorded
    # the caller's start is untouched: donation writes the graph's own buffers
    assert _states_bits_equal(bundle.params, start)


@pytest.mark.cuda
def test_cuda_b5_and_b7_inside_a_graph_bitwise(cuda_device):
    """B5 (one launch, a ticket and a scratch its last block re-zeroes) and
    B7 (a cooperative launch whose barrier counter a memset resets) captured
    in one graph after a warm-up on the capture stream: every one of five
    replays, on the same memory, gives the eager bits."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(8, 421_642)).astype(np.float32)).to(cuda_device)
    x[6:] *= 4.0
    g = kernels.gram(x[None])[0]
    z0 = x.mean(dim=0)
    want_b5 = kernels.selection_mean_from_gram(x, g, f=2, q=4)
    want_b7, want_it = kernels.center_loop(x, z0, mode="clip", c_tau=900.0, max_iter=10)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up: per-stream caches, first-launch attributes
        kernels.selection_mean_from_gram(x, g, f=2, q=4)
        kernels.center_loop(x, z0, mode="clip", c_tau=900.0, max_iter=10)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        b5 = kernels.selection_mean_from_gram(x, g, f=2, q=4)
        b7, it = kernels.center_loop(x, z0, mode="clip", c_tau=900.0, max_iter=10)
    for r in range(5):
        b5.zero_()
        b7.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert _bits_equal(b5, want_b5), f"B5, replay {r + 1}"
        assert _bits_equal(b7, want_b7) and int(it) == int(want_it), f"B7, replay {r + 1}"


@pytest.mark.cuda
def test_cuda_compiled_gaussian_noise_per_replay(deterministic_cudnn):
    """A generator passed to the compiled step draws fresh noise at every
    replay (the byzantine rows differ step to step) and the same noise as
    the eager step from the same seed; the caller's generator advances as
    the eager step's does."""
    from byzpy_tpu_torch.ops import attack_ops, robust
    from byzpy_tpu_torch.parallel import PSStepConfig, build_ps_train_step, jit_ps_train_step

    bundle, xs, ys = _smallcnn_round("cuda")
    cfg = PSStepConfig(n_nodes=8, n_byzantine=2)
    rows = []

    def attack(honest, g):
        return attack_ops.gaussian(g, (honest.shape[1],), honest.dtype, device=honest.device)

    def eager_attack(honest, g):
        rows.append(attack(honest, g))
        return rows[-1]

    eager, opt0 = build_ps_train_step(bundle, robust.coordinate_median, cfg, attack=eager_attack)
    compiled, _ = jit_ps_train_step(bundle, robust.coordinate_median, cfg, attack=attack,
                                    donate=False)
    ge = torch.Generator(device="cuda").manual_seed(11)
    gc = torch.Generator(device="cuda").manual_seed(11)
    pe, oe, pc, oc = bundle.params, opt0, bundle.params, opt0
    norms = []
    for s in range(3):
        pe, oe, me = eager(pe, oe, xs, ys, generator=ge)
        pc, oc, mc = compiled(pc, oc, xs, ys, generator=gc)
        assert _states_bits_equal((pe, oe, me), (pc, oc, mc)), f"step {s + 1}"
        assert torch.equal(ge.get_state(), gc.get_state())
        norms.append(float(mc["agg_grad_norm"]))
    assert len(set(norms)) == 3
    assert not torch.equal(rows[0], rows[1])  # the eager draws advance too


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["multi_krum", "meamed"])
def test_cuda_compiled_serving_step_bitwise(deterministic_cudnn, which):
    """``jit_serving_ps_step`` at bucket 64 (a cohort of 13 valid rows):
    five replays equal the eager step bit for bit and capture one graph."""
    from byzpy_tpu_torch.aggregators import MeanOfMedians, MultiKrum
    from byzpy_tpu_torch.parallel import build_serving_ps_step, jit_serving_ps_step

    agg = MultiKrum(2, 4, device="cuda") if which == "multi_krum" else MeanOfMedians(2, device="cuda")
    bundle, _, _ = _smallcnn_round("cuda")
    d = sum(int(v.numel()) for v in bundle.params.values())
    rng = np.random.default_rng(3)
    matrix = torch.zeros((64, d), device="cuda")
    matrix[:13] = torch.from_numpy(rng.normal(size=(13, d)).astype(np.float32)).cuda()
    valid = torch.zeros(64, dtype=torch.bool, device="cuda")
    valid[:13] = True
    weights = valid.float()
    eager, opt0 = build_serving_ps_step(bundle, agg.masked_matrix_fn())
    compiled, _ = jit_serving_ps_step(bundle, agg.masked_matrix_fn())
    pe, oe, pc, oc = bundle.params, opt0, bundle.params, opt0
    for s in range(5):
        pe, oe, me = eager(pe, oe, matrix, valid, weights)
        pc, oc, mc = compiled(pc, oc, matrix, valid, weights)
        assert _states_bits_equal((pe, oe, me), (pc, oc, mc)), f"step {s + 1}"
    assert len(compiled.graphs) == 1


@pytest.mark.cuda
def test_cuda_compiled_ragged_step_bitwise(deterministic_cudnn):
    """``jit_ragged_serving_ps_step`` at capacity 64, trimmed mean through
    the segmented sort-reduce: replays equal the eager step at cohorts of
    6, 13 and 29 rows, one graph for all."""
    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean
    from byzpy_tpu_torch.parallel import build_ragged_serving_ps_step, jit_ragged_serving_ps_step

    agg = CoordinateWiseTrimmedMean(2, device="cuda")
    bundle, _, _ = _smallcnn_round("cuda")
    d = sum(int(v.numel()) for v in bundle.params.values())
    rng = np.random.default_rng(5)
    eager, opt0 = build_ragged_serving_ps_step(bundle, agg.ragged_matrix_fn(), row_capacity=64)
    compiled, _ = jit_ragged_serving_ps_step(bundle, agg.ragged_matrix_fn(), row_capacity=64)
    pe, oe, pc, oc = bundle.params, opt0, bundle.params, opt0
    for m in (6, 13, 29):
        flat = torch.zeros((64, d), device="cuda")
        flat[:m] = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).cuda()
        weights = torch.zeros(64, device="cuda")
        weights[:m] = 1.0
        offsets = torch.zeros(1, dtype=torch.int32, device="cuda")
        lengths = torch.tensor([m], dtype=torch.int32, device="cuda")
        pe, oe, me = eager(pe, oe, flat, offsets, lengths, weights)
        pc, oc, mc = compiled(pc, oc, flat, offsets, lengths, weights)
        assert _states_bits_equal((pe, oe, me), (pc, oc, mc)), f"m = {m}"
    assert len(compiled.graphs) == 1


def _refusals():
    """name -> (twin builder of a SmallCNN bundle, the role the error names)."""
    from byzpy_tpu_torch.aggregators import MinimumDiameterAveraging
    from byzpy_tpu_torch.attacks import InfluenceAscentAttack
    from byzpy_tpu_torch.ops import robust
    from byzpy_tpu_torch.parallel import PSStepConfig, adaptive_attack_rows, jit_ps_train_step

    cfg = PSStepConfig(n_nodes=8, n_byzantine=2)

    def influence(bundle):
        d = sum(int(v.numel()) for v in bundle.params.values())
        atk = InfluenceAscentAttack(d, device="cuda")
        return jit_ps_train_step(bundle, robust.coordinate_median, cfg,
                                 attack=lambda h, g: adaptive_attack_rows(atk, 2, honest=h))

    return {
        "mda": (lambda b: jit_ps_train_step(
            b, MinimumDiameterAveraging(2, device="cuda").matrix_fn(), cfg), "aggregate"),
        "influence_ascent": (influence, "attack"),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mda", "influence_ascent"])
def test_cuda_compiled_step_refuses_host_reads(cuda_device, which):
    """A step whose aggregate or attack reads the host cannot be captured:
    the twin raises ``GraphCaptureError`` naming the callable's role and
    saying that it reads the host, and runs nothing eagerly in its place.
    MDA's branch-and-bound and the adaptive attacks read it by design."""
    from byzpy_tpu_torch.utils.cuda_graph import GraphCaptureError

    make, role = _refusals()[which]
    bundle, xs, ys = _smallcnn_round("cuda")
    step, opt0 = make(bundle)
    args = (bundle.params, opt0, xs, ys)
    kernels.reset_launch_counts()
    with pytest.raises(GraphCaptureError, match=rf"the {role} callable .* reads the host"):
        step(*args)
    assert not step.graphs
    assert all(v == 0 for k, v in kernels.launch_counts.items() if k.startswith("graph_replay"))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["caf", "masked_geometric_median"])
def test_cuda_compiled_step_captures_the_host_free_loops(deterministic_cudnn, which):
    """CAF (fixed passes) in the PS step and the masked geometric median
    (B7's masked mode) in the serving step at bucket 64 no longer read the
    host: each twin captures one graph, five replays equal the eager steps
    bit for bit, and a replay makes no synchronizing call (sync debug mode
    ``error``)."""
    from byzpy_tpu_torch.aggregators import GeometricMedian
    from byzpy_tpu_torch.ops import robust
    from byzpy_tpu_torch.parallel import (
        PSStepConfig, build_ps_train_step, build_serving_ps_step, jit_ps_train_step,
        jit_serving_ps_step,
    )

    bundle, xs, ys = _smallcnn_round("cuda")
    d = sum(int(v.numel()) for v in bundle.params.values())
    if which == "caf":
        v0 = torch.randn((d,), generator=torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")

        def agg(m):
            return robust.caf(m, f=2, v_init=v0)

        cfg = PSStepConfig(n_nodes=8, n_byzantine=2)
        eager, opt0 = build_ps_train_step(bundle, agg, cfg)
        compiled, _ = jit_ps_train_step(bundle, agg, cfg, donate=False)
        args = (xs, ys)
    else:
        fn = GeometricMedian(device="cuda").masked_matrix_fn()
        eager, opt0 = build_serving_ps_step(bundle, fn)
        compiled, _ = jit_serving_ps_step(bundle, fn)
        gen = torch.Generator(device="cuda").manual_seed(4)
        matrix = torch.zeros((64, d), device="cuda")
        matrix[:37] = torch.randn((37, d), generator=gen, device="cuda")
        valid = torch.arange(64, device="cuda") < 37
        args = (matrix, valid, valid.float())
    pe, oe, pc, oc = bundle.params, opt0, bundle.params, opt0
    for s in range(5):
        pe, oe, me = eager(pe, oe, *args)
        pc, oc, mc = compiled(pc, oc, *args)
        assert _states_bits_equal((pe, oe, me), (pc, oc, mc)), f"step {s + 1}"
    assert len(compiled.graphs) == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        compiled(pc, oc, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("attacked", [False, True])
def test_cuda_compiled_gossip_step_replays_bitwise(deterministic_cudnn, attacked):
    """``jit_gossip_train_step`` on SmallCNN over ring(8, 2) (NNM then the
    geometric median, as BASELINE config #4 aggregates; one byzantine node,
    attacked: Gaussian rows from the step's generator): two replays equal
    two eager steps bit for bit, theta and the honest loss, the generators
    advance alike, one graph, each node's kernels counted once at the
    capture and one replay a step."""
    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.ops import attack_ops, preagg, robust
    from byzpy_tpu_torch.parallel import GossipStepConfig, build_gossip_train_step, jit_gossip_train_step

    bundle, xs, ys = _smallcnn_round("cuda", batch=8)

    def agg(m):
        return robust.geometric_median(preagg.nnm(m, f=1), max_iter=32)

    attack = None
    if attacked:
        def attack(honest, g):
            return attack_ops.gaussian(g, (honest.shape[1],), sigma=0.1, device="cuda")

    topo, cfg = Topology.ring(8, 2), GossipStepConfig(8, 1, 0.05)
    eager, init = build_gossip_train_step(bundle, agg, topo, cfg, attack=attack)
    compiled, cinit = jit_gossip_train_step(bundle, agg, topo, cfg, attack=attack)
    ge = torch.Generator(device="cuda").manual_seed(9) if attacked else None
    gc = torch.Generator(device="cuda").manual_seed(9) if attacked else None
    te, tc = init(), cinit()
    kernels.reset_launch_counts()
    for s in range(2):
        te, me = eager(te, xs, ys, generator=ge)
        tc, mc = compiled(tc, xs, ys, generator=gc)
        assert _bits_equal(te, tc) and _bits_equal(me["honest_loss"], mc["honest_loss"]), s
        if attacked:
            assert torch.equal(ge.get_state(), gc.get_state())
    assert len(compiled.graphs) == 1
    per_node = {"gram": 8, "nnm_weights": 8, "mix_rows": 8, "sorted_reduce:median": 8,
                "center_loop:weiszfeld": 8}
    assert compiled.last_capture["launches"] == per_node
    assert kernels.launch_counts["graph_replay:gossip_train_step"] == 2


# ---------------------------------------------------------------------------
# the engine's cuda actor pool: stream discipline and pooled results
# ---------------------------------------------------------------------------

# ~50 ms of device time at the H100's clock: long enough that a missing
# wait or an early reuse shows
_SLEEP_CYCLES = 100_000_000


class _StreamWorker:
    """An actor object whose methods queue slow work on the actor's stream."""

    def stream_id(self):
        return torch.cuda.current_stream().cuda_stream

    def slow_double(self, x):
        torch.cuda._sleep(_SLEEP_CYCLES)
        return x * 2

    def slow_clone(self, v):
        torch.cuda._sleep(_SLEEP_CYCLES)
        return v.clone()

    def block(self, event):
        event.wait(timeout=60)
        return torch.ones(2, device="cuda")


def _engine_run(coro, timeout=120):
    import asyncio

    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.mark.cuda
def test_cuda_actor_stream_discipline(cuda_device):
    """Each actor runs on a stream of its own; the caller's stream waits on
    the actor's result, the actor waits on the caller's writes, and a
    chunk view the caller drops (allocated on a stream that never waits on
    the actor) is not handed to a new allocation while the actor reads
    it."""
    import asyncio

    from byzpy_tpu_torch.engine.actor import spawn_actor
    from byzpy_tpu_torch.engine.actor.backends.cuda import CudaActorBackend

    async def go():
        a = await spawn_actor(CudaActorBackend(), _StreamWorker)
        b = await spawn_actor(CudaActorBackend(), _StreamWorker)
        streams = {await a.stream_id(), await b.stream_id(),
                   torch.cuda.current_stream().cuda_stream}
        # the caller waits on the actor: read the result at once
        x = torch.full((1 << 20,), 3.0, device=cuda_device)
        seen_after = (await a.slow_double(x)).clone()
        # the actor waits on the caller: a slow write, then the actor reads
        y = torch.empty((1 << 20,), device=cuda_device)
        torch.cuda._sleep(_SLEEP_CYCLES)
        y.fill_(5.0)
        seen_before = await b.slow_clone(y)
        # a dropped view of a matrix made on a side stream
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            m = torch.full((64, 1 << 16), 7.0, device=cuda_device)
            task = asyncio.ensure_future(a.slow_clone(m[:, : 1 << 15]))
            await asyncio.sleep(0)  # the call records its event on `side`
            del m
        out = await task
        with torch.cuda.stream(side):
            junk = [torch.empty((64, 1 << 16), device=cuda_device).fill_(-1.0) for _ in range(4)]
        torch.cuda.synchronize()
        for ref in (a, b):
            await ref.backend.close()
        return streams, seen_after, seen_before, out, junk

    streams, seen_after, seen_before, out, _ = _engine_run(go())
    assert len(streams) == 3
    assert bool((seen_after == 6.0).all()) and bool((seen_before == 5.0).all())
    assert bool((out == 7.0).all())


@pytest.mark.cuda
def test_cuda_capture_refused_while_the_pool_runs(cuda_device):
    """A CUDA-graph capture while a cuda actor's call runs raises
    ``GraphCaptureError``; after the pool closes the same step captures."""
    import asyncio
    import threading

    from byzpy_tpu_torch.engine.actor import spawn_actor
    from byzpy_tpu_torch.engine.actor.backends.cuda import CudaActorBackend
    from byzpy_tpu_torch.utils.cuda_graph import CapturedStep, GraphCaptureError

    step = CapturedStep(lambda p, o: (p * 2, o + 1, {"s": p.sum()}), name="ps_train_step",
                        donate=False)
    p, o = torch.ones(8, device=cuda_device), torch.zeros(8, device=cuda_device)

    async def go():
        a = await spawn_actor(CudaActorBackend(), _StreamWorker)
        event = threading.Event()
        task = asyncio.ensure_future(a.block(event))
        await asyncio.sleep(0.1)
        try:
            with pytest.raises(GraphCaptureError, match="cuda actor call"):
                step(p, o)
        finally:
            event.set()
        await task
        await a.backend.close()

    _engine_run(go())
    p2, o2, m = step(p, o)
    assert len(step.graphs) == 1 and bool((p2 == 2).all()) and float(m["s"]) == 8.0


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [2, 4])
def test_cuda_pooled_coordinate_wise_classes_bitwise(cuda_device, workers):
    """On a cuda pool the coordinate-wise classes (feature chunks of B1 and
    B6, the attacks' column spans) give their direct results bit for bit,
    and each chunk's kernel launched on an actor."""
    from byzpy_tpu_torch import attacks as A
    from byzpy_tpu_torch import aggregators as P
    from byzpy_tpu_torch.engine.graph import ActorPoolConfig, run_operator, select_adaptive_chunk_size

    x = torch.from_numpy(_matrix(np.random.default_rng(workers), (13, 50_001), specials=False))
    x = x.to(cuda_device)
    rows = list(x)
    cfg = ActorPoolConfig(backend="cuda", count=workers)
    cases = [
        (P.CoordinateWiseMedian(chunk_size=4096), {"gradients": rows}, "sorted_reduce:median"),
        (P.CoordinateWiseTrimmedMean(3, chunk_size=4096), {"gradients": rows},
         "sorted_reduce:trimmed"),
        (P.MeanOfMedians(3, chunk_size=4096), {"gradients": rows}, "meamed"),
        (A.EmpireAttack(scale=-1.1), {"honest_grads": rows}, None),
        (A.SignFlipAttack(), {"base_grad": rows[0]}, None),
        (A.MimicAttack(epsilon=2), {"honest_grads": rows}, None),
    ]
    chunk = select_adaptive_chunk_size(50_001, 4096, pool_size=workers)
    for op, inputs, key in cases:
        op.chunk_size = 4096
        before = kernels.launch_counts[key] if key else 0
        pooled = _engine_run(run_operator(op, inputs, pool_config=cfg))
        if key:
            assert kernels.launch_counts[key] - before == -(-50_001 // chunk)
            direct = op.aggregate(rows)
        else:
            direct = op.apply(**inputs)
        torch.cuda.synchronize()
        assert _bits_equal(pooled, direct), op.name


# ---------------------------------------------------------------------------
# the orchestrators on cuda node actors
# ---------------------------------------------------------------------------


def _orchestrator_classes():
    """An honest node that computes a gradient on its actor's stream (a
    slow queue of work first, so a missing wait shows), optionally blocking
    on an event or returning NaN after a host sleep; a sign-flip node."""
    import threading
    import time

    from byzpy_tpu_torch.engine.node import ByzantineNode, HonestNode

    class Node(HonestNode):
        def __init__(self, idx, d=1 << 16):
            g = torch.Generator(device="cuda").manual_seed(idx)
            self.base = torch.randn((d,), device="cuda", generator=g)
            self.state = torch.zeros((d,), device="cuda")
            self.calls = 0
            self.hang_s = None
            self.block = None

        def next_batch(self):
            return None, None

        def set_hang(self, seconds):
            self.hang_s = seconds

        def set_block(self, event: threading.Event):
            self.block = event

        def honest_gradient(self, x, y):
            self.calls += 1
            if self.block is not None:
                self.block.wait(30.0)
            torch.cuda._sleep(_SLEEP_CYCLES // 10)
            g = self.base * self.calls + 0.5 * self.state
            if self.hang_s is not None:
                self.hang_s, seconds = None, self.hang_s
                time.sleep(seconds)
                return torch.full_like(g, float("nan"))
            return g

        def apply_server_gradient(self, gradient):
            torch.cuda._sleep(_SLEEP_CYCLES // 10)
            self.state = self.state - 0.1 * gradient

        def snapshot(self):
            return self.state.clone()

    class Flip(ByzantineNode):
        def next_batch(self):
            return None, None

        def byzantine_gradient(self, honest):
            return -2.0 * honest[0]

        def apply_server_gradient(self, gradient):
            pass

    return Node, Flip


async def _spawn_orchestrator_nodes(backend, n=4):
    from byzpy_tpu_torch.engine.node import ByzantineNodeActor, HonestNodeActor

    Node, Flip = _orchestrator_classes()
    honest = [await HonestNodeActor.spawn(Node, i, backend=backend) for i in range(n)]
    byz = [await ByzantineNodeActor.spawn(Flip, backend=backend)]
    return honest, byz


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_cuda_ps_round_on_cuda_actors_equals_thread_actors(cuda_device, overlap):
    """The same PS rounds (serial, or streamed with prefetch) on ``cuda``
    node actors, each on a stream of its own, and on ``thread`` actors:
    the aggregates and every node's state are the same bits."""
    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian
    from byzpy_tpu_torch.engine.overlap import OverlapConfig
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer

    async def go(backend):
        honest, byz = await _spawn_orchestrator_nodes(backend)
        ps = ParameterServer(honest, byz, aggregator=CoordinateWiseMedian(),
                             overlap=OverlapConfig() if overlap else None)
        aggs = []
        await ps.run(4, on_round=lambda i, a: aggs.append(a.clone()))
        await ps.close()
        states = [await h.snapshot() for h in honest]
        for a in honest + byz:
            await a.close()
        torch.cuda.synchronize()
        return aggs, states

    cuda_aggs, cuda_states = _engine_run(go("cuda"))
    thread_aggs, thread_states = _engine_run(go("thread"))
    for a, b in zip(cuda_aggs + cuda_states, thread_aggs + thread_states, strict=True):
        assert _bits_equal(a, b)


@pytest.mark.cuda
def test_cuda_timed_out_actor_call_is_never_folded(cuda_device):
    """A ``cuda`` node whose call outlives ``call_timeout`` (it returns NaN
    after a host sleep): the round aggregates the survivors only, nothing
    of the abandoned call reaches a fold, and the next probe runs after
    the leftover call on the actor's thread and stream and is
    re-admitted."""
    import asyncio

    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian
    from byzpy_tpu_torch.engine.parameter_server import ElasticPolicy, ParameterServer

    async def go():
        honest, byz = await _spawn_orchestrator_nodes("cuda")
        for h in honest:
            await h.honest_gradient_for_next_batch()   # warm-up, off the clock
        await honest[1].set_hang(1.0)
        agg = CoordinateWiseMedian()
        seen = []
        aggregate = agg.aggregate

        def logging_aggregate(gradients):
            seen.extend(bool(torch.isfinite(g).all()) for g in gradients)
            return aggregate(gradients)

        agg.aggregate = logging_aggregate
        ps = ParameterServer(honest, byz, aggregator=agg,
                             elastic=ElasticPolicy(min_quorum=3, call_timeout=0.3))
        first = await ps.round()
        suspects = sorted(ps.elastic_state.suspects)
        await asyncio.sleep(1.2)
        second = await ps.round()
        events = list(ps.elastic_state.events)
        await ps.close()
        for a in honest + byz:
            await a.close()
        torch.cuda.synchronize()
        return first, second, suspects, events, seen

    first, second, suspects, events, seen = _engine_run(go())
    assert suspects == ["honest:1"]
    assert bool(torch.isfinite(first).all()) and bool(torch.isfinite(second).all())
    assert (1, "honest:1", "readmitted") in events
    # round 1 gathered 3 honest and 1 byzantine gradient, round 2 all 5
    assert seen == [True] * 9


@pytest.mark.cuda
def test_cuda_ps_close_leaves_no_task_pending(cuda_device):
    """Prefetch chains in flight on ``cuda`` actors (each node's next
    gradient queued behind its apply): ``close()`` cancels and awaits
    them, so no task of the server is left, and ``flush()`` before it
    settles them with every node's state the serial schedule's."""
    import asyncio

    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian
    from byzpy_tpu_torch.engine.overlap import OverlapConfig
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer

    async def go(flush):
        honest, byz = await _spawn_orchestrator_nodes("cuda")
        ps = ParameterServer(honest, byz, aggregator=CoordinateWiseMedian(),
                             overlap=OverlapConfig(prefetch_depth=1))
        for _ in range(3):
            await ps.round()
        chains = list(ps._pending_honest)
        if flush:
            await ps.flush()
            assert all(t.done() for t in chains)
        await ps.close()
        pending = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        states = [await h.snapshot() for h in honest]
        for a in honest + byz:
            await a.close()
        torch.cuda.synchronize()
        return pending, chains, states

    for flush in (False, True):
        pending, chains, _ = _engine_run(go(flush))
        assert pending == [] and all(t.done() for t in chains)


@pytest.mark.cuda
def test_cuda_capture_refused_while_a_prefetch_chain_runs(cuda_device):
    """Round r + 1's gradient is in flight on a ``cuda`` actor's stream
    while round r returns: a CUDA-graph capture then refuses with
    ``GraphCaptureError``; after ``flush`` and ``close`` it captures."""
    import asyncio
    import threading

    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian
    from byzpy_tpu_torch.engine.overlap import OverlapConfig
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer
    from byzpy_tpu_torch.utils.cuda_graph import CapturedStep, GraphCaptureError

    step = CapturedStep(lambda p, o: (p * 2, o + 1, {"s": p.sum()}), name="ps_train_step",
                        donate=False)
    p, o = torch.ones(8, device=cuda_device), torch.zeros(8, device=cuda_device)

    async def go():
        honest, byz = await _spawn_orchestrator_nodes("cuda")
        ps = ParameterServer(honest, byz, aggregator=CoordinateWiseMedian(),
                             overlap=OverlapConfig(prefetch_depth=1))
        await ps.round()
        await ps.flush()   # round 1's gradients computed and buffered
        gate = threading.Event()
        for h in honest:
            await h.set_block(gate)
        await ps.round()   # its chains' next gradients now wait on the gate
        await asyncio.sleep(0.2)
        try:
            with pytest.raises(GraphCaptureError, match="cuda actor call"):
                step(p, o)
        finally:
            gate.set()
        await ps.flush()
        await ps.close()
        for a in honest + byz:
            await a.close()

    _engine_run(go())
    p2, o2, m = step(p, o)
    assert len(step.graphs) == 1 and bool((p2 == 2).all()) and float(m["s"]) == 8.0


# ---------------------------------------------------------------------------
# The mesh: feature-sharded forms and a one-rank NCCL round
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL process group on the card and its 1-D ``nodes`` mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket

    import torch.distributed as dist

    from byzpy_tpu_torch.parallel.mesh import init_process_group, node_mesh

    if dist.is_initialized():
        pytest.skip("a process group is already initialized in this process")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    assert init_process_group(f"tcp://127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        yield node_mesh()
    finally:
        dist.destroy_process_group()


# (form, fn, the launch keys the local part must make)
SHARDED_FORMS = {
    "trimmed": ("trimmed_mean", {"f": 2}, ("sorted_reduce:trimmed",)),
    "median": ("coordinate_median", {}, ("sorted_reduce:median",)),
    "meamed": ("mean_of_medians", {"f": 2}, ("meamed",)),
    "multi_krum": ("multi_krum", {"f": 2, "q": 4}, ("gram", "selection_mean_from_gram:krum")),
    "cge": ("cge", {"f": 2}, ("row_sq_dists", "segment_sum")),
    "monna": ("monna", {"f": 2}, ("row_sq_dists", "segment_sum")),
    "geomed": ("geometric_median", {"max_iter": 16}, ("sorted_reduce:median", "row_sq_dists",
                                                      "segment_sum")),
    "cclip": ("centered_clipping", {"c_tau": 50.0, "M": 3}, ("row_sq_dists", "segment_sum")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 64, 128])
@pytest.mark.parametrize("name", sorted(SHARDED_FORMS))
def test_cuda_sharded_forms_launch_the_kernels_on_local_columns(nccl_mesh, name, n):
    """The feature-sharded form on a one-rank mesh launches its kernels on
    the local columns (and never gathers), and gives the unsharded
    function's value: bit for bit for the coordinate-wise ones, within
    f32 rounding for the others."""
    import functools

    from byzpy_tpu_torch.ops import robust
    from byzpy_tpu_torch.parallel.feature_sharded import FeatureGroup, sharded_form

    fn_name, kw, keys = SHARDED_FORMS[name]
    fn = functools.partial(getattr(robust, fn_name), **kw)
    x = _pre_rows(n, 1, n, 50_001, "cuda")[0]
    form = sharded_form(fn, FeatureGroup(nccl_mesh, "nodes"))
    for k in kernels.launch_counts:
        kernels.launch_counts[k] = 0
    got = form(x)
    torch.cuda.synchronize()
    for key in keys:
        assert kernels.launch_counts[key] > 0, (key, dict(kernels.launch_counts))
    want = fn(x)
    if name in ("trimmed", "median", "meamed"):
        assert _bits_equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("su", ["off", "on"])
def test_cuda_one_rank_nccl_round_equals_mesh_none(nccl_mesh, su):
    """Three SmallCNN rounds (8 nodes, 2 sign-flipping, trimmed mean, SGD
    with momentum, precisions off) on the one-rank NCCL mesh equal the
    ``mesh=None`` round bit for bit, parameters and metrics."""
    import functools

    from byzpy_tpu_torch.models import nets, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, robust
    from byzpy_tpu_torch.parallel import PSStepConfig, build_ps_train_step

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    x, y = synthetic_classification(n_samples=8 * 16 * 3, seed=5, device="cuda")
    cfg = PSStepConfig(n_nodes=8, n_byzantine=2)
    agg = functools.partial(robust.trimmed_mean, f=2)
    runs = []
    for mesh in (None, nccl_mesh):
        bundle = nets.mnist_cnn(seed=0, device="cuda")
        step, opt = build_ps_train_step(
            bundle, agg, cfg, mesh=mesh, sharded_update=su,
            attack=lambda h, g: attack_ops.sign_flip(h.mean(0)))
        params, out = bundle.params, []
        for s in range(3):
            sl = slice(s * 128, (s + 1) * 128)
            params, opt, metrics = step(params, opt, x[sl].reshape(8, 16, 28, 28, 1),
                                        y[sl].reshape(8, 16))
            out.append(({k: v.clone() for k, v in params.items()},
                        {k: float(v) for k, v in metrics.items()}))
        runs.append(out)
    for (p0, m0), (p1, m1) in zip(*runs):
        assert all(_bits_equal(p0[k], p1[k]) for k in p0)
        assert m0["agg_grad_norm"] == m1["agg_grad_norm"]
        assert m0["honest_loss"] == pytest.approx(m1["honest_loss"], rel=1e-6)


# (name, the mesh=None aggregate and pre-aggregate) of the C.2 check
C2_CASES = {
    "geomed": ("geometric_median", {}, None),
    "clip+trimmed": ("trimmed_mean", {"f": 2}, ("clip_rows", {"threshold": 10_000.0})),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(C2_CASES))
def test_cuda_sharded_form_at_resnet18_width_matches_mesh_none(nccl_mesh, name):
    """One aggregation of an 8 x 11,173,962 matrix (ResNet-18 for CIFAR's
    width, rows like its gradients, two of them 5x), the sharded form on
    the one-rank NCCL mesh against the ``mesh=None`` function on the same
    matrix: this separates a summation-order difference from a fault
    before training drift compounds it. The sharded geometric median sums
    its distances with ``row_sq_dists`` and B11 and all-reduces them, and
    stops on its own step lengths; ``mesh=None`` runs B7's loop: both stop
    at ``tol = 1e-6``, so they are held within 1e-5 of the largest entry.
    Clip + trimmed mean differ only in the clip factors' norms (the
    all-reduced ``row_sq_dists`` against ``clip_rows``' own): within f32
    rounding, rtol 1e-6 and an absolute ulp of the largest clipped entry
    (a trimmed mean of values near 3 that cancel to near 0 keeps their
    rounding, not its own). Each case prints its distance."""
    import functools

    from byzpy_tpu_torch.ops import preagg, robust
    from byzpy_tpu_torch.parallel.feature_sharded import FeatureGroup, sharded_form

    fn_name, kw, pre = C2_CASES[name]
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(8, 11_173_962)).astype(np.float32))
    x = x.to("cuda")
    x[6:] *= 5.0
    fn = functools.partial(getattr(robust, fn_name), **kw)
    group = FeatureGroup(nccl_mesh, "nodes")
    form = sharded_form(fn, group)
    if pre is None:
        got = form(x)
        it_form = robust.last_iterations.get("geometric_median")
        want = fn(x)
        it_plain = robust.last_iterations.get("geometric_median")
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"C2 {name}: max |sharded - mesh=None| {diff:.3e} (|z| max {scale:.4f}); Weiszfeld "
              f"steps {it_form} / {it_plain}")
        assert diff <= 1e-5 * scale, (diff, scale, it_form, it_plain)
    else:
        pre_fn = functools.partial(getattr(preagg, pre[0]), **pre[1])
        clipped = pre_fn(x)
        got = form(sharded_form(pre_fn, group)(x))
        want = fn(clipped)
        ulp = float(torch.finfo(torch.float32).eps) * float(clipped.abs().max())
        print(f"C2 {name}: max |sharded - mesh=None| {float((got - want).abs().max()):.3e} (an ulp "
              f"of the largest clipped entry {ulp:.3e})")
        torch.testing.assert_close(got, want, rtol=1e-6, atol=ulp)


@pytest.mark.cuda
def test_cuda_compiled_mesh_step_replays_the_eager_mesh_step(nccl_mesh):
    """``jit_ps_train_step(mesh=)`` on the one-rank NCCL mesh: the NCCL
    collectives run inside the graph, and three replays equal three eager
    mesh steps bit for bit (SmallCNN, trimmed mean, the sharded update)."""
    import functools

    from byzpy_tpu_torch.models import nets, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, robust
    from byzpy_tpu_torch.parallel import PSStepConfig, build_ps_train_step, jit_ps_train_step

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    x, y = synthetic_classification(n_samples=8 * 16, seed=5, device="cuda")
    xs, ys = x.reshape(8, 16, 28, 28, 1), y.reshape(8, 16)
    cfg = PSStepConfig(n_nodes=8, n_byzantine=2)
    kw = dict(mesh=nccl_mesh, sharded_update="on",
              attack=lambda h, g: attack_ops.sign_flip(h.mean(0)))
    agg = functools.partial(robust.trimmed_mean, f=2)
    bundle = nets.mnist_cnn(seed=0, device="cuda")
    eager, opt = build_ps_train_step(bundle, agg, cfg, **kw)
    compiled, copt = jit_ps_train_step(bundle, agg, cfg, donate=False, **kw)
    pe, oe, pc, oc = bundle.params, opt, bundle.params, copt
    for _ in range(3):
        pe, oe, me = eager(pe, oe, xs, ys)
        pc, oc, mc = compiled(pc, oc, xs, ys)
        assert all(_bits_equal(pe[k], pc[k]) for k in pe)
        assert float(me["agg_grad_norm"]) == float(mc["agg_grad_norm"])
    assert len(compiled.graphs) == 1
    assert compiled.last_capture["launches"].get("sorted_reduce:trimmed", 0) > 0


@pytest.mark.cuda
def test_cuda_compiled_mesh_step_refuses_a_host_reading_form(nccl_mesh):
    """The geometric median's sharded form tests its stop on the host each
    Weiszfeld step: the capture refuses it with ``GraphCaptureError``."""
    from byzpy_tpu_torch.models import nets, synthetic_classification
    from byzpy_tpu_torch.ops import robust
    from byzpy_tpu_torch.parallel import PSStepConfig, jit_ps_train_step
    from byzpy_tpu_torch.utils.cuda_graph import GraphCaptureError

    x, y = synthetic_classification(n_samples=8 * 16, seed=5, device="cuda")
    bundle = nets.mnist_cnn(seed=0, device="cuda")
    step, opt = jit_ps_train_step(bundle, robust.geometric_median, PSStepConfig(n_nodes=8),
                                  mesh=nccl_mesh)
    with pytest.raises(GraphCaptureError, match="on feature-sharded columns reads its stopping "
                                                "test on the host"):
        step(bundle.params, opt, x.reshape(8, 16, 28, 28, 1), y.reshape(8, 16))
    assert not step.graphs


_GLOO_CAPTURE = r"""
import socket, sys, torch, torch.distributed as dist
from byzpy_tpu_torch.models import nets, synthetic_classification
from byzpy_tpu_torch.ops import kernels, robust
from byzpy_tpu_torch.parallel import PSStepConfig, collectives, jit_ps_train_step
from byzpy_tpu_torch.parallel.mesh import init_process_group, node_mesh
from byzpy_tpu_torch.utils.cuda_graph import GraphCaptureError
with socket.socket() as s:
    s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]
torch.cuda.set_device(0)
init_process_group(f"tcp://127.0.0.1:{port}", 1, 0, backend="gloo")
mesh = node_mesh(device="cuda")
x, y = synthetic_classification(n_samples=8 * 16, seed=5, device="cuda")
bundle = nets.mnist_cnn(seed=0, device="cuda")
step, opt = jit_ps_train_step(bundle, robust.coordinate_median, PSStepConfig(n_nodes=8), mesh=mesh)
before = dict(kernels.launch_counts)
try:
    step(bundle.params, opt, x.reshape(8, 16, 28, 28, 1), y.reshape(8, 16))
    print("CAPTURED")
except GraphCaptureError as exc:
    print("REFUSED", "gloo" in str(exc), dict(kernels.launch_counts) == before, not step.graphs)
# the backstop: a gloo collective inside a capture raises the same error
g = torch.cuda.CUDAGraph()
t = torch.ones(4, device="cuda")
try:
    with torch.cuda.graph(g):
        collectives.all_reduce_sum(t, "nodes", mesh=mesh)
    print("BACKSTOP CAPTURED")
except GraphCaptureError as exc:
    print("BACKSTOP", "gloo" in str(exc))
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_cuda_compiled_mesh_step_refuses_a_gloo_group():
    """A mesh over gloo groups on CUDA tensors (gloo moves them through the
    host): ``jit_ps_train_step(mesh=)`` refuses at the capture with a
    ``GraphCaptureError`` naming gloo, keeps no graph and counts no launch
    (its warm-up's are taken back), and a gloo collective inside any
    capture raises the same error. In a process of its own, since
    its default process group is gloo."""
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _GLOO_CAPTURE], capture_output=True, text=True,
                         timeout=300, cwd=root, env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.split("\n")
    assert "REFUSED True True True" in lines, out.stdout
    assert "BACKSTOP True" in lines, out.stdout


# -- the serving frontend on the card ------------------------------------------

FRONTEND_FAMILIES = ("trimmed_mean", "median", "multi_krum", "cge", "geometric_median")


def _frontend_agg(name, device):
    from byzpy_tpu_torch import aggregators as A

    return {
        "trimmed_mean": lambda: A.CoordinateWiseTrimmedMean(2, device=device),
        "median": lambda: A.CoordinateWiseMedian(device=device),
        "multi_krum": lambda: A.MultiKrum(2, 4, device=device),
        "cge": lambda: A.ComparativeGradientElimination(2, device=device),
        "geometric_median": lambda: A.GeometricMedian(device=device),
    }[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("ragged_door", ["1", "0"])
@pytest.mark.parametrize("name", FRONTEND_FAMILIES)
def test_cuda_frontend_round_is_the_direct_executor(cuda_device, name, ragged_door, monkeypatch):
    """One ``ServingFrontend`` round on the card (13 clients, every third one
    round stale, two sign-flipped) is bit for bit the same cohort through
    ``RaggedExecutor`` (door on) or ``CohortAggregator`` (door off) called
    directly, and the aggregate stays on the card."""
    from byzpy_tpu_torch import serving

    monkeypatch.setenv("BYZPY_TPU_TORCH_RAGGED", ragged_door)
    d, m = 50_001, 13
    rng = np.random.default_rng(3)
    base = rng.normal(size=d).astype(np.float32)
    rows = [(base + 0.3 * rng.normal(size=d)).astype(np.float32) for _ in range(m)]
    rows[-2:] = [(-4.0 * base).astype(np.float32)] * 2
    policy = serving.StalenessPolicy("exponential", gamma=0.5)
    agg = _frontend_agg(name, None)
    fe = serving.ServingFrontend([serving.TenantConfig(name, agg, dim=d, cohort_cap=16,
                                                       staleness=policy)], clock=lambda: 0.0)
    for i, r in enumerate(rows):
        assert fe.submit(name, f"c{i}", -(i % 3 == 1), r) == (True, "accepted")
    rid, cohort, vec = fe.close_round_nowait(name)
    assert rid == 0 and vec.is_cuda and cohort.dense.is_cuda
    subs = [serving.Submission(f"c{i}", -(i % 3 == 1), r, 0.0) for i, r in enumerate(rows)]
    if ragged_door == "1":
        direct = serving.RaggedExecutor(agg, d, row_capacity=16, max_cohorts=1, with_evidence=False)
        want = direct.aggregate([serving.build_cohort(subs, 0, None, policy)], [name])[0].vector
    else:
        want = serving.CohortAggregator(agg).aggregate(
            serving.build_cohort(subs, 0, serving.BucketLadder(16, min_bucket=2), policy))
    assert _bits_equal(vec, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["multi_krum", "krum", "cge", "monna", "trimmed_mean",
                                  "geometric_median", "centered_clipping"])
def test_cuda_evidence_view_matches_the_cpu(cuda_device, name):
    """Each evidence view scored on the card (B3's Gram, ``row_sq_dists``)
    is within rtol 1e-5 of the same view on the CPU, with equal keep sets."""
    from byzpy_tpu_torch import aggregators as A

    make = {
        "multi_krum": lambda dev: A.MultiKrum(2, 4, device=dev),
        "krum": lambda dev: A.Krum(2, device=dev),
        "cge": lambda dev: A.ComparativeGradientElimination(2, device=dev),
        "monna": lambda dev: A.MoNNA(2, device=dev),
        "trimmed_mean": lambda dev: A.CoordinateWiseTrimmedMean(2, device=dev),
        "geometric_median": lambda dev: A.GeometricMedian(device=dev),
        "centered_clipping": lambda dev: A.CenteredClipping(c_tau=50.0, device=dev),
    }[name]
    rng = np.random.default_rng(8)
    x = rng.normal(size=(16, 100_003)).astype(np.float32)
    x[9:11] *= -6.0
    valid = np.arange(16) < 13
    center = x[:13].mean(axis=0)
    on_card = make(None).round_evidence(torch.from_numpy(x).cuda(), valid, aggregate=torch.from_numpy(center).cuda())
    on_cpu = make("cpu").round_evidence(x, valid, aggregate=center)
    assert on_card["kind"] == on_cpu["kind"]
    np.testing.assert_allclose(on_card["scores"], on_cpu["scores"], rtol=1e-5, atol=1e-5)
    if on_cpu["keep"] is not None:
        np.testing.assert_array_equal(on_card["keep"], on_cpu["keep"])
