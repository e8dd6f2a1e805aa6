"""The port's models, data helpers and tree ravel against the JAX package.

The ResNet family (both stems, both blocks, f32 and bf16 compute), the
full-width parameter counts and leaf shapes of ``cifar_resnet18`` and
``imagenet_resnet50``, ``models.convert`` on nested trees,
``models/data.py`` and ``utils/trees.py:ravel_pytree_fn`` / ``tree_size``.
Parameters cross between the packages through ``models.convert``; inputs
are made with numpy from a seed. Each tolerance is stated where it is
used.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byzpy_tpu.models import data as jdata
from byzpy_tpu.models import nets as jnets
from byzpy_tpu.utils import trees as jtrees
from byzpy_tpu_torch.models import convert, data, nets
from byzpy_tpu_torch.utils import trees

CPU = "cpu"
# two of bf16's ulps at the logits' magnitude: one rounding of each package
# at the last layer, in another order
BF16_LOGIT_ULPS = 2 * 2.0**-7


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# (block, ImageNet stem, input hw, compute dtype): both stems and both
# blocks, each dtype; every stride-2 "SAME" convolution meets an even input
RESNET_CASES = [
    ("basic", False, 32, "f32"),
    ("bottleneck", True, 32, "f32"),
    ("basic", True, 16, "bf16"),
    ("bottleneck", False, 16, "bf16"),
]


def _resnets(block, imagenet, dt):
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    jblock = jnets.BottleneckBlock if block == "bottleneck" else jnets.ResNetBlock
    tblock = nets.BottleneckBlock if block == "bottleneck" else nets.ResNetBlock
    jm = jnets.ResNet(stage_sizes=(1, 1), block_cls=jblock, num_classes=10, num_filters=32,
                      small_input=not imagenet, dtype=jdt)
    tm = nets.ResNet((1, 1), tblock, 10, 32, not imagenet, dtype=tdt)
    return jm, tm


@pytest.mark.parametrize("block,imagenet,hw,dt", RESNET_CASES)
def test_resnet_logits_and_gradients_match_flax(block, imagenet, hw, dt):
    """Logits and every parameter's gradient of the cross-entropy loss, the
    flax parameters (GroupNorm scales and biases moved off 1 and 0)
    converted into the port. f32: logits within 1e-5, each gradient within
    1e-4 of its leaf's largest |value| (the convolutions and GroupNorm
    reductions sum in other orders). bf16 compute, against the reference
    run op by op: logits within two bf16 ulps of the largest logit; each
    gradient within 10% of its leaf's largest |value| with a cosine of at
    least 0.995 to the reference (every layer of the backward pass rounds
    to bf16's 8-bit mantissa in both packages, in different orders; 7% and
    0.9985 at worst at this size)."""
    jm, tm = _resnets(block, imagenet, dt)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    params = jax.tree_util.tree_unflatten(
        treedef, [a + 0.1 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)])
    ours = convert.ordered_like(convert.from_flax(_np_tree(params), device=CPU),
                                dict(tm.named_parameters()))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, hw, hw, 3)).astype(np.float32)
    y = np.array([1, 3, 5, 7])

    # f32 runs the reference under jit; bf16 op by op, which rounds every
    # layer's output to bf16 as flax's modules and the port do (under jit
    # XLA fuses layers and keeps some intermediates in f32: a third of a
    # leaf's largest gradient apart at the stem, at this size)
    run = jax.jit if dt == "f32" else (lambda fn: fn)
    ref = np.asarray(run(jm.apply)(params, jnp.asarray(x)))
    out = torch.func.functional_call(tm, ours, (torch.from_numpy(x),))
    assert out.dtype == torch.float32 and out.shape == (4, 10)
    if dt == "f32":
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        atol = BF16_LOGIT_ULPS * float(np.abs(ref).max())
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=atol)

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    jgrads = convert.from_flax(_np_tree(run(jax.grad(jloss))(params)), device=CPU)
    leaves_t = {k: v.clone().requires_grad_(True) for k, v in ours.items()}
    loss = torch.nn.functional.cross_entropy(
        torch.func.functional_call(tm, leaves_t, (torch.from_numpy(x),)), torch.from_numpy(y))
    grads = dict(zip(leaves_t, torch.autograd.grad(loss, list(leaves_t.values()))))
    for k, g in grads.items():
        want = jgrads[k]
        scale = float(want.abs().max())
        if dt == "f32":
            assert float((g - want).abs().max()) <= 1e-4 * scale, k
        else:
            assert float((g - want).abs().max()) <= 0.1 * scale, k
            cos = float(torch.nn.functional.cosine_similarity(g.reshape(-1), want.reshape(-1), dim=0))
            assert cos >= 0.995, (k, cos)


@pytest.mark.parametrize("which", ["cifar_resnet18", "imagenet_resnet50"])
def test_full_width_resnets_match_the_reference_shapes(which):
    """Every leaf's name and shape of the full-width bundles, and their
    parameter counts (11,173,962 and 25,557,032), against ``jax.eval_shape``
    of the reference's ``init`` (which compiles nothing)."""
    if which == "cifar_resnet18":
        jm, tm, shape = (jnets.ResNet18(num_classes=10), nets.ResNet18(num_classes=10),
                         (1, 32, 32, 3))
        d = 11_173_962
    else:
        jm = jnets.ResNet50(num_classes=1000, small_input=False, dtype=jnp.bfloat16)
        tm = nets.ResNet50(num_classes=1000, small_input=False, dtype=torch.bfloat16)
        shape, d = (1, 224, 224, 3), 25_557_032
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))
    assert jtrees.tree_size(shapes) == d
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    example = dict(tm.named_parameters())
    converted = convert.ordered_like(convert.from_flax(zeros, device=CPU), example)  # names, shapes
    assert list(converted) == list(example)
    assert trees.tree_size(example) == sum(p.numel() for p in example.values()) == d
    assert all(p.dtype == torch.float32 for p in example.values())  # parameters stay f32


def test_bundles_and_init():
    """``digits_mlp``'s leaves against the reference's; ``init_params``
    draws LeCun-normal weights, zero biases and GroupNorm scales of one;
    the full-width bundles are made on the device asked for."""
    jb = jnets.digits_mlp(seed=0)
    ours = nets.digits_mlp(seed=0, device=CPU)
    convert.ordered_like(convert.from_flax(_np_tree(jb.params), device=CPU), ours.params)
    tm = nets.ResNet((1,), nets.ResNetBlock, 10, 32, True)
    p = nets.init_params(tm, seed=3, device=CPU)
    assert torch.equal(p["groupnorm_0.weight"], torch.ones(32))
    assert torch.equal(p["resnetblock_0.groupnorm_1.bias"], torch.zeros(32))
    assert torch.equal(p["dense_0.bias"], torch.zeros(10))
    w = p["resnetblock_0.conv_0.weight"]
    std = np.sqrt(1.0 / (32 * 9))
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert 0.5 * std < float(w.std()) < 1.5 * std
    assert torch.equal(p["conv_0.weight"], nets.init_params(tm, seed=3, device=CPU)["conv_0.weight"])
    b = nets.cifar_resnet18(seed=1, device=CPU)
    assert sum(v.numel() for v in b.params.values()) == 11_173_962
    assert all(v.device.type == "cpu" for v in b.params.values())


@pytest.mark.parametrize("size,kernel,stride,want", [
    (32, 3, 2, (0, 1)), (33, 3, 2, (1, 1)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
    (16, 3, 1, (1, 1)), (16, 1, 2, (0, 0)), (15, 1, 2, (0, 0)), (8, 7, 2, (2, 3)),
])
def test_same_padding_is_lax(size, kernel, stride, want):
    """flax's "SAME" puts the odd pixel after: lax's own padding."""
    assert nets.same_padding(size, kernel, stride) == want
    lax_pads = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert tuple(lax_pads[0]) == want


def test_convert_round_trips_nested_trees():
    """``from_flax`` / ``to_flax`` on a ResNet-34 tree (16 basic blocks, so
    flax's string order puts ``ResNetBlock_10`` before ``ResNetBlock_2``)
    and a bottleneck tree: the round trip gives the tree back exactly, and
    ``ordered_like`` keeps the port's module order, not flax's."""
    for jm, tm in ((jnets.ResNet34(num_classes=10, num_filters=32), nets.ResNet34(num_filters=32)),
                   _resnets("bottleneck", True, "f32")):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
        rng = np.random.default_rng(1)
        tree = jax.tree_util.tree_map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
        params = convert.from_flax(tree, device=CPU)
        ordered = convert.ordered_like(params, dict(tm.named_parameters()))
        assert list(ordered) == [k for k, _ in tm.named_parameters()]
        back = convert.to_flax(ordered)
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf)
    names = list(ordered)
    assert names.index("bottleneckblock_0.conv_0.weight") < names.index("dense_0.weight")
    order = [k for k in convert.from_flax(tree, device=CPU)]
    assert order.index("dense_0.weight") < order.index("groupnorm_0.weight")  # flax's sort
    with pytest.raises(ValueError, match="no mapping"):
        convert.from_flax({"params": {"Embed_0": {"embedding": np.zeros(3)}}}, device=CPU)
    with pytest.raises(ValueError, match="no mapping"):
        convert.to_flax({"embed_0.weight": torch.zeros(3)})


def test_ravel_pytree_fn_and_tree_size_match_the_reference():
    """The flat vector of a nested structure (dictionaries at several
    levels, keys that sort differently as strings, lists, tuples, a 0-d
    leaf) equals the reference's exactly; ``unravel`` inverts it into the
    reference's structure; ``tree_size`` counts its elements."""
    rng = np.random.default_rng(0)
    tree = {"b": {"Conv_10": rng.normal(size=(3, 2)).astype(np.float32),
                  "Conv_2": rng.normal(size=(4,)).astype(np.float32)},
            "a": [rng.normal(size=(2, 2)).astype(np.float32),
                  (rng.normal(size=()).astype(np.float32),)]}
    jravel, junravel = jtrees.ravel_pytree_fn(tree)
    ravel, unravel = trees.ravel_pytree_fn(tree)
    flat = ravel(tree)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jravel(tree)))
    assert trees.tree_size(tree) == jtrees.tree_size(tree) == 15
    back = unravel(flat * 2)
    jback = junravel(jnp.asarray(flat.numpy() * 2))
    assert list(back) == list(jback) == ["a", "b"]
    assert list(back["b"]) == list(jback["b"]) == ["Conv_10", "Conv_2"]
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jback),
                              jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
                                  lambda t: t.numpy(), back))):
        np.testing.assert_array_equal(b, np.asarray(a))
    assert isinstance(back["a"], list) and isinstance(back["a"][1], tuple)
    # one dtype: unravel keeps the vector's dtype, as the reference's does
    assert unravel(flat.to(torch.float64))["b"]["Conv_2"].dtype == torch.float64
    with pytest.raises(ValueError):
        unravel(flat[:-1])
    # tensors ravel as numpy arrays do
    ttree = {"w": torch.from_numpy(tree["b"]["Conv_2"]), "v": torch.zeros(3)}
    assert torch.equal(trees.ravel_pytree_fn(ttree)[0](ttree),
                       torch.cat([torch.zeros(3), ttree["w"]]))


def test_ravel_pytree_fn_mixed_dtypes_match_the_reference():
    """Mixed leaf dtypes ravel to their promoted dtype; ``unravel`` casts each
    leaf back and refuses a vector of another dtype (``TypeError``), as the
    reference's does."""
    tree = {"h": np.arange(4, dtype=np.float32).reshape(2, 2).astype(jnp.bfloat16),
            "f": np.array([0.5, 1.5], np.float32)}
    jravel, junravel = jtrees.ravel_pytree_fn(tree)
    ttree = {"h": torch.arange(4, dtype=torch.bfloat16).reshape(2, 2),
             "f": torch.tensor([0.5, 1.5])}
    ravel, unravel = trees.ravel_pytree_fn(ttree)
    flat = ravel(ttree)
    assert flat.dtype == torch.float32
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jravel(tree)))
    back = unravel(flat)
    assert back["h"].dtype == torch.bfloat16 and back["f"].dtype == torch.float32
    assert str(junravel(jravel(tree))["h"].dtype) == "bfloat16"
    with pytest.raises(TypeError):
        unravel(flat.to(torch.float64))
    with pytest.raises(TypeError):
        junravel(jravel(tree).astype(jnp.float16))


def test_sharded_dataset_matches_the_reference():
    """Shard size, every node's slice and the stacked shards, exactly (the
    remainder past ``n_nodes * shard`` left out)."""
    x, y = data.synthetic_classification(n_samples=103, input_shape=(4, 4, 1), seed=2, device=CPU)
    jx, jy = jdata.synthetic_classification(n_samples=103, input_shape=(4, 4, 1), seed=2)
    ours, ref = data.ShardedDataset(x, y, 4), jdata.ShardedDataset(jx, jy, 4)
    assert ours.shard_size == ref.shard_size == 25
    for node in range(4):
        a, b = ours.node_slice(node), ref.node_slice(node)
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b[1]))
    xs, ys = ours.stacked_shards()
    jxs, jys = ref.stacked_shards()
    assert xs.shape == (4, 25, 4, 4, 1) and ys.shape == (4, 25)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))


def _write_idx(path, arr: np.ndarray, code: int, *, gz: bool) -> None:
    header = bytes([0, 0, code, arr.ndim]) + np.asarray(arr.shape, ">u4").tobytes()
    payload = header + arr.tobytes()
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(payload)


@pytest.mark.parametrize("gz", [False, True])
def test_load_mnist_idx_matches_the_reference(tmp_path, gz):
    """IDX files written here (raw and gzip, uint8 images and labels, the
    test split under its other file name) load exactly as the reference
    loads them; a missing file and a bad magic raise as there."""
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, size=(7, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=(7,), dtype=np.uint8)
    ext = ".gz" if gz else ""
    _write_idx(tmp_path / f"train-images-idx3-ubyte{ext}", images, 0x08, gz=gz)
    _write_idx(tmp_path / f"train-labels-idx1-ubyte{ext}", labels, 0x08, gz=gz)
    _write_idx(tmp_path / f"t10k-images.idx3-ubyte{ext}", images[:3], 0x08, gz=gz)
    _write_idx(tmp_path / f"t10k-labels.idx1-ubyte{ext}", labels[:3], 0x08, gz=gz)
    for split, norm in (("train", True), ("train", False), ("test", True)):
        x, y = data.load_mnist_idx(str(tmp_path), split=split, normalize=norm, device=CPU)
        jx, jy = jdata.load_mnist_idx(str(tmp_path), split=split, normalize=norm)
        assert x.dtype == torch.float32 and x.shape == jx.shape and y.dtype == torch.int64
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    with pytest.raises(FileNotFoundError, match="train images"):
        data.load_mnist_idx(str(tmp_path / "nowhere"), device=CPU)
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "train-images-idx3-ubyte").write_bytes(b"\x01\x02\x08\x01")
    _write_idx(tmp_path / "bad" / "train-labels-idx1-ubyte", labels, 0x08, gz=False)
    with pytest.raises(ValueError, match="not an IDX file"):
        data.load_mnist_idx(str(tmp_path / "bad"), device=CPU)


def test_load_digits_dataset_matches_the_reference():
    """scikit-learn's digits, shuffled and split exactly as the reference
    does."""
    pytest.importorskip("sklearn")
    ours = data.load_digits_dataset(seed=3, device=CPU)
    ref = jdata.load_digits_dataset(seed=3)
    assert [tuple(t.shape) for t in ours] == [tuple(a.shape) for a in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_samplers_are_seed_deterministic():
    """``sample_batch`` and ``sample_node_batches`` draw from the generator
    they are given: the same seed gives the same batches, another seed
    others, and every node's batch comes from its own shard."""
    x, y = data.synthetic_classification(n_samples=64, input_shape=(3,), seed=1, device=CPU)

    def batch(seed):
        return data.sample_batch(x, y, torch.Generator().manual_seed(seed), 16)

    (a, ya), (b, yb), (c, _) = batch(5), batch(5), batch(6)
    assert a.shape == (16, 3) and ya.shape == (16,)
    assert torch.equal(a, b) and torch.equal(ya, yb) and not torch.equal(a, c)
    rows = {tuple(r.tolist()) for r in x}
    assert all(tuple(r.tolist()) in rows for r in a)
    xs, ys = data.ShardedDataset(x, y, 4).stacked_shards()

    def nodes(seed):
        return data.sample_node_batches(xs, ys, torch.Generator().manual_seed(seed), 5)

    (na, nya), (nb, _), (nc, _) = nodes(7), nodes(7), nodes(8)
    assert na.shape == (4, 5, 3) and nya.shape == (4, 5)
    assert torch.equal(na, nb) and not torch.equal(na, nc)
    for node in range(4):
        shard = {tuple(r.tolist()) for r in xs[node]}
        assert all(tuple(r.tolist()) in shard for r in na[node])


@pytest.mark.parametrize("drop_last", [True, False])
def test_host_batches_match_the_reference(drop_last):
    """The epoch's batches, in the reference's order batch for batch, from
    numpy arrays and from tensors."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(23, 2)).astype(np.float32)
    y = rng.integers(0, 10, size=(23,))
    ref = list(jdata.host_batches(x, y, batch_size=5, seed=4, drop_last=drop_last))
    ours = list(data.host_batches(x, y, batch_size=5, seed=4, drop_last=drop_last))
    tens = list(data.host_batches(torch.from_numpy(x), torch.from_numpy(y), batch_size=5, seed=4,
                                  drop_last=drop_last))
    assert len(ours) == len(tens) == len(ref) == (4 if drop_last else 5)
    for (a, ya), (t, yt), (b, yb) in zip(ours, tens, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(t.numpy(), b)
        np.testing.assert_array_equal(yt.numpy(), yb)
