"""Datasets and per-node batches for the PS round.

Counterpart of ``byzpy_tpu/models/data.py``. What the JAX package makes
with numpy is made here with the same numpy calls, so both packages see
the same values bit for bit: :func:`synthetic_classification`, the IDX
reader behind :func:`load_mnist_idx`, :func:`load_digits_dataset`'s
shuffle and split, and :func:`host_batches`' epoch order. The containers
are torch tensors, labels int64 for ``cross_entropy`` (the reference's
are int32).

The reference's samplers draw their indices from a ``jax.random`` key,
which PyTorch cannot reproduce; :func:`sample_batch` and
:func:`sample_node_batches` draw from an explicit ``torch.Generator``
instead (as ``pre_aggregators.Bucketing`` does): the same generator state
gives the same batches.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

_IDX_DTYPES = {
    0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"), 0x0E: np.dtype(">f8"),
}


def _idx_read(path: str) -> np.ndarray:
    """One IDX file (MNIST's format), gzip or raw: big-endian magic ``0x00
    0x00 <dtype> <ndim>``, ``ndim`` uint32 dimensions, then the row-major
    payload."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        data = fh.read()
    if len(data) < 4 or data[0] != 0 or data[1] != 0:
        raise ValueError(f"{path}: not an IDX file (bad magic {data[:4]!r})")
    dtype = _IDX_DTYPES.get(data[2])
    if dtype is None:
        raise ValueError(f"{path}: unknown IDX dtype code 0x{data[2]:02x}")
    ndim = data[3]
    header = 4 + 4 * ndim
    dims = np.frombuffer(data[4:header], dtype=">u4").astype(np.int64)
    arr = np.frombuffer(data[header:], dtype=dtype)
    if arr.size != int(np.prod(dims)):
        raise ValueError(f"{path}: payload has {arr.size} items, header promises {dims}")
    return arr.reshape(dims)


def load_mnist_idx(
    data_dir: str,
    *,
    split: str = "train",
    normalize: bool = True,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MNIST from the IDX files in ``data_dir`` (``train-images-idx3-ubyte``
    and ``train-labels-idx1-ubyte``, or ``t10k-*`` for ``split="test"``,
    each raw or ``.gz``). Returns ``x: (n, 28, 28, 1)`` float32 (in [0, 1]
    with ``normalize``) and ``y: (n,)`` int64. Raises
    ``FileNotFoundError`` naming the expected files when one is absent."""
    prefix = {"train": "train", "test": "t10k"}[split]
    found: dict = {}
    for kind, tag in (("images", "idx3"), ("labels", "idx1")):
        for stem in (f"{prefix}-{kind}-{tag}-ubyte", f"{prefix}-{kind}.{tag}-ubyte"):
            for ext in ("", ".gz"):
                cand = os.path.join(data_dir, stem + ext)
                if os.path.exists(cand):
                    found[kind] = cand
                    break
            if kind in found:
                break
        if kind not in found:
            raise FileNotFoundError(
                f"no {prefix} {kind} IDX file under {data_dir} "
                f"(expected e.g. {prefix}-{kind}-{tag}-ubyte[.gz])"
            )
    x = _idx_read(found["images"]).astype(np.float32)
    y = _idx_read(found["labels"]).astype(np.int64)
    if normalize:
        x /= 255.0
    dev = resolve_device(device)
    return torch.from_numpy(x[..., None]).to(dev), torch.from_numpy(y).to(dev)


def load_digits_dataset(
    *,
    test_fraction: float = 0.25,
    normalize: bool = True,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The handwritten digits bundled with scikit-learn (1,797 8x8 images,
    10 classes), shuffled with ``numpy.random.default_rng(seed)`` and split
    as the reference splits them. Returns ``(x_train, y_train, x_test,
    y_test)``, images ``(n, 8, 8, 1)`` float32 (in [0, 1] with
    ``normalize``), labels int64. scikit-learn is imported here, not with
    the module: a host without it can use everything else."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as exc:
        raise ImportError(
            "load_digits_dataset needs scikit-learn; for MNIST use load_mnist_idx"
        ) from exc

    bunch = load_digits()
    x = bunch.data.astype(np.float32).reshape(-1, 8, 8, 1)
    y = bunch.target.astype(np.int64)
    if normalize:
        x /= 16.0
    order = np.random.default_rng(seed).permutation(x.shape[0])
    x, y = x[order], y[order]
    n_test = int(round(test_fraction * x.shape[0]))
    dev = resolve_device(device)
    parts = (x[n_test:], y[n_test:], x[:n_test], y[:n_test])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in parts)


def synthetic_classification(
    *,
    n_samples: int = 4096,
    input_shape: Sequence[int] = (28, 28, 1),
    num_classes: int = 10,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-conditional Gaussian blobs ``(x, y)``: ``x`` float32 of shape
    ``(n_samples, *input_shape)``, ``y`` int64 labels."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=(n_samples,))
    centers = rng.normal(size=(num_classes, int(np.prod(input_shape)))).astype(np.float32)
    x = centers[y] + 0.5 * rng.normal(size=(n_samples, centers.shape[1])).astype(np.float32)
    return (
        torch.from_numpy(x.reshape((n_samples, *input_shape))).to(dev),
        torch.from_numpy(y.astype(np.int64)).to(dev),
    )


@dataclass(frozen=True)
class ShardedDataset:
    """A dataset split into ``n_nodes`` contiguous shards (node ``i``
    trains on shard ``i``); a remainder past ``n_nodes * shard_size`` is
    left out."""

    x: torch.Tensor
    y: torch.Tensor
    n_nodes: int

    @property
    def shard_size(self) -> int:
        return self.x.shape[0] // self.n_nodes

    def node_slice(self, node: int) -> Tuple[torch.Tensor, torch.Tensor]:
        lo = node * self.shard_size
        return self.x[lo:lo + self.shard_size], self.y[lo:lo + self.shard_size]

    def stacked_shards(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(n_nodes, shard, ...)`` and ``(n_nodes, shard)`` views."""
        usable = self.shard_size * self.n_nodes
        xs = self.x[:usable].reshape((self.n_nodes, self.shard_size) + tuple(self.x.shape[1:]))
        ys = self.y[:usable].reshape((self.n_nodes, self.shard_size))
        return xs, ys


def _draw(high: int, shape: Tuple[int, ...], generator: Optional[torch.Generator],
          device: torch.device) -> torch.Tensor:
    """Uniform int64 indices in ``[0, high)`` from ``generator`` (drawn on
    its device), on ``device``."""
    where = device if generator is None else generator.device
    return torch.randint(0, high, shape, generator=generator, device=where).to(device)


def sample_batch(
    x: torch.Tensor,
    y: torch.Tensor,
    generator: Optional[torch.Generator],
    batch_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch drawn uniformly with replacement, by indexing."""
    idx = _draw(x.shape[0], (batch_size,), generator, x.device)
    return x.index_select(0, idx), y.index_select(0, idx)


def sample_node_batches(
    xs_all: torch.Tensor,
    ys_all: torch.Tensor,
    generator: Optional[torch.Generator],
    batch_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node batches from stacked shards: ``xs_all: (n_nodes, shard,
    *feature)``, ``ys_all: (n_nodes, shard)`` (from
    :meth:`ShardedDataset.stacked_shards`) -> ``(n_nodes, batch_size,
    *feature)`` and ``(n_nodes, batch_size)``, each node drawing with
    replacement from its own shard."""
    n_nodes, shard = ys_all.shape[:2]
    idx = _draw(shard, (n_nodes, batch_size), generator, xs_all.device)
    rows = torch.arange(n_nodes, device=xs_all.device)[:, None]
    return xs_all[rows, idx], ys_all[rows, idx]


def host_batches(
    x,
    y,
    *,
    batch_size: int,
    seed: int = 0,
    drop_last: bool = True,
) -> Iterator[Tuple[object, object]]:
    """One epoch of batches on the host, in the order of
    ``numpy.random.default_rng(seed).permutation`` (the reference's, batch
    for batch). ``x`` and ``y`` are numpy arrays or tensors; the batches
    are of the same kind."""
    order = np.random.default_rng(seed).permutation(x.shape[0])
    stop = (x.shape[0] // batch_size) * batch_size if drop_last else x.shape[0]
    for lo in range(0, stop, batch_size):
        sel = order[lo:lo + batch_size]
        yield x[sel], y[sel]


__all__ = [
    "ShardedDataset",
    "host_batches",
    "load_digits_dataset",
    "load_mnist_idx",
    "sample_batch",
    "sample_node_batches",
    "synthetic_classification",
]
