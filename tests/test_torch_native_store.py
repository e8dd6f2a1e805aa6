"""The port's shm store (``byzpy_tpu_torch.engine.storage.native_store``)
against the JAX package's (``byzpy_tpu.engine.storage.native_store``), on
the CPU: a segment one package registers holds the same bytes, by name
and size, when the other opens it. Exact (raw bytes).
"""

import numpy as np
import pytest
import torch

from byzpy_tpu.engine.storage import native_store as jstore
from byzpy_tpu_torch.engine.storage import native_store as store


def test_both_builds_load():
    assert store.available() and jstore.available()
    assert store._LIB._name != jstore._LIB._name  # the port builds its own copy
    assert "_build" in store._LIB._name


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.uint8])
def test_reference_segment_opens_in_the_port(dtype):
    arr = (np.arange(3 * 257) % 251).astype(dtype).reshape(3, 257)
    h = jstore.register_tensor(arr)
    try:
        handle = store.SharedTensorHandle(h.name, h.shape, str(torch.from_numpy(arr).dtype)[6:])
        assert handle.nbytes == h.nbytes
        view = store.open_tensor(handle)
        np.testing.assert_array_equal(view.numpy(), arr)
        del view
        store.close_tensor(handle)
    finally:
        jstore.cleanup_tensor(h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_port_segment_opens_in_the_reference(dtype):
    t = torch.linspace(-3, 3, 1000).to(dtype).reshape(10, 100)
    h = store.register_tensor(t)
    try:
        raw = jstore.SharedTensorHandle(h.name, (h.nbytes,), "|u1")
        view = jstore.open_tensor(raw)
        np.testing.assert_array_equal(view, t.view(torch.uint8).reshape(-1).numpy())
        del view
        jstore.close_tensor(raw)
        mine = store.open_tensor(h)
        assert mine.dtype == dtype and torch.equal(mine.view(torch.uint8), t.view(torch.uint8))
        mine[0, 0] = 7  # a mapping, not a copy
        assert float(store.open_tensor(h)[0, 0]) == 7.0
        del mine
    finally:
        store.cleanup_tensor(h)


def test_stale_handle_is_refused():
    h = store.register_tensor(torch.zeros(4))
    try:
        with pytest.raises(ValueError, match="stale or mismatched"):
            store.open_tensor(store.SharedTensorHandle(h.name, (4096,), "float32"))
    finally:
        store.cleanup_tensor(h)
    with pytest.raises(OSError):
        store.open_tensor(h)
