"""The port's wire (``byzpy_tpu_torch.engine.actor.wire``) against the JAX
package's (``byzpy_tpu.engine.actor.wire``) on the CPU, same numpy inputs.

Exact throughout: the blockwise codes and scales, the decoded values and
``payload_block_stats`` equal the reference's numpy codecs bit for bit for
int8 / fp8 / fp8_e5m2 / s4 / bf16; the HMAC of one body under one key is
the same digest; ``decode_batch`` equals the per-frame decode. The frame
body is ``pickle``: a callable that pickles only by value is refused with a
``TypeError`` that names it.
"""

import asyncio
import functools

import numpy as np
import pytest
import torch

from byzpy_tpu.engine.actor import wire as jwire
from byzpy_tpu_torch.engine.actor import ipc, wire
from byzpy_tpu_torch.engine.storage import native_store

MODES = ("int8", "fp8", "fp8_e5m2", "s4")


def _arr(seed, n=3000):
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    x[:256] *= 1e-3  # a quiet block
    x[256:512] = 0.0  # an all-zero block
    x[700] = 40.0  # a loud value
    return x


@pytest.mark.parametrize("block", [256, 64])
@pytest.mark.parametrize("mode", MODES)
def test_blockwise_codes_scales_and_decode_match(mode, block):
    x = _arr(1)
    codes, scales, finite = wire._blockwise_encode(torch.from_numpy(x), block, mode)
    rcodes, rscales, rfinite = jwire._np_blockwise_encode(x, block, mode)
    assert finite and rfinite
    np.testing.assert_array_equal(codes.numpy().view(np.uint8), np.asarray(rcodes).view(np.uint8))
    np.testing.assert_array_equal(scales.numpy(), rscales)
    ours = wire._blockwise_decode(codes, scales, block, x.shape, "float32", mode)
    ref = jwire._np_blockwise_decode(rcodes, rscales, block, x.shape, np.float32, mode)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_bf16_codes_match():
    x = _arr(2)
    codes, ok = wire._to_bf16(torch.from_numpy(x))
    rcodes, rok = jwire._np_to_bf16(x)
    assert ok and rok
    np.testing.assert_array_equal(codes.numpy().view(np.uint16), rcodes)
    np.testing.assert_array_equal(wire._from_bf16(codes, x.shape, "float32").numpy(),
                                  jwire._np_from_bf16(rcodes, x.shape, np.float32))
    x[3] = np.inf
    assert not wire._to_bf16(torch.from_numpy(x))[1]
    assert not jwire._np_to_bf16(x)[1]


@pytest.mark.parametrize("mode", ("bf16",) + MODES)
def test_compressed_frames_round_trip_and_stats_match(mode, monkeypatch):
    """A whole frame through ``encode`` / ``decode_with_stats``: the same
    decoded values and the same pre-decode stats as the reference's frame
    of the same array; a non-finite tensor travels lossless."""
    x = _arr(3)
    bad = _arr(4)
    bad[9] = np.nan
    ours, stats = wire.decode_with_stats(
        wire.encode({"g": torch.from_numpy(x), "bad": torch.from_numpy(bad), "k": 3},
                    precision=mode)[4:])
    ref, rstats = jwire.decode_with_stats(
        jwire.encode({"g": x, "bad": bad, "k": 3}, precision=mode)[4:])
    np.testing.assert_array_equal(ours["g"].numpy(), ref["g"])
    np.testing.assert_array_equal(ours["bad"].numpy(), bad)
    assert ours["k"] == 3
    assert stats == rstats
    comp = wire.compress_payload({"g": torch.from_numpy(x)}, mode)
    assert wire.payload_block_stats(comp) == jwire.payload_block_stats(
        jwire.compress_payload({"g": x}, mode))


@pytest.mark.parametrize("mode", MODES)
def test_decode_rows_and_absmax_match(mode):
    xs = np.stack([_arr(s, 1024) for s in range(3)])
    enc = [jwire._np_blockwise_encode(r, 256, mode) for r in xs]
    codes = np.stack([e[0] for e in enc])
    scales = np.stack([e[1] for e in enc])
    ours = wire.decode_rows_np(torch.from_numpy(codes.view(np.uint8) if mode != "int8" else codes),
                               torch.from_numpy(scales), mode=mode, block=256, d=1024)
    np.testing.assert_array_equal(ours.numpy(), jwire.decode_rows_np(
        codes, scales, mode=mode, block=256, d=1024))


@pytest.mark.parametrize("mode", MODES)
def test_ef_precompensate_matches(mode):
    x = _arr(5)
    res = np.random.default_rng(6).normal(size=x.shape).astype(np.float32) * 1e-3
    comp, new = wire.ef_precompensate(torch.from_numpy(x), torch.from_numpy(res), mode, block=256)
    rcomp, rnew = jwire.ef_precompensate(x, res, mode, block=256)
    np.testing.assert_array_equal(comp.numpy(), rcomp)
    np.testing.assert_array_equal(new.numpy(), rnew)


def test_hmac_digest_matches_and_wrong_key_is_refused(monkeypatch):
    body = b"one body, one key"
    assert wire._sign(body, b"k3y") == jwire._sign(body, b"k3y")
    monkeypatch.setenv("BYZPY_TPU_TORCH_WIRE_KEY", "k3y")
    frame = wire.encode({"v": torch.arange(4)})
    assert torch.equal(wire.decode(frame[4:])["v"], torch.arange(4))
    monkeypatch.setenv("BYZPY_TPU_TORCH_WIRE_KEY", "other")
    with pytest.raises(ValueError, match="HMAC verification failed"):
        wire.decode(frame[4:])
    monkeypatch.delenv("BYZPY_TPU_TORCH_WIRE_KEY")
    with pytest.raises(Exception):  # a signed frame read without a key: not a pickle
        wire.decode(frame[4:])


@pytest.mark.parametrize("keep", [False, True])
def test_decode_batch_equals_per_frame(monkeypatch, keep):
    monkeypatch.setenv("BYZPY_TPU_TORCH_WIRE_KEY", "batch")
    frames = [wire.encode({"gradient": torch.from_numpy(_arr(s)), "i": s}, precision=m)[4:]
              for s, m in enumerate(("int8", "int8", "s4", "fp8", "bf16"))]
    frames.append(wire.encode({"plain": [1, 2]})[4:])
    batch = wire.decode_batch(frames, keep_quantized=keep)
    assert len(batch) == len(frames)
    for body, got in zip(frames, batch):
        obj, stats = wire.decode_with_stats(body)
        assert got.error is None and got.stats == stats
        for k, v in obj.items():
            g = got.obj[k]
            if isinstance(g, wire.QuantizedWireArray):
                assert keep and k == "gradient" and g.mode != "bf16"
                g = wire.decompress_payload(g)
            if isinstance(v, torch.Tensor):
                assert torch.equal(g, v)
            else:
                assert g == v
    bad = bytearray(frames[2])
    bad[-3] ^= 0xFF
    cut = wire.decode_batch([frames[0], bytes(bad), frames[1]])
    assert len(cut) == 2 and cut[0].error is None and isinstance(cut[1].error, ValueError)


def _module_level(x):
    return x + 1


def test_pickle_by_reference_only():
    frame = wire.encode({"fn": _module_level, "p": functools.partial(_module_level, 2)})
    obj = wire.decode(frame[4:])
    assert obj["fn"](1) == 2 and obj["p"]() == 3
    with pytest.raises(TypeError, match="lambda"):
        wire.encode({"fn": lambda x: x})

    def nested(x):
        return x

    with pytest.raises(TypeError, match="nested"):
        wire.encode({"fn": nested})


def test_send_recv_over_a_stream_pair():
    async def main():
        got = asyncio.get_running_loop().create_future()

        async def serve(reader, writer):
            got.set_result(await wire.recv_obj(reader))
            writer.close()

        server = await asyncio.start_server(serve, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        await wire.send_obj(writer, {"t": torch.ones(3, dtype=torch.bfloat16)})
        obj = await asyncio.wait_for(got, 10)
        writer.close()
        server.close()
        await server.wait_closed()
        return obj

    obj = asyncio.run(asyncio.wait_for(main(), 20))
    assert obj["t"].dtype == torch.bfloat16 and torch.equal(obj["t"], torch.ones(3, dtype=torch.bfloat16))


def test_host_view_walks_dataclasses_and_containers():
    import collections

    Pair = collections.namedtuple("Pair", "a b")
    t = torch.ones(2)
    out = wire.host_view({"x": [t, (t, Pair(t, 1))], "q": None})
    assert out["x"][1][1].b == 1 and isinstance(out["x"][1][1], Pair)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn, torch.int64])
def test_ipc_wrap_unwrap_round_trip(dtype):
    t = torch.arange(90000, dtype=torch.float32).to(dtype).reshape(300, 300)
    wrapped, handles = ipc.wrap_payload({"t": t, "small": torch.ones(3)})
    try:
        assert len(handles) == 1 and handles[0].dtype == str(dtype).removeprefix("torch.")
        out = ipc.unwrap_payload(wrapped, copy=True, close=True)
        assert out["t"].dtype == dtype
        assert torch.equal(out["t"].view(torch.uint8), t.view(torch.uint8))
    finally:
        ipc.cleanup_handles(handles)
    comp, handles = ipc.wrap_payload({"t": torch.randn(70000)}, precision="int8")
    try:
        assert handles and ipc.unwrap_payload(comp, copy=True)["t"].shape == (70000,)
    finally:
        ipc.cleanup_handles(handles)


def test_native_store_is_built_and_holds_the_bytes():
    assert native_store.available()
    t = torch.randn(33, 7)
    h = native_store.register_tensor(t)
    try:
        view = native_store.open_tensor(h)
        assert torch.equal(view, t)
        del view
    finally:
        native_store.cleanup_tensor(h)
