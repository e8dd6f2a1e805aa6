"""The wire-byte laws of ``parallel/comms.py`` against the JAX package's,
number for number (tolerance 0), and one mesh round's traffic record
against them on gloo worlds of 2 and 4 ranks.

The laws price one node a device and a flat vector that fills the shard
grid, so the rounds here have as many nodes as ranks and ``d = 128 x 8 =
1,024`` (a whole number of 256-value blocks a rank). The record's
all-to-all is then exactly the gradient-transpose term of
``ps_round_wire_bytes`` and its all-gather exactly the update-move term;
the remaining entries are the round's scalar all-reduces (the gradient
norm and the honest loss, 8 bytes a rank in all).
"""

import itertools

import pytest
from _torch_mesh_world import World

from byzpy_tpu.parallel import comms as jcomms
from byzpy_tpu_torch.parallel import comms

SIZES = [2, 4]
D_IN = 128
D = D_IN * 8
PRECISIONS = ["off", "bf16", "int8", "fp8", "fp8_e5m2", "s4"]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("block", [32, 256])
def test_compression_factor(precision, block):
    for dtype_bytes in (2, 4):
        assert comms.compression_factor(precision, block=block, dtype_bytes=dtype_bytes) == \
            jcomms.compression_factor(precision, block=block, dtype_bytes=dtype_bytes)


def test_opt_state_bytes():
    for n, slots, sharded, shards in itertools.product((1000, 11_173_962), (1, 2), (False, True),
                                                       (1, 3, 8)):
        kw = dict(slots=slots, update_sharded=sharded, n_shards=shards)
        assert comms.opt_state_bytes(n, **kw) == jcomms.opt_state_bytes(n, **kw)


@pytest.mark.parametrize("grad,param", [("off", "off"), ("int8", "off"), ("off", "int8"),
                                        ("s4", "fp8"), ("bf16", "bf16")])
def test_ps_round_wire_bytes(grad, param):
    for n, chips, sharded in itertools.product((421_642, 11_173_962), (1, 2, 8, 64), (False, True)):
        kw = dict(update_sharded=sharded, grad_precision=grad, param_precision=param)
        assert comms.ps_round_wire_bytes(n, chips, **kw) == jcomms.ps_round_wire_bytes(n, chips, **kw)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_serving_laws(precision):
    for n, signed in itertools.product((4096, 421_642), (False, True)):
        assert comms.serving_ingress_bytes(n, precision=precision, signed=signed) == \
            jcomms.serving_ingress_bytes(n, precision=precision, signed=signed)
        assert comms.sharded_round_wire_bytes(4, 64, n, precision=precision, signed=signed,
                                              extras_bytes_per_shard=123.0) == \
            jcomms.sharded_round_wire_bytes(4, 64, n, precision=precision, signed=signed,
                                            extras_bytes_per_shard=123.0)
    assert comms.partial_fold_bytes(16, 4096, signed=True, extras_bytes=5.0) == \
        jcomms.partial_fold_bytes(16, 4096, signed=True, extras_bytes=5.0)


@pytest.mark.parametrize("shards,fanout", [(1, None), (4, None), (4, 2), (8, 2), (9, 3), (16, 4)])
def test_merge_tree_wire_bytes(shards, fanout):
    kw = dict(signed=True, extras_bytes_per_row=12.0)
    assert comms.merge_tree_wire_bytes(shards, fanout, 64, 4096, **kw) == \
        jcomms.merge_tree_wire_bytes(shards, fanout, 64, 4096, **kw)
    with pytest.raises(ValueError):
        comms.merge_tree_wire_bytes(4, 1, 64, 4096)


def test_scaling_model():
    kw = dict(flops_per_chip=3e12, wire_bytes_fn=lambda n: 4e8 * (n - 1) / n,
              chip_flops=989e12, ici_bytes_per_s=4.5e11, precision="int8")
    ours, ref = comms.scaling_model(**kw), jcomms.scaling_model(**kw)
    assert [(p.n_chips, p.compute_s, p.comm_s, p.efficiency) for p in ours] == \
        [(p.n_chips, p.compute_s, p.comm_s, p.efficiency) for p in ref]
    # the port's defaults are an H100's, not the reference's TPU's
    default = comms.scaling_model(flops_per_chip=3e12, wire_bytes_fn=lambda n: 4e8)
    assert default[0].compute_s == 3e12 / (989e12 * 0.4)


def test_collective_op_wire_laws():
    for opcode in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute"):
        for g in (1, 2, 8):
            ours = comms.CollectiveOp(opcode, 4096, g)
            ref = jcomms.CollectiveOp(opcode, 4096, g)
            assert ours.wire_bytes_per_device == ref.wire_bytes_per_device


@pytest.fixture(scope="module", params=SIZES, ids=lambda k: f"world{k}")
def world(request, tmp_path_factory):
    w = World(request.param, str(tmp_path_factory.mktemp(f"rdzv{request.param}")))
    yield w
    w.close()


ROUNDS = [("off", "off", None), ("int8", "off", None), ("s4", "on", None),
          ("off", "on", "int8"), ("bf16", "on", "fp8"), ("fp8", "on", "s4")]


@pytest.mark.parametrize("grad,su,gather", ROUNDS)
def test_round_traffic_record_equals_the_law(world, grad, su, gather):
    k = world.size
    results = world.run("ps_traffic", agg="median", n_nodes=k, n_byz=1, d_in=D_IN,
                        comm=None if grad == "off" else grad, su=su, gather=gather)
    per, ops, state_bytes = results[0]
    assert all(r[0] == per and r[1] == ops for r in results)
    # the transpose moves the precision's payload: codes and f32 scales
    a2a = {dtype for opcode, dtype, _, _ in ops if opcode == "all-to-all"}
    assert a2a == {"off": {"float32"}, "bf16": {"bfloat16"}, "int8": {"int8", "float32"},
                   "s4": {"uint8", "float32"}, "fp8": {"uint8", "float32"}}[grad]
    sharded = su == "on"
    law_transpose = comms.ps_round_wire_bytes(D, k, grad_precision=grad)
    law_gather_only = comms.ps_round_wire_bytes(
        D, k, update_sharded=sharded, param_precision=gather or "off") - \
        comms.ps_round_wire_bytes(D, k) / 2
    assert per["all-to-all"] == law_transpose - comms.ps_round_wire_bytes(D, k) / 2
    assert per["all-gather"] == law_gather_only
    assert per["all-gather"] + per["all-to-all"] == comms.ps_round_wire_bytes(
        D, k, update_sharded=sharded, grad_precision=grad, param_precision=gather or "off")
    # the scalar all-reduces: the gradient norm and the honest loss
    assert per["all-reduce"] == 2 * (2 * 4 * (k - 1) // k)
    # the carried state: SGD's trace (and the exact flat shard when sharded)
    assert state_bytes == comms.opt_state_bytes(D, slots=1, update_sharded=sharded, n_shards=k)
