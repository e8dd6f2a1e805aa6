"""The legacy runtime on the CPU: the mailbox transports, ``NodeRunner``
children and ``StepParameterServer`` rounds.

The JAX package's ``tests/test_legacy_runtime.py`` cases on the port, with
the runners' children on the CPU (``BYZPY_TPU_TORCH_CHILD_DEVICE=cpu``),
plus a parity case: five ``StepParameterServer`` rounds of the port's
runners under the port's trimmed mean against the JAX package's
``StepParameterServer`` over the same nodes hosted in process under its
trimmed mean, every update equal bit for bit. The node classes live at
module level (a child imports them by reference) and this module imports
no JAX at its top, so a child never loads it.
"""

import functools
import queue

import numpy as np
import pytest
import torch

from byzpy_tpu_torch.engine.legacy import (
    LocalMailbox,
    NodeCluster,
    NodeRunner,
    StepParameterServer,
    TcpMailbox,
)
from byzpy_tpu_torch.ops import robust

D = 64
TARGETS = (1.0, 1.0, 1.5, 4.0, -3.0)


@pytest.fixture(autouse=True)
def _cpu_children_and_registry(monkeypatch):
    monkeypatch.setenv("BYZPY_TPU_TORCH_CHILD_DEVICE", "cpu")
    LocalMailbox.clear_registry()
    yield
    LocalMailbox.clear_registry()


def test_local_mailbox_roundtrip():
    a, b = LocalMailbox("a"), LocalMailbox("b")
    a.send("b", {"v": 1})
    sender, payload = b.recv(timeout=1)
    assert sender == "a" and payload == {"v": 1}
    with pytest.raises(ConnectionError):
        a.send("ghost", None)
    with pytest.raises(queue.Empty):
        a.recv(timeout=0.05)
    with pytest.raises(ValueError, match="already exists"):
        LocalMailbox("a")
    b.close()
    a.close()


def test_tcp_mailbox_loopback_carries_a_tensor():
    a = TcpMailbox("a")
    b = TcpMailbox("b")
    a.add_peer("b", (b.host, b.port))
    b.add_peer("a", (a.host, a.port))
    try:
        sent = torch.arange(8, dtype=torch.float32) * 0.5
        a.send("b", {"grad": sent, "round": 3})
        sender, payload = b.recv(timeout=5)
        assert sender == "a" and payload["round"] == 3
        assert torch.equal(payload["grad"], sent)
        b.send("a", "pong")
        assert a.recv(timeout=5) == ("b", "pong")
        with pytest.raises(ConnectionError):
            a.send("ghost", 1)
        with pytest.raises(TypeError, match="by reference"):
            a.send("b", lambda: None)
    finally:
        a.close()
        b.close()


class CountNode:
    """Step-protocol node: ``step()`` returns a gradient toward ``target``."""

    def __init__(self, target):
        self.target = float(target)
        self.w = 0.0
        self.messages = []

    def step(self, payload=None):
        return 2.0 * (self.w - self.target)

    def apply_update(self, update):
        self.w -= 0.25 * update

    def get_w(self):
        return self.w

    def handle_message(self, message):
        self.messages.append(message)

    def message_count(self):
        return len(self.messages)

    def device(self):
        return str(torch.zeros(1).device), torch.cuda.is_available()


class VectorNode:
    """A node whose state is a ``(D,)`` float32 vector drawn from its seed:
    ``step()`` returns ``2 (w - target)``, ``apply_update(u)`` takes ``w -=
    0.25 u``. The same arithmetic in numpy float32 (:class:`NumpyVectorNode`)
    gives the same bits."""

    def __init__(self, seed, target):
        self.w = torch.from_numpy(np.random.default_rng(seed).normal(size=D).astype(np.float32))
        self.target = torch.full((D,), target, dtype=torch.float32)

    def step(self, payload=None):
        return 2.0 * (self.w - self.target)

    def apply_update(self, update):
        self.w = self.w - 0.25 * update

    def get_w(self):
        return self.w


class NumpyVectorNode:
    def __init__(self, seed, target):
        self.w = np.random.default_rng(seed).normal(size=D).astype(np.float32)
        self.target = np.full((D,), target, dtype=np.float32)

    def step(self, payload=None):
        return np.float32(2.0) * (self.w - self.target)

    def apply_update(self, update):
        self.w = self.w - np.float32(0.25) * np.asarray(update, dtype=np.float32)


def test_node_runner_step_call_deliver():
    runner = NodeRunner(functools.partial(CountNode, 2.0))
    assert runner.child_device == "cpu"
    runner.start()
    try:
        g = runner.step()
        assert g == -4.0
        runner.call("apply_update", g)
        assert runner.call("get_w") == 1.0
        runner.deliver({"hello": 1})
        for _ in range(100):
            if runner.call("message_count") == 1:
                break
        assert runner.call("message_count") == 1
        with pytest.raises(RuntimeError):
            runner.call("missing_method")
        # the child sees no card: CUDA_VISIBLE_DEVICES is empty there
        assert runner.call("device") == ("cpu", False)
    finally:
        runner.stop()
    with pytest.raises(ConnectionError):
        runner.step()


def test_node_runner_refuses_a_lambda_factory_and_a_bad_device():
    with pytest.raises(TypeError, match="by reference"):
        NodeRunner(lambda: CountNode(1.0))


def test_node_runner_device_argument(monkeypatch):
    monkeypatch.delenv("BYZPY_TPU_TORCH_CHILD_DEVICE")
    assert NodeRunner(functools.partial(CountNode, 1.0)).child_device == "cuda"
    assert NodeRunner(functools.partial(CountNode, 1.0), child_device="cpu").child_device == "cpu"
    with pytest.raises(ValueError, match="child_device"):
        NodeRunner(functools.partial(CountNode, 1.0), child_device="tpu")
    if not torch.cuda.is_available():
        runner = NodeRunner(functools.partial(CountNode, 1.0))
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            runner.start()


def test_step_parameter_server_median_round():
    cluster = NodeCluster()
    for i, t in enumerate((1.0, 1.0, 4.0)):
        cluster.add(f"n{i}", NodeRunner(functools.partial(CountNode, t)))
    with pytest.raises(ValueError, match="duplicate"):
        cluster.add("n0", NodeRunner(functools.partial(CountNode, 0.0)))
    with cluster:
        ps = StepParameterServer(cluster, lambda grads: float(np.median(grads)))
        for _ in range(25):
            ps.round()
        ws = [cluster.runner(n).call("get_w") for n in cluster.names]
    # median aggregation drives every node to the majority target
    np.testing.assert_allclose(ws, 1.0, atol=0.05)
    assert ps.rounds_completed == 25


class _InProcessRunner:
    def __init__(self, node):
        self.node = node

    def call(self, method, *args):
        return getattr(self.node, method)(*args)


class _InProcessCluster:
    """The JAX package's ``StepParameterServer`` reads ``step_all``,
    ``names`` and ``runner(name).call``: this holds the same nodes in
    process, so the reference's server runs without a child."""

    def __init__(self, nodes):
        self._runners = {name: _InProcessRunner(node) for name, node in nodes.items()}

    @property
    def names(self):
        return sorted(self._runners)

    def runner(self, name):
        return self._runners[name]

    def step_all(self):
        return {name: r.node.step() for name, r in self._runners.items()}


def _port_aggregate(name, grads):
    x = torch.stack(list(grads))
    return robust.coordinate_median(x) if name == "median" else robust.trimmed_mean(x, f=1)


# (aggregator, nodes): at these node counts the result is order-free (the
# middle value; the half-sum of the two middle values), so both packages
# give the same bits
PARITY_CASES = [("median", 5), ("trimmed_mean", 4)]


@pytest.mark.parametrize("agg,n_nodes", PARITY_CASES)
def test_step_parameter_server_matches_the_reference_bitwise(agg, n_nodes):
    """Five rounds: every update (and every node's weights after them) of
    the port's runners equals the JAX package's server over the same
    nodes hosted in process, bit for bit (tolerance 0)."""
    import jax
    import jax.numpy as jnp

    from byzpy_tpu.engine.legacy import StepParameterServer as RefServer
    from byzpy_tpu.ops import robust as ref_robust

    ref_fn = jax.jit(ref_robust.coordinate_median if agg == "median"
                     else functools.partial(ref_robust.trimmed_mean, f=1))

    def ref_aggregate(grads):
        return np.asarray(ref_fn(jnp.stack([jnp.asarray(g) for g in grads])))

    targets = TARGETS[:n_nodes]
    names = [f"n{i}" for i in range(n_nodes)]
    ref = RefServer(_InProcessCluster(
        {n: NumpyVectorNode(i, t) for i, (n, t) in enumerate(zip(names, targets))}),
        ref_aggregate)
    cluster = NodeCluster()
    for i, (n, t) in enumerate(zip(names, targets)):
        cluster.add(n, NodeRunner(functools.partial(VectorNode, i, t)))
    with cluster:
        ps = StepParameterServer(cluster, functools.partial(_port_aggregate, agg))
        for _ in range(5):
            got = ps.round()
            want = ref.round()
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
        for n in names:
            np.testing.assert_array_equal(cluster.runner(n).call("get_w").numpy(),
                                          ref.cluster.runner(n).node.w)
    assert ps.rounds_completed == ref.rounds_completed == 5
