"""byzpy_tpu_torch — the PyTorch/CUDA port of byzpy_tpu.

The JAX package ``byzpy_tpu`` is the reference; this package mirrors its
layout (``ops``, ``models``, ``parallel``, ``utils``, the operator classes
of ``aggregators``, ``pre_aggregators`` and ``attacks``, the graph
engine of ``engine.graph`` with its actor pools on ``engine.actor``'s
``thread`` and ``cuda`` backends, and the orchestrators of
``engine.node``, ``engine.parameter_server`` and ``engine.peer_to_peer``)
and runs on an NVIDIA Hopper GPU.
Plain tensor code is PyTorch; every kernel the JAX
package wrote in Pallas becomes a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_build.py``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``. The compiled steps of ``parallel`` (``jit_*``),
the counterpart of ``jax.jit``, replay CUDA graphs (``utils/cuda_graph.py``).

The front door is the JAX package's: ``asyncio.run(run_operator(
CoordinateWiseMedian(), gradients, pool_config=ActorPoolConfig(
backend="cuda", count=4)))``.

This package imports neither JAX nor anything of ``byzpy_tpu``.
"""

from .version import __version__

__all__ = ["__version__", "OperatorExecutor", "run_operator"]


def __getattr__(name: str):
    # lazy, as in the JAX package: importing the package stays cheap
    if name in ("OperatorExecutor", "run_operator"):
        from .engine.graph import executor

        return getattr(executor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
