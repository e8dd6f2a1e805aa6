"""byzpy_tpu_torch — the PyTorch/CUDA port of byzpy_tpu.

The JAX package ``byzpy_tpu`` is the reference; this package mirrors its
layout (``ops``, ``models``, ``parallel``, ``utils``, the operator classes
of ``aggregators``, ``pre_aggregators`` and ``attacks``, and
``engine.graph``'s operator protocol) and runs on an NVIDIA Hopper GPU.
Plain tensor code is PyTorch; every kernel the JAX
package wrote in Pallas becomes a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_build.py``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.

This package imports neither JAX nor anything of ``byzpy_tpu``.
"""

from .version import __version__

__all__ = ["__version__"]
