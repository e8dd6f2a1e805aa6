"""Subtask fan-out for attacks on actor pools.

Counterpart of ``byzpy_tpu/attacks/chunked.py``. The reference
parallelizes every attack except LabelFlip by slicing the work across
pool workers (``byzpy/attacks/base.py:47-119`` + per-attack
``create_subtasks``). The split is over the feature dimension of the
stacked honest matrix (or of the raveled base gradient): each subtask
emits the malicious coordinates of one column span, and the reduce
concatenates them back into the gradient's structure. The spans are
views of the matrix on its device, passed by reference (the JAX package
ships numpy copies).

On one card the plain ``apply`` path is the fast one; this mode serves
pools. The chunk functions are module-level, as the reference's are.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import torch

from ..engine.graph.chunking import pool_size_from_context, select_adaptive_chunk_size
from ..engine.graph.operator import OpContext
from ..engine.graph.subtask import SubTask
from ..ops import attack_ops
from ..utils.trees import stack_gradients, unravel_like

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def mix_seed(seed: int, index: int) -> int:
    """A 63-bit seed for item ``index`` of a stream seeded by ``seed``
    (splitmix64 of both): the Gaussian fan-out's seeds, one per call and
    one per chunk, in place of the JAX package's ``fold_in`` of a key."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (index & _MASK64)) >> 1


# -- module-level chunk functions ---------------------------------------------


def _empire_chunk(cols: torch.Tensor, *, scale: float) -> torch.Tensor:
    return attack_ops.empire(cols, scale=scale)


def _little_chunk(cols: torch.Tensor, *, f: int, n_total: int) -> torch.Tensor:
    return attack_ops.little(cols, f=f, n_total=n_total)


def _mimic_chunk(cols: torch.Tensor, *, epsilon: int) -> torch.Tensor:
    return cols[epsilon]


def _inf_chunk(width: int, *, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return attack_ops.inf_vector((width,), dtype=dtype, device=device)


def _sign_flip_chunk(cols: torch.Tensor, *, scale: float) -> torch.Tensor:
    # the base gradient stacks to a (1, w) block
    return attack_ops.sign_flip(cols[0], scale=scale)


def _gaussian_chunk(width: int, seed: int, *, mu: float, sigma: float, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    generator = torch.Generator(device=device).manual_seed(seed)
    return attack_ops.gaussian(generator, (width,), dtype=dtype, mu=mu, sigma=sigma, device=device)


# -- mixins -------------------------------------------------------------------


class FeatureChunkedAttack:
    """Mixin: fan malicious-coordinate spans across the pool and
    concatenate them (the reference's attack subtask mode, split by
    feature)."""

    supports_subtasks = True
    chunk_size = 65536
    _chunk_fn: Any = None

    def _chunk_params(self, host: torch.Tensor) -> Mapping[str, Any]:
        return {}

    def _chunk_host(self, inputs: Mapping[str, Any]) -> torch.Tensor:
        """The ``(n, d)`` stacked honest matrix (or the ``(1, d)`` base
        gradient block) on the attack's device."""
        grads = inputs.get("honest_grads")
        if not grads:
            raise ValueError(f"{self.name} attack requires honest_grads")
        return self._stack_honest(grads)[0]

    def _unravel_like(self, inputs: Mapping[str, Any]):
        return unravel_like(inputs.get("honest_grads"), self.device)

    def _chunk_args(self, host: torch.Tensor, start: int, end: int, idx: int) -> tuple:
        return (host[:, start:end],)

    def create_subtasks(self, inputs: Mapping[str, Any], *, context: OpContext) -> Iterable[SubTask]:
        host = self._chunk_host(inputs)
        d = host.shape[-1]
        chunk = select_adaptive_chunk_size(
            d, self.chunk_size, pool_size=pool_size_from_context(context)
        )
        params = dict(self._chunk_params(host))
        fn = type(self)._chunk_fn
        # an eager list: instance state that _chunk_args reads (the
        # Gaussian fan-out's seed) is taken before another create_subtasks
        # call advances it
        tasks = []
        for idx, start in enumerate(range(0, d, chunk)):
            end = min(d, start + chunk)
            tasks.append(SubTask(fn=fn, args=self._chunk_args(host, start, end, idx),
                                 kwargs=params, name=f"{self.name}-feat[{start}:{end}]"))
        return tasks

    def reduce_subtasks(self, partials, inputs: Mapping[str, Any], *, context: OpContext) -> Any:
        return self._unravel_like(inputs)(torch.cat(list(partials)))


class BaseGradChunkedAttack(FeatureChunkedAttack):
    """Variant for ``uses_base_grad`` attacks: the spans come from the
    node's own gradient instead of the honest matrix."""

    def _chunk_host(self, inputs: Mapping[str, Any]) -> torch.Tensor:
        base = inputs.get("base_grad")
        if base is None:
            raise ValueError(f"{self.name} attack requires base_grad")
        return stack_gradients([base], device=self.device)[0]

    def _unravel_like(self, inputs: Mapping[str, Any]):
        return unravel_like([inputs.get("base_grad")], self.device)


__all__ = [
    "FeatureChunkedAttack",
    "BaseGradChunkedAttack",
    "mix_seed",
    "_empire_chunk",
    "_little_chunk",
    "_mimic_chunk",
    "_inf_chunk",
    "_sign_flip_chunk",
    "_gaussian_chunk",
]
