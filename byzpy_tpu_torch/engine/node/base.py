"""Training-node ABCs.

Counterpart of ``byzpy_tpu/engine/node/base.py`` (API parity:
``byzpy/engine/node/base.py:1-39``). A node owns its data shard and its
local state. Gradients are tensors, or dictionaries / lists / tuples of
them, that the aggregators stack (:func:`byzpy_tpu_torch.utils.trees.
stack_gradients`); a node hosted in a ``cuda`` actor computes on the
actor's stream.
"""

from __future__ import annotations

import abc
from typing import Any, Sequence, Tuple


class Node(abc.ABC):
    """Common surface: a batch supply and applying the aggregated update."""

    @abc.abstractmethod
    def next_batch(self) -> Tuple[Any, Any]:
        """Return the next ``(x, y)`` local batch."""

    @abc.abstractmethod
    def apply_server_gradient(self, gradient: Any) -> None:
        """Apply the aggregated gradient to the local model state."""

    def ping(self) -> bool:
        """Cheap liveness probe: answering at all is the signal."""
        return True

    def resync_params(self, state: Any) -> None:
        """Receive authoritative state on re-admission
        (``ElasticPolicy.resync``). Default: nothing to load."""


class HonestNode(Node):
    """A node that computes true gradients on its own shard."""

    @abc.abstractmethod
    def honest_gradient(self, x: Any, y: Any) -> Any:
        """Gradient of the local loss at the current parameters."""

    def honest_gradient_for_next_batch(self) -> Any:
        x, y = self.next_batch()
        return self.honest_gradient(x, y)


class ByzantineNode(Node):
    """A node that emits adversarial vectors, possibly from the honest
    gradients it observes (the omniscient adversary)."""

    @abc.abstractmethod
    def byzantine_gradient(self, honest_gradients: Sequence[Any]) -> Any:
        """Malicious vector shaped like an honest gradient."""

    def byzantine_gradient_for_next_batch(self, honest_gradients: Sequence[Any]) -> Any:
        return self.byzantine_gradient(honest_gradients)


__all__ = ["Node", "HonestNode", "ByzantineNode"]
