"""Execution engine (counterpart of ``byzpy_tpu/engine``): so far the
operator protocol of ``engine.graph``, ``engine.peer_to_peer``'s
topology and the compressed wire rows of ``engine.actor.wire``."""
