"""Execution engine (counterpart of ``byzpy_tpu/engine``): so far the
operator protocol of ``engine.graph`` and ``engine.peer_to_peer``'s
topology."""
