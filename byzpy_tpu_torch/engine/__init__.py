"""Execution engine (counterpart of ``byzpy_tpu/engine``): the graph
engine of ``engine.graph`` (operators, schedulers, sessions, actor
pools), the actor layer of ``engine.actor`` (the ``thread`` and ``cuda``
backends, channels, and the compressed wire rows of
``engine.actor.wire``), and ``engine.peer_to_peer``'s topology."""
