"""Execution engine (counterpart of ``byzpy_tpu/engine``): the graph
engine of ``engine.graph`` (operators, schedulers, sessions, actor
pools), the actor layer of ``engine.actor`` (the ``thread`` and ``cuda``
backends, channels, and the compressed wire rows of
``engine.actor.wire``), the node tier of ``engine.node``, the
orchestrators of ``engine.parameter_server`` and ``engine.peer_to_peer``,
and the overlapped round machinery of ``engine.overlap``."""
