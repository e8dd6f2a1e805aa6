"""Execution engine (counterpart of ``byzpy_tpu/engine``): the graph
engine of ``engine.graph`` (operators, schedulers, sessions, actor
pools), the actor layer of ``engine.actor`` (the ``thread``, ``cuda``,
``process`` and ``tcp://`` backends, channels, and the wire's frames of
``engine.actor.wire``), the host shm store of ``engine.storage``, the node tier of ``engine.node``, the
orchestrators of ``engine.parameter_server`` and ``engine.peer_to_peer``,
and the overlapped round machinery of ``engine.overlap``."""
