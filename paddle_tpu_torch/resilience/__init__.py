"""Resilience: deterministic fault injection (``faults``) for the hardened
paths (the serving engine, the checkpoint writer, the embedding engine's
host tier, the fleet's replicas), the shared retry policy (``retry``) and
the gang supervisor (``supervisor``: whole-gang restarts under a budget,
and replica-grained ``restart(rank)`` for serving fleets)."""
