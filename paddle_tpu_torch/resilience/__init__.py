"""Resilience: deterministic fault injection (``faults``) for the hardened
paths (the serving engine, the checkpoint writer, the embedding engine's
host tier) and the shared retry policy (``retry``)."""
