"""Resilience: deterministic fault injection (``faults``) for the
serving engine's hardened paths."""
