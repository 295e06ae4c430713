"""Observability of the port: the in-tree tracing core (``otel.py``).

The reference's other planes (flight recorder, SLO, devtime, usage,
profiling, alerts) are ROADMAP A.10.
"""
