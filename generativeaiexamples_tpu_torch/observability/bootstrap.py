"""One-call observability activation for server startup.

Port of ``generativeaiexamples_tpu/observability/bootstrap.py``: every
server entry point of the port (engine, encoder, chain) calls
``init_observability()`` before binding its port.

Env surface (all opt-in; absent vars are no-ops):

  * ``APP_TRACING_EXPORTER`` (+ ``APP_TRACING_OTLP_ENDPOINT`` /
    ``APP_TRACING_JSONL_PATH`` / ``APP_TRACING_SERVICE``) — span exporter;
  * ``ENABLE_TRACING`` — actually emit spans (exporter alone is inert);
  * ``APP_FLIGHT_DUMP_PATH`` — SIGUSR1 flight-dump target.

The reference's profiler server (``APP_PROFILER_PORT``) is
``observability/profiling.py``, ROADMAP A.17.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

_done = False


def init_observability(service: str = "") -> None:
    """Idempotent; safe from any server's startup path. The SIGUSR1 dump
    installs only from the main thread (servers started on other threads,
    as tests and the card smoke start them, go without it)."""
    global _done
    if _done:
        return
    _done = True
    from generativeaiexamples_tpu_torch.observability import flight, otel

    if service and not os.environ.get("APP_TRACING_SERVICE"):
        os.environ["APP_TRACING_SERVICE"] = (
            f"generativeaiexamples-tpu-torch-{service}")
    exporter = otel.configure_from_env()
    if exporter is not None:
        logger.info("tracing exporter: %s", type(exporter).__name__)
    flight.install_signal_dump()
