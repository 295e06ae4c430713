"""Observability of the port: the in-tree tracing core (``otel``) and the
host planes of the servers.

Sibling planes: ``flight`` (scheduler-state ring + request timelines),
``trace`` (the admission / dispatch record stream), ``slo`` (budgets,
burn rates, shed pressure), ``usage`` (the per-tenant ledger),
``devtime`` (the per-dispatch device-time ledger on CUDA events and the
first-seen watch), ``chaos`` (fault injection), ``lockwatch`` (the lock
order sanitizer), ``alerts`` (multi-window burn-rate alerts over the SLO
judge's verdicts), ``forensics`` (per-request critical paths, the
tail-exemplar ring and ``/debug/doctor``) and ``bootstrap``
(``init_observability``). The QoS admission plane is
``engine/qos.py``; device profiling (``profiling``) is A.17.
"""

from generativeaiexamples_tpu_torch.observability.bootstrap import (  # noqa: F401
    init_observability,
)
from generativeaiexamples_tpu_torch.observability.devtime import (  # noqa: F401
    DEVTIME,
    DevtimeLedger,
)
from generativeaiexamples_tpu_torch.observability.flight import (  # noqa: F401
    FLIGHT,
    REQUEST_LOG,
    FlightRecorder,
    RequestLog,
    install_signal_dump,
    timeline,
    timeline_attributes,
)
from generativeaiexamples_tpu_torch.observability.usage import (  # noqa: F401
    USAGE,
    UsageLedger,
    tenant_from_headers,
)
from generativeaiexamples_tpu_torch.observability.otel import (  # noqa: F401
    ConsoleSpanExporter,
    InMemorySpanExporter,
    JsonlSpanExporter,
    Span,
    Tracer,
    extract_traceparent,
    get_tracer,
    inject_traceparent,
    set_exporter,
)
