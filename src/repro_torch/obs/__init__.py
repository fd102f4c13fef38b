"""Unified telemetry: metrics registry + span tracer + sinks.

Copies of the JAX package's ``obs`` modules, exporting what it exports.
Disabled by default. ``enable()`` installs the process-wide registry;
``set_tracer(Tracer())`` installs the span recorder. Every hot-path
helper (``counter_add``/``gauge_set``/``observe``/``span``/``instant``/
``trace_counter``) is a single module-level ``None`` check while
disabled, so instrumented code pays nothing until a launcher opts in via
``--metrics-dir`` / ``--trace``.
"""
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    active,
    counter_add,
    disable,
    enable,
    enabled,
    gauge_set,
    observe,
    register_source,
    unregister_source,
)
from .sink import MetricsWriter  # noqa: F401
from .trace import (  # noqa: F401
    PIPELINE_TRACKS,
    Tracer,
    instant,
    set_tracer,
    span,
    trace_counter,
    tracer,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "MetricsWriter", "Tracer",
    "PIPELINE_TRACKS",
    "enable", "disable", "active", "enabled",
    "counter_add", "gauge_set", "observe",
    "register_source", "unregister_source",
    "set_tracer", "tracer", "span", "instant", "trace_counter",
]
