"""Telemetry hooks the serving and training paths call, with nothing
behind them yet.

The JAX package's ``obs`` records these calls into a metrics registry and a
trace once ``enable()`` / ``set_tracer()`` switch them on; disabled, each is
a single ``None`` check. The port has no sink to switch them on, so here
they do nothing. The registry, the tracer and ``--metrics-dir`` /
``--trace`` come with the telemetry slice and replace these bodies.
"""
from __future__ import annotations

import contextlib


def span(name: str, cat: str = "", args: dict | None = None):
    """A timed region of the trace (``with span(...):``)."""
    return contextlib.nullcontext()


def counter_add(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``."""


def observe(name: str, value: float) -> None:
    """One sample of the histogram ``name``."""


def gauge_set(name: str, value: float) -> None:
    """The current value of the gauge ``name``."""


def trace_counter(name: str, value: float) -> None:
    """One point of the trace's counter track ``name``."""
