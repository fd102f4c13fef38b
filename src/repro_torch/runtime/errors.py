"""Failures of the port, from the JAX package's ``runtime/errors.py``.

The port imports nothing of the JAX package, so it keeps its own copy of
the classes its paths raise: fault injection's ``InjectedFault``, the
sample store's ``StoreStalled`` and serving's ``DeadlineExceeded`` and
``Overloaded``. The transport and corrupt-episode errors come with the
slices that raise them.
"""
from __future__ import annotations


class InjectedFault(RuntimeError):
    """Raised by a ``crash`` fault spec firing at a fault point.

    Deliberately a distinct type: tests and chaos runs assert that a
    failure was the injected one and not an incidental bug."""

    def __init__(self, site: str, key=None):
        self.site = site
        self.key = key
        super().__init__(f"injected fault at {site!r}"
                         + (f" key={key!r}" if key is not None else ""))


class StoreStalled(RuntimeError):
    """A sample-store wait loop gave up: the producer died or the stall
    deadline passed with no store progress.

    Carries the diagnostics the old silent ``_cv.wait(60.0)`` spin threw
    away: which key the waiter was blocked on, what was resident at the
    time, and whether the producer looked alive."""

    def __init__(self, op: str, key, *, resident, producer_alive,
                 waited_s: float, producer_info: str | None = None):
        self.op = op
        self.key = key
        self.resident = tuple(resident)
        self.producer_alive = producer_alive
        self.producer_info = producer_info
        self.waited_s = waited_s
        alive = ("unknown" if producer_alive is None
                 else "alive" if producer_alive else "DEAD")
        super().__init__(
            f"sample store stalled in {op} waiting on {key!r} "
            f"({waited_s:.1f}s without progress); resident episodes: "
            f"{sorted(self.resident)!r}; producer: {alive}"
            + (f" [{producer_info}]" if producer_info else ""))


class DeadlineExceeded(RuntimeError):
    """A serving request's deadline passed before it was served."""


class Overloaded(RuntimeError):
    """A serving request was shed at admission because the queue was full."""
