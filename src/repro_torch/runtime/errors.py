"""Failures of the port, from the JAX package's ``runtime/errors.py``.

The port imports nothing of the JAX package, so it keeps its own copy of
the classes its paths raise: fault injection's ``InjectedFault``, the
sample store's ``StoreStalled``, the disk store's ``CorruptEpisodeError``,
the remote walkers' ``TransportError`` and serving's ``DeadlineExceeded``
and ``Overloaded``.
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


class CorruptEpisodeError(RuntimeError):
    """An episode payload failed its integrity check (short file, checksum
    mismatch). Retriable: the ``(seed, epoch, episode, chunk)`` RNG keying
    means the episode can be re-walked bitwise-identically."""

    def __init__(self, key, path: str, reason: str):
        self.key = key
        self.path = path
        self.reason = reason
        super().__init__(f"episode {key!r} corrupt at {path}: {reason}")


class DeadlineExceeded(RuntimeError):
    """A serving request's deadline passed before it was served."""


class Overloaded(RuntimeError):
    """A serving request was shed at admission because the queue was full."""


class TransportError(RuntimeError):
    """A transport-level failure: torn/corrupt frame, injected disconnect,
    ack timeout, or a peer that vanished mid-conversation. Retriable by
    reconnect-and-resend — the idempotence keys on every episode chunk make
    redelivery exactly-once at the store."""
