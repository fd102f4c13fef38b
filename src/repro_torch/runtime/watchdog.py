"""Watchdog deadlines for producer/consumer wait loops (a copy of the JAX
package's ``runtime/watchdog.py``).

The sample stores used to spin forever in ``_cv.wait(timeout=60.0)`` loops:
a walker thread dying without ``finish_epoch``/``abandon`` left the trainer
blocked silently, for good. :class:`Deadline` replaces those with loud
failure: a waiter periodically feeds it the store's progress version and a
producer-liveness probe, and it raises a diagnostics-carrying
:class:`~repro_torch.runtime.errors.StoreStalled` when the producer is provably
dead or nothing has happened for ``timeout_s``.

The deadline is measured from the last **progress** event (any put / drop /
finish on the store), not from the start of the wait: a healthy-but-slow
pipeline never trips it, only a genuinely wedged one does.
"""
from __future__ import annotations

import time

from repro_torch.runtime.errors import StoreStalled

#: wait-slice between liveness/deadline checks; condition notifies still
#: wake waiters immediately — this only bounds failure-detection latency
POLL_S = 0.25


class Deadline:
    """Stall watchdog for one wait loop.

    Parameters
    ----------
    timeout_s : seconds without store progress before ``StoreStalled``
        (None = no overall deadline; producer liveness still applies).
    op : description of the blocked operation ("get"/"put"/"episodes").
    key : the (epoch, episode) — or epoch — being waited on.
    producer : optional zero-arg liveness probe (e.g. ``WalkEngine.alive``
        or ``HostHealth.any_alive`` for remote producers); a False return
        while the waited-for work is still possible raises immediately — no
        point waiting out the deadline on a corpse.
    producer_info : optional zero-arg callable returning a human-readable
        producer description (e.g. ``HostHealth.describe``, naming which
        HOSTS are alive/dead and how stale their leases are) — attached to
        the ``StoreStalled`` so the diagnostic names the dead machine, not
        just "producer: DEAD".
    resident : zero-arg callable returning the store's resident keys, for
        the diagnostic.
    """

    def __init__(self, timeout_s: float | None, *, op: str, key,
                 producer=None, producer_info=None, resident=lambda: ()):
        self.timeout_s = timeout_s
        self.op = op
        self.key = key
        self.producer = producer
        self.producer_info = producer_info
        self.resident = resident
        self._t_progress = time.monotonic()
        self._version = None

    def wait_s(self) -> float:
        """The cv-wait / sleep slice to use before the next check."""
        if self.timeout_s is None:
            return POLL_S
        remaining = self.timeout_s - (time.monotonic() - self._t_progress)
        return max(0.001, min(POLL_S, remaining))

    def check(self, version=None, *, producer_done: bool = False) -> None:
        """Raise ``StoreStalled`` if stalled; otherwise note progress.

        version : the store's progress counter; any change resets the
            deadline clock.
        producer_done : True once the producer has legitimately finished
            (epoch done-marker seen) — suppresses the liveness raise so a
            normally-exited producer isn't mistaken for a crash.
        """
        now = time.monotonic()
        if version != self._version:
            self._version = version
            self._t_progress = now
            return
        alive = None
        if self.producer is not None and not producer_done:
            alive = bool(self.producer())
            if not alive:
                raise StoreStalled(self.op, self.key,
                                   resident=self.resident(),
                                   producer_alive=False,
                                   producer_info=self._info(),
                                   waited_s=now - self._t_progress)
        if (self.timeout_s is not None
                and now - self._t_progress >= self.timeout_s):
            raise StoreStalled(self.op, self.key, resident=self.resident(),
                               producer_alive=alive,
                               producer_info=self._info(),
                               waited_s=now - self._t_progress)

    def _info(self) -> str | None:
        if self.producer_info is None:
            return None
        try:
            return str(self.producer_info())
        except Exception as e:  # noqa: BLE001 — diagnostics must not mask
            return f"producer_info failed: {e!r}"
