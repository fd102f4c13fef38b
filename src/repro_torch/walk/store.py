"""Sample store connecting the walk engine to the training engine (paper Fig. 2).

A copy of the in-memory half of the JAX package's ``walk/store.py`` (the
fast-cluster mode, §IV-A: samples stay resident). The disk store comes with
the slice that ports ``--store disk``.

The two engines are decoupled: the walk engine `put`s episode-partitioned
sample arrays, the trainer `get`s them. The store is bounded: constructed
with ``depth=N``, ``put`` applies backpressure (blocks the walker) while N
undrained episodes are resident, and ``drop`` releases a consumed episode,
so peak sample memory is O(depth · episode), not O(epoch).

Every wait loop runs under a watchdog ``Deadline``: a producer that died
without ``finish_epoch``/``abandon`` (liveness wired via
:meth:`SampleStore.set_producer`, typically ``WalkEngine.alive``) or
``stall_timeout_s`` seconds without any store progress raises a
diagnostics-carrying ``StoreStalled`` instead of spinning forever.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.obs import counter_add, gauge_set, observe, trace_counter
from repro_torch.runtime import Deadline

#: default seconds without store progress before a blocked wait raises
#: ``StoreStalled`` (pass ``stall_timeout_s=None`` to wait forever;
#: producer-liveness detection still applies)
DEFAULT_STALL_TIMEOUT_S = 600.0


class SampleStore:
    #: bounded-capacity knob: None = unbounded; N = ``put`` blocks while N
    #: undrained episodes are resident.
    depth: int | None = None

    #: producer-liveness probe (``set_producer``); None = unknown
    _producer = None

    def set_producer(self, alive_fn) -> None:
        """Wire a zero-arg producer-liveness probe (``WalkEngine.alive``):
        a blocked ``get`` whose producer is dead fails with
        ``StoreStalled`` instead of waiting out the stall deadline."""
        self._producer = alive_fn

    def put(self, epoch: int, episode: int, pairs: np.ndarray) -> None:
        raise NotImplementedError

    def get(self, epoch: int, episode: int, *, block: bool = True) -> np.ndarray:
        raise NotImplementedError

    def finish_epoch(self, epoch: int) -> None:
        pass

    # ------------------------------------------------------------- draining
    def drop(self, epoch: int, episode: int) -> None:
        """Release one consumed episode (frees a backpressure slot)."""

    def drop_epoch(self, epoch: int) -> None:
        """Release every episode of an epoch plus its bookkeeping."""

    def abandon(self) -> None:
        """Terminal: the consumer died. Subsequent ``put``s are discarded
        without blocking, so a walker mid-epoch can run to completion (and
        ``finish_epoch``) instead of deadlocking on backpressure."""


class MemorySampleStore(SampleStore):
    """Thread-safe in-memory store; trainer blocks until the walker delivers.

    ``depth=N`` bounds resident (put-but-not-dropped) episodes: the walker's
    ``put`` blocks until the trainer ``drop``s. ``peak_resident`` records the
    high-water mark so tests can assert the bound actually held.
    ``stall_timeout_s`` is the watchdog deadline on every wait loop,
    measured from the last store progress event (put/drop/finish), so a
    slow-but-moving pipeline never trips it.
    """

    def __init__(self, depth: int | None = None,
                 stall_timeout_s: float | None = DEFAULT_STALL_TIMEOUT_S):
        self.depth = depth
        self.stall_timeout_s = stall_timeout_s
        self._data: dict[tuple[int, int], np.ndarray] = {}
        self._dropped: set[tuple[int, int]] = set()
        self._done: set[int] = set()
        self._cv = threading.Condition()
        self._abandoned = False
        self._version = 0              # progress counter for the watchdogs
        self.peak_resident = 0

    def _resident_keys(self):
        return list(self._data)

    def put(self, epoch, episode, pairs):
        t0 = time.perf_counter()
        with self._cv:
            if self.depth is not None:
                # no producer probe here: put's stall means the CONSUMER
                # vanished without drop/abandon — only the progress
                # deadline can see that
                dl = Deadline(self.stall_timeout_s, op="put",
                              key=(epoch, episode),
                              resident=self._resident_keys)
                while len(self._data) >= self.depth and not self._abandoned:
                    dl.check(self._version)
                    self._cv.wait(timeout=dl.wait_s())
            if self._abandoned:
                return
            observe("store.put_wait_s", time.perf_counter() - t0)
            counter_add("store.puts")
            self._data[(epoch, episode)] = pairs
            self.peak_resident = max(self.peak_resident, len(self._data))
            gauge_set("store.resident", len(self._data))
            trace_counter("store.resident", len(self._data))
            self._version += 1
            self._cv.notify_all()

    def finish_epoch(self, epoch):
        with self._cv:
            self._done.add(epoch)
            self._version += 1
            self._cv.notify_all()

    def get(self, epoch, episode, *, block=True):
        t0 = time.perf_counter()
        with self._cv:
            dl = Deadline(self.stall_timeout_s, op="get",
                          key=(epoch, episode), producer=self._producer,
                          resident=self._resident_keys)
            while (epoch, episode) not in self._data:
                if (epoch, episode) in self._dropped:
                    raise KeyError((epoch, episode))  # consumed and released
                if not block or (epoch in self._done):
                    raise KeyError((epoch, episode))
                dl.check(self._version, producer_done=epoch in self._done)
                self._cv.wait(timeout=dl.wait_s())
            observe("store.get_blocked_s", time.perf_counter() - t0)
            counter_add("store.gets")
            return self._data[(epoch, episode)]

    def drop(self, epoch, episode):
        with self._cv:
            if self._data.pop((epoch, episode), None) is not None:
                self._dropped.add((epoch, episode))
                gauge_set("store.resident", len(self._data))
                trace_counter("store.resident", len(self._data))
                self._version += 1
                self._cv.notify_all()

    def drop_epoch(self, epoch: int) -> None:
        with self._cv:
            for k in [k for k in self._data if k[0] == epoch]:
                del self._data[k]
            self._dropped = {k for k in self._dropped if k[0] != epoch}
            self._done.discard(epoch)
            self._version += 1
            self._cv.notify_all()

    def abandon(self) -> None:
        with self._cv:
            self._abandoned = True
            self._data.clear()
            self._version += 1
            self._cv.notify_all()
