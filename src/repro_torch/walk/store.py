"""Sample store connecting the walk engine to the training engine (paper Fig. 2).

A copy of the JAX package's ``walk/store.py`` (numpy and the standard
library only). The episode files of :class:`DiskSampleStore` (``.npy``,
``.crc`` sidecar, ``.done`` marker) are byte for byte those of the JAX
package's store, under the same names, so either package reads a sample
directory the other wrote.

The two engines are decoupled: the walk engine `put`s episode-partitioned
sample arrays, the trainer `get`s them. Two backends mirror the paper's two
cluster modes (§IV-A): in-memory (fast clusters, samples stay resident) and
disk (slow clusters: offline files partitioned by episode, memory-mapped).

Both backends implement a bounded-capacity contract: constructed with
``depth=N``, ``put`` applies backpressure (blocks the walker) while more than
N undrained episodes are resident, and ``drop`` releases a consumed episode.
With the streaming dataflow (walk engine puts episodes as they complete, the
episode pipeline drops them once built into blocks) peak sample memory is
O(depth · episode), not O(epoch).

Fault tolerance (``repro_torch.runtime``): every wait loop runs under a
watchdog ``Deadline`` — a producer that died without
``finish_epoch``/``abandon`` (liveness wired via
:meth:`SampleStore.set_producer`, typically ``WalkEngine.alive``) or
``stall_timeout_s`` seconds without any store progress raises a
diagnostics-carrying ``StoreStalled`` instead of spinning silently forever.
Disk episode files are published atomically (tmp + ``os.replace``) with a
CRC32 sidecar written *first*, so a reader that sees the payload always sees
its checksum; a short or corrupt payload raises ``CorruptEpisodeError``,
which the episode pipeline treats as retriable (re-walk the episode —
bitwise identical by RNG keying — and :meth:`DiskSampleStore.rewrite` the
file). Fault sites: ``store.put`` (both backends), ``disk.write`` (a
``corrupt`` spec truncates the payload after its checksum is recorded,
simulating a torn write).

``put_unique``, ``accepted_episodes`` and ``set_producer``'s ``info_fn``
are the store's half of the remote walkers' exactly-once delivery and
coordinator failover (``walk/remote.py``).
"""
from __future__ import annotations

import os
import threading
import time
import zlib

import numpy as np

from repro_torch.obs import counter_add, gauge_set, observe, trace_counter
from repro_torch.runtime import CorruptEpisodeError, Deadline, fault_point

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
    #: optional producer description for stall diagnostics; None = unnamed
    _producer_info = None

    def set_producer(self, alive_fn, info_fn=None) -> None:
        """Wire a zero-arg producer-liveness probe (``WalkEngine.alive`` or
        ``RemoteWalkCoordinator.alive`` for remote producers): a blocked
        ``get``/``episodes`` whose producer is dead fails with
        ``StoreStalled`` instead of waiting out the stall deadline.
        ``info_fn`` (e.g. ``HostHealth.describe``) renders the producer's
        state for the diagnostic, so a stall names the dead HOST."""
        self._producer = alive_fn
        self._producer_info = info_fn

    def put(self, epoch: int, episode: int, pairs: np.ndarray) -> None:
        raise NotImplementedError

    def put_unique(self, epoch: int, episode: int, pairs: np.ndarray) -> bool:
        """Idempotent ``put``: deliver the episode exactly once.

        Returns False — WITHOUT blocking or storing — when the episode is
        already resident, already consumed-and-dropped, or the store was
        abandoned; True when this call delivered it. This is the store-side
        half of the remote walkers' exactly-once contract: a reconnecting
        producer resends everything unacked, and redelivery lands here as a
        no-op instead of a duplicate episode."""
        raise NotImplementedError

    def get(self, epoch: int, episode: int, *, block: bool = True) -> np.ndarray:
        raise NotImplementedError

    def accepted_episodes(self, epoch: int) -> list[int]:
        """Episodes of ``epoch`` this store has already accepted — resident
        OR consumed-and-dropped. This is the coordinator-failover recovery
        source: a restarted episode server re-derives its ordered-put
        cursor from the longest contiguous accepted prefix and only
        re-produces what the store never took (``walk/remote.py``)."""
        return []

    def finish_epoch(self, epoch: int) -> None:
        pass

    def episodes(self, epoch: int) -> int:
        raise NotImplementedError

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
        self._counts: dict[int, int] = {}
        self._cv = threading.Condition()
        self._abandoned = False
        self._version = 0              # progress counter for the watchdogs
        self.peak_resident = 0

    def _resident_keys(self):
        return list(self._data)

    def put(self, epoch, episode, pairs):
        fault_point("store.put", (epoch, episode))
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
            self._counts[epoch] = self._counts.get(epoch, 0) + 1
            self.peak_resident = max(self.peak_resident, len(self._data))
            gauge_set("store.resident", len(self._data))
            trace_counter("store.resident", len(self._data))
            self._version += 1
            self._cv.notify_all()

    def put_unique(self, epoch, episode, pairs):
        with self._cv:
            k = (epoch, episode)
            if self._abandoned or k in self._data or k in self._dropped:
                return False
        # single delivery thread per store in the remote design, so the
        # check-then-put window is benign; a racing duplicate would merely
        # overwrite with bitwise-identical pairs
        self.put(epoch, episode, pairs)
        return True

    def accepted_episodes(self, epoch):
        with self._cv:
            return sorted({ep for (e, ep) in self._data if e == epoch}
                          | {ep for (e, ep) in self._dropped if e == epoch})

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
                          producer_info=self._producer_info,
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

    def episodes(self, epoch):
        with self._cv:
            dl = Deadline(self.stall_timeout_s, op="episodes", key=epoch,
                          producer=self._producer,
                          producer_info=self._producer_info,
                          resident=self._resident_keys)
            while epoch not in self._done:
                dl.check(self._version, producer_done=epoch in self._done)
                self._cv.wait(timeout=dl.wait_s())
            return self._counts.get(epoch, 0)

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
            self._counts.pop(epoch, None)
            self._version += 1
            self._cv.notify_all()

    def abandon(self) -> None:
        with self._cv:
            self._abandoned = True
            self._data.clear()
            self._version += 1
            self._cv.notify_all()


class DiskSampleStore(SampleStore):
    """Episode-partitioned .npy files, loaded with mmap (paper's SSD mode).

    ``get(block=True)`` polls for the episode file until it appears, the
    epoch's ``.done`` marker rules it out, or the watchdog trips (producer
    dead / ``stall_timeout_s`` without progress → ``StoreStalled``). Files
    are published atomically: payload written to a tmp name, CRC32+length
    sidecar (``<file>.crc``) published first, then ``os.replace`` — so any
    visible payload has a visible checksum, and a torn/corrupt payload is
    detected at read time (``CorruptEpisodeError``, retriable via re-walk +
    :meth:`rewrite`). ``depth``/``drop`` give the same bounded contract as
    the memory store; ``keep=True`` (default) preserves the files on drop —
    they are the offline-mode artifact — while ``keep=False`` deletes them,
    bounding disk use for transient runs. ``fresh=True`` clears stale
    episode files, checksums and ``.done`` markers from a previous run at
    construction — REQUIRED when a walker reuses a directory, or consumers
    race the old run's markers / silently read its samples. ``verify=False``
    skips checksum verification in ``get`` (one extra sequential read of a
    page-cached file when on).
    """

    def __init__(self, root: str, *, depth: int | None = None,
                 keep: bool = True, poll_s: float = 0.005,
                 fresh: bool = False, verify: bool = True,
                 stall_timeout_s: float | None = DEFAULT_STALL_TIMEOUT_S):
        self.root = root
        self.depth = depth
        self.keep = keep
        self.poll_s = poll_s
        self.verify = verify
        self.stall_timeout_s = stall_timeout_s
        os.makedirs(root, exist_ok=True)
        if fresh:
            for f in os.listdir(root):
                if (f.startswith("epoch")
                        and f.endswith((".npy", ".done", ".crc"))):
                    os.remove(os.path.join(root, f))
        self._cv = threading.Condition()
        self._resident: set[tuple[int, int]] = set()   # put-but-not-dropped
        self._dropped: set[tuple[int, int]] = set()
        self._produced: dict[int, int] = {}            # puts per epoch
        self._abandoned = False
        self._version = 0
        self.peak_resident = 0

    def _path(self, epoch, episode):
        return os.path.join(self.root, f"epoch{epoch:04d}_ep{episode:04d}.npy")

    def _done_path(self, epoch):
        return os.path.join(self.root, f"epoch{epoch:04d}.done")

    def _resident_keys(self):
        with self._cv:
            return list(self._resident)

    # ------------------------------------------------------------ publishing
    def _publish(self, epoch, episode, pairs, *, corrupt: bool = False):
        """Atomic checksummed write: payload to tmp, sidecar first, then
        rename. ``corrupt`` (fault injection) truncates the payload AFTER
        its checksum is recorded — a torn write the reader must catch."""
        path = self._path(epoch, episode)
        tmp = path + ".tmp.npy"
        np.save(tmp, pairs)
        with open(tmp, "rb") as f:
            blob = f.read()
        crc_tmp = path + ".crc.tmp"
        with open(crc_tmp, "w") as f:
            f.write(f"{zlib.crc32(blob):08x} {len(blob)}")
        os.replace(crc_tmp, path + ".crc")
        # crash window between the two renames: a process dying RIGHT HERE
        # leaves the new sidecar visible with no (or a stale) payload — the
        # safe orientation, since a stale payload then fails its checksum
        # (CorruptEpisodeError, retriable) instead of silently passing. The
        # regression test crashes here and proves the invariant holds for
        # both put and rewrite.
        fault_point("disk.write", (epoch, episode, "publish"))
        if corrupt:
            with open(tmp, "wb") as f:
                f.write(blob[:max(0, len(blob) - 16)])
        os.replace(tmp, path)

    def put(self, epoch, episode, pairs):
        fault_point("store.put", (epoch, episode))
        t0 = time.perf_counter()
        with self._cv:
            if self.depth is not None:
                dl = Deadline(self.stall_timeout_s, op="put",
                              key=(epoch, episode),
                              resident=lambda: list(self._resident))
                while (len(self._resident) >= self.depth
                       and not self._abandoned):
                    dl.check(self._version)
                    self._cv.wait(timeout=dl.wait_s())
            if self._abandoned:
                return
            observe("store.put_wait_s", time.perf_counter() - t0)
            counter_add("store.puts")
            self._resident.add((epoch, episode))
            self._produced[epoch] = self._produced.get(epoch, 0) + 1
            self.peak_resident = max(self.peak_resident, len(self._resident))
            gauge_set("store.resident", len(self._resident))
            trace_counter("store.resident", len(self._resident))
            self._version += 1
        corrupt = fault_point("disk.write", (epoch, episode))
        self._publish(epoch, episode, pairs, corrupt=corrupt)
        with self._cv:
            self._cv.notify_all()

    def put_unique(self, epoch, episode, pairs):
        with self._cv:
            if self._abandoned or (epoch, episode) in self._dropped:
                return False
        if os.path.exists(self._path(epoch, episode)):
            return False
        self.put(epoch, episode, pairs)
        return True

    def rewrite(self, epoch, episode, pairs) -> None:
        """Re-publish one episode's payload (checksummed, atomic) without
        touching the resident/backpressure bookkeeping — the repair path
        after a ``CorruptEpisodeError`` re-walk."""
        self._publish(epoch, episode, pairs)

    def accepted_episodes(self, epoch):
        # published files survive a coordinator restart (the disk store's
        # whole point); in-process drops with keep=False deleted theirs, so
        # union the dropped set back in — after a real process death that
        # set is empty and the deleted prefix is simply re-produced
        pre = f"epoch{epoch:04d}_ep"
        eps = {int(f[len(pre):len(pre) + 4]) for f in os.listdir(self.root)
               if f.startswith(pre) and f.endswith(".npy")
               and not f.endswith(".tmp.npy")}
        with self._cv:
            eps |= {ep for (e, ep) in self._dropped if e == epoch}
        return sorted(eps)

    def finish_epoch(self, epoch):
        with open(self._done_path(epoch), "w") as f:
            f.write("done")
        with self._cv:
            self._version += 1

    # -------------------------------------------------------------- reading
    def _load_verified(self, epoch, episode):
        path = self._path(epoch, episode)
        if self.verify:
            crc_path = path + ".crc"
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError as e:
                raise CorruptEpisodeError((epoch, episode), path,
                                          f"unreadable: {e}") from e
            if os.path.exists(crc_path):
                with open(crc_path) as f:
                    want_crc, want_len = f.read().split()
                if len(blob) != int(want_len):
                    raise CorruptEpisodeError(
                        (epoch, episode), path,
                        f"short file: {len(blob)} != {want_len} bytes")
                if f"{zlib.crc32(blob):08x}" != want_crc:
                    raise CorruptEpisodeError(
                        (epoch, episode), path,
                        f"checksum mismatch (want {want_crc})")
        try:
            return np.load(path, mmap_mode="r")
        except (ValueError, EOFError, OSError) as e:
            # unverifiable legacy file (no sidecar) that np.load rejects
            raise CorruptEpisodeError((epoch, episode), path,
                                      f"npy parse failed: {e}") from e

    def get(self, epoch, episode, *, block=True):
        path = self._path(epoch, episode)
        t0 = time.perf_counter()
        dl = Deadline(self.stall_timeout_s, op="get", key=(epoch, episode),
                      producer=self._producer,
                      producer_info=self._producer_info,
                      resident=self._resident_keys)
        next_check = time.monotonic()
        while not os.path.exists(path):
            if (epoch, episode) in self._dropped:
                raise KeyError((epoch, episode))
            done = os.path.exists(self._done_path(epoch))
            if not block or done:
                # the walker publishes the file BEFORE .done: re-check once so
                # a racing finish_epoch can't hide a file that just landed
                if os.path.exists(path):
                    break
                raise KeyError((epoch, episode))
            now = time.monotonic()
            if now >= next_check:
                dl.check(self._disk_version(epoch), producer_done=done)
                next_check = now + dl.wait_s()
            time.sleep(self.poll_s)
        observe("store.get_blocked_s", time.perf_counter() - t0)
        counter_add("store.gets")
        return self._load_verified(epoch, episode)

    def _disk_version(self, epoch):
        """Progress signal for cross-process waits: local bookkeeping plus
        the published-file count (an external producer writing files is
        progress even though our in-process counters never move)."""
        pre = f"epoch{epoch:04d}_ep"
        n = sum(1 for f in os.listdir(self.root)
                if f.startswith(pre) and f.endswith(".npy")
                and not f.endswith(".tmp.npy"))
        return (self._version, n)

    def episodes(self, epoch):
        # like the memory store: wait for the walker to declare the epoch
        # complete, then report how many episodes were produced
        dl = Deadline(self.stall_timeout_s, op="episodes", key=epoch,
                      producer=self._producer,
                      producer_info=self._producer_info,
                      resident=self._resident_keys)
        next_check = time.monotonic()
        while not os.path.exists(self._done_path(epoch)):
            now = time.monotonic()
            if now >= next_check:
                dl.check(self._disk_version(epoch))
                next_check = now + dl.wait_s()
            time.sleep(self.poll_s)
        with self._cv:
            if epoch in self._produced:      # we are the producing process
                return self._produced[epoch]
            # offline consumer: count files, adding back only episodes WE
            # dropped whose file is actually gone (keep=False)
            pre = f"epoch{epoch:04d}_ep"
            n = len([f for f in os.listdir(self.root)
                     if f.startswith(pre) and f.endswith(".npy")
                     and not f.endswith(".tmp.npy")])
            return n + len([k for k in self._dropped if k[0] == epoch
                            and not os.path.exists(self._path(*k))])

    def drop(self, epoch, episode):
        path = self._path(epoch, episode)
        with self._cv:
            if (epoch, episode) in self._dropped or not os.path.exists(path):
                return
            self._dropped.add((epoch, episode))
            if not self.keep:
                os.remove(path)
                if os.path.exists(path + ".crc"):
                    os.remove(path + ".crc")
            self._resident.discard((epoch, episode))
            gauge_set("store.resident", len(self._resident))
            trace_counter("store.resident", len(self._resident))
            self._version += 1
            self._cv.notify_all()

    def drop_epoch(self, epoch: int) -> None:
        pre = f"epoch{epoch:04d}_ep"
        with self._cv:
            if not self.keep:
                for f in os.listdir(self.root):
                    if f.startswith(pre) and f.endswith((".npy", ".crc")):
                        os.remove(os.path.join(self.root, f))
            self._dropped = {k for k in self._dropped if k[0] != epoch}
            self._resident = {k for k in self._resident if k[0] != epoch}
            self._produced.pop(epoch, None)
            self._version += 1
            self._cv.notify_all()

    def abandon(self) -> None:
        with self._cv:
            self._abandoned = True
            self._resident.clear()
            self._version += 1
            self._cv.notify_all()
