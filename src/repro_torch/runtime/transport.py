"""Fault-tolerant episode transport: framing, idempotent chunk assembly,
and per-host health leases.

A copy of the JAX package's ``runtime/transport.py`` (the standard library
and numpy only). The wire format is the same byte for byte — header,
crc32, JSON encoding — so a producer of either package feeds a server of
the other.

The paper's deployment decouples CPU walk machines from GPU trainers across
a cluster; this module is the wire layer that crossing that process/host
boundary needs. Three pieces, each independently testable:

* :class:`FramedSocket` — length-prefixed, CRC32-checksummed message frames
  over a stream socket, with the ``net.*`` fault sites injected in the send
  path (``net.delay`` sleeps, ``net.drop`` swallows the frame,
  ``net.duplicate`` sends it twice, ``net.reorder`` holds it back one
  frame, ``net.disconnect`` closes the socket mid-conversation). Every
  failure is deterministic and replayable — a spec fires on the site's
  invocation ordinal or on the frame's message key, never on wall-clock.
* :class:`ChunkAssembler` — exactly-once assembly of episode chunks keyed
  by the idempotence key ``(seed, epoch, episode, chunk)``. Reconnect-and-
  resend after a drop is safe by construction: a chunk that already landed
  is acknowledged and discarded (``dup``), an episode that already
  assembled never assembles twice, and assembly concatenates in CHUNK
  order regardless of arrival order, so the assembled bytes are bitwise
  identical to in-process production.
* :class:`HostHealth` — heartbeat/lease registry replacing the in-process
  ``WalkEngine.alive`` probe as the store watchdog's producer-liveness
  source. ``any_alive`` is the probe; ``describe`` names each host and its
  lease staleness, so a ``StoreStalled`` diagnostic says WHICH machine
  died. ``expired()`` is what the coordinator polls to reassign a dead
  host's unfinished episodes to survivors.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
import zlib

import numpy as np

from repro_torch.obs import counter_add
from repro_torch.runtime.errors import TransportError
from repro_torch.runtime.faults import fault_point

#: frame magic + protocol version; a peer speaking anything else fails the
#: very first recv instead of mis-parsing garbage lengths
MAGIC = b"EWT1"

#: frame header: magic, crc32(header_json + body), header_json length,
#: body length
_FRAME = struct.Struct("!4sIIQ")

#: refuse absurd frames instead of attempting a multi-GB recv on a torn
#: length field that happened to pass the magic check
MAX_BODY_BYTES = 1 << 31


def _dumps(msg: dict) -> bytes:
    # repr/eval-free minimal JSON: stdlib json keeps the dependency surface
    # at zero and the headers are tiny (the payload rides in the body)
    import json
    return json.dumps(msg, separators=(",", ":")).encode()


def _loads(blob: bytes) -> dict:
    import json
    return json.loads(blob.decode())


def pack_frame(msg: dict, body: bytes = b"") -> bytes:
    hdr = _dumps(msg)
    crc = zlib.crc32(body, zlib.crc32(hdr))
    return _FRAME.pack(MAGIC, crc, len(hdr), len(body)) + hdr + body


class FramedSocket:
    """One message-framed connection end.

    ``send(msg, body, key=..., inject=True)`` runs the ``net.*`` fault
    sites with the given invocation key before/while writing — injection is
    opt-in PER SEND so that only the deterministic chunk stream consumes
    fault ordinals (control traffic like heartbeats and acks is timing-
    dependent and would make ``at=N`` specs non-replayable). ``recv()``
    verifies length and checksum and raises :class:`TransportError` on a
    torn or corrupt frame, ``ConnectionError`` on EOF. Counters
    (`frames_sent`, `bytes_sent`, `frames_dropped`, `frames_duplicated`,
    ...) feed the server's ``transport_stats``.
    """

    def __init__(self, sock):
        self.sock = sock
        self._held: bytes | None = None      # net.reorder holds one frame
        self._send_mu = threading.Lock()
        self.frames_sent = 0
        self.bytes_sent = 0
        self.frames_dropped = 0
        self.frames_duplicated = 0
        self.frames_recv = 0
        self.bytes_recv = 0

    # --------------------------------------------------------------- send
    def send(self, msg: dict, body: bytes = b"", *, key=None,
             inject: bool = False) -> None:
        frame = pack_frame(msg, body)
        if inject:
            fault_point("net.delay", key)          # delay kind sleeps
            if fault_point("net.disconnect", key):
                self.close()
                raise TransportError(f"injected disconnect (key={key!r})")
            if fault_point("net.drop", key):
                self.frames_dropped += 1
                counter_add("transport.frames_dropped")
                return                             # the wire ate it
            dup = fault_point("net.duplicate", key)
            reorder = fault_point("net.reorder", key)
        else:
            dup = reorder = False
        with self._send_mu:
            if reorder and self._held is None:
                self._held = frame                 # goes out AFTER the next
                return
            self._sendall(frame)
            if dup:
                self.frames_duplicated += 1
                counter_add("transport.frames_duplicated")
                self._sendall(frame)
            if self._held is not None:
                held, self._held = self._held, None
                self._sendall(held)

    def _sendall(self, frame: bytes) -> None:
        try:
            self.sock.sendall(frame)
        except OSError as e:
            raise TransportError(f"send failed: {e}") from e
        self.frames_sent += 1
        self.bytes_sent += len(frame)
        # process-wide mirrors: per-connection ints above stay the canonical
        # per-socket view (aggregated by RemoteEpisodeServer.transport_stats);
        # the registry counters are the cross-connection totals
        counter_add("transport.frames_sent")
        counter_add("transport.bytes_sent", len(frame))

    # --------------------------------------------------------------- recv
    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            try:
                got = self.sock.recv(min(1 << 20, n - len(buf)))
            except OSError as e:
                raise TransportError(f"recv failed: {e}") from e
            if not got:
                raise ConnectionError(
                    f"peer closed mid-frame ({len(buf)}/{n} bytes)")
            buf += got
        return bytes(buf)

    def recv(self) -> tuple[dict, bytes]:
        head = self._read_exact(_FRAME.size)
        magic, crc, hdr_len, body_len = _FRAME.unpack(head)
        if magic != MAGIC:
            raise TransportError(f"bad frame magic {magic!r}")
        if body_len > MAX_BODY_BYTES:
            raise TransportError(f"absurd body length {body_len}")
        hdr = self._read_exact(hdr_len)
        body = self._read_exact(body_len)
        if zlib.crc32(body, zlib.crc32(hdr)) != crc:
            raise TransportError("frame checksum mismatch")
        self.frames_recv += 1
        self.bytes_recv += _FRAME.size + hdr_len + body_len
        counter_add("transport.frames_recv")
        counter_add("transport.bytes_recv", _FRAME.size + hdr_len + body_len)
        return _loads(hdr), body

    def close(self) -> None:
        # shutdown first: close() alone does not reliably wake another
        # thread blocked in recv() on the same socket
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def stats(self) -> dict:
        return {"frames_sent": self.frames_sent,
                "bytes_sent": self.bytes_sent,
                "frames_dropped": self.frames_dropped,
                "frames_duplicated": self.frames_duplicated,
                "frames_recv": self.frames_recv,
                "bytes_recv": self.bytes_recv}


# --------------------------------------------------------------------------
# chunk payload encoding: dtype/shape in the header, raw bytes in the body
# --------------------------------------------------------------------------
def encode_pairs(pairs: np.ndarray) -> tuple[dict, bytes]:
    a = np.ascontiguousarray(pairs)
    return {"dtype": a.dtype.str, "shape": list(a.shape)}, a.tobytes()


def decode_pairs(meta: dict, body: bytes) -> np.ndarray:
    a = np.frombuffer(body, dtype=np.dtype(meta["dtype"]))
    return a.reshape(meta["shape"])


class ChunkAssembler:
    """Exactly-once chunk→episode assembly.

    Every chunk carries the idempotence key ``(seed, epoch, episode,
    chunk)`` plus the episode's total chunk count. :meth:`add` returns
    ``(dup, assembled)``: ``dup`` is True when this exact chunk (or its
    whole episode) already landed — the caller acks and discards — and
    ``assembled`` is the episode's full pair array exactly once, on the
    call that completed it. Arrival order is irrelevant: assembly
    concatenates in chunk order, so duplicated/reordered/resent deliveries
    produce bitwise-identical episodes (property-tested under random
    interleavings).
    """

    def __init__(self):
        self._mu = threading.Lock()
        #: (seed, epoch, episode) -> {chunk: pairs}
        self._parts: dict[tuple, dict[int, np.ndarray]] = {}
        self._nchunks: dict[tuple, int] = {}
        self._complete: set[tuple] = set()
        self.dup_chunks = 0
        self.chunks_applied = 0

    def add(self, seed: int, epoch: int, episode: int, chunk: int,
            nchunks: int, pairs: np.ndarray):
        ek = (seed, epoch, episode)
        if not (0 <= chunk < nchunks):
            raise TransportError(
                f"chunk index {chunk} out of range for {nchunks} chunks "
                f"(episode {ek})")
        with self._mu:
            if ek in self._complete:
                self.dup_chunks += 1
                return True, None
            want = self._nchunks.setdefault(ek, nchunks)
            if want != nchunks:
                raise TransportError(
                    f"episode {ek}: chunk count changed {want} -> {nchunks}")
            parts = self._parts.setdefault(ek, {})
            if chunk in parts:
                self.dup_chunks += 1
                return True, None
            parts[chunk] = pairs
            self.chunks_applied += 1
            if len(parts) < nchunks:
                return False, None
            # complete: assemble in CHUNK order, free the parts
            orderd = [parts[c] for c in range(nchunks)]
            del self._parts[ek]
            self._complete.add(ek)
        assembled = (orderd[0] if len(orderd) == 1
                     else np.concatenate(orderd, axis=0))
        return False, assembled

    def complete(self, seed: int, epoch: int, episode: int) -> bool:
        with self._mu:
            return (seed, epoch, episode) in self._complete

    def forget_epoch(self, seed: int, epoch: int) -> None:
        """Release bookkeeping for a fully-consumed epoch."""
        with self._mu:
            for d in (self._parts, self._nchunks):
                for k in [k for k in d if k[0] == seed and k[1] == epoch]:
                    del d[k]
            self._complete = {k for k in self._complete
                              if not (k[0] == seed and k[1] == epoch)}


class HostHealth:
    """Heartbeat/lease registry for remote producer hosts.

    A host is ``alive`` while its last heartbeat is younger than
    ``lease_s``. :meth:`any_alive` is the store-watchdog probe (True while
    no host has registered yet — unknown is not dead); :meth:`expired`
    returns hosts whose lease has lapsed since the last call site marked
    them (the coordinator's reassignment trigger); :meth:`describe` renders
    the per-host state for ``StoreStalled`` diagnostics.
    """

    def __init__(self, lease_s: float = 5.0):
        self.lease_s = lease_s
        self._mu = threading.Lock()
        self._last: dict[str, float] = {}       # host -> last beat (monotonic)
        self._dead: set[str] = set()            # marked by mark_dead()

    def beat(self, host: str) -> None:
        with self._mu:
            self._last[host] = time.monotonic()
            self._dead.discard(host)            # a beating host is not dead

    def alive(self, host: str) -> bool:
        with self._mu:
            t = self._last.get(host)
            if t is None or host in self._dead:
                return False
            return time.monotonic() - t < self.lease_s

    def hosts(self) -> list[str]:
        with self._mu:
            return sorted(self._last)

    def any_alive(self) -> bool:
        with self._mu:
            if not self._last:
                return True                     # nobody registered yet
            now = time.monotonic()
            return any(h not in self._dead and now - t < self.lease_s
                       for h, t in self._last.items())

    def expired(self) -> list[str]:
        """Hosts whose lease has lapsed and that are not yet marked dead."""
        with self._mu:
            now = time.monotonic()
            return sorted(h for h, t in self._last.items()
                          if h not in self._dead and now - t >= self.lease_s)

    def mark_dead(self, host: str) -> None:
        with self._mu:
            self._dead.add(host)

    def describe(self) -> str:
        with self._mu:
            if not self._last:
                return "no producer hosts registered"
            now = time.monotonic()
            bits = []
            for h in sorted(self._last):
                age = now - self._last[h]
                if h in self._dead or age >= self.lease_s:
                    bits.append(f"{h}: DEAD (last heartbeat {age:.1f}s ago, "
                                f"lease {self.lease_s:.1f}s)")
                else:
                    bits.append(f"{h}: alive ({age:.1f}s ago)")
            return "; ".join(bits)

    def snapshot(self) -> dict:
        with self._mu:
            now = time.monotonic()
            return {h: {"last_beat_age_s": now - t,
                        "alive": h not in self._dead and now - t < self.lease_s}
                    for h, t in self._last.items()}
