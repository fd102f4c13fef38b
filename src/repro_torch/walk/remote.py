"""Remote walk producers: episode chunks over the fault-tolerant transport.

A copy of the JAX package's ``walk/remote.py``: the same protocol on the
same wire format (``runtime/transport.py``), so a producer of either
package feeds a server of the other, bitwise. Like the rest of ``walk``,
``runtime``, ``obs`` and ``graph`` it imports neither torch nor JAX: a
spawned producer never loads CUDA.

The paper runs walk generation on dedicated CPU machines and training on a
GPU cluster; this module crosses that boundary. Three roles:

* :class:`RemoteEpisodeServer` — trainer-side. Listens on a socket, hands
  out episode assignments from a lock-server-free work queue (the
  PyTorch-BigGraph shape: any producer can run any episode because the
  ``(seed, epoch, episode, chunk)`` RNG keying makes episodes
  location-independent), assembles arriving chunks exactly-once through a
  :class:`~repro_torch.runtime.transport.ChunkAssembler`, and delivers completed
  episodes into the bounded :class:`~repro_torch.walk.store.SampleStore` in
  episode order — matching the in-process ``WalkEngine.run_epoch`` put
  order exactly, so the trainer cannot tell the difference (test-gated
  bitwise). A :class:`~repro_torch.runtime.transport.HostHealth` lease registry
  tracks producer heartbeats; an expired host's in-flight episodes are
  reclaimed and reassigned to survivors.
* :class:`RemoteProducer` — walker-side. Connects, asks for work, streams
  each assigned episode's chunks (pipelined, then drains acks), and on ANY
  transport failure — torn frame, injected ``net.disconnect``, ack timeout
  after a ``net.drop`` — reconnects and resends everything unacked.
  Redelivery is exactly-once at the server by the idempotence key, so the
  producer's recovery rule is maximally dumb: when in doubt, resend.
* :class:`RemoteWalkCoordinator` — the launcher's facade. Spawns N
  producers (subprocesses via multiprocessing ``spawn`` — real parallelism,
  sidestepping the GIL-bound in-process walker pool — or threads for
  tests), owns the server, and exposes ``epoch_walker()`` handles that
  mimic the ``WalkEngine`` async surface (``start_async``/``finished``/
  ``alive``/``join``) so ``launch.train`` swaps producers with one factory.

Fault sites: every CHUNK frame send runs the ``net.*`` sites keyed
``(epoch, episode, chunk)`` — control traffic (hello/heartbeat/work/acks)
is deliberately uninstrumented so ordinal-based specs target the
deterministic chunk stream, not timing-dependent polling.
``producer.episode`` fires at the top of each assigned episode, keyed
``(host, epoch, episode)``, so a chaos plan can kill one specific host.

Coordinator failover: the server itself is restartable. Its work-queue
state (pending/assigned episodes, the ordered-put cursor) is small and
fully reconstructible from the :class:`SampleStore` contents plus the
``(seed, epoch, episode, chunk)`` RNG keying — the same replay property
``--resume`` exploits for trainer crash-resume. A server built with
``recover=True`` scans the store at each epoch activation: the longest
contiguous prefix of already-accepted episodes becomes the put cursor
(complete episodes are never re-produced), everything after it is
re-queued for assignment (partial episodes replay bitwise via the RNG
keys; the fresh :class:`ChunkAssembler`'s dedup absorbs any chunks still
in flight from before the takeover — recovery needs no new wire state).
Producers, for their part, treat ANY server loss — connect refused, hello
timeout, dead heartbeat — as an outage to ride out: a jittered capped
exponential-backoff reconnect loop (:class:`~repro_torch.runtime.retry.
RetryPolicy`, seeded per host so the fleet never thunders in lockstep)
resends everything unacked on reattach, and only gives up once the
outage outlives ``server_grace_s``. Killing the coordinator mid-epoch
and restarting it therefore resumes the epoch bitwise-identically to an
uninterrupted run (test- and CI-gated).
"""
from __future__ import annotations

import collections
import heapq
import multiprocessing as mp
import socket
import threading
import time
import zlib

from repro_torch.obs import (counter_add, observe, register_source, span,
                             unregister_source)
from repro_torch.obs import trace as _trace
from repro_torch.runtime import FaultPlan, fault_point, install_plan
from repro_torch.runtime.errors import InjectedFault, TransportError
from repro_torch.runtime.retry import RetryPolicy
from repro_torch.runtime.transport import (ChunkAssembler, FramedSocket,
                                           HostHealth, decode_pairs,
                                           encode_pairs)
from repro_torch.walk.engine import WalkConfig, WalkEngine

#: producer poll interval while the server has no assignable episode
WAIT_POLL_S = 0.05


def _connect_once(address) -> socket.socket:
    """Single connect attempt; retry scheduling lives in the callers'
    :class:`RetryPolicy` loops (jittered, grace-bounded)."""
    s = socket.create_connection(address, timeout=5.0)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


class RemoteEpisodeServer:
    """Work-queue + chunk-assembly server feeding one :class:`SampleStore`.

    Epochs are produced strictly sequentially (``submit_epoch`` queues;
    the next activates when the current fully lands), mirroring the
    launcher's one-producing-epoch-at-a-time overlap. Within an epoch the
    assignment window bounds run-ahead: an episode is handed out only while
    ``episode - next_put < window``, so completed-but-unput episodes held
    for ordered delivery stay O(window), and the store's own ``depth``
    backpressure (applied in the dedicated put thread) paces everything
    upstream of it.
    """

    def __init__(self, store, num_episodes: int, seed: int, *,
                 lease_s: float = 10.0, window: int | None = None,
                 port: int = 0, recover: bool = False,
                 carry_stats: dict | None = None):
        self.store = store
        self.num_episodes = num_episodes
        self.seed = seed
        self.health = HostHealth(lease_s)
        self.assembler = ChunkAssembler()
        depth = getattr(store, "depth", None)
        self.window = window or max(2, (depth or 2) + 1)
        # Failover: a recovering successor re-derives each epoch's put
        # cursor from store.accepted_episodes() at activation instead of
        # starting from 0 — see _activate_locked. carry_stats folds a dead
        # predecessor's transport aggregates into this server's, so
        # diagnostics deltas stay monotonic across a takeover.
        self.recover_mode = recover
        self.recovered_episodes = 0
        self._dup_base = 0
        self._applied_base = 0
        self._t0 = time.monotonic()
        #: wall seconds from construction to the first applied (non-dup)
        #: chunk — the failover stats' recovery-time-to-first-chunk metric
        self.first_chunk_s: float | None = None
        if recover:
            counter_add("failover.takeovers")
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._epoch: int | None = None
        self._epoch_queue: collections.deque[int] = collections.deque()
        self._pending: collections.deque[int] = collections.deque()
        self._assigned: dict[int, str] = {}
        self._ready: list = []                 # heap of (episode, pairs)
        self._next_put = 0
        self._finished_epochs: set[int] = set()
        self._error: BaseException | None = None
        self._shutdown = False
        self._stop_evt = threading.Event()
        self._conns: list[FramedSocket] = []
        self._closed_stats = {"frames_recv": 0, "bytes_recv": 0,
                              "frames_sent": 0, "bytes_sent": 0}
        if carry_stats:
            for k in self._closed_stats:
                self._closed_stats[k] += carry_stats.get(k, 0)
            self._dup_base = carry_stats.get("dup_chunks", 0)
            self._applied_base = carry_stats.get("chunks_applied", 0)
        # first-chunk arrival time per (host, epoch, episode), for the
        # per-host receive-lane trace spans; one writer thread per episode
        # (its host's connection), so no lock needed
        self._recv_t0: dict[tuple, float] = {}
        self._threads: list[threading.Thread] = []
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", port))
        self._lsock.listen(64)
        # timeout-polling accept: closing a listener does not reliably wake
        # a thread blocked in accept(), so poll with a short timeout and
        # check the stop event between attempts
        self._lsock.settimeout(0.25)
        self.address = self._lsock.getsockname()

    # ---------------------------------------------------------------- lifecycle
    def start(self) -> None:
        for target, name in ((self._accept_loop, "rws-accept"),
                             (self._put_loop, "rws-put"),
                             (self._reclaim_loop, "rws-reclaim")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop_work(self) -> None:
        """Stop handing out assignments: subsequent ``work`` requests get
        ``done``, so producers drain and exit cleanly while the sockets
        stay open. Call before :meth:`close`."""
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._stop_evt.set()

    def close(self) -> None:
        self.stop_work()
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._mu:
            conns = list(self._conns)
        for c in conns:
            c.close()
        for t in self._threads:
            t.join(timeout=5.0)

    def kill(self) -> None:
        """SIGKILL-equivalent stop for failover tests: drop
        the listener and every connection WITHOUT the ``stop_work`` drain
        handshake, so producers observe a dead server (connection errors),
        never a clean ``done``. The work-queue state dies with this object;
        a successor built with ``recover=True`` on the same port
        reconstructs it from the store."""
        self._stop_evt.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._mu:
            conns = list(self._conns)
        for c in conns:
            c.close()
        # only after the sockets are dead: a live producer must never win a
        # race and see the shutdown "done" reply from a killed server
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        # short join: a put thread blocked on store backpressure only wakes
        # at the next consumer drop; it re-checks _shutdown then and exits
        # (its in-flight put is idempotent at the store), so don't stall
        # the takeover on it
        for t in self._threads:
            t.join(timeout=1.0)

    # ------------------------------------------------------------------ epochs
    def submit_epoch(self, epoch: int) -> None:
        finished: list[int] = []
        with self._cv:
            if self._error is not None:
                raise self._error
            if (epoch == self._epoch or epoch in self._finished_epochs
                    or epoch in self._epoch_queue):
                pass          # idempotent resubmission (coordinator takeover)
            elif self._epoch is None:
                finished = self._activate_locked(epoch)
            else:
                self._epoch_queue.append(epoch)
            self._cv.notify_all()
        for e in finished:     # store calls stay outside the lock
            self.store.finish_epoch(e)

    def _activate_locked(self, epoch: int) -> list[int]:
        """Make ``epoch`` the producing epoch. In recovery mode, scan the
        store first: the longest contiguous prefix of already-accepted
        episodes becomes the put cursor (never re-produced); the rest is
        re-queued and replayed bitwise via the RNG keys. An epoch the store
        already holds in full finishes immediately and the next queued one
        activates — returns those epochs so the caller can run their
        ``store.finish_epoch`` outside the lock."""
        done: list[int] = []
        while True:
            base = 0
            if self.recover_mode:
                accepted = set(self.store.accepted_episodes(epoch))
                while base < self.num_episodes and base in accepted:
                    base += 1
                if base:
                    self.recovered_episodes += base
                    counter_add("failover.recovered_episodes", base)
                    print(f"remote-walk: takeover of epoch {epoch}: store "
                          f"already accepted episodes [0..{base}); "
                          f"re-producing {self.num_episodes - base}")
            self._epoch = epoch
            self._pending = collections.deque(range(base, self.num_episodes))
            self._assigned = {}
            self._ready = []
            self._next_put = base
            if base < self.num_episodes:
                return done
            # the whole epoch landed before the takeover
            self._finished_epochs.add(epoch)
            self._epoch = None
            done.append(epoch)
            if not self._epoch_queue:
                return done
            epoch = self._epoch_queue.popleft()

    def epoch_finished(self, epoch: int) -> bool:
        with self._mu:
            return epoch in self._finished_epochs

    def wait_epoch(self, epoch: int, timeout_s: float | None = None) -> None:
        """Block until ``epoch`` has fully landed in the store; re-raise the
        recorded production error, if any — the facade's ``join``.

        Checks are ordered so a failed server is never mistaken for a slow
        one: the recorded error re-raises the moment it is set (even when
        the timeout happens to be due at the same wake), and a server shut
        down before the epoch landed fails fast instead of waiting out
        ``timeout_s``."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._cv:
            while True:
                if self._error is not None:
                    raise self._error
                if epoch in self._finished_epochs:
                    return
                if self._shutdown:
                    raise TransportError(
                        f"episode server shut down before epoch {epoch} "
                        "was produced")
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"epoch {epoch} not produced in time")
                self._cv.wait(timeout=0.25)

    def _fail(self, err: BaseException) -> None:
        """Record a terminal production error and fail consumers fast —
        the remote mirror of ``WalkEngine.start_async``'s error path."""
        with self._cv:
            if self._error is None:
                self._error = err
            epoch = self._epoch
            self._cv.notify_all()
        if epoch is not None:
            self.store.finish_epoch(epoch)

    # --------------------------------------------------------------- put thread
    def _put_loop(self) -> None:
        try:
            while True:
                with self._cv:
                    while not (self._shutdown
                               or (self._epoch is not None and self._ready
                                   and self._ready[0][0] == self._next_put)):
                        self._cv.wait(timeout=0.25)
                    if self._shutdown:
                        return
                    epoch = self._epoch
                    ep, pairs = heapq.heappop(self._ready)
                # store.put may block on backpressure — outside the lock so
                # chunk handlers / assignment keep running meanwhile
                with span("store_put", "store",
                          {"epoch": epoch, "episode": ep}):
                    self.store.put_unique(epoch, ep, pairs)
                finished: list[int] = []
                with self._cv:
                    self._next_put += 1
                    done = self._next_put >= self.num_episodes
                    if done:
                        self._finished_epochs.add(epoch)
                        self._epoch = None
                        if self._epoch_queue:
                            finished = self._activate_locked(
                                self._epoch_queue.popleft())
                    self._cv.notify_all()
                if done:
                    self.store.finish_epoch(epoch)
                for e in finished:
                    self.store.finish_epoch(e)
        except BaseException as e:  # noqa: BLE001 — any put failure is terminal
            self._fail(e)

    # ----------------------------------------------------------- reclaim thread
    def _reclaim_loop(self) -> None:
        poll = max(0.1, self.health.lease_s / 4)
        while True:
            if self._stop_evt.wait(timeout=poll):
                return
            for host in self.health.expired():
                self.health.mark_dead(host)
                with self._cv:
                    lost = sorted(ep for ep, h in self._assigned.items()
                                  if h == host)
                    for ep in reversed(lost):
                        del self._assigned[ep]
                        self._pending.appendleft(ep)
                    self._cv.notify_all()
                if lost:
                    print(f"remote-walk: host {host!r} lease expired; "
                          f"reassigning episodes {lost} to survivors")
            with self._cv:
                epoch_active = self._epoch is not None
            if epoch_active and self.health.hosts() \
                    and not self.health.any_alive():
                self._fail(TransportError(
                    "all remote producer hosts are dead "
                    f"[{self.health.describe()}]"))
                return

    # ------------------------------------------------------------- connections
    def _accept_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                s, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return                          # listener closed: shutting down
            s.settimeout(None)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = FramedSocket(s)
            with self._mu:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="rws-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: FramedSocket) -> None:
        try:
            while True:
                msg, body = conn.recv()
                reply = self._dispatch(msg, body)
                if reply is None:               # bye
                    break
                conn.send(reply)
        except (TransportError, ConnectionError, OSError):
            pass                                # producer will reconnect
        finally:
            with self._mu:
                if conn in self._conns:
                    self._conns.remove(conn)
                st = conn.stats()
                for k in self._closed_stats:
                    self._closed_stats[k] += st.get(k, 0)
            conn.close()

    def _dispatch(self, msg: dict, body: bytes) -> dict | None:
        t = msg.get("t")
        host = msg.get("host", "?")
        self.health.beat(host)
        if t in ("hello", "hb"):
            if t == "hb":
                counter_add("transport.heartbeats")
            return {"t": "ok", "seed": self.seed}
        if t == "bye":
            return None
        if t == "work":
            return self._assign(host)
        if t == "chunk":
            return self._chunk(msg, body)
        raise TransportError(f"unknown message type {t!r}")

    def _assign(self, host: str) -> dict:
        with self._cv:
            if self._shutdown or self._error is not None:
                return {"t": "done"}
            if (self._epoch is not None and self._pending
                    and self._pending[0] - self._next_put < self.window):
                ep = self._pending.popleft()
                self._assigned[ep] = host
                return {"t": "assign", "epoch": self._epoch, "episode": ep}
            return {"t": "wait", "poll_s": WAIT_POLL_S}

    def _chunk(self, msg: dict, body: bytes) -> dict:
        epoch, ep = msg["epoch"], msg["episode"]
        if msg["seed"] != self.seed:
            raise TransportError(
                f"producer seed {msg['seed']} != server seed {self.seed}")
        dup, assembled = self.assembler.add(
            msg["seed"], epoch, ep, msg["chunk"], msg["nchunks"],
            decode_pairs(msg, body))
        counter_add("transport.chunks_recv")
        if dup:
            counter_add("transport.dup_chunks")
        elif self.first_chunk_s is None:
            # benign write race between connection threads: both candidates
            # are within microseconds, either is a valid recovery-time mark
            self.first_chunk_s = time.monotonic() - self._t0
        complete = assembled is not None
        tr = _trace.tracer()
        if tr is not None:
            host = msg.get("host", "?")
            k = (host, epoch, ep)
            t0 = self._recv_t0.setdefault(k, tr.now_us())
            if complete:
                self._recv_t0.pop(k, None)
                tr.add_span("recv_episode", f"host:{host}", t0, tr.now_us(),
                            {"epoch": epoch, "episode": ep,
                             "nchunks": msg["nchunks"]})
        if complete:
            with self._cv:
                if epoch == self._epoch and ep >= self._next_put:
                    heapq.heappush(self._ready, (ep, assembled))
                    self._assigned.pop(ep, None)
                    self._cv.notify_all()
        return {"t": "ack", "epoch": epoch, "episode": ep,
                "chunk": msg["chunk"], "dup": dup, "complete": complete}

    # ------------------------------------------------------------------- stats
    def transport_stats(self) -> dict:
        with self._mu:
            agg = dict(self._closed_stats)
            for c in self._conns:
                st = c.stats()
                for k in agg:
                    agg[k] += st.get(k, 0)
        agg["dup_chunks"] = self.assembler.dup_chunks + self._dup_base
        agg["chunks_applied"] = (self.assembler.chunks_applied
                                 + self._applied_base)
        applied = max(1, agg["chunks_applied"])
        agg["resend_rate"] = agg["dup_chunks"] / applied
        return agg


class RemoteProducer:
    """One walk-producer host: ask for work, walk it, ship it, survive.

    Runs the store-free :class:`WalkEngine` generation surface
    (``episode_chunk_stream``) so its chunks carry exactly the RNG keys the
    in-process engine would use. All chunks of an assigned episode are
    pipelined onto the wire, then their acks drained; any transport failure
    (including an ack timeout after an injected ``net.drop``) triggers
    reconnect-and-resend of the unacked remainder.

    Server loss — connect refused, hello timeout, dead socket — is an
    outage to ride out, not a death sentence: reconnects follow a jittered
    capped exponential backoff (seeded per host, so a fleet of producers
    desynchronizes instead of thundering against a restarting coordinator)
    and only give up once one outage exceeds ``server_grace_s`` seconds.
    """

    def __init__(self, address, host: str, graph, wcfg: WalkConfig, *,
                 heartbeat_s: float = 1.0, ack_timeout_s: float = 10.0,
                 connect_timeout_s: float = 30.0,
                 server_grace_s: float = 30.0):
        self.address = tuple(address)
        self.host = host
        self.engine = WalkEngine(graph, wcfg)
        self.wcfg = wcfg
        self.heartbeat_s = heartbeat_s
        self.ack_timeout_s = ack_timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.server_grace_s = server_grace_s
        self._conn: FramedSocket | None = None
        self.reconnects = 0
        self.chunks_resent = 0
        self.outage_s = 0.0             # cumulative seconds disconnected
        self._outage_t0: float | None = None
        self._ever_connected = False
        self._retry = RetryPolicy(
            attempts=None, backoff_s=0.05, mult=2.0, max_backoff_s=1.0,
            jitter=0.5, retry_on=(TransportError, ConnectionError, OSError))
        # deterministic per host, decorrelated across hosts
        self._retry_seed = zlib.crc32(host.encode())

    # -------------------------------------------------------------- connection
    def _connection(self) -> FramedSocket:
        """Current work connection, (re)established under the backoff
        policy. A dead server is tolerated for ``server_grace_s`` seconds
        per outage — measured from the moment the connection was lost, not
        from this call — then the last connection error propagates. The
        first-ever connection uses ``connect_timeout_s`` instead (that is a
        startup race against the server's listen(), not an outage)."""
        if self._conn is not None:
            return self._conn
        window = (self.server_grace_s if self._ever_connected
                  else self.connect_timeout_s)
        # _outage_t0 is set by _drop_connection when a live connection is
        # lost; None here means this is the startup connect (not an outage)
        outage = self._outage_t0 is not None
        t0 = self._outage_t0 if outage else time.monotonic()
        delays = self._retry.delays(seed=self._retry_seed + self.reconnects)
        while True:
            s = None
            try:
                s = _connect_once(self.address)
                s.settimeout(self.ack_timeout_s)
                conn = FramedSocket(s)
                conn.send({"t": "hello", "host": self.host})
                conn.recv()             # hello timeout == ack timeout
                self._conn = conn
                self._ever_connected = True
                if outage:
                    dt = time.monotonic() - t0
                    self.outage_s += dt
                    observe("producer.outage_s", dt)
                    self._outage_t0 = None
                return conn
            except (TransportError, ConnectionError, OSError) as e:
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                waited = time.monotonic() - t0
                if waited >= window:
                    raise TransportError(
                        f"host {self.host!r}: server {self.address!r} "
                        f"unreachable for {waited:.1f}s (> grace "
                        f"{window:.1f}s): {e}") from e
                time.sleep(next(delays, self._retry.backoff_s))

    def _drop_connection(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
            self.reconnects += 1
            counter_add("transport.producer_reconnects")
        if self._outage_t0 is None:
            self._outage_t0 = time.monotonic()

    # -------------------------------------------------------------- heartbeats
    def _heartbeat_loop(self, stop: threading.Event) -> None:
        # dedicated connection: a long GIL-heavy walk on the work connection
        # must not starve the lease — heartbeats ride their own socket and
        # are never fault-injected. While the server is unreachable, retry
        # pacing comes from the jittered backoff policy (capped at the
        # heartbeat interval) instead of a bare wait(heartbeat_s), so the
        # fleet's reattach probes spread out across a takeover.
        conn = None
        delays = None
        while not stop.is_set():
            try:
                if conn is None:
                    s = _connect_once(self.address)
                    s.settimeout(self.ack_timeout_s)
                    conn = FramedSocket(s)
                conn.send({"t": "hb", "host": self.host})
                conn.recv()
                delays = None                   # healthy: reset the backoff
                wait = self.heartbeat_s
            except (TransportError, ConnectionError, OSError):
                if conn is not None:
                    conn.close()
                conn = None
                if delays is None:
                    delays = self._retry.delays(
                        seed=self._retry_seed ^ 0x5BEA7)
                wait = min(self.heartbeat_s,
                           next(delays, self.heartbeat_s))
            stop.wait(wait)
        if conn is not None:
            conn.close()

    # -------------------------------------------------------------- work loop
    def run(self) -> None:
        stop = threading.Event()
        hb = threading.Thread(target=self._heartbeat_loop, args=(stop,),
                              name=f"hb-{self.host}", daemon=True)
        hb.start()
        try:
            while True:
                # outside the retry except: a _connection() failure means
                # the outage outlived the grace window — terminal, and the
                # informative grace error must propagate, not be retried
                conn = self._connection()
                try:
                    conn.send({"t": "work", "host": self.host})
                    reply, _ = conn.recv()
                    # a duplicated final chunk can leave one stray ack in
                    # flight after the drain loop already saw the episode
                    # fully acked — skip past it
                    while reply.get("t") == "ack":
                        reply, _ = conn.recv()
                except (TransportError, ConnectionError, OSError):
                    self._drop_connection()
                    continue
                t = reply.get("t")
                if t == "done":
                    break
                if t == "wait":
                    time.sleep(reply.get("poll_s", WAIT_POLL_S))
                    continue
                epoch, episode = reply["epoch"], reply["episode"]
                fault_point("producer.episode", (self.host, epoch, episode))
                self._ship_episode(epoch, episode)
        finally:
            stop.set()
            hb.join(timeout=5.0)
            if self._conn is not None:
                try:
                    self._conn.send({"t": "bye", "host": self.host})
                except (TransportError, ConnectionError, OSError):
                    pass
                self._conn.close()
                self._conn = None

    def _ship_episode(self, epoch: int, episode: int) -> None:
        tr = _trace.tracer()
        t_ship = tr.now_us() if tr is not None else 0.0
        chunks = list(self.engine.episode_chunk_stream(epoch, episode))
        acked: set[int] = set()
        attempts = 0
        while len(acked) < len(chunks):
            attempts += 1
            if attempts > 10:
                raise TransportError(
                    f"episode ({epoch}, {episode}): gave up after "
                    f"{attempts - 1} transport attempts")
            if attempts > 1:
                self.chunks_resent += len(chunks) - len(acked)
                counter_add("transport.chunks_resent",
                            len(chunks) - len(acked))
            # grace-window exhaustion in _connection() is terminal and must
            # escape with its own error, not count as a transport attempt
            conn = self._connection()
            try:
                for c, n, pairs in chunks:
                    if c in acked:
                        continue
                    meta, body = encode_pairs(pairs)
                    conn.send({"t": "chunk", "host": self.host,
                               "seed": self.wcfg.seed, "epoch": epoch,
                               "episode": episode, "chunk": c, "nchunks": n,
                               **meta},
                              body, key=(epoch, episode, c), inject=True)
                # drain until every chunk is acked — set-idempotent, so a
                # duplicated frame's double ack is absorbed rather than
                # desynchronizing the reply stream; a dropped frame's
                # missing ack surfaces as a recv timeout below
                while len(acked) < len(chunks):
                    reply, _ = conn.recv()
                    if reply.get("t") != "ack":
                        raise TransportError(
                            f"expected ack, got {reply.get('t')!r}")
                    acked.add(reply["chunk"])
            except (TransportError, ConnectionError, OSError):
                # includes socket timeouts waiting on the ack of a dropped
                # frame: reconnect and resend whatever is unacked — the
                # server's idempotence keys discard anything that DID land
                self._drop_connection()
        counter_add("walk.episodes_shipped")
        if tr is not None:
            # walk + ship + ack-drain for one assigned episode, on this
            # producer's lane (thread-mode producers share the trainer's
            # tracer; subprocess producers run with obs disabled)
            tr.add_span("ship_episode", "producer:" + self.host, t_ship,
                        tr.now_us(), {"epoch": epoch, "episode": episode,
                                      "chunks": len(chunks),
                                      "attempts": attempts})


def _producer_main(address, host, graph, wcfg, inject_specs, heartbeat_s,
                   server_grace_s=30.0):
    """Subprocess entry (multiprocessing ``spawn``): fresh interpreter, own
    fault-plan counters, no torch or jax import anywhere on this path."""
    if inject_specs:
        install_plan(FaultPlan(inject_specs))
    RemoteProducer(address, host, graph, wcfg, heartbeat_s=heartbeat_s,
                   server_grace_s=server_grace_s).run()


class _EpochHandle:
    """One epoch's walker, shaped like the ``WalkEngine`` async surface."""

    def __init__(self, coord: "RemoteWalkCoordinator"):
        self._coord = coord
        self._epoch: int | None = None

    def start_async(self, epoch: int) -> None:
        self._epoch = epoch
        self._coord.server.submit_epoch(epoch)

    def finished(self) -> bool:
        return (self._epoch is None
                or self._coord.server.epoch_finished(self._epoch)
                or self._coord.server._error is not None)

    def alive(self) -> bool:
        return self._coord.alive()

    def join(self) -> None:
        if self._epoch is not None:
            self._coord.server.wait_epoch(self._epoch)


class RemoteWalkCoordinator:
    """Owns the server plus N producers; hands ``launch.train`` walker
    handles indistinguishable from ``WalkEngine``.

    ``mode="process"`` spawns real subprocess producers (the GIL-free
    path); ``mode="thread"`` runs them as in-process threads — same
    protocol, same sockets, cheap enough for tests.
    """

    def __init__(self, graph, wcfg: WalkConfig, store, *,
                 num_producers: int = 2, heartbeat_s: float = 1.0,
                 lease_s: float = 10.0, mode: str = "process",
                 ack_timeout_s: float = 10.0, inject_specs=(),
                 port: int = 0, recover: bool = False,
                 server_grace_s: float = 30.0):
        self.graph = graph
        self.wcfg = wcfg
        self.store = store
        self.num_producers = max(1, num_producers)
        self.heartbeat_s = heartbeat_s
        self.ack_timeout_s = ack_timeout_s
        self.mode = mode
        self.inject_specs = list(inject_specs)
        self.lease_s = lease_s
        self.server_grace_s = server_grace_s
        self.server = RemoteEpisodeServer(store, wcfg.episodes, wcfg.seed,
                                          lease_s=lease_s, port=port,
                                          recover=recover)
        self.takeovers = 1 if recover else 0
        self._recovered_base = 0
        self._procs: list = []
        self._producers: list[RemoteProducer] = []   # thread mode only

    def start(self) -> None:
        self.server.start()
        # one source of truth for the wire + lease surfaces: the registry
        # snapshot (metrics.jsonl, diagnostics.json) reads the live
        # aggregation instead of anyone keeping a parallel copy
        register_source("transport", self.transport_stats)
        # read through self.server dynamically — a restart_server() swap
        # must not leave the registry or the store watchdog holding bound
        # methods of a dead server's health registry
        register_source("host_health", lambda: self.server.health.snapshot())
        set_producer = getattr(self.store, "set_producer", None)
        if callable(set_producer):
            set_producer(self.alive, lambda: self.server.health.describe())
        for i in range(self.num_producers):
            host = f"walker-{i}"
            if self.mode == "process":
                ctx = mp.get_context("spawn")
                p = ctx.Process(
                    target=_producer_main,
                    args=(self.server.address, host, self.graph, self.wcfg,
                          self.inject_specs, self.heartbeat_s,
                          self.server_grace_s),
                    name=host, daemon=True)
                p.start()
            else:
                prod = RemoteProducer(self.server.address, host, self.graph,
                                      self.wcfg, heartbeat_s=self.heartbeat_s,
                                      ack_timeout_s=self.ack_timeout_s,
                                      server_grace_s=self.server_grace_s)
                self._producers.append(prod)

                def _run(prod=prod):
                    # An injected crash simulates a SIGKILL'd producer
                    # process, and a grace-window TransportError a producer
                    # that gave up on a dead server: either way the thread
                    # must die silently (liveness is detected via the
                    # lease, not the exception) — exactly like the
                    # subprocess path, where the process just exits. Any
                    # other exception still escapes to the caller.
                    try:
                        prod.run()
                    except (InjectedFault, TransportError):
                        pass

                p = threading.Thread(target=_run, name=host, daemon=True)
                p.start()
            self._procs.append(p)

    def epoch_walker(self) -> _EpochHandle:
        return _EpochHandle(self)

    def alive(self) -> bool:
        """Producer-liveness probe for the store watchdog: healthy while
        any host's lease is live (or none has registered yet) and the
        server hasn't recorded a terminal error."""
        return self.server._error is None and self.server.health.any_alive()

    def transport_stats(self) -> dict:
        return self.server.transport_stats()

    # -------------------------------------------------------------- failover
    def restart_server(self) -> float:
        """Simulated coordinator failover inside one process: a
        SIGKILL-equivalent drop of the current episode server, then a
        successor on the SAME port that reconstructs the work queue from
        the store and re-submits the epochs the trainer had handed the
        predecessor. Producers are untouched — they ride out the outage in
        their reconnect backoff and reattach to the successor. Returns the
        takeover wall seconds (kill → successor accepting).

        The full-process-death path is ``--coordinator-resume``: there the
        launcher itself builds a ``recover=True`` coordinator and
        re-submits epochs from the resume cursor instead."""
        old = self.server
        t0 = time.monotonic()
        old.kill()
        # trainer-side knowledge that survives in this process: which
        # epochs were submitted and which already finished. The successor
        # re-derives everything else (put cursor, pending set) from the
        # store at activation.
        with old._cv:
            finished = set(old._finished_epochs)
            epochs = ([old._epoch] if old._epoch is not None else [])
            epochs += list(old._epoch_queue)
        srv = RemoteEpisodeServer(
            self.store, self.wcfg.episodes, self.wcfg.seed,
            lease_s=self.lease_s, port=old.address[1], recover=True,
            carry_stats=old.transport_stats())
        srv._finished_epochs |= finished
        self.server = srv
        self.takeovers += 1
        self._recovered_base += old.recovered_episodes
        srv.start()
        for e in epochs:
            srv.submit_epoch(e)
        return time.monotonic() - t0

    def failover_stats(self) -> dict:
        """Takeover counters for diagnostics.json and the launcher summary.
        ``producer_outage_s`` only aggregates thread-mode producers —
        subprocess producers keep their clocks in their own interpreter."""
        out = {"takeovers": self.takeovers,
               "recovered_episodes": (self._recovered_base
                                      + self.server.recovered_episodes),
               "producer_reconnects": sum(p.reconnects
                                          for p in self._producers),
               "producer_outage_s": round(sum(p.outage_s
                                              for p in self._producers), 3)}
        if self.server.first_chunk_s is not None:
            out["first_chunk_s"] = round(self.server.first_chunk_s, 3)
        return out

    def close(self) -> None:
        # drain first: producers see "done" on their next work request and
        # exit on their own; only then tear the sockets down
        self.server.stop_work()
        for p in self._procs:
            p.join(timeout=10.0)
        self.server.close()
        for p in self._procs:
            if hasattr(p, "terminate") and p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        self._procs = []
        unregister_source("transport")
        unregister_source("host_health")
