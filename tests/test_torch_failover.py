"""Coordinator failover on the port, held to the JAX package's cases:
the restartable episode server, the producers' outage grace, and the
training launcher's remote walkers on the CPU.

The invariant under test: killing the episode server mid-epoch and starting
a recovering successor on the same port is invisible to the trainer — the
run stays BITWISE identical to an uninterrupted one, with zero lost and
zero double-stored chunks; and the launcher's ``--remote-walkers`` runs
(one rank or two, killed and resumed with ``--coordinator-resume``) write
the checkpoint of their in-process runs bit for bit. Every socket listens
on port 0, and every wait on a socket, a lease, an epoch, a thread or a
child process has a timeout.
"""
import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.graph import powerlaw_graph
from repro_torch.launch import train as ttrain
from repro_torch.runtime import InjectedFault, StoreStalled, TransportError
from repro_torch.runtime.retry import RetryPolicy, call_with_retry
from repro_torch.runtime.transport import (ChunkAssembler, FramedSocket,
                                           HostHealth)
from repro_torch.walk import (MemorySampleStore, RemoteWalkCoordinator,
                              WalkConfig, WalkEngine)
from repro_torch.walk import remote as remote_mod
from repro_torch.walk.remote import RemoteEpisodeServer, RemoteProducer
from repro_torch.walk.store import DiskSampleStore

#: seconds any one wait on an epoch, a thread or a store may take
WAIT_S = 60.0
GRAPH = None
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the in-process launcher runs: the suite's
    workers share the machine's cores, and the training loop's many small
    ops on spinning thread pools slow by orders of magnitude when they are
    oversubscribed."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph():
    global GRAPH
    if GRAPH is None:
        GRAPH = powerlaw_graph(300, 4, seed=1)
    return GRAPH


def _wcfg():
    return WalkConfig(walk_length=6, window=3, episodes=4, seed=3,
                      chunk_size=40)


def _same_bits(got, want, msg=""):
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, msg
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=msg)


# ---------------------------------------------------------------------------
# retry: jitter determinism, caps, grace windows
# ---------------------------------------------------------------------------
def test_retry_jitter_deterministic_per_seed_and_bounded():
    p = RetryPolicy(attempts=7, backoff_s=0.1, mult=2.0, max_backoff_s=0.4,
                    jitter=0.5)
    a = list(p.delays(seed=11))
    b = list(p.delays(seed=11))
    c = list(p.delays(seed=12))
    assert a == b                          # replayable per seed
    assert a != c                          # decorrelated across seeds
    for i, d in enumerate(a):              # each delay within ±jitter of base
        base = min(0.1 * 2.0 ** i, 0.4)
        assert 0.5 * base <= d <= 1.5 * base


@pytest.mark.parametrize("cap,want", [(None, [0.1, 0.2, 0.4]),
                                      (0.15, [0.1, 0.15, 0.15])])
def test_retry_zero_jitter_keeps_geometric_stream_with_cap(cap, want):
    p = RetryPolicy(attempts=4, backoff_s=0.1, max_backoff_s=cap)
    assert list(p.delays()) == pytest.approx(want)


def test_retry_max_elapsed_window_reraises_last_error():
    calls = []

    def fn():
        calls.append(time.monotonic())
        raise ValueError("still down")

    p = RetryPolicy(attempts=None, backoff_s=0.01, mult=1.0,
                    max_elapsed_s=0.15, retry_on=(ValueError,))
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="still down"):
        call_with_retry(fn, policy=p)
    assert len(calls) > 3                  # it really retried inside the window
    assert time.monotonic() - t0 < 2.0     # ...and gave up soon after it closed


def test_retry_unbounded_attempts_retries_past_small_counts():
    state = {"n": 0}

    def fn():
        state["n"] += 1
        if state["n"] < 20:
            raise OSError("flaky")
        return "ok"

    p = RetryPolicy(attempts=None, backoff_s=0.0, retry_on=(OSError,))
    assert call_with_retry(fn, policy=p) == "ok"
    assert state["n"] == 20


# ---------------------------------------------------------------------------
# wait_epoch: errors beat timeouts; shutdown fails fast
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("when", ["before", "while_waiting"])
def test_wait_epoch_reraises_recorded_error_promptly(when):
    srv = RemoteEpisodeServer(MemorySampleStore(), 4, seed=3)
    timer = None
    try:
        err = TransportError("producers imploded")
        if when == "before":
            srv._fail(err)
        else:
            timer = threading.Timer(0.2, srv._fail, args=(err,))
            timer.start()
        t0 = time.monotonic()
        with pytest.raises(TransportError, match="imploded"):
            srv.wait_epoch(0, timeout_s=30.0)
        # never waited out the timeout
        assert time.monotonic() - t0 < (1.0 if when == "before" else 5.0)
    finally:
        if timer is not None:
            timer.join(timeout=5.0)
        srv.close()


def test_wait_epoch_fails_fast_after_kill():
    srv = RemoteEpisodeServer(MemorySampleStore(), 4, seed=3)
    srv.start()
    srv.kill()
    t0 = time.monotonic()
    with pytest.raises(TransportError, match="shut down"):
        srv.wait_epoch(0, timeout_s=30.0)
    assert time.monotonic() - t0 < 1.0


# ---------------------------------------------------------------------------
# HostHealth lease edges
# ---------------------------------------------------------------------------
def test_lease_boundary_exact_expiry_is_dead_and_reported():
    h = HostHealth(lease_s=10.0)
    h.beat("w0")
    with h._mu:
        h._last["w0"] = time.monotonic() - h.lease_s   # age == lease exactly
    # the boundary is closed on the dead side: alive uses strict <,
    # expired uses >= — the same instant can never be both
    assert not h.alive("w0") and not h.any_alive()
    assert h.expired() == ["w0"]
    with h._mu:
        h._last["w0"] = time.monotonic() - h.lease_s + 5.0   # well inside
    assert h.alive("w0") and h.expired() == []


def test_lease_resurrection_after_expiry_and_mark_dead():
    h = HostHealth(lease_s=10.0)
    h.beat("w0")
    with h._mu:
        h._last["w0"] = time.monotonic() - 60.0
    assert h.expired() == ["w0"]
    h.mark_dead("w0")
    assert h.expired() == []               # marked: not re-reported
    assert not h.alive("w0")
    h.beat("w0")                           # the host reconnected and beats
    assert h.alive("w0") and h.any_alive()
    assert h.expired() == []
    assert h.snapshot()["w0"]["alive"]
    # a second expiry cycle on the resurrected host behaves identically
    with h._mu:
        h._last["w0"] = time.monotonic() - 60.0
    assert h.expired() == ["w0"]


def test_lease_concurrent_beats_vs_expiry_sweep():
    """Reclaim-loop shape under load: beat threads hammer while a sweeper
    runs expired()/mark_dead/any_alive — no dict-mutation crashes, no host
    both beating and staying dead."""
    h = HostHealth(lease_s=0.02)
    stop = threading.Event()
    errors = []

    def beater(host):
        try:
            while not stop.is_set():
                h.beat(host)
        except Exception as e:             # noqa: BLE001 — the assertion
            errors.append(e)

    threads = [threading.Thread(target=beater, args=(f"w{i}",), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    t_end = time.monotonic() + 0.5
    while time.monotonic() < t_end:
        for host in h.expired():
            h.mark_dead(host)
        h.any_alive()
        h.describe()
        h.snapshot()
    stop.set()
    for t in threads:
        t.join(timeout=5.0)
    assert not errors and not any(t.is_alive() for t in threads)
    h.beat("w0")                           # beats always win over mark_dead
    assert h.alive("w0")
    time.sleep(0.05)
    assert h.expired() != []               # and leases still lapse afterwards


# ---------------------------------------------------------------------------
# store scan: the recovery source
# ---------------------------------------------------------------------------
def test_accepted_episodes_memory_store_counts_resident_and_dropped():
    store = MemorySampleStore()
    pairs = np.arange(8, dtype=np.int32).reshape(4, 2)
    assert store.accepted_episodes(0) == []
    store.put(0, 0, pairs)
    store.put(0, 1, pairs)
    store.get(0, 0)
    store.drop(0, 0)                       # consumed: still accepted
    store.put(1, 0, pairs)
    assert store.accepted_episodes(0) == [0, 1]
    assert store.accepted_episodes(1) == [0]
    assert store.accepted_episodes(2) == []


def test_accepted_episodes_disk_store_survives_new_instance(tmp_path):
    pairs = np.arange(8, dtype=np.int32).reshape(4, 2)
    store = DiskSampleStore(str(tmp_path), keep=True)
    store.put(0, 0, pairs)
    store.put(0, 2, pairs)                 # a gap: episode 1 never landed
    # a FRESH instance — the post-coordinator-death view — sees the files
    reborn = DiskSampleStore(str(tmp_path), keep=True, fresh=False)
    assert reborn.accepted_episodes(0) == [0, 2]
    assert reborn.accepted_episodes(1) == []
    # keep=False drops delete their file but stay accepted in-process
    vol = DiskSampleStore(str(tmp_path / "vol"), keep=False)
    vol.put(0, 0, pairs)
    vol.get(0, 0)
    vol.drop(0, 0)
    assert vol.accepted_episodes(0) == [0]


# ---------------------------------------------------------------------------
# kill the server mid-epoch or between epochs, recover, stay bitwise
# ---------------------------------------------------------------------------
def test_coordinator_restart_mid_epoch_bitwise_and_exactly_once():
    g, wcfg = _graph(), _wcfg()
    ref = WalkEngine(g, wcfg)
    # depth=1 forces puts to trail consumption, so the kill below is
    # guaranteed to land mid-epoch (the last episode cannot have been put)
    store = MemorySampleStore(depth=1, stall_timeout_s=WAIT_S)
    coord = RemoteWalkCoordinator(g, wcfg, store, num_producers=2,
                                  heartbeat_s=0.1, lease_s=5.0,
                                  mode="thread", ack_timeout_s=1.0,
                                  server_grace_s=20.0)
    coord.start()
    try:
        h = coord.epoch_walker()
        h.start_async(0)
        for ep in range(2):
            _same_bits(store.get(0, ep), ref.episode_pairs(0, ep))
            store.drop(0, ep)

        takeover_s = coord.restart_server()
        assert takeover_s < 10.0

        for ep in range(2, wcfg.episodes):
            _same_bits(store.get(0, ep), ref.episode_pairs(0, ep),
                       f"episode {ep} diverged across the takeover")
            store.drop(0, ep)
        coord.server.wait_epoch(0, timeout_s=WAIT_S)   # the successor
        assert h.finished()

        fo = coord.failover_stats()
        assert fo["takeovers"] == 1
        # the consumed episodes (and possibly one the put thread raced in)
        # were recovered from the store, never re-produced
        k = fo["recovered_episodes"]
        assert 2 <= k < wcfg.episodes
        assert fo["producer_reconnects"] >= 1
        # exactly-once across the takeover: the successor applied precisely
        # the unique chunks of the episodes it re-produced
        unique = sum(len(list(ref.episode_chunk_stream(0, ep)))
                     for ep in range(k, wcfg.episodes))
        assert coord.server.assembler.chunks_applied == unique
        # carried aggregates stay monotonic
        total = sum(len(list(ref.episode_chunk_stream(0, ep)))
                    for ep in range(wcfg.episodes))
        assert coord.transport_stats()["chunks_applied"] >= total
    finally:
        coord.close()


def test_coordinator_restart_between_epochs_recovers_full_epoch(monkeypatch):
    """A takeover after an epoch fully landed must finish it from what the
    trainer already knows (no re-production) and produce the NEXT epoch
    normally, each of its chunks applied exactly once.

    The one producer may still be draining the acks of epoch 0's last
    episode when the predecessor dies ("when in doubt, resend"): the
    successor's fresh assembler then applies those resent chunks too. So
    the test records, on the successor alone, the chunk keys it applied,
    the episodes it leased and the episodes it stored, and holds each to
    its exact set."""
    g, wcfg = _graph(), _wcfg()
    ref = WalkEngine(g, wcfg)
    store = MemorySampleStore(depth=wcfg.episodes, stall_timeout_s=WAIT_S)
    coord = RemoteWalkCoordinator(g, wcfg, store, num_producers=1,
                                  heartbeat_s=0.1, lease_s=5.0,
                                  mode="thread", ack_timeout_s=1.0,
                                  server_grace_s=20.0)
    coord.start()
    try:
        h0 = coord.epoch_walker()
        h0.start_async(0)
        coord.server.wait_epoch(0, timeout_s=WAIT_S)   # epoch 0 resident
        applied, leased, stored = [], [], []           # by the successor

        class RecordingAssembler(ChunkAssembler):
            def add(self, seed, epoch, ep, chunk, nchunks, pairs):
                dup, assembled = super().add(seed, epoch, ep, chunk,
                                             nchunks, pairs)
                if not dup:
                    applied.append((epoch, ep, chunk))
                return dup, assembled

        assign = RemoteEpisodeServer._assign

        def recording_assign(self, host):
            reply = assign(self, host)
            if reply["t"] == "assign" and self is coord.server:
                leased.append((reply["epoch"], reply["episode"]))
            return reply

        put = store.put_unique

        def recording_put(epoch, ep, pairs):
            stored.append((epoch, ep))
            return put(epoch, ep, pairs)

        # the predecessor keeps its own assembler; only the successor,
        # built inside restart_server, gets the recording one
        monkeypatch.setattr(remote_mod, "ChunkAssembler", RecordingAssembler)
        monkeypatch.setattr(RemoteEpisodeServer, "_assign", recording_assign)
        monkeypatch.setattr(store, "put_unique", recording_put)
        coord.restart_server()
        # resubmitting the finished epoch is idempotent; epoch 1 activates
        # with an empty scan and produces normally
        coord.server.submit_epoch(0)
        h1 = coord.epoch_walker()
        h1.start_async(1)
        for epoch in (0, 1):
            for ep in range(wcfg.episodes):
                _same_bits(store.get(epoch, ep), ref.episode_pairs(epoch, ep))
                store.drop(epoch, ep)
        coord.server.wait_epoch(1, timeout_s=WAIT_S)
        fo = coord.failover_stats()
        assert fo["takeovers"] == 1
        episodes = range(wcfg.episodes)
        # the successor re-produced nothing of epoch 0: it leased and
        # stored epoch 1's episodes only, each stored once, in order
        assert set(leased) == {(1, ep) for ep in episodes}
        assert stored == [(1, ep) for ep in episodes]
        # epoch 1 was produced whole: every chunk applied exactly once
        unique = sorted((1, ep, c) for ep in episodes
                        for c, _, _ in ref.episode_chunk_stream(1, ep))
        assert sorted(k for k in applied if k[0] == 1) == unique
        # anything of epoch 0 it applied is a resend of the last episode,
        # the only one whose acks can have been in flight at the kill
        last = wcfg.episodes - 1
        last_chunks = {(0, last, c)
                       for c, _, _ in ref.episode_chunk_stream(0, last)}
        assert {k for k in applied if k[0] == 0} <= last_chunks
        assert len(applied) == coord.server.assembler.chunks_applied
    finally:
        coord.close()


# ---------------------------------------------------------------------------
# producer grace window
# ---------------------------------------------------------------------------
def _dead_address():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = s.getsockname()
    s.close()                              # nobody listens here any more
    return addr


def test_producer_outage_grace_window_expires_with_informative_error():
    prod = RemoteProducer(_dead_address(), "w0", _graph(), _wcfg(),
                          ack_timeout_s=0.3, connect_timeout_s=0.6,
                          server_grace_s=0.6)
    t0 = time.monotonic()
    with pytest.raises(TransportError, match="unreachable.*grace"):
        prod._connection()
    waited = time.monotonic() - t0
    assert 0.5 <= waited < 10.0            # gave up only once the window shut


def test_producer_rides_out_outage_shorter_than_grace():
    """Kill the server with no clean handshake; the producer's backoff loop
    must reattach to a successor on the same port inside the grace window
    and report the outage it rode out."""
    g, wcfg = _graph(), _wcfg()
    store = MemorySampleStore(depth=4)
    srv = RemoteEpisodeServer(store, wcfg.episodes, wcfg.seed, lease_s=10.0)
    srv.start()
    prod = RemoteProducer(srv.address, "w0", g, wcfg, ack_timeout_s=1.0,
                          server_grace_s=15.0)
    prod._connection()                     # attached to the first server
    port = srv.address[1]
    srv.kill()
    prod._drop_connection()
    succ = RemoteEpisodeServer(store, wcfg.episodes, wcfg.seed,
                               lease_s=10.0, port=port, recover=True)
    succ.start()
    try:
        conn = prod._connection()          # reattaches inside the grace
        assert isinstance(conn, FramedSocket)
        assert prod.reconnects == 1
        assert prod.outage_s > 0.0
    finally:
        succ.close()
        prod._drop_connection()


def test_producer_hello_timeout_counts_against_grace():
    """A server that accepts but never answers hello (half-dead coordinator)
    must burn the grace window, not hang forever."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    held = []
    stop = threading.Event()

    def hold():
        lsock.settimeout(0.1)
        while not stop.is_set():
            try:
                s, _ = lsock.accept()      # accept, say nothing
                held.append(s)
            except socket.timeout:
                continue
            except OSError:
                return

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    prod = RemoteProducer(lsock.getsockname(), "w0", _graph(), _wcfg(),
                          ack_timeout_s=0.2, connect_timeout_s=0.7,
                          server_grace_s=0.7)
    try:
        with pytest.raises(TransportError, match="grace"):
            prod._connection()
    finally:
        stop.set()
        t.join(timeout=5.0)
        for s in held:
            s.close()
        lsock.close()


# ---------------------------------------------------------------------------
# the launcher on the CPU
# ---------------------------------------------------------------------------
# tests/test_failover.py's schedule (2 epochs x 3 episodes, 240 nodes)
TRAIN = ["--nodes", "240", "--dim", "16", "--epochs", "2", "--episodes", "3",
         "--subparts", "2", "--minibatch", "32", "--negatives", "4",
         "--neg-pool", "256", "--walk-workers", "2", "--seed", "3"]
REMOTE = ["--remote-walkers", "1", "--heartbeat-s", "0.2", "--lease-s", "5",
          "--server-grace-s", "20"]


def _port(out, *extra):
    return ttrain.main([*TRAIN, "--out-dir", str(out), "--device", "cpu",
                        *extra])


def _tables(out):
    with np.load(os.path.join(str(out), "embeddings_2.npz")) as z:
        return {k: np.frombuffer(z[k].tobytes(), np.uint8)
                for k in ("vertex", "context")}


def _same_tables(a, b, what):
    for k in ("vertex", "context"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k}: {what}")


def _no_producer_left():
    """No spawned producer outlives a launcher run."""
    deadline = time.monotonic() + 10.0
    while mp.active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not mp.active_children(), mp.active_children()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted in-process run every launcher case is held to."""
    out = tmp_path_factory.mktemp("ref")
    _port(out)
    return _tables(out)


def test_remote_walkers_train_the_in_process_bits(reference, tmp_path,
                                                  capsys):
    """--remote-walkers 1 (a spawned producer): the checkpoint is the
    in-process run's bit for bit; the launcher prints the JAX launcher's
    lines and returns the transport statistics."""
    r = _port(tmp_path, *REMOTE)
    out = capsys.readouterr().out
    _same_tables(_tables(tmp_path), reference, "remote walkers")
    assert "remote walkers: 1 subprocess producer(s) @ 127.0.0.1:" in out
    assert "duplicate chunk(s) discarded" in out and "transport: " in out
    assert "failover:" not in out
    st = r["transport"]
    assert st["chunks_applied"] >= 6 and st["dup_chunks"] == 0
    assert r["failover"]["takeovers"] == 0
    _no_producer_left()


def test_coordinator_resume_training_is_bitwise_identical(reference,
                                                          tmp_path, capsys):
    """Kill a remote-walker training run before episode (1, 1), restart it
    with --resume --coordinator-resume against the surviving disk store:
    the recovering server skips every episode the store already accepted,
    and the final tables are bitwise the uninterrupted in-process run's.
    The crash's diagnostics.json holds the hosts' leases, the transport
    and the failover statistics."""
    rw = [*REMOTE, "--store", "disk", "--keep-samples", "--ckpt-every", "1"]
    with pytest.raises(InjectedFault):
        _port(tmp_path, *rw, "--inject", "train.episode:crash:key=1/1")
    _no_producer_left()
    assert not (tmp_path / "embeddings_2.npz").exists()
    diag = json.load(open(tmp_path / "diagnostics.json"))
    assert diag["error"] == "InjectedFault"
    assert {"host_health", "transport", "failover"} <= set(diag)
    assert "walker-0" in diag["host_health"]
    assert diag["transport"]["chunks_applied"] >= 3
    assert diag["failover"]["takeovers"] == 0
    capsys.readouterr()

    r = _port(tmp_path, *rw, "--resume", "--coordinator-resume")
    out = capsys.readouterr().out
    _no_producer_left()
    assert "coordinator takeover: recovering server on port" in out
    assert "remote-walk: takeover of epoch 1" in out
    assert "failover: 1 takeover(s)" in out
    assert r["failover"]["takeovers"] == 1
    assert r["failover"]["recovered_episodes"] >= 1
    _same_tables(_tables(tmp_path), reference, "coordinator failover")


def test_all_producers_dead_fails_with_hosts_named(tmp_path):
    """No fallback: with the only producer killed, the run fails naming the
    dead host, writes diagnostics.json with the remote keys, and walks
    nothing in process."""
    with pytest.raises((TransportError, StoreStalled), match="walker-0"):
        _port(tmp_path, "--remote-walkers", "1", "--heartbeat-s", "0.1",
              "--lease-s", "1", "--inject",
              "producer.episode:crash:key=walker-0/*")
    _no_producer_left()
    diag = json.load(open(tmp_path / "diagnostics.json"))
    assert diag["error"] in ("TransportError", "StoreStalled")
    assert {"host_health", "transport", "failover"} <= set(diag)
    assert diag["host_health"]["walker-0"]["alive"] is False
    assert diag["transport"]["chunks_applied"] == 0


def test_remote_walkers_telemetry_has_host_lanes(reference, tmp_path):
    """The reference CI's telemetry leg with two spawned producers: the
    schema gate passes with the per-host receive lanes (``host:walker-<i>``
    of whichever producers were assigned episodes: one may take them all)
    beside the pipeline's, the snapshots carry the transport source, and
    the checkpoint is still the in-process run's."""
    mdir, trace = tmp_path / "m", tmp_path / "trace.json"
    _port(tmp_path, "--remote-walkers", "2", "--metrics-dir", str(mdir),
          "--metrics-interval-s", "0.2", "--trace", str(trace))
    _no_producer_left()
    _same_tables(_tables(tmp_path), reference, "telemetry leg")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "check_telemetry.py"),
         "--metrics", str(mdir / "metrics.jsonl"),
         "--summary", str(mdir / "metrics_summary.json"),
         "--trace", str(trace),
         "--require-tracks", "walk,build,stage,train,store,host"],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    events = json.load(open(trace))["traceEvents"]
    lanes = {e["args"]["name"] for e in events if e["name"] == "thread_name"}
    hosts = {lane for lane in lanes if lane.startswith("host:")}
    assert hosts and hosts <= {"host:walker-0", "host:walker-1"}, lanes
    snaps = [json.loads(line) for line in open(mdir / "metrics.jsonl")]
    assert any("transport" in s["sources"] and "host_health" in s["sources"]
               for s in snaps)


@pytest.mark.parametrize("argv,match", [
    (["--resume", "--coordinator-resume"], "remote-walkers"),
    (["--remote-walkers", "1", "--coordinator-resume"], "resume"),
], ids=["without_remote_walkers", "without_resume"])
def test_coordinator_resume_flag_validation(tmp_path, argv, match):
    """Both validations fire before any graph work (no output directory is
    made) with JAX's messages."""
    out = tmp_path / "never"
    with pytest.raises(SystemExit, match=match):
        _port(out, *argv)
    assert not out.exists()


def test_remote_flags_have_jax_defaults(monkeypatch):
    """The six flags parse with the JAX launcher's defaults."""
    seen = {}
    monkeypatch.setattr(ttrain, "train_embedding",
                        lambda args: seen.update(vars(args)))
    ttrain.main([])
    assert {k: seen[k] for k in (
        "remote_walkers", "coordinator_resume", "coordinator_port",
        "server_grace_s", "heartbeat_s", "lease_s")} == {
        "remote_walkers": 0, "coordinator_resume": False,
        "coordinator_port": 0, "server_grace_s": 30.0, "heartbeat_s": 1.0,
        "lease_s": 10.0}


def test_two_ranks_with_remote_walkers_train_the_in_process_bits(tmp_path):
    """Two gloo CPU ranks, each with its own episode server and producer:
    the checkpoint is bitwise the two-rank in-process run's."""
    from test_torch_ring import _run_ranks

    code = ("import sys; from repro_torch.launch import train; "
            "train.main(sys.argv[1:])")
    common = [*TRAIN, "--device", "cpu"]
    _run_ranks(code, 2, *common, "--out-dir", tmp_path / "mem")
    outs = _run_ranks(code, 2, *common, *REMOTE, "--out-dir",
                      tmp_path / "remote")
    assert "remote walkers: 1 subprocess producer(s)" in outs[0]
    _same_tables(_tables(tmp_path / "remote"), _tables(tmp_path / "mem"),
                 "two ranks with remote walkers")
