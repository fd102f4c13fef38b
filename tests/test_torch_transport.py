"""The remote walkers' transport on the port: framing, exactly-once chunk
assembly, host-health leases and remote-producer chaos, held to the JAX
package's cases, plus the cross-package checks — the same frame bytes, and
a producer of either package feeding a server of the other.

The invariant under test everywhere: a remote-producer run is BITWISE
identical to in-process production — with zero faults and under every
``net.*`` chaos kind — because episodes are keyed ``(seed, epoch, episode,
chunk)`` and redelivery is exactly-once at the assembler. Producers run as
threads (same protocol, same sockets as the spawned ones). Every socket
listens on port 0, and every wait on a socket, an epoch or a thread has a
timeout.
"""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro.graph import powerlaw_graph as jpowerlaw
from repro.runtime import FaultSpec as JFaultSpec
from repro.runtime.transport import encode_pairs as jencode_pairs
from repro.runtime.transport import pack_frame as jpack_frame
from repro.walk import MemorySampleStore as JMemStore
from repro.walk import WalkConfig as JWalkConfig
from repro.walk import WalkEngine as JWalkEngine
from repro.walk.remote import RemoteEpisodeServer as JServer
from repro.walk.remote import RemoteProducer as JProducer
from repro_torch.graph import powerlaw_graph
from repro_torch.runtime import (FaultSpec, StoreStalled, TransportError,
                                 inject)
from repro_torch.runtime.transport import (MAGIC, ChunkAssembler, FramedSocket,
                                           HostHealth, _FRAME, decode_pairs,
                                           encode_pairs, pack_frame)
from repro_torch.walk import (MemorySampleStore, RemoteEpisodeServer,
                              RemoteProducer, RemoteWalkCoordinator,
                              WalkConfig, WalkEngine)
from repro_torch.walk.store import DiskSampleStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds any one wait on an epoch, a thread or a store may take
WAIT_S = 60.0


def _pair():
    a, b = socket.socketpair()
    a.settimeout(WAIT_S)
    b.settimeout(WAIT_S)
    return FramedSocket(a), FramedSocket(b)


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------
def test_frame_roundtrip_over_socketpair():
    tx, rx = _pair()
    body = np.arange(1000, dtype=np.int32).tobytes()
    tx.send({"t": "chunk", "episode": 3}, body)
    msg, got = rx.recv()
    assert msg == {"t": "chunk", "episode": 3}
    assert got == body
    assert tx.frames_sent == 1 and rx.frames_recv == 1
    assert tx.bytes_sent == rx.bytes_recv > len(body)
    tx.close(), rx.close()


def _corrupt_body():
    frame = bytearray(pack_frame({"t": "chunk"}, b"payload-bytes"))
    frame[-3] ^= 0xFF                      # flip one body byte
    return bytes(frame)


def _bad_magic():
    frame = bytearray(pack_frame({"t": "x"}))
    frame[:4] = b"NOPE"
    return bytes(frame)


@pytest.mark.parametrize("frame,match", [
    (_corrupt_body, "checksum"),
    (_bad_magic, "magic"),
    (lambda: _FRAME.pack(MAGIC, 0, 2, (1 << 31) + 1) + b"{}", "absurd"),
], ids=["corrupt_body", "bad_magic", "absurd_length"])
def test_frame_torn_or_foreign_is_rejected(frame, match):
    tx, rx = _pair()
    tx.sock.sendall(frame())
    with pytest.raises(TransportError, match=match):
        rx.recv()
    tx.close(), rx.close()


def test_recv_on_closed_peer_raises_connectionerror():
    tx, rx = _pair()
    tx.close()
    with pytest.raises(ConnectionError):
        rx.recv()
    rx.close()


def test_encode_decode_pairs_roundtrip():
    pairs = np.random.default_rng(0).integers(
        0, 1000, size=(257, 2)).astype(np.int32)
    meta, body = encode_pairs(pairs)
    assert (meta, body) == jencode_pairs(pairs)
    out = decode_pairs(meta, body)
    assert out.dtype == pairs.dtype
    np.testing.assert_array_equal(out, pairs)


@pytest.mark.parametrize("msg,body", [
    ({"t": "hello", "host": "walker-0"}, b""),
    ({"t": "ack", "epoch": 3, "episode": 1, "chunk": 0, "dup": False,
      "complete": True}, b""),
    ({"t": "chunk", "host": "w", "seed": 7, "epoch": 0, "episode": 2,
      "chunk": 1, "nchunks": 3, "dtype": "<i4", "shape": [4, 2]},
     np.arange(8, dtype=np.int32).tobytes()),
    ({"t": "x", "s": "ünï€ode", "f": 0.1, "n": None}, bytes(range(256))),
], ids=["hello", "ack", "chunk", "unicode"])
def test_pack_frame_bytes_equal_jax(msg, body):
    """One wire format: the header, its crc32 and the JSON bytes are the
    JAX package's, byte for byte."""
    assert pack_frame(msg, body) == jpack_frame(msg, body)


def test_send_fault_sites_fire_only_when_injected():
    tx, rx = _pair()
    with inject("net.drop:fire:at=0") as plan:
        tx.send({"t": "hb"})               # control frame: no injection
        assert not plan.fired and tx.frames_dropped == 0
        tx.send({"t": "chunk"}, b"x", key=(0, 0, 0), inject=True)
        assert plan.fired and tx.frames_dropped == 1
    msg, _ = rx.recv()                     # only the heartbeat arrived
    assert msg == {"t": "hb"}
    tx.close(), rx.close()


def test_send_duplicate_and_reorder_sites():
    tx, rx = _pair()
    with inject("net.duplicate:fire:key=0/0/0",
                "net.reorder:fire:key=0/0/1") as plan:
        tx.send({"c": 0}, key=(0, 0, 0), inject=True)   # sent twice
        tx.send({"c": 1}, key=(0, 0, 1), inject=True)   # held back
        tx.send({"c": 2}, key=(0, 0, 2), inject=True)   # flushes the held one
    order = [rx.recv()[0]["c"] for _ in range(4)]
    assert order == [0, 0, 2, 1]
    assert tx.frames_duplicated == 1
    assert [f[0] for f in plan.fired] == ["net.duplicate", "net.reorder"]
    tx.close(), rx.close()


def test_send_disconnect_site_closes_and_raises():
    tx, rx = _pair()
    with inject("net.disconnect:fire:at=0"):
        with pytest.raises(TransportError, match="disconnect"):
            tx.send({"c": 0}, key=(0, 0, 0), inject=True)
    with pytest.raises(ConnectionError):
        rx.recv()                          # our end really closed
    rx.close()


# ---------------------------------------------------------------------------
# exactly-once chunk assembly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nchunks,rng_seed,extra", [
    (1, 0, []), (4, 1, [0, 0, 3]), (8, 2, list(range(16))),
    (5, 3, [4, 4, 4, 1]), (2, 4, [0, 1, 0, 1, 0, 1]),
])
def test_assembler_interleavings(nchunks, rng_seed, extra):
    """Deliver every chunk once plus `extra` redeliveries, in a shuffled
    order: the episode must assemble exactly once, bitwise in chunk order,
    with every redelivery flagged dup (the ack-and-discard contract)."""
    chunks = {c: np.full((c + 1, 2), c, dtype=np.int32)
              for c in range(nchunks)}
    schedule = list(range(nchunks)) + [e % nchunks for e in extra]
    np.random.default_rng(rng_seed).shuffle(schedule)
    asm = ChunkAssembler()
    assembled, dups = [], 0
    for c in schedule:
        dup, out = asm.add(7, 0, 0, c, nchunks, chunks[c])
        dups += dup
        if out is not None:
            assembled.append(out)
    assert len(assembled) == 1
    np.testing.assert_array_equal(
        assembled[0], np.concatenate([chunks[c] for c in range(nchunks)]))
    assert dups == len(schedule) - nchunks
    assert asm.complete(7, 0, 0)
    # redelivery after completion: still acked as dup, never re-assembled
    dup, out = asm.add(7, 0, 0, 0, nchunks, chunks[0])
    assert dup and out is None


def test_assembler_rejects_bad_chunks():
    asm = ChunkAssembler()
    with pytest.raises(TransportError, match="out of range"):
        asm.add(1, 0, 0, 3, 2, np.zeros((1, 2), np.int32))
    asm.add(1, 0, 0, 0, 2, np.zeros((1, 2), np.int32))
    with pytest.raises(TransportError, match="chunk count changed"):
        asm.add(1, 0, 0, 1, 5, np.zeros((1, 2), np.int32))


def test_assembler_forget_epoch_releases_keys():
    asm = ChunkAssembler()
    _, out = asm.add(1, 0, 0, 0, 1, np.ones((2, 2), np.int32))
    assert out is not None and asm.complete(1, 0, 0)
    asm.forget_epoch(1, 0)
    assert not asm.complete(1, 0, 0)
    dup, out = asm.add(1, 0, 0, 0, 1, np.ones((2, 2), np.int32))
    assert not dup and out is not None    # a forgotten epoch can replay


# ---------------------------------------------------------------------------
# host health leases
# ---------------------------------------------------------------------------
def test_host_health_lease_lifecycle():
    h = HostHealth(lease_s=0.15)
    assert h.any_alive()                   # nobody registered: unknown != dead
    h.beat("walker-0")
    assert h.alive("walker-0") and h.any_alive() and h.hosts() == ["walker-0"]
    assert h.expired() == []
    time.sleep(0.2)
    assert not h.alive("walker-0") and not h.any_alive()
    assert h.expired() == ["walker-0"]
    h.mark_dead("walker-0")
    assert h.expired() == []               # marked hosts are not re-reported
    assert "walker-0: DEAD" in h.describe()
    h.beat("walker-0")                     # a beating host is not dead
    assert h.alive("walker-0") and "alive" in h.describe()
    snap = h.snapshot()
    assert snap["walker-0"]["alive"]


def test_store_stalled_names_dead_host():
    """The watchdog's diagnostic must say WHICH producer host died."""
    h = HostHealth(lease_s=0.05)
    h.beat("walker-1")
    time.sleep(0.1)
    store = MemorySampleStore(stall_timeout_s=30.0)
    store.set_producer(h.any_alive, h.describe)
    with pytest.raises(StoreStalled) as ei:
        store.get(0, 0)
    assert "walker-1: DEAD" in str(ei.value)
    assert ei.value.producer_alive is False


# ---------------------------------------------------------------------------
# fault-spec grammar of the new sites (the key wildcard)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("text", [
    "net.drop:fire:at=2", "net.delay:delay:key=0/1/0:times=inf:delay=0.5",
    "producer.episode:crash:key=walker-0/*", "disk.write:corrupt",
    "net.duplicate:fire:key=0/2/1:times=3", "net.reorder:fire:at=7:key=a",
])
def test_fault_spec_parses_like_jax(text):
    s, j = FaultSpec.parse(text), JFaultSpec.parse(text)
    assert (s.site, s.kind, s.at, s.key, s.times, s.delay_s) == \
        (j.site, j.kind, j.at, j.key, j.times, j.delay_s)


def test_fault_spec_key_wildcard_prefix_match():
    s = FaultSpec.parse("producer.episode:crash:key=walker-0/*:times=inf")
    assert s.matches(0, "walker-0/0/5")
    assert s.matches(3, "walker-0/1/0")
    assert not s.matches(0, "walker-1/0/5")
    assert not s.matches(0, None)
    # exact keys stay exact: no implicit prefixing
    e = FaultSpec.parse("producer.episode:crash:key=walker-0/0:times=inf")
    assert e.matches(0, "walker-0/0")
    assert not e.matches(0, "walker-0/0/1")


# ---------------------------------------------------------------------------
# idempotent store puts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["memory", "disk"])
def test_put_unique_dedups(tmp_path, kind):
    store = (MemorySampleStore() if kind == "memory"
             else DiskSampleStore(str(tmp_path)))
    pairs = np.arange(10, dtype=np.int32).reshape(5, 2)
    assert store.put_unique(0, 0, pairs)
    assert not store.put_unique(0, 0, pairs)      # resident: duplicate
    store.get(0, 0)
    store.drop(0, 0)
    assert not store.put_unique(0, 0, pairs)      # consumed: still duplicate
    assert store.put_unique(0, 1, pairs)
    np.testing.assert_array_equal(np.asarray(store.get(0, 1)), pairs)


# ---------------------------------------------------------------------------
# remote production end-to-end (thread-mode producers)
# ---------------------------------------------------------------------------
GRAPH = {}


def _graph(jax=False):
    if jax not in GRAPH:
        GRAPH[jax] = (jpowerlaw if jax else powerlaw_graph)(300, 4, seed=1)
    return GRAPH[jax]


def _wcfg(jax=False):
    # chunk_size=40 gives multiple chunks per episode so chunk-keyed
    # net.* specs have real (epoch, episode, chunk>0) targets
    return (JWalkConfig if jax else WalkConfig)(
        walk_length=6, window=3, episodes=4, seed=3, chunk_size=40)


def _same_bits(got, want, msg=""):
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, msg
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=msg)


def test_episode_chunk_stream_matches_episode_pairs_and_jax():
    eng = WalkEngine(_graph(), _wcfg())
    jeng = JWalkEngine(_graph(True), _wcfg(True))
    for ep in range(2):
        chunks = list(eng.episode_chunk_stream(0, ep))
        assert len(chunks) >= 2            # the chaos tests need chunk 1
        assert all(n == len(chunks) for _, n, _ in chunks)
        jchunks = list(jeng.episode_chunk_stream(0, ep))
        assert [(c, n) for c, n, _ in chunks] == \
            [(c, n) for c, n, _ in jchunks]
        for (_, _, p), (_, _, q) in zip(chunks, jchunks):
            _same_bits(p, q)
        _same_bits(np.concatenate([p for _, _, p in chunks]),
                   eng.episode_pairs(0, ep))


def _run_remote_epochs(specs, *, num_producers=2, lease_s=20.0,
                       epochs=2, expect_fired=True):
    """Run `epochs` epochs through thread-mode remote producers under the
    given fault specs; assert every episode lands bitwise-identical to the
    in-process engine. Returns the coordinator's transport stats."""
    g, wcfg = _graph(), _wcfg()
    ref = WalkEngine(g, wcfg)
    store = MemorySampleStore(depth=3, stall_timeout_s=WAIT_S)
    coord = RemoteWalkCoordinator(g, wcfg, store, num_producers=num_producers,
                                  heartbeat_s=0.2, lease_s=lease_s,
                                  mode="thread", ack_timeout_s=1.5)
    with inject(*specs) as plan:
        coord.start()
        try:
            for epoch in range(epochs):
                h = coord.epoch_walker()
                h.start_async(epoch)
                for ep in range(wcfg.episodes):
                    _same_bits(store.get(epoch, ep),
                               ref.episode_pairs(epoch, ep), f"{epoch, ep}")
                    store.drop(epoch, ep)
                coord.server.wait_epoch(epoch, timeout_s=WAIT_S)
                assert h.finished()
            stats = coord.transport_stats()
        finally:
            coord.close()
    if expect_fired:
        assert plan.fired, f"fault plan {specs} never fired"
    return stats


def test_remote_production_bitwise_identical_no_faults():
    stats = _run_remote_epochs((), expect_fired=False)
    # 2 epochs x 4 episodes x >=2 chunks, zero retransmission
    assert stats["chunks_applied"] >= 16
    assert stats["dup_chunks"] == 0 and stats["resend_rate"] == 0.0
    assert stats["frames_recv"] > 0 and stats["bytes_recv"] > 0


@pytest.mark.parametrize("spec", [
    "net.drop:fire:key=0/1/0",            # chunk vanishes -> ack timeout
    "net.duplicate:fire:key=0/2/1",       # chunk lands twice -> dup-acked
    "net.disconnect:fire:key=0/1/1",      # socket dies mid-episode
    "net.reorder:fire:key=0/0/0",         # chunk 0 arrives after chunk 1
])
def test_remote_production_bitwise_identical_under_chaos(spec):
    """Reconnect-and-resend recovery is invisible to the trainer: the run
    under each network fault is bitwise-identical to in-process walks."""
    stats = _run_remote_epochs((spec,), epochs=1)
    if "duplicate" in spec:
        assert stats["dup_chunks"] >= 1    # the dup MUST have been discarded


def test_killed_producer_episodes_reassigned_to_survivors(capsys):
    """Kill walker-0 at its first assigned episode (whichever it is — the
    /* wildcard absorbs assignment races): its lease lapses, the reclaim
    loop reassigns, and walker-1 finishes the epoch bitwise-correct."""
    stats = _run_remote_epochs(("producer.episode:crash:key=walker-0/*",),
                               lease_s=2.0, epochs=1)
    assert stats["chunks_applied"] >= 8
    assert "lease expired; reassigning" in capsys.readouterr().out


def test_all_producers_dead_fails_fast_with_named_hosts():
    g, wcfg = _graph(), _wcfg()
    store = MemorySampleStore(depth=3, stall_timeout_s=WAIT_S)
    coord = RemoteWalkCoordinator(g, wcfg, store, num_producers=2,
                                  heartbeat_s=0.1, lease_s=0.6,
                                  mode="thread", ack_timeout_s=1.5)
    with inject("producer.episode:crash:key=walker-0/*",
                "producer.episode:crash:key=walker-1/*") as plan:
        coord.start()
        try:
            h = coord.epoch_walker()
            h.start_async(0)
            with pytest.raises(TransportError, match="hosts are dead") as ei:
                coord.server.wait_epoch(0, timeout_s=30.0)
            assert "walker-0: DEAD" in str(ei.value)
            assert "walker-1: DEAD" in str(ei.value)
            assert not coord.alive()
            assert len(plan.fired) == 2
        finally:
            coord.close()


def test_producer_resends_after_drop_without_duplicating_samples():
    """A dropped chunk frame forces a full resend pass; the assembler's
    idempotence keys keep every double-landed chunk out of the store."""
    stats = _run_remote_epochs(("net.drop:fire:key=0/0/1",), epochs=1)
    # exactly-once despite retransmission: applied == unique chunk count
    eng = WalkEngine(_graph(), _wcfg())
    unique = sum(len(list(eng.episode_chunk_stream(0, ep)))
                 for ep in range(_wcfg().episodes))
    assert stats["chunks_applied"] == unique


# ---------------------------------------------------------------------------
# across the packages: one protocol
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("server_pkg,producer_pkg", [
    ("port", "jax"), ("jax", "port")],
    ids=["jax_producer_to_port_server", "port_producer_to_jax_server"])
def test_producer_and_server_across_packages(server_pkg, producer_pkg):
    """A producer of one package feeds a server of the other: every episode
    of two epochs lands bitwise the in-process engine's."""
    srv_jax, prod_jax = server_pkg == "jax", producer_pkg == "jax"
    wcfg = _wcfg(srv_jax)
    store = (JMemStore if srv_jax else MemorySampleStore)(
        depth=3, stall_timeout_s=WAIT_S)
    srv = (JServer if srv_jax else RemoteEpisodeServer)(
        store, wcfg.episodes, wcfg.seed, lease_s=20.0)
    srv.start()
    prod = (JProducer if prod_jax else RemoteProducer)(
        srv.address, "walker-x", _graph(prod_jax), _wcfg(prod_jax),
        heartbeat_s=0.2, ack_timeout_s=5.0, server_grace_s=10.0)
    errors = []

    def run():
        try:
            prod.run()
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    ref = WalkEngine(_graph(), _wcfg())
    try:
        for epoch in range(2):
            srv.submit_epoch(epoch)
            for ep in range(wcfg.episodes):
                _same_bits(store.get(epoch, ep), ref.episode_pairs(epoch, ep),
                           f"{epoch, ep}")
                store.drop(epoch, ep)
            srv.wait_epoch(epoch, timeout_s=WAIT_S)
        assert srv.transport_stats()["dup_chunks"] == 0
    finally:
        srv.stop_work()
        t.join(timeout=WAIT_S)
        srv.close()
    assert not t.is_alive() and not errors, errors


_BLOCKED_IMPORT = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch.walk.remote
import repro_torch.runtime.transport
import repro_torch.launch.train
print("ok")
"""


def test_remote_walkers_import_without_torch_or_jax():
    """The producer's whole import chain (and the launcher module a spawned
    child re-imports as its main) loads in an interpreter whose import
    system refuses torch, JAX and the JAX package: a producer never loads
    CUDA."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
