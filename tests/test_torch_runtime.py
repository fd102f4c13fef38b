"""The training launcher's fault tolerance and telemetry, port against the
JAX package: bounded retry, the walk-chunk retry, the disk sample store
(its files byte for byte the JAX store's, read across in both directions;
torn and bit-flipped payloads detected; the publish crash window), the
pipeline's corrupt-episode re-walk and per-episode stage timings, then the
port's launcher on the CPU: ``--store disk`` bitwise ``--store memory``,
crash-resume bitwise, ``diagnostics.json`` with JAX's keys, the telemetry
files through ``tools/check_telemetry.py``, and two ``gloo`` ranks
writing under ``rank1/``. Every comparison is bitwise."""
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import EpisodePipeline as JPipeline
from repro.core.partition import NodePartition as JPartition
from repro.graph import powerlaw_graph as jpowerlaw
from repro.launch.train import main as jtrain_main
from repro.runtime import RetryPolicy as JRetryPolicy
from repro.runtime import call_with_retry as jcall_with_retry
from repro.walk import WalkConfig as JWalkConfig
from repro.walk import WalkEngine as JWalkEngine
from repro.walk.store import DiskSampleStore as JDiskStore
from repro.walk.store import MemorySampleStore as JMemStore
from repro_torch import obs
from repro_torch.core import EpisodePipeline
from repro_torch.core.partition import NodePartition
from repro_torch.graph.generators import powerlaw_graph
from repro_torch.launch import train as ttrain
from repro_torch.runtime import (CorruptEpisodeError, InjectedFault,
                                 RetryPolicy, call_with_retry, inject)
from repro_torch.train.checkpoint import load_arrays
from repro_torch.walk import (DiskSampleStore, MemorySampleStore, WalkConfig,
                              WalkEngine)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the in-process launcher runs: the suite's
    workers share the machine's cores, and the training loop's many small
    ops on spinning thread pools slow by orders of magnitude when they are
    oversubscribed (every run of a test uses the same setting)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_obs():
    """Telemetry is process-global state; never leak it across tests."""
    for o in (obs, jobs):
        o.disable()
        o.set_tracer(None)
    yield
    for o in (obs, jobs):
        o.disable()
        o.set_tracer(None)


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------
POLICIES = [dict(attempts=4, backoff_s=0.1, mult=2.0),
            dict(attempts=6, backoff_s=0.05, mult=3.0, max_backoff_s=0.5),
            dict(attempts=5, backoff_s=0.2, jitter=0.25),
            dict(attempts=None, backoff_s=0.01, mult=1.5, max_backoff_s=0.1,
                 jitter=0.5),
            dict(attempts=1), dict(attempts=0)]


@pytest.mark.parametrize("kw", POLICIES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("seed", [0, 7])
def test_retry_delays_equal_jax(kw, seed):
    """The backoff schedule, the clamp and the seeded jitter stream, float
    for float (an unbounded policy read for its first 12 delays). Unseeded
    jitter draws from the OS in both packages, so it has no stream to
    compare."""
    got = list(itertools.islice(RetryPolicy(**kw).delays(seed=seed), 12))
    want = list(itertools.islice(JRetryPolicy(**kw).delays(seed=seed), 12))
    assert got == want


def _flaky(fails, exc=ValueError):
    calls = []

    def fn(x):
        calls.append(x)
        if len(calls) <= fails:
            raise exc(f"transient {len(calls)}")
        return 2 * x
    return fn, calls


@pytest.mark.parametrize("fails,attempts,max_elapsed_s", [
    (0, 3, None), (2, 3, None), (3, 3, None), (5, None, 0.03), (1, 1, None)])
def test_call_with_retry_equals_jax(fails, attempts, max_elapsed_s):
    """The same tries, the same on_retry calls, the same result or the same
    re-raised error, under attempts and under an elapsed cap."""
    outcomes = []
    for call, policy in ((call_with_retry, RetryPolicy),
                         (jcall_with_retry, JRetryPolicy)):
        fn, calls = _flaky(fails)
        seen = []
        pol = policy(attempts=attempts, backoff_s=0.01,
                     max_elapsed_s=max_elapsed_s)
        try:
            res = call(fn, 21, policy=pol,
                       on_retry=lambda a, e: seen.append((a, str(e))))
        except ValueError as e:
            res = f"raised {e}"
        outcomes.append((res, len(calls), seen))
    got, want = outcomes
    if max_elapsed_s is None:
        assert got == want
    else:        # the window, not a count, ends it: both give up, loudly
        assert got[0].startswith("raised") and want[0].startswith("raised")
        assert got[1] >= 2 and want[1] >= 2


# ---------------------------------------------------------------------------
# walk-chunk crash -> retry -> bitwise JAX's pairs
# ---------------------------------------------------------------------------
def _graphs():
    return powerlaw_graph(400, 4, seed=7), jpowerlaw(400, 4, seed=7)


WALK_KW = dict(walk_length=8, window=3, episodes=3, seed=11, chunk_size=64)


@pytest.mark.parametrize("workers", [1, 2])
def test_walk_chunk_crash_retry_equals_jax(workers):
    """Crashed chunks (the 4th and 9th attempts) are retried from their
    (seed, epoch, episode, chunk) key: the port's pairs equal the JAX
    engine's with no fault at all, and episode_pairs replays them."""
    g, jg = _graphs()
    ref = JMemStore()
    JWalkEngine(jg, JWalkConfig(**WALK_KW, workers=workers), ref).run_epoch(0)
    store = MemorySampleStore()
    eng = WalkEngine(g, WalkConfig(**WALK_KW, workers=workers,
                                   retry_backoff_s=0.001), store)
    with inject("walk.chunk:crash:at=3", "walk.chunk:crash:at=8") as plan:
        eng.run_epoch(0)
    assert [k for _, k, _ in plan.fired] == ["crash", "crash"]
    for ep in range(WALK_KW["episodes"]):
        want = np.asarray(ref.get(0, ep))
        np.testing.assert_array_equal(np.asarray(store.get(0, ep)), want)
        np.testing.assert_array_equal(eng.episode_pairs(0, ep), want)


def test_walk_retries_exhausted_fails_loudly():
    g, _ = _graphs()
    store = MemorySampleStore()
    eng = WalkEngine(g, WalkConfig(episodes=2, workers=1, retries=2,
                                   retry_backoff_s=0.001, chunk_size=256),
                     store)
    # times=inf: the crash outlives every retry attempt
    with inject("walk.chunk:crash:key=0/0/0:times=inf") as plan:
        eng.start_async(0)
        with pytest.raises(KeyError):
            store.get(0, 0)       # error path finishes the epoch -> KeyError
        with pytest.raises(InjectedFault):
            eng.join()
    assert len(plan.fired) == 2   # both tries of chunk (0, 0, 0)


# ---------------------------------------------------------------------------
# the disk store: the JAX store's files, both ways
# ---------------------------------------------------------------------------
def _episodes(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, size=(50 + 17 * i, 2)).astype(np.int32)
            for i in range(n)]


def _dir_bytes(root):
    """Every file directly under ``root``, name -> bytes."""
    return {f: open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root))
            if os.path.isfile(os.path.join(root, f))}


def test_disk_files_byte_identical_and_read_across(tmp_path):
    """The same episodes through both stores: the same file names and
    bytes (.npy, .crc, .done); each store reads the other's directory."""
    eps = _episodes()
    dirs = {}
    for name, cls in (("port", DiskSampleStore), ("jax", JDiskStore)):
        d = str(tmp_path / name)
        s = cls(d)
        for ep, p in enumerate(eps):
            s.put(0, ep, p)
        s.finish_epoch(0)
        dirs[name] = d
    got, want = _dir_bytes(dirs["port"]), _dir_bytes(dirs["jax"])
    assert list(got) == list(want) == [
        "epoch0000.done"] + [f"epoch0000_ep{e:04d}.npy{x}"
                             for e in range(3) for x in ("", ".crc")]
    assert got == want
    for reader, written in ((DiskSampleStore, "jax"), (JDiskStore, "port")):
        s = reader(dirs[written])
        assert s.episodes(0) == 3
        for ep, p in enumerate(eps):
            np.testing.assert_array_equal(np.asarray(s.get(0, ep)), p)
        assert s.accepted_episodes(0) == [0, 1, 2]


def _bitflip(path):
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF                        # same length, different bytes
    with open(path, "wb") as f:
        f.write(bytes(blob))


@pytest.mark.parametrize("how", ["torn", "bitflip"])
def test_disk_corruption_detected_and_repaired(tmp_path, how):
    """A torn write (the disk.write corrupt fault) or a flipped byte raises
    the port's CorruptEpisodeError, as JAX's store raises its own on the
    same file; rewrite repairs the file."""
    store = DiskSampleStore(str(tmp_path))
    pairs = np.arange(40, dtype=np.int32).reshape(-1, 2)
    if how == "torn":
        with inject("disk.write:corrupt:at=0"):
            store.put(0, 0, pairs)
    else:
        store.put(0, 0, pairs)
        _bitflip(store._path(0, 0))
    with pytest.raises(CorruptEpisodeError,
                       match="short file" if how == "torn" else "checksum"
                       ) as ei:
        store.get(0, 0, block=False)
    assert ei.value.key == (0, 0)
    from repro.runtime import CorruptEpisodeError as JCorrupt
    with pytest.raises(JCorrupt):
        JDiskStore(str(tmp_path)).get(0, 0, block=False)
    store.rewrite(0, 0, pairs)
    np.testing.assert_array_equal(np.asarray(store.get(0, 0)), pairs)


def test_disk_drop_fresh_and_publish_crash_window(tmp_path):
    """drop removes the sidecar (keep=False); fresh clears stale files; a
    crash between the sidecar's rename and the payload's leaves either no
    payload (KeyError) or one that fails the new checksum — for put and
    for the rewrite repair alike."""
    a = DiskSampleStore(str(tmp_path / "drop"), keep=False)
    a.put(0, 0, np.zeros((4, 2), np.int32))
    assert os.path.exists(a._path(0, 0) + ".crc")
    a.drop(0, 0)
    assert not os.listdir(str(tmp_path / "drop"))

    b = DiskSampleStore(str(tmp_path / "fresh"))
    b.put(0, 0, np.zeros((4, 2), np.int32))
    b.finish_epoch(0)
    DiskSampleStore(str(tmp_path / "fresh"), fresh=True)
    assert not os.listdir(str(tmp_path / "fresh"))

    store = DiskSampleStore(str(tmp_path / "crash"))
    pairs = np.arange(64, dtype=np.int32).reshape(32, 2)
    with inject("disk.write:crash:key=0/0/publish") as plan:
        with pytest.raises(InjectedFault):
            store.put(0, 0, pairs)
    assert plan.fired
    assert os.path.exists(store._path(0, 0) + ".crc")
    assert not os.path.exists(store._path(0, 0))
    with pytest.raises(KeyError):
        store.get(0, 0, block=False)
    store.rewrite(0, 0, pairs)
    np.testing.assert_array_equal(np.asarray(store.get(0, 0)), pairs)
    with open(store._path(0, 0), "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff\xff")
    with inject("disk.write:crash:key=0/0/publish"):
        with pytest.raises(InjectedFault):
            store.rewrite(0, 0, pairs)
    with pytest.raises(CorruptEpisodeError):
        store.get(0, 0)                    # still corrupt, still detected
    store.rewrite(0, 0, pairs)
    np.testing.assert_array_equal(np.asarray(store.get(0, 0)), pairs)


# ---------------------------------------------------------------------------
# the pipeline: corrupt-episode re-walk, per-episode stage timings
# ---------------------------------------------------------------------------
def test_pipeline_rewalks_corrupt_episode_equal_to_jax(tmp_path):
    """Episode 1's file is torn as it is written; the pipeline re-walks it
    (bitwise the JAX engine's episode), builds its blocks and repairs the
    file, which then matches the JAX walker's file byte for byte."""
    from repro.core.partition import build_episode_blocks as jbuild

    g, jg = _graphs()
    cfg = dict(episodes=2, seed=9, chunk_size=128)
    store = DiskSampleStore(str(tmp_path / "port"))
    eng = WalkEngine(g, WalkConfig(**cfg), store)
    with inject("disk.write:corrupt:key=0/1"):
        eng.run_epoch(0)
    jstore = JDiskStore(str(tmp_path / "jax"))
    JWalkEngine(jg, JWalkConfig(**cfg), jstore).run_epoch(0)

    part = NodePartition(g.num_nodes, dims=(1,), subparts=2)
    pipe = EpisodePipeline(store, part, pad_multiple=8,
                           rewalk=WalkEngine(g, WalkConfig(**cfg))
                           .episode_pairs)
    try:
        eb1 = pipe.get(0, 1)                # corrupt on disk: re-walked
        assert pipe.recovered == [(0, 1)]
    finally:
        pipe.close()
    want = jbuild(np.asarray(jstore.get(0, 1)),
                  JPartition(g.num_nodes, dims=(1,), subparts=2),
                  pad_multiple=8)
    np.testing.assert_array_equal(eb1.blocks, np.asarray(want.blocks))
    assert _dir_bytes(str(tmp_path / "port")) == \
        _dir_bytes(str(tmp_path / "jax"))


def _pipes(depth=2, stage=False):
    """The same four episodes in both packages' memory stores, each behind
    its own package's pipeline."""
    out = []
    for store_cls, pipe_cls, part_cls in (
            (MemorySampleStore, EpisodePipeline, NodePartition),
            (JMemStore, JPipeline, JPartition)):
        store = store_cls()
        for ep, p in enumerate(_episodes(4, seed=1)):
            store.put(0, ep, p % 100)
        out.append(pipe_cls(store, part_cls(100, dims=(1,), subparts=1),
                            pad_multiple=8, depth=depth,
                            stage_fn=(lambda eb: eb) if stage else None))
    return out


@pytest.mark.parametrize("order", ["sync", "prefetched", "out_of_order"])
def test_pop_times_keys_equal_jax(order):
    """pop_times after a sync build (three stages), after prefetched gets,
    and after gets out of prefetch order: the same keys per episode as
    JAX's pipeline, consumed once; the registry histograms count every
    stage."""
    seen = []
    for o, (pipe) in zip((obs, jobs), _pipes(depth=4,
                                             stage=order == "sync")):
        reg = o.enable()
        try:
            eps = [0] if order == "sync" else [0, 1, 2]
            if order != "sync":
                pipe.prefetch_window(0, 0, 3)
            for ep in (eps if order != "out_of_order" else [2, 0, 1]):
                pipe.get(0, ep)
            times = [sorted(pipe.pop_times(0, ep)) for ep in eps]
            assert all(pipe.pop_times(0, ep) == {} for ep in eps)
            hists = reg.snapshot()["histograms"]
            seen.append((times, {k: v["count"] for k, v in hists.items()
                                 if k.startswith("pipeline.")}))
        finally:
            pipe.close()
            o.disable()
    assert seen[0] == seen[1]


def test_pop_times_bounded_like_jax():
    for pipe in _pipes():
        try:
            for i in range(pipe._times_cap * 3):
                pipe._record((0, i), "build_s", 0.001)
            assert len(pipe._times) == pipe._times_cap == 64
            assert pipe.pop_times(0, 0) == {}                   # oldest gone
            assert pipe.pop_times(0, pipe._times_cap * 3 - 1)   # newest kept
        finally:
            pipe.close()


def test_pop_times_concurrent_records_lose_nothing():
    """Stage workers record concurrently: 16 threads (more than the
    cores) with a short switch interval each record three stages of their
    own episodes; every episode then pops all three."""
    import threading

    pipe = _pipes(depth=1000)[0]          # cap 8,000 entries: no eviction
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(150):
                for stage in ("walk_wait_s", "build_s", "stage_s"):
                    pipe._record((t, i), stage, 0.001)

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert len(pipe._times) == 16 * 150
        assert all(len(pipe.pop_times(t, i)) == 3
                   for t in range(16) for i in range(150))
    finally:
        sys.setswitchinterval(old)
        pipe.close()


# ---------------------------------------------------------------------------
# the launcher on the CPU
# ---------------------------------------------------------------------------
# tests/test_runtime.py's schedule (2 epochs x 3 episodes, 240 nodes)
TRAIN = ["--nodes", "240", "--dim", "16", "--epochs", "2", "--episodes", "3",
         "--subparts", "2", "--minibatch", "32", "--negatives", "4",
         "--neg-pool", "256", "--walk-workers", "2", "--seed", "3"]


def _port(out, *extra):
    return ttrain.main([*TRAIN, "--out-dir", str(out), "--device", "cpu",
                        *extra])


def _tables(out, name="embeddings_2.npz"):
    """The stored words of both tables (as the reference CI compares
    them)."""
    with np.load(os.path.join(str(out), name)) as z:
        return {k: np.frombuffer(z[k].tobytes(), np.uint8)
                for k in ("vertex", "context")}


def _same_tables(a, b):
    for k in ("vertex", "context"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted memory-store run every launcher case is held to."""
    out = tmp_path_factory.mktemp("ref")
    _port(out)
    return _tables(out)


def test_disk_store_trains_memory_store_bits(reference, tmp_path, capsys):
    """--store disk --keep-samples: the same checkpoint bit for bit, and
    the kept files are the JAX walker's for the same graph and seed; a
    second run into the same directory warns about the stale files."""
    sdir = tmp_path / "samples"
    _port(tmp_path / "disk", "--store", "disk", "--keep-samples",
          "--store-dir", str(sdir))
    _same_tables(_tables(tmp_path / "disk"), reference)
    assert sorted(os.listdir(sdir))[:3] == [
        "epoch0000.done", "epoch0000_ep0000.npy", "epoch0000_ep0000.npy.crc"]
    stored = DiskSampleStore(str(sdir))
    assert stored.episodes(0) == stored.episodes(1) == 3
    _port(tmp_path / "disk2", "--store", "disk", "--keep-samples",
          "--store-dir", str(sdir))
    assert "already holds episode files" in capsys.readouterr().out
    _same_tables(_tables(tmp_path / "disk2"), reference)


@pytest.mark.parametrize("store", ["memory", "disk"])
def test_corrupt_episode_is_rewalked_bitwise(reference, tmp_path, capsys,
                                             store):
    """disk.write:corrupt on episode (1, 1): the run re-walks it, says so
    on the epoch line, and trains the reference's bits (the memory store
    writes no file, so nothing fires there)."""
    stats = _port(tmp_path, "--store", store, "--inject",
                  "disk.write:corrupt:key=1/1")
    out = capsys.readouterr().out
    if store == "disk":
        assert stats["rewalked"] == [(1, 1)]
        assert "[1 episode(s) re-walked]" in out
    else:
        assert stats["rewalked"] == [] and "re-walked" not in out
    _same_tables(_tables(tmp_path), reference)


@pytest.mark.parametrize("inject,ckpt_every,cursor", [
    (["train.episode:crash:key=1/1"], "1", [1, 1]),
    (["walk.chunk:crash:at=2", "train.episode:crash:key=1/2"], "2", [1, 1]),
], ids=["mid_epoch_kill", "walker_crash_then_kill"])
@pytest.mark.parametrize("store", ["memory", "disk"])
def test_crash_resume_is_bitwise(reference, tmp_path, inject, ckpt_every,
                                 cursor, store):
    """The run dies at an injected train.episode crash (after a retried
    walk-chunk crash in the second case), leaves diagnostics.json and a
    resume checkpoint at the cursor; --resume trains the reference's bits."""
    args = ["--store", store, "--ckpt-every", ckpt_every]
    with pytest.raises(InjectedFault):
        _port(tmp_path, *args, *[f"--inject={s}" for s in inject])
    diag = json.load(open(tmp_path / "diagnostics.json"))
    assert diag["error"] == "InjectedFault"
    cur, _ = load_arrays(str(tmp_path / "resume.npz"))
    assert np.asarray(cur["__cursor__"]).tolist() == cursor
    assert not (tmp_path / "embeddings_2.npz").exists()
    _port(tmp_path, *args, "--resume")
    _same_tables(_tables(tmp_path), reference)


def test_diagnostics_keys_and_counters_equal_jax(tmp_path):
    """A crash before episode (0, 1) with --metrics-dir: both launchers'
    diagnostics.json have the same keys, the same counters (one episode
    trained) and histograms; the sink closed, the registry is off."""
    from repro.runtime import InjectedFault as JInjected

    diags = {}
    for name, run in (
            ("port", lambda a: _port(tmp_path / "port", *a)),
            ("jax", lambda a: jtrain_main(
                ["--arch", "tencent-embedding", *TRAIN, "--out-dir",
                 str(tmp_path / "jax"), *a]))):
        mdir = tmp_path / name / "metrics"
        with pytest.raises((InjectedFault, JInjected)):
            run(["--metrics-dir", str(mdir), "--metrics-interval-s", "0.2",
                 "--inject", "train.episode:crash:key=0/1"])
        diags[name] = json.load(open(tmp_path / name / "diagnostics.json"))
        assert (mdir / "metrics_summary.json").exists()
    port, ref = diags["port"], diags["jax"]
    assert set(port) == set(ref) == {"error", "message", "metrics"}
    assert port["error"] == ref["error"] == "InjectedFault"
    assert port["message"] == ref["message"]
    m, jm = port["metrics"], ref["metrics"]
    assert set(m) == set(jm)
    assert set(m["counters"]) == set(jm["counters"])
    assert m["counters"]["train.episodes"] == 1 == \
        jm["counters"]["train.episodes"]
    assert m["counters"]["walk.chunks"] >= 1
    assert set(m["histograms"]) <= set(jm["histograms"])
    assert m["histograms"]["pipeline.build_s"]["count"] >= 1
    assert obs.active() is None and jobs.active() is None


def test_telemetry_files_pass_check_telemetry(reference, tmp_path):
    """--metrics-dir and --trace on a disk-store run: the schema gate
    passes with a span on every pipeline lane, walk workers included; the
    checkpoint is still the reference's."""
    mdir, trace = tmp_path / "m", tmp_path / "trace.json"
    _port(tmp_path, "--store", "disk", "--metrics-dir", str(mdir),
          "--metrics-interval-s", "0.2", "--trace", str(trace))
    _same_tables(_tables(tmp_path), reference)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "check_telemetry.py"),
         "--metrics", str(mdir / "metrics.jsonl"),
         "--summary", str(mdir / "metrics_summary.json"),
         "--trace", str(trace),
         "--require-tracks", "walk,build,stage,train,store"],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    events = json.load(open(trace))["traceEvents"]
    lanes = {e["args"]["name"] for e in events if e["name"] == "thread_name"}
    # the chunk workers' lanes (the pool starts its second thread only when
    # no idle one can take a chunk)
    assert "walk:walk_0" in lanes
    summary = json.load(open(mdir / "metrics_summary.json"))
    for name in ("walk.chunk_s", "pipeline.walk_wait_s", "pipeline.build_s",
                 "pipeline.stage_s", "store.put_wait_s", "train.episode_s"):
        assert summary["histograms"][name]["count"] > 0, name
    assert summary["counters"]["train.episodes"] == 6
    assert obs.active() is None and obs.tracer() is None


def test_two_ranks_write_under_rank_dirs(tmp_path):
    """Two gloo CPU ranks through the launcher with --store disk and
    telemetry: rank 1's samples, metrics and trace land under rank1/,
    rank 0's where one rank's would; the checkpoint is bitwise the
    memory-store two-rank run's, which tests/test_torch_ring.py serves."""
    from test_torch_ring import _run_ranks

    code = ("import sys; from repro_torch.launch import train; "
            "train.main(sys.argv[1:])")
    common = [*TRAIN, "--device", "cpu"]
    _run_ranks(code, 2, *common, "--out-dir", tmp_path / "mem")
    d = tmp_path / "disk"
    _run_ranks(code, 2, *common, "--out-dir", d, "--store", "disk",
               "--keep-samples", "--metrics-dir", d / "m", "--trace",
               d / "t" / "trace.json")
    for rank0, rank1 in (("samples", "samples/rank1"), ("m", "m/rank1"),
                         ("t/trace.json", "t/rank1/trace.json")):
        assert (d / rank0).exists() and (d / rank1).exists(), rank1
    # every rank walks the same episodes
    assert _dir_bytes(str(d / "samples" / "rank1")) == \
        _dir_bytes(str(d / "samples"))
    assert not (d / "rank1").exists()    # no failure, no diagnostics
    _same_tables(_tables(d), _tables(tmp_path / "mem"))
