"""Decoupled random-walk engine (paper §III intro + §IV-A).

A numpy copy of the JAX package's ``walk/engine.py`` (``WalkConfig`` and
``WalkEngine``, the DeepWalk and node2vec-biased steps, and the remote
producers' chunk stream); the sample stream is bitwise the same for any
``node2vec_p`` and ``node2vec_q``.

The paper decouples random-walk network augmentation from embedding training:
the walk engine runs on CPUs, writes episode-partitioned samples, and the GPU
training engine consumes them. This module produces walks (vectorized numpy
DeepWalk / node2vec-style) and hands them to a :class:`SampleStore`
partitioned by episode, applying the degree-guided partitioning of GraphVite
[4]: walk start nodes are ordered so that high-degree nodes spread uniformly
across episode partitions, balancing per-episode work.

Streaming dataflow: each episode's start nodes are split into fixed-size
chunks, each chunk seeded independently by (seed, epoch, episode, chunk).
A worker pool (``WalkConfig.workers``) generates chunks concurrently; the
coordinator assembles them IN CHUNK ORDER and ``put``s each episode into the
store as soon as it completes, so episode e's training overlaps episode
e+1's walks. Because the chunk decomposition and per-chunk RNG streams are
fixed by the config — never by the worker count — the sample stream is
bitwise identical for any ``workers`` setting.

Fault tolerance: each chunk is a retriable unit — its RNG stream is fixed
by (seed, epoch, episode, chunk), so a crashed chunk replayed under
``WalkConfig.retries`` produces bitwise-identical pairs. The
``walk.chunk`` fault site sits at the top of the chunk body;
:meth:`WalkEngine.alive` feeds the store's producer-liveness watchdog so a
walker that exhausts its retries fails consumers loudly instead of leaving
them blocked.

Telemetry: each chunk is a ``walk_chunk`` span on its worker thread's
``walk:<thread>`` lane, and each episode's hand-over to the store a
``store_put`` span on the ``store`` lane (where the JAX package's remote
coordinator puts its own), so a trace shows backpressure on the walker.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.obs import counter_add, observe, span
from repro_torch.obs import trace as _trace
from repro_torch.runtime import RetryPolicy, call_with_retry, fault_point
from repro_torch.walk.augment import walks_to_pairs
from repro_torch.walk.store import SampleStore


@dataclasses.dataclass
class WalkConfig:
    walk_length: int = 10          # paper's walk distance k
    window: int = 5                # paper's walk context length l
    walks_per_node: int = 1
    node2vec_p: float = 1.0        # return parameter (1.0 == DeepWalk)
    node2vec_q: float = 1.0        # in-out parameter
    episodes: int = 8              # partitions per epoch
    seed: int = 0
    # streaming knobs. `workers` sizes the chunk worker pool (1 = run chunks
    # inline on the coordinator). `chunk_size` fixes the canonical per-episode
    # chunk decomposition — it changes the RNG stream, `workers` never does.
    # `lookahead` bounds run-ahead: chunk futures are in flight for at most
    # this many episodes beyond the one currently being assembled.
    workers: int = 1
    chunk_size: int = 4096
    lookahead: int = 2
    # fault tolerance: total tries per chunk (1 = fail on first error) and
    # the base backoff between them. Replay is bitwise-safe: the chunk's RNG
    # stream depends only on (seed, epoch, episode, chunk).
    retries: int = 3
    retry_backoff_s: float = 0.05


class WalkEngine:
    """Produces augmented edge samples, episode-partitioned.

    ``run_epoch`` streams episodes into the store as they complete (chunks
    sharded over ``config.workers`` threads); ``start_async``/``join`` run the
    whole engine on a background thread so training overlaps walk generation
    — the paper's pipelined decoupling. Worker errors propagate through the
    ``_errors`` queue and re-raise in ``join``.
    """

    def __init__(self, graph: CSRGraph, config: WalkConfig,
                 store: SampleStore | None = None):
        # store=None is the producer-side mode: a remote walk producer (and
        # the pipeline's re-walk) use only the store-free generation surface
        # (episode_chunk_stream / episode_pairs). run_epoch/start_async
        # require a store.
        self.graph = graph
        self.config = config
        self.store = store
        self._thread: threading.Thread | None = None
        self._errors: _queue.Queue = _queue.Queue()

    # ------------------------------------------------------------------ walks
    def _step(self, cur: np.ndarray, prev: np.ndarray | None,
              rng: np.random.Generator) -> np.ndarray:
        """One vectorized walk step. Uniform choice for p=q=1, else 2nd-order."""
        g = self.graph
        deg = g.indptr[cur + 1] - g.indptr[cur]
        cfg = self.config
        m = g.num_edges
        if prev is None or (cfg.node2vec_p == 1.0 and cfg.node2vec_q == 1.0):
            off = rng.integers(0, np.maximum(deg, 1))
            # clamp: dead-end nodes produce an in-bounds dummy index that the
            # final where(deg>0) mask discards
            nxt = g.indices[np.minimum(g.indptr[cur] + off, m - 1)]
        else:
            # node2vec biased step via rejection sampling (KnightKing-style):
            # proposal = uniform neighbor; accept with weight/upper_bound.
            upper = max(1.0, 1.0 / cfg.node2vec_p, 1.0 / cfg.node2vec_q)
            nxt = np.empty_like(cur)
            pending = np.arange(cur.size)
            for _ in range(16):  # bounded retries, then fall back to uniform
                if pending.size == 0:
                    break
                c = cur[pending]
                off = rng.integers(0, np.maximum(g.indptr[c + 1] - g.indptr[c], 1))
                prop = g.indices[np.minimum(g.indptr[c] + off, m - 1)]
                w = np.full(prop.shape, 1.0 / cfg.node2vec_q)
                w[prop == prev[pending]] = 1.0 / cfg.node2vec_p
                # distance-1 check (shared neighbor) approximated as weight 1
                # for proposals adjacent to prev — exact check is O(deg); the
                # rejection bound keeps the walk distribution close (KnightKing).
                accept = rng.random(prop.shape) < (w / upper)
                nxt[pending[accept]] = prop[accept]
                pending = pending[~accept]
            if pending.size:
                c = cur[pending]
                off = rng.integers(0, np.maximum(g.indptr[c + 1] - g.indptr[c], 1))
                nxt[pending] = g.indices[np.minimum(g.indptr[c] + off, m - 1)]
        # dead ends (deg==0) stay in place
        return np.where(deg > 0, nxt, cur)

    def generate_walks(self, starts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """(num_walks, walk_length+1) int32 walk matrix."""
        L = self.config.walk_length
        walks = np.empty((starts.size, L + 1), dtype=np.int32)
        walks[:, 0] = starts
        prev = None
        for t in range(L):
            walks[:, t + 1] = self._step(walks[:, t], prev, rng)
            prev = walks[:, t]
        return walks

    # --------------------------------------------------------------- episodes
    def _episode_starts(self, epoch: int) -> list[np.ndarray]:
        """Degree-guided partitioning of start nodes into episodes [4]:
        sort by degree, deal round-robin so every episode gets a balanced mix."""
        g, cfg = self.graph, self.config
        rng = np.random.default_rng(cfg.seed + 1000003 * epoch)
        starts = np.repeat(np.arange(g.num_nodes, dtype=np.int32), cfg.walks_per_node)
        order = np.argsort(g.degrees().astype(np.int64)[starts % g.num_nodes], kind="stable")
        starts = starts[order[::-1]]  # high-degree first
        parts = [starts[i :: cfg.episodes] for i in range(cfg.episodes)]
        for p in parts:
            rng.shuffle(p)
        return parts

    def _chunk_pairs(self, epoch: int, episode: int, chunk: int,
                     starts: np.ndarray) -> np.ndarray:
        """Walks + augmentation for one start-node chunk. The RNG stream is
        keyed by (seed, epoch, episode, chunk) — independent of which worker
        runs it and of the worker count."""
        fault_point("walk.chunk", (epoch, episode, chunk))
        t0 = time.perf_counter()
        cfg = self.config
        rng = np.random.default_rng(
            [cfg.seed & 0x7FFFFFFF, epoch, episode, chunk])
        walks = self.generate_walks(starts, rng)
        pairs = walks_to_pairs(walks, cfg.window)
        dt = time.perf_counter() - t0
        counter_add("walk.chunks")
        counter_add("walk.pairs", int(pairs.shape[0]))
        observe("walk.chunk_s", dt)
        tr = _trace.tracer()
        if tr is not None:
            # one lane per worker thread: concurrent chunk spans on a shared
            # lane would render as bogus nesting in Perfetto
            end = tr.now_us()
            tr.add_span("walk_chunk",
                        "walk:" + threading.current_thread().name,
                        end - dt * 1e6, end,
                        {"epoch": epoch, "episode": episode, "chunk": chunk,
                         "pairs": int(pairs.shape[0])})
        return pairs

    def _chunk_retrying(self, epoch: int, episode: int, chunk: int,
                        starts: np.ndarray) -> np.ndarray:
        """`_chunk_pairs` under the configured retry policy. Replay is
        bitwise-identical (RNG keyed by the chunk, not the attempt)."""
        cfg = self.config
        return call_with_retry(
            self._chunk_pairs, epoch, episode, chunk, starts,
            policy=RetryPolicy(attempts=max(1, cfg.retries),
                               backoff_s=cfg.retry_backoff_s))

    def _episode_chunks(self, starts: np.ndarray) -> list[np.ndarray]:
        c = max(1, self.config.chunk_size)
        return [starts[lo: lo + c] for lo in range(0, max(starts.size, 1), c)]

    def _assemble(self, chunks: list[np.ndarray]) -> np.ndarray:
        if not chunks:
            return np.zeros((0, 2), dtype=np.int32)
        if len(chunks) == 1:
            return chunks[0]
        return np.concatenate(chunks, axis=0)

    def run_epoch(self, epoch: int) -> None:
        """Stream every episode of one epoch into the store as it completes.

        Chunks run on a ``config.workers``-thread pool (inline when 1);
        episodes are assembled and ``put`` in episode order, so a bounded
        store's backpressure paces the coordinator while workers keep
        generating up to ``lookahead`` episodes ahead.
        """
        cfg = self.config
        parts = self._episode_starts(epoch)
        if cfg.workers <= 1:
            for ep, starts in enumerate(parts):
                pairs = self._assemble(
                    [self._chunk_retrying(epoch, ep, c, s)
                     for c, s in enumerate(self._episode_chunks(starts))])
                self._put(epoch, ep, pairs)
            self.store.finish_epoch(epoch)
            return

        pool = ThreadPoolExecutor(max_workers=cfg.workers,
                                  thread_name_prefix="walk")
        futs: dict[int, list] = {}

        def submit(ep: int) -> None:
            futs[ep] = [pool.submit(self._chunk_retrying, epoch, ep, c, s)
                        for c, s in enumerate(self._episode_chunks(parts[ep]))]

        try:
            hi = min(len(parts), 1 + max(0, cfg.lookahead))
            for ep in range(hi):
                submit(ep)
            for ep in range(len(parts)):
                pairs = self._assemble([f.result() for f in futs.pop(ep)])
                if hi < len(parts):
                    submit(hi)
                    hi += 1
                # may block on store backpressure — workers keep running the
                # already-submitted lookahead chunks meanwhile
                self._put(epoch, ep, pairs)
        except BaseException:
            pool.shutdown(wait=False, cancel_futures=True)
            raise
        pool.shutdown(wait=True)
        self.store.finish_epoch(epoch)

    def _put(self, epoch: int, episode: int, pairs: np.ndarray) -> None:
        with span("store_put", "store", {"epoch": epoch, "episode": episode}):
            self.store.put(epoch, episode, pairs)

    def episode_chunk_stream(self, epoch: int, episode: int):
        """Yield ``(chunk_index, num_chunks, pairs)`` for one episode.

        The remote producer's unit of shipment: the SAME chunk decomposition
        and ``(seed, epoch, episode, chunk)`` RNG keys as ``run_epoch`` /
        ``episode_pairs``, so chunks shipped over the transport and
        assembled in chunk order are bitwise-identical to in-process
        production — and any producer can replay any episode."""
        starts = self._episode_starts(epoch)[episode]
        chunks = self._episode_chunks(starts)
        for c, s in enumerate(chunks):
            yield c, len(chunks), self._chunk_retrying(epoch, episode, c, s)

    def episode_pairs(self, epoch: int, episode: int) -> np.ndarray:
        """Regenerate one episode's pairs directly (no store interaction),
        bitwise-identical to what ``run_epoch`` puts: the chunk
        decomposition and RNG keys depend only on the config. Deterministic
        replay for corrupt-episode recovery (the pipeline's ``rewalk``)."""
        starts = self._episode_starts(epoch)[episode]
        return self._assemble(
            [self._chunk_retrying(epoch, episode, c, s)
             for c, s in enumerate(self._episode_chunks(starts))])

    # ------------------------------------------------------------ async mode
    def start_async(self, epoch: int) -> None:
        self.store.set_producer(self.alive)

        def _run():
            try:
                self.run_epoch(epoch)
            except Exception as e:
                self._errors.put(e)
                # wake any blocked store.get() so consumers fail fast rather
                # than hang (they see the epoch finished with missing episodes)
                self.store.finish_epoch(epoch)
        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def finished(self) -> bool:
        """True once the async epoch (if any) has fully completed."""
        return self._thread is None or not self._thread.is_alive()

    def alive(self) -> bool:
        """Producer-liveness probe for the store watchdogs. True while the
        async walker thread is running — or before/without one (sync use:
        no thread means the caller IS the producer, which is trivially
        alive)."""
        return self._thread is None or self._thread.is_alive()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if not self._errors.empty():
            raise self._errors.get()
