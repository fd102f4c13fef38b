"""Decoupled random-walk engine (paper §III intro + §IV-A).

A numpy copy of the JAX package's ``walk/engine.py`` (``WalkConfig`` and
``WalkEngine``, DeepWalk steps only: without the node2vec-biased step and
the remote producers' chunk stream, which the training launcher does not
use); the sample stream is bitwise the same.

The paper decouples random-walk network augmentation from embedding training:
the walk engine runs on CPUs, writes episode-partitioned samples, and the GPU
training engine consumes them. This module produces walks (vectorized numpy
DeepWalk) and hands them to a :class:`SampleStore`
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

Fault tolerance: :meth:`WalkEngine.alive` feeds the store's
producer-liveness watchdog, so a walker that dies fails consumers loudly
instead of leaving them blocked. (The JAX package also retries a failed
chunk; with no fault source in the port, a chunk is pure seeded numpy and
has nothing to retry.)
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.obs import counter_add, observe
from repro_torch.walk.augment import walks_to_pairs
from repro_torch.walk.store import SampleStore


@dataclasses.dataclass
class WalkConfig:
    walk_length: int = 10          # paper's walk distance k
    window: int = 5                # paper's walk context length l
    walks_per_node: int = 1
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
        # store=None: only ``episode_pairs`` (regeneration) is usable
        self.graph = graph
        self.config = config
        self.store = store
        self._thread: threading.Thread | None = None
        self._errors: _queue.Queue = _queue.Queue()

    # ------------------------------------------------------------------ walks
    def _step(self, cur: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """One vectorized uniform walk step."""
        g = self.graph
        deg = g.indptr[cur + 1] - g.indptr[cur]
        off = rng.integers(0, np.maximum(deg, 1))
        # clamp: dead-end nodes produce an in-bounds dummy index that the
        # final where(deg>0) mask discards
        nxt = g.indices[np.minimum(g.indptr[cur] + off, g.num_edges - 1)]
        # dead ends (deg==0) stay in place
        return np.where(deg > 0, nxt, cur)

    def generate_walks(self, starts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """(num_walks, walk_length+1) int32 walk matrix."""
        L = self.config.walk_length
        walks = np.empty((starts.size, L + 1), dtype=np.int32)
        walks[:, 0] = starts
        for t in range(L):
            walks[:, t + 1] = self._step(walks[:, t], rng)
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
        t0 = time.perf_counter()
        cfg = self.config
        rng = np.random.default_rng(
            [cfg.seed & 0x7FFFFFFF, epoch, episode, chunk])
        walks = self.generate_walks(starts, rng)
        pairs = walks_to_pairs(walks, cfg.window)
        counter_add("walk.chunks")
        counter_add("walk.pairs", int(pairs.shape[0]))
        observe("walk.chunk_s", time.perf_counter() - t0)
        return pairs

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
                    [self._chunk_pairs(epoch, ep, c, s)
                     for c, s in enumerate(self._episode_chunks(starts))])
                self.store.put(epoch, ep, pairs)
            self.store.finish_epoch(epoch)
            return

        pool = ThreadPoolExecutor(max_workers=cfg.workers,
                                  thread_name_prefix="walk")
        futs: dict[int, list] = {}

        def submit(ep: int) -> None:
            futs[ep] = [pool.submit(self._chunk_pairs, epoch, ep, c, s)
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
                self.store.put(epoch, ep, pairs)
        except BaseException:
            pool.shutdown(wait=False, cancel_futures=True)
            raise
        pool.shutdown(wait=True)
        self.store.finish_epoch(epoch)

    def episode_pairs(self, epoch: int, episode: int) -> np.ndarray:
        """Regenerate one episode's pairs directly (no store interaction),
        bitwise-identical to what ``run_epoch`` puts: the chunk
        decomposition and RNG keys depend only on the config."""
        starts = self._episode_starts(epoch)[episode]
        return self._assemble(
            [self._chunk_pairs(epoch, episode, c, s)
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
