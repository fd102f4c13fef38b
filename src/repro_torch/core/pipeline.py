"""Episode pipeline: overlap host-side walk-wait, block building and device
staging with device compute (paper §III-C, Fig. 3 stages 5/7).

A copy of the JAX package's ``core/pipeline.py``. ``EpisodePipeline`` runs
a bounded multi-stage pipeline:

    walk-wait (store.get)  ->  block-build (2D bucketing)  ->  device staging

Each stage has its own worker pool, so episode e+1's walk-wait overlaps
episode e's build which overlaps episode e-1's staging; ``depth`` bounds how
many episodes are in flight at once. Prefetches are keyed by
(epoch, episode): a ``get`` for anything not in flight falls back to a
synchronous build instead of handing back the wrong episode's blocks.
The staging stage (``HybridEmbeddingTrainer.stage_blocks``) copies on a
side stream, so it overlaps the kernels the training loop enqueues.

A torn or bit-flipped episode file (the disk store's
``CorruptEpisodeError``) is re-walked through ``rewalk`` — bitwise the
original by RNG keying — and the file repaired, instead of failing the run.
Every stage's seconds land in the ``pipeline.*_s`` histograms and, per
episode, in :meth:`EpisodePipeline.pop_times`.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.partition import NodePartition, build_episode_blocks
from repro_torch.obs import observe, span
from repro_torch.runtime import CorruptEpisodeError

# Registry histogram / trace track per pipeline stage: every _record lands
# in the process histogram too, so per-stage durations survive even when a
# caller never pops (or the bounded per-episode table evicts the entry).
_STAGE_METRIC = {"walk_wait_s": "pipeline.walk_wait_s",
                 "build_s": "pipeline.build_s",
                 "stage_s": "pipeline.stage_s"}


class EpisodePipeline:
    """Bounded multi-stage prefetcher for episode blocks.

    Parameters
    ----------
    store : SampleStore — walk-engine output, keyed (epoch, episode).
    part, pad_multiple, block_cap — block-build geometry (forwarded to
        :func:`build_episode_blocks`).
    depth : max episodes in flight (prefetched but not yet consumed).
    stage_fn : optional third-stage callable ``EpisodeBlocks -> staged``
        (``HybridEmbeddingTrainer.stage_blocks``); when None the pipeline is
        two-stage and ``get`` returns EpisodeBlocks. It may run on a stage
        worker or inline on the consumer thread (prefetch miss).
    device : the device ``stage_fn`` stages to; a CUDA device is made the
        current device of every stage worker thread.
    drop_consumed : call ``store.drop(epoch, episode)`` once the build stage
        has bucketed the pairs — with a bounded store this is what frees the
        walker's backpressure slots.
    rewalk : optional ``(epoch, episode) -> pairs`` regenerator (e.g.
        ``WalkEngine.episode_pairs``). When the store raises
        ``CorruptEpisodeError`` — a torn or bit-flipped episode file — the
        fetch stage re-walks the episode (bitwise-identical by RNG keying)
        instead of failing the run, and repairs the file via the store's
        ``rewrite`` if it has one.

    Each stage runs on one worker thread.
    """

    def __init__(self, store, part: NodePartition, *, pad_multiple: int,
                 block_cap: int | None = None, depth: int = 2,
                 stage_fn=None, device=None, drop_consumed: bool = False,
                 rewalk=None):
        self.store = store
        self.rewalk = rewalk
        self.recovered: list[tuple[int, int]] = []  # corrupt episodes re-walked
        self.part = part
        self.pad_multiple = pad_multiple
        self.block_cap = block_cap
        self.depth = max(1, depth)
        self.stage_fn = stage_fn
        self.drop_consumed = drop_consumed
        self._fetch_pool = ThreadPoolExecutor(1, thread_name_prefix="ep-fetch")
        self._build_pool = ThreadPoolExecutor(1, thread_name_prefix="ep-build")
        dev = torch.device(device) if device is not None else None
        init = None
        if dev is not None and dev.type == "cuda":
            index = (dev.index if dev.index is not None
                     else torch.cuda.current_device())
            init = lambda: torch.cuda.set_device(index)  # noqa: E731
        self._stage_pool = (ThreadPoolExecutor(1, thread_name_prefix="ep-stage",
                                               initializer=init)
                            if stage_fn is not None else None)
        self._inflight: dict[tuple[int, int], object] = {}
        self._times: dict[tuple[int, int], dict] = {}
        self._times_mu = threading.Lock()   # stage workers write concurrently
        # bound on retained per-episode timing entries: entries leave via
        # pop_times; callers that consume out of prefetch order (or never
        # pop) are covered by oldest-first eviction
        self._times_cap = max(64, 8 * self.depth)

    def _record(self, key, stage, seconds):
        observe(_STAGE_METRIC[stage], seconds)  # registry copy: never dropped
        with self._times_mu:
            self._times.setdefault(key, {})[stage] = seconds
            while len(self._times) > self._times_cap:
                self._times.pop(next(iter(self._times)))

    # ------------------------------------------------------------- stages
    def _get_pairs(self, epoch: int, episode: int):
        """store.get with corrupt-episode recovery (when ``rewalk`` is set):
        regenerate the pairs deterministically and repair the stored file."""
        try:
            return self.store.get(epoch, episode)
        except CorruptEpisodeError:
            if self.rewalk is None:
                raise
            pairs = self.rewalk(epoch, episode)
            rewrite = getattr(self.store, "rewrite", None)
            if callable(rewrite):
                rewrite(epoch, episode, pairs)
            self.recovered.append((epoch, episode))
            return pairs

    # Each stage is one helper, used by the prefetch chain and, inline, by
    # the prefetch-miss path: both record the same per-stage timings (a
    # sync-built episode is one built on the critical path).
    def _fetch(self, key, sync=False):
        t0 = time.perf_counter()
        with span("walk_wait", "walk", _span_args(key, sync)):
            pairs = self._get_pairs(*key)
        self._record(key, "walk_wait_s", time.perf_counter() - t0)
        return pairs

    def _build(self, key, pairs, sync=False):
        t0 = time.perf_counter()
        with span("build", "build", _span_args(key, sync)):
            eb = build_episode_blocks(
                np.asarray(pairs), self.part, block_cap=self.block_cap,
                pad_multiple=self.pad_multiple)
        self._record(key, "build_s", time.perf_counter() - t0)
        if self.drop_consumed:
            self.store.drop(*key)   # pairs are bucketed; free the slot
        return eb

    def _stage(self, key, eb, sync=False):
        t0 = time.perf_counter()
        with span("stage", "stage", _span_args(key, sync)):
            staged = self.stage_fn(eb)
        self._record(key, "stage_s", time.perf_counter() - t0)
        return staged

    def _build_from(self, key, fetch_fut):
        return self._build(key, fetch_fut.result())

    def _stage_from(self, key, build_fut):
        return self._stage(key, build_fut.result())

    def _build_sync(self, epoch: int, episode: int):
        """Prefetch-miss fallback: the same stages inline."""
        key = (epoch, episode)
        eb = self._build(key, self._fetch(key, True), True)
        return eb if self.stage_fn is None else self._stage(key, eb, True)

    # ---------------------------------------------------------------- API
    def prefetch(self, epoch: int, episode: int) -> bool:
        """Enqueue (epoch, episode) through the stage chain. Idempotent; a
        no-op (returns False) when already in flight or ``depth`` is full."""
        key = (epoch, episode)
        if key in self._inflight:
            return False
        if len(self._inflight) >= self.depth:
            return False
        f = self._fetch_pool.submit(self._fetch, key)
        f = self._build_pool.submit(self._build_from, key, f)
        if self._stage_pool is not None:
            f = self._stage_pool.submit(self._stage_from, key, f)
        self._inflight[key] = f
        return True

    def prefetch_window(self, epoch: int, episode: int, num_episodes: int) -> None:
        """Keep the next ``depth`` episodes of the epoch in flight."""
        for ep in range(episode, min(episode + self.depth, num_episodes)):
            self.prefetch(epoch, ep)

    def get(self, epoch: int, episode: int):
        """Returns the prefetched (staged) blocks, building synchronously on
        a miss. Asking for a key that was never prefetched leaves other
        in-flight prefetches untouched."""
        fut = self._inflight.pop((epoch, episode), None)
        if fut is not None:
            return fut.result()
        return self._build_sync(epoch, episode)

    def pop_times(self, epoch: int, episode: int) -> dict:
        """Per-stage seconds recorded for a consumed episode:
        ``walk_wait_s`` (blocked in store.get), ``build_s``, ``stage_s``
        (absent for two-stage pipelines). Entries persist until popped
        (bounded by oldest-first eviction, cap ``max(64, 8*depth)``); the
        ``pipeline.*_s`` registry histograms keep every duration regardless
        of pops."""
        with self._times_mu:
            return self._times.pop((epoch, episode), {})

    def close(self):
        """Shut down the stage workers, waiting for in-flight work: a build
        racing interpreter teardown can die inside numpy with the module
        half-unloaded. Queued-but-unstarted futures are cancelled."""
        for pool in (self._fetch_pool, self._build_pool, self._stage_pool):
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        self._inflight.clear()
        self._times.clear()


def _span_args(key, sync):
    args = {"epoch": key[0], "episode": key[1]}
    if sync:
        args["sync"] = True
    return args
