"""Episode pipeline: overlap host-side walk-wait, block building and device
staging with device compute (paper §III-C, Fig. 3 stages 5/7).

A copy of the JAX package's ``core/pipeline.py`` without its corrupt-
episode re-walk (the memory store never raises one). ``EpisodePipeline``
runs a bounded multi-stage pipeline:

    walk-wait (store.get)  ->  block-build (2D bucketing)  ->  device staging

Each stage has its own worker pool, so episode e+1's walk-wait overlaps
episode e's build which overlaps episode e-1's staging; ``depth`` bounds how
many episodes are in flight at once. Prefetches are keyed by
(epoch, episode): a ``get`` for anything not in flight falls back to a
synchronous build instead of handing back the wrong episode's blocks.
The staging stage (``HybridEmbeddingTrainer.stage_blocks``) copies on a
side stream, so it overlaps the kernels the training loop enqueues.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.partition import NodePartition, build_episode_blocks
from repro_torch.obs import observe, span

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

    Each stage runs on one worker thread.
    """

    def __init__(self, store, part: NodePartition, *, pad_multiple: int,
                 block_cap: int | None = None, depth: int = 2,
                 stage_fn=None, device=None, drop_consumed: bool = False):
        self.store = store
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

    # ------------------------------------------------------------- stages
    def _fetch(self, key):
        t0 = time.perf_counter()
        with span("walk_wait", "walk", {"epoch": key[0], "episode": key[1]}):
            pairs = self.store.get(*key)
        observe(_STAGE_METRIC["walk_wait_s"], time.perf_counter() - t0)
        return pairs

    def _build(self, key, pairs):
        t0 = time.perf_counter()
        with span("build", "build", {"epoch": key[0], "episode": key[1]}):
            eb = build_episode_blocks(
                np.asarray(pairs), self.part, block_cap=self.block_cap,
                pad_multiple=self.pad_multiple)
        observe(_STAGE_METRIC["build_s"], time.perf_counter() - t0)
        if self.drop_consumed:
            self.store.drop(*key)   # pairs are bucketed; free the slot
        return eb

    def _stage(self, key, eb):
        t0 = time.perf_counter()
        with span("stage", "stage", {"epoch": key[0], "episode": key[1]}):
            staged = self.stage_fn(eb)
        observe(_STAGE_METRIC["stage_s"], time.perf_counter() - t0)
        return staged

    def _build_from(self, key, fetch_fut):
        return self._build(key, fetch_fut.result())

    def _stage_from(self, key, build_fut):
        return self._stage(key, build_fut.result())

    def _build_sync(self, epoch: int, episode: int):
        """Prefetch-miss fallback: the same stages inline."""
        key = (epoch, episode)
        eb = self._build(key, self._fetch(key))
        return eb if self.stage_fn is None else self._stage(key, eb)

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

    def close(self):
        """Shut down the stage workers, waiting for in-flight work: a build
        racing interpreter teardown can die inside numpy with the module
        half-unloaded. Queued-but-unstarted futures are cancelled."""
        for pool in (self._fetch_pool, self._build_pool, self._stage_pool):
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        self._inflight.clear()
