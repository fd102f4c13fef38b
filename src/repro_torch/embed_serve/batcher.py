"""Async micro-batching request frontend for embedding retrieval.

A copy of the JAX package's ``embed_serve/batcher.py`` (pure Python) on
the port's copies of ``obs`` and ``runtime``.

Single-query requests are individually tiny (one (d,) vector) while the
top-k kernel's cost is dominated by the per-batch table scan, so serving
heavy traffic means coalescing: requests enter a bounded queue, a worker
thread (the single-worker pattern of the episode pipeline) collects them
until either the batch-window deadline or the max batch size hits, pads
the stacked queries to ``pad_multiple`` rows (or to ``max_batch`` with
``fixed_batch``), runs the backend once, and resolves each request's
future with its own row of the result.

Backpressure is the queue bound: ``submit`` blocks when the queue is full,
so an over-driven client slows to the serve rate instead of ballooning
memory. Exceptions from the backend propagate to every future of the
failed batch; ``close()`` serves everything already queued before the
worker exits (drain, don't drop).

Overload control (``runtime``): ``deadline_ms`` stamps every request at
admission and expires it with ``DeadlineExceeded`` — instead of serving
it — once the stamp passes (a request never hangs past its deadline: it is
either served, expired, or shed). ``shed_on_full=True`` turns the full-
queue block into an immediate ``Overloaded`` raise, the admission-control
mode for latency-sensitive serving. When the backend returns a third
element (``ShardedEmbeddingStore.topk(return_meta=True)``'s ``TopKMeta``),
it is attached to every request of the batch, so callers see degraded
responses tagged as such.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from repro_torch.obs import (gauge_set, observe, register_source, span,
                             trace_counter, unregister_source)
from repro_torch.runtime import DeadlineExceeded, Overloaded

_CLOSE = object()


@dataclasses.dataclass
class BatcherStats:
    """Coalescing + overload counters. ``shed`` is bumped by submitter
    threads, the rest by the worker — ALL under the batcher's stats lock,
    and readers should take a consistent :meth:`MicroBatcher.stats_snapshot`
    rather than reading fields off the live object mid-flight."""

    requests: int = 0
    batches: int = 0
    padded_rows: int = 0
    shed: int = 0         # rejected at admission (queue full, shed_on_full)
    expired: int = 0      # deadline passed before the batch ran
    degraded: int = 0     # requests answered from a degraded (partial) scan

    @property
    def mean_batch(self) -> float:
        return self.requests / self.batches if self.batches else 0.0


class MicroBatcher:
    """Batches single-query requests into backend calls.

    serve_fn: ``(B, d) float32 -> (vals (B, k), ids (B, k))`` — typically
    ``lambda q: store.topk(q, k)``. Each ``submit((d,) vector)`` returns a
    ``concurrent.futures.Future`` resolving to that query's
    ``(vals (k,), ids (k,))``.
    """

    def __init__(self, serve_fn, dim: int, *, max_batch: int = 256,
                 window_ms: float = 2.0, pad_multiple: int = 8,
                 queue_cap: int = 4096, fixed_batch: bool = False,
                 deadline_ms: float | None = None,
                 shed_on_full: bool = False):
        """fixed_batch=True pads every backend call to max_batch rows, so a
        jitted (shape-specialized) backend compiles exactly one batch shape
        instead of one per first-seen multiple of pad_multiple — the right
        mode for compiled serving (warm up with one max_batch call).
        deadline_ms gives every request a per-request deadline from the
        moment of admission: a request still queued when it expires fails
        with DeadlineExceeded instead of being served late. shed_on_full
        makes a full queue raise Overloaded at submit instead of blocking
        (admission control instead of backpressure)."""
        assert max_batch >= 1 and pad_multiple >= 1 and queue_cap >= 1
        self._serve_fn = serve_fn
        self._dim = dim
        self._max_batch = max_batch
        self._window_s = window_ms / 1e3
        self._pad = max_batch if fixed_batch else pad_multiple
        self._deadline_s = None if deadline_ms is None else deadline_ms / 1e3
        self._shed_on_full = shed_on_full
        self._queue = queue.Queue(maxsize=queue_cap)
        self._closed = False
        self._drained = False       # close() finished its cancel-drain
        self.stats = BatcherStats()
        self._stats_mu = threading.Lock()   # guards EVERY stats field
        self._thread = threading.Thread(target=self._worker,
                                        name="embed-serve-batcher",
                                        daemon=True)
        self._thread.start()
        # BatcherStats over the registry: the canonical counters live here
        # (under _stats_mu); the registry polls them at snapshot time, so
        # metrics.jsonl / diagnostics see the same numbers stats_snapshot
        # callers do, without a second set of books
        register_source("serve.batcher", self._stats_source)

    def _stats_source(self) -> dict:
        s = self.stats_snapshot()
        d = dataclasses.asdict(s)
        d["mean_batch"] = s.mean_batch
        d["queue_depth"] = self._queue.qsize()
        return d

    # ---------------------------------------------------------------- API
    def submit(self, query) -> Future:
        """Enqueue one (d,) query; blocks when the queue is full (or, with
        ``shed_on_full``, raises Overloaded instead of blocking)."""
        q = np.asarray(query, dtype=np.float32)
        if q.shape != (self._dim,):
            raise ValueError(f"query shape {q.shape} != ({self._dim},)")
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        fut = Future()
        t_sub = time.perf_counter()
        dl = (None if self._deadline_s is None
              else t_sub + self._deadline_s)
        if self._shed_on_full:
            try:
                self._queue.put_nowait((q, fut, dl, t_sub))
            except queue.Full:
                with self._stats_mu:
                    self.stats.shed += 1
                raise Overloaded(
                    f"queue full ({self._queue.maxsize}); request shed"
                ) from None
        else:
            self._queue.put((q, fut, dl, t_sub))
        depth = self._queue.qsize()
        gauge_set("serve.queue_depth", depth)
        trace_counter("serve.queue_depth", depth)
        # a close() racing the check above either drains this item (worker
        # backlog or close's cancel loop) or already finished draining —
        # `_drained` was set before that final drain, so seeing it here
        # means nobody will ever pop the queue again: cancel, don't strand
        if self._drained:
            fut.cancel()
        return fut

    def close(self) -> None:
        """Stop accepting requests, serve the backlog, join the worker.

        Always synchronous: a no-wait variant cannot uphold both the
        serve-the-backlog guarantee and the no-stranded-future guarantee
        (the worker may finish its drain before a racing submit's put
        lands), so one isn't offered."""
        if self._closed:
            return
        self._closed = True
        unregister_source("serve.batcher")
        self._queue.put(_CLOSE)
        self._thread.join()
        # a submit() that raced close() past the closed check would
        # otherwise hang its caller: cancel, don't strand. `_drained`
        # goes up BEFORE the drain so a put landing after the final
        # get_nowait sees it and self-cancels (see submit).
        self._drained = True
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _CLOSE:
                item[1].cancel()

    def stats_snapshot(self) -> BatcherStats:
        """A consistent copy of the counters. The live ``stats`` object is
        written by the worker and submitter threads under ``_stats_mu``;
        reading its fields individually can observe a torn update (e.g.
        ``requests`` from batch N+1 with ``batches`` from batch N, skewing
        ``mean_batch``). Readers take the snapshot instead."""
        with self._stats_mu:
            return dataclasses.replace(self.stats)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker
    def _worker(self):
        while True:
            item = self._queue.get()
            if item is _CLOSE:
                self._drain()
                return
            batch = [item]
            deadline = time.perf_counter() + self._window_s
            closing = False
            while len(batch) < self._max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _CLOSE:
                    closing = True
                    break
                batch.append(nxt)
            self._run(batch)
            if closing:
                self._drain()
                return

    def _drain(self):
        """Serve whatever was queued before the close sentinel."""
        batch = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _CLOSE:
                continue
            batch.append(item)
            if len(batch) == self._max_batch:
                self._run(batch)
                batch = []
        if batch:
            self._run(batch)

    def _run(self, batch):
        # expire first: a request whose deadline passed while queued gets
        # DeadlineExceeded, never a late answer
        now = time.perf_counter()
        live = []
        for q, fut, dl, t_sub in batch:
            if dl is not None and now > dl:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(DeadlineExceeded(
                        f"request expired {now - dl:.3f}s past its "
                        f"deadline before serving"))
                    with self._stats_mu:
                        self.stats.expired += 1
                continue
            if fut.set_running_or_notify_cancel():
                live.append((q, fut, t_sub))
        if not live:
            return
        qs = np.stack([q for q, _, _ in live])
        B = qs.shape[0]
        Bp = -(-B // self._pad) * self._pad
        if Bp > B:                      # pad rows: results are discarded
            qs = np.concatenate(
                [qs, np.zeros((Bp - B, self._dim), qs.dtype)])
        try:
            with span("serve_batch", "serve", {"batch": B, "padded": Bp}):
                out = self._serve_fn(qs)
        except Exception as e:          # noqa: BLE001 — propagate to callers
            for _, fut, _ in live:
                fut.set_exception(e)
            return
        # backend returns (vals, ids) or (vals, ids, meta) — a degraded-scan
        # tag (TopKMeta) is attached to every request of the batch
        meta = out[2] if len(out) == 3 else None
        vals, ids = out[0], out[1]
        t_done = time.perf_counter()
        for i, (_, fut, t_sub) in enumerate(live):
            row = (np.asarray(vals[i]), np.asarray(ids[i]))
            fut.set_result(row if meta is None else row + (meta,))
            observe("serve.request_s", t_done - t_sub)  # admission -> served
        with self._stats_mu:
            self.stats.requests += B
            self.stats.batches += 1
            self.stats.padded_rows += Bp - B
            if meta is not None and getattr(meta, "degraded", False):
                self.stats.degraded += len(live)


def drive_open_loop(batcher: MicroBatcher, queries, *, qps: float = 0.0,
                    timeout: float = 600.0):
    """Drive a query stream through a batcher open-loop, measuring each
    request from just before its submit (queue backpressure included) to
    future resolution. qps > 0 paces submissions on a fixed schedule;
    qps = 0 bursts. The launcher's load generator, the same definition as
    the JAX package's, so their reported percentiles mean the same thing.

    Returns (results, latencies_s, wall_s) — all in submission order."""
    n = len(queries)
    futs = [None] * n
    lat = [None] * n           # distinct slots: no lock needed under GIL

    def make_cb(i, t_sub):
        def cb(_fut):
            lat[i] = time.perf_counter() - t_sub
        return cb

    interval = 1.0 / qps if qps > 0 else 0.0
    t_start = time.perf_counter()
    for i in range(n):
        if interval:
            delay = t_start + i * interval - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        t_sub = time.perf_counter()
        fut = batcher.submit(queries[i])
        fut.add_done_callback(make_cb(i, t_sub))
        futs[i] = fut
    results = [f.result(timeout=timeout) for f in futs]
    wall = time.perf_counter() - t_start
    # Future.result() wakes BEFORE done-callbacks run (CPython notifies
    # waiters first), so the last slots may still be None for an instant
    deadline = time.perf_counter() + 10.0
    while any(v is None for v in lat):
        if time.perf_counter() > deadline:
            raise RuntimeError("latency callbacks did not complete")
        time.sleep(0.0005)
    return results, lat, wall
