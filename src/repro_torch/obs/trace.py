"""Span tracer emitting Chrome trace-event JSON (Perfetto-loadable).

A copy of the JAX package's ``obs/trace.py`` (pure Python): the same
events, phases and tracks, so the two packages' traces of one run line up.

The tracer renders the paper's central overlap claim — walk machines,
the sample store, and the trainer saturated *simultaneously* — as an
actual timeline: one span per pipeline-stage unit of work, each on a
named track. Load the output of ``--trace FILE`` at https://ui.perfetto.dev
(or ``chrome://tracing``) and the stage overlap is directly visible.

Tracks are logical lanes mapped onto trace-event ``tid``s inside a single
synthetic process. The canonical pipeline lanes come first, in fixed
order (``walk``, ``build``, ``stage``, ``train``, ``store``, ``serve``);
dynamic lanes (one per walk-worker thread, one per remote producer host)
are appended as they first emit. ``thread_name``/``thread_sort_index``
metadata events pin names and order so every run renders the same way.

The module-level :func:`span` helper follows the same design rule as
``fault_point`` and the metrics helpers: with no tracer installed it is a
single ``None`` check returning a shared no-op context manager — zero
allocation on disabled hot paths.

Spans record wall-clock-anchored microseconds from a monotonic clock
(``perf_counter``) relative to tracer start. The event buffer is bounded
(``max_events``); past the cap events are counted in ``dropped`` rather
than grown without bound — a trace that silently eats the heap would be
a poor observability tool.
"""
from __future__ import annotations

import json
import threading
import time

# Canonical pipeline lanes, pre-registered in this order so every trace
# renders walk→build→stage→train top-to-bottom regardless of which stage
# emits first. Dynamic lanes (walk workers, producer hosts) follow.
PIPELINE_TRACKS = ("walk", "build", "stage", "train", "store", "serve")


class Tracer:
    """Thread-safe bounded recorder of complete ("X"), instant ("i") and
    counter ("C") trace events, serialized as Chrome trace-event JSON."""

    def __init__(self, max_events: int = 1_000_000):
        self.max_events = max_events
        self.dropped = 0
        self._mu = threading.Lock()
        self._events: list[tuple] = []      # (ph, name, track, ts_us, dur_us, args)
        self._tracks: dict[str, int] = {}
        self._t0 = time.perf_counter()
        for t in PIPELINE_TRACKS:
            self._tracks[t] = len(self._tracks) + 1

    # ------------------------------------------------------------ plumbing
    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks.setdefault(track, len(self._tracks) + 1)
        return tid

    def _push(self, ev: tuple) -> None:
        with self._mu:
            self._tid(ev[2])        # first emit on a dynamic lane names it
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    # ------------------------------------------------------------- emitters
    def add_span(self, name: str, track: str, t0_us: float, t1_us: float,
                 args: dict | None = None) -> None:
        """Record a complete span with explicit endpoints (in tracer
        microseconds, see :meth:`now_us`) — for spans whose start was
        observed before the duration was known (e.g. first-chunk to
        last-chunk arrival of a remote episode)."""
        self._push(("X", name, track, t0_us, max(0.0, t1_us - t0_us), args))

    def span(self, name: str, track: str = "train",
             args: dict | None = None) -> "_Span":
        return _Span(self, name, track, args)

    def instant(self, name: str, track: str = "train",
                args: dict | None = None) -> None:
        self._push(("i", name, track, self.now_us(), 0.0, args))

    def counter(self, name: str, value) -> None:
        """Counter-track sample: Perfetto renders these as a value-over-
        time graph (store residency, serve queue depth)."""
        self._push(("C", name, name, self.now_us(), 0.0, {"value": value}))

    # ---------------------------------------------------------------- output
    def event_count(self) -> int:
        with self._mu:
            return len(self._events)

    def to_json(self) -> dict:
        with self._mu:
            events = list(self._events)
            tracks = dict(self._tracks)
        out = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
                "args": {"name": "repro pipeline"}}]
        for track, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            out.append({"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                        "args": {"name": track}})
            out.append({"ph": "M", "pid": 1, "tid": tid,
                        "name": "thread_sort_index",
                        "args": {"sort_index": tid}})
        for ph, name, track, ts, dur, args in events:
            ev = {"ph": ph, "pid": 1, "tid": tracks.get(track, 0),
                  "name": name, "ts": ts}
            if ph == "X":
                ev["dur"] = dur
            elif ph == "i":
                ev["s"] = "t"            # instant scope: thread
            if args:
                ev["args"] = args
            out.append(ev)
        meta = {"dropped_events": self.dropped}
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": meta}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


class _Span:
    """Context manager recording one complete event on exit."""

    __slots__ = ("_tr", "_name", "_track", "_args", "_t0")

    def __init__(self, tracer, name, track, args):
        self._tr = tracer
        self._name = name
        self._track = track
        self._args = args

    def __enter__(self):
        self._t0 = self._tr.now_us()
        return self

    def __exit__(self, *exc):
        self._tr.add_span(self._name, self._track, self._t0,
                          self._tr.now_us(), self._args)
        return False


class _NoopSpan:
    """Shared do-nothing context manager returned by the module-level
    helpers when no tracer is installed — one instance for the whole
    process, so a disabled ``with span(...)`` allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()

# --------------------------------------------------------------- module state
_TRACER: Tracer | None = None


def set_tracer(tracer: Tracer | None) -> None:
    global _TRACER
    _TRACER = tracer


def tracer() -> Tracer | None:
    return _TRACER


# ------------------------------------------------------- hot-path helpers
# Same rule as fault_point / metrics: disabled == one None check.
def span(name: str, track: str = "train", args: dict | None = None):
    tr = _TRACER
    if tr is None:
        return _NOOP
    return _Span(tr, name, track, args)


def instant(name: str, track: str = "train", args: dict | None = None) -> None:
    tr = _TRACER
    if tr is None:
        return
    tr.instant(name, track, args)


def trace_counter(name: str, value) -> None:
    tr = _TRACER
    if tr is None:
        return
    tr.counter(name, value)
