"""Process-wide telemetry registry: counters, gauges, bounded histograms.

A copy of the JAX package's ``obs/metrics.py`` (pure Python). One registry
serves the whole walk → store → train → serve path. Components never hold
a registry reference; they call the module-level helpers
(:func:`counter_add`, :func:`gauge_set`, :func:`observe`) at named
metrics, exactly the way fault sites call ``fault_point``. The design rule
is the one ``runtime.faults`` follows: with no registry installed every
helper is a single module-level ``None`` check — no allocation, no lock,
no dict lookup — so instrumented hot paths cost nothing until a launcher
opts in.

Three metric kinds:

* :class:`Counter` — monotonically increasing, thread-safe ``add``.
* :class:`Gauge` — last-write-wins instantaneous value (queue depth,
  resident episodes).
* :class:`Histogram` — bounded-memory distribution with **exact**
  ``count``/``sum``/``min``/``max`` always, and exact p50/p95/p99 while
  the observation count is within the reservoir capacity; past the
  capacity the percentiles come from uniform reservoir sampling
  (Vitter's Algorithm R, deterministic per-histogram RNG so two runs of
  the same stream summarize identically).

Beyond owned metrics, a registry accepts **sources**: zero-arg callables
returning a dict, polled at :meth:`Registry.snapshot` time. This is how
per-component counter surfaces (the ``MicroBatcher`` stats) surface
through the one registry without duplicated bookkeeping: the component
keeps its canonical counters and the registry reads them when asked, so
``metrics.jsonl`` sees every surface in one snapshot.
"""
from __future__ import annotations

import math
import random
import threading
import time


class Counter:
    """Monotonic counter. ``add`` is thread-safe (the GIL does not make
    ``+=`` on an attribute atomic — the read/add/store can interleave)."""

    __slots__ = ("_mu", "_value")

    def __init__(self):
        self._mu = threading.Lock()
        self._value = 0

    def add(self, n=1) -> None:
        with self._mu:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v           # single store: atomic enough for a gauge


class Histogram:
    """Bounded-memory value distribution.

    ``count``/``sum``/``min``/``max`` are exact for the whole stream.
    Percentiles are computed over a reservoir of at most ``cap`` values:
    exact (nearest-rank over every observation) while ``count <= cap``,
    and a uniform sample of the stream after that (Algorithm R — each
    observation ends up in the reservoir with probability ``cap/count``).
    The replacement RNG is seeded per-histogram, so identical observation
    streams produce identical summaries run after run.
    """

    def __init__(self, cap: int = 4096, seed: int = 0):
        assert cap >= 1
        self.cap = cap
        self._mu = threading.Lock()
        self._values: list[float] = []
        self._rng = random.Random(seed)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v) -> None:
        v = float(v)
        with self._mu:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if len(self._values) < self.cap:
                self._values.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.cap:
                    self._values[j] = v

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (the inverted-CDF definition: the
        smallest reservoir value with at least ``q``% of values at or
        below it). NaN when nothing was observed."""
        with self._mu:
            vals = sorted(self._values)
        if not vals:
            return math.nan
        idx = max(0, math.ceil(q / 100.0 * len(vals)) - 1)
        return vals[min(idx, len(vals) - 1)]

    def summary(self) -> dict:
        with self._mu:
            vals = sorted(self._values)
            count, total = self.count, self.sum
            lo, hi = self.min, self.max
        out = {"count": count, "sum": total,
               "min": (None if count == 0 else lo),
               "max": (None if count == 0 else hi),
               "mean": (total / count if count else None),
               "exact": count <= len(vals) or count == 0}
        for q, name in ((50, "p50"), (95, "p95"), (99, "p99")):
            if not vals:
                out[name] = None
            else:
                idx = max(0, math.ceil(q / 100.0 * len(vals)) - 1)
                out[name] = vals[min(idx, len(vals) - 1)]
        return out


class Registry:
    """Thread-safe name → metric map plus snapshot-time sources.

    ``counter``/``gauge``/``histogram`` are get-or-create: the first call
    at a name fixes its kind (a name reused as a different kind raises).
    ``register_source(name, fn)`` attaches a zero-arg callable returning a
    dict, polled at snapshot time — the collector hook pre-existing
    counter surfaces use to read through the registry.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self._sources: dict[str, object] = {}
        self._t0 = time.monotonic()

    def _get_or_create(self, table, name, make, kind):
        m = table.get(name)          # lock-free fast path (dict read is safe)
        if m is not None:
            return m
        with self._mu:
            for other_kind, other in (("counter", self._counters),
                                      ("gauge", self._gauges),
                                      ("histogram", self._hists)):
                if other is not table and name in other:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{other_kind}, not {kind}")
            return table.setdefault(name, make())

    def counter(self, name: str) -> Counter:
        return self._get_or_create(self._counters, name, Counter, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(self._gauges, name, Gauge, "gauge")

    def histogram(self, name: str, cap: int = 4096) -> Histogram:
        return self._get_or_create(self._hists, name,
                                   lambda: Histogram(cap=cap), "histogram")

    # ------------------------------------------------------------- sources
    def register_source(self, name: str, fn) -> None:
        """Attach a snapshot-time collector (last registration at a name
        wins — a relaunched component simply replaces its predecessor)."""
        with self._mu:
            self._sources[name] = fn

    def unregister_source(self, name: str) -> None:
        with self._mu:
            self._sources.pop(name, None)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """One JSON-serializable view of everything: owned metrics plus
        every registered source, polled now. Sources run outside the
        registry lock (they may take their component's own locks)."""
        with self._mu:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
            sources = dict(self._sources)
        snap = {
            "ts": time.time(),
            "elapsed_s": time.monotonic() - self._t0,
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.summary() for k, h in sorted(hists.items())},
        }
        src = {}
        for name, fn in sorted(sources.items()):
            try:
                src[name] = fn()
            except Exception as e:   # noqa: BLE001 — a dying component must
                src[name] = {"error": f"{type(e).__name__}: {e}"}  # not kill
        snap["sources"] = src                                      # snapshots
        return snap


# ----------------------------------------------------------------- registry
_REG: Registry | None = None


def enable(registry: Registry | None = None) -> Registry:
    """Install the process-wide registry (creating one when not given)
    and return it. Until this is called every hot-path helper is a no-op."""
    global _REG
    _REG = registry if registry is not None else Registry()
    return _REG


def disable() -> None:
    global _REG
    _REG = None


def active() -> Registry | None:
    return _REG


def enabled() -> bool:
    return _REG is not None


# ------------------------------------------------------- hot-path helpers
# The fault_point design rule: disabled == one module-level None check.
def counter_add(name: str, n=1) -> None:
    reg = _REG
    if reg is None:
        return
    reg.counter(name).add(n)


def gauge_set(name: str, v) -> None:
    reg = _REG
    if reg is None:
        return
    reg.gauge(name).set(v)


def observe(name: str, v) -> None:
    reg = _REG
    if reg is None:
        return
    reg.histogram(name).observe(v)


def register_source(name: str, fn) -> None:
    reg = _REG
    if reg is None:
        return
    reg.register_source(name, fn)


def unregister_source(name: str) -> None:
    reg = _REG
    if reg is None:
        return
    reg.unregister_source(name)
