"""Metrics sink: periodic registry snapshots to ``metrics.jsonl``.

A copy of the JAX package's ``obs/sink.py`` (pure Python).
``--metrics-dir DIR`` on the serving launcher attaches a
:class:`MetricsWriter`: a daemon thread appending one JSON line per
interval — the full registry snapshot, sources included — to
``DIR/metrics.jsonl``, plus a final ``metrics_summary.json`` written at
close. The jsonl is a time series (each line carries ``ts``/``elapsed_s``);
the summary is the last word.

The writer never touches hot paths — it only *reads* the registry on its
own thread — and it swallows write errors (a full disk must not kill a
training run; the error is kept and reported at close).
"""
from __future__ import annotations

import json
import os
import threading

from .metrics import Registry


class MetricsWriter:
    def __init__(self, registry: Registry, out_dir: str,
                 interval_s: float = 5.0):
        self.registry = registry
        self.out_dir = out_dir
        self.interval_s = max(0.05, float(interval_s))
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.summary_path = os.path.join(out_dir, "metrics_summary.json")
        self.lines_written = 0
        self.last_error: str | None = None
        os.makedirs(out_dir, exist_ok=True)
        open(self.path, "w").close()       # truncate: one run, one series
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="metrics-writer",
                                        daemon=True)
        self._thread.start()

    def _write_line(self) -> None:
        try:
            snap = self.registry.snapshot()
            with open(self.path, "a") as f:
                f.write(json.dumps(snap, default=str,
                                   separators=(",", ":")) + "\n")
            self.lines_written += 1
        except Exception as e:  # noqa: BLE001 — sink errors must not kill runs
            self.last_error = f"{type(e).__name__}: {e}"

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write_line()

    def close(self) -> None:
        """Stop the thread, append one last line, write the summary."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._write_line()
        try:
            snap = self.registry.snapshot()
            snap["lines_written"] = self.lines_written
            if self.last_error:
                snap["sink_error"] = self.last_error
            with open(self.summary_path, "w") as f:
                json.dump(snap, f, indent=2, default=str)
        except Exception as e:  # noqa: BLE001
            self.last_error = f"{type(e).__name__}: {e}"
