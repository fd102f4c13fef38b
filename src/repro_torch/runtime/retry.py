"""Bounded retry with exponential backoff, jitter, and elapsed caps.

A copy of the JAX package's ``runtime/retry.py`` (pure Python): the same
backoff schedule, the same seeded jitter stream and the same
``max_elapsed_s`` rule, so a policy retries identically in both packages.

The walk engine keys every chunk's RNG stream by
``(seed, epoch, episode, chunk)``, so replaying a failed unit of work
produces bitwise-identical output — retry is semantics-preserving by
construction. This module is the one retry-loop implementation, so attempt
accounting and backoff behave the same at every call site.

``jitter`` spreads each delay by a deterministic-seedable fraction (seed it
from the host name: replayable per host, decorrelated across hosts), so
producers that notice one outage together do not reconnect in lockstep.
``max_elapsed_s`` turns "retry N times" into "retry for a grace window",
and ``attempts=None`` makes the window the only bound.
"""
from __future__ import annotations

import dataclasses
import random
import time


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` total tries (1 = no retry; ``None`` = unbounded, cap
    with ``max_elapsed_s``); backoff before try i is
    ``backoff_s * mult**(i-1)`` seconds, clamped to ``max_backoff_s`` and
    spread by ``±jitter`` (a fraction of the delay, deterministic per
    ``delays(seed=...)``). ``max_elapsed_s`` stops retrying — the last
    error re-raises — once that many seconds have passed since the first
    try."""

    attempts: int | None = 3
    backoff_s: float = 0.05
    mult: float = 2.0
    max_backoff_s: float | None = None
    jitter: float = 0.0
    max_elapsed_s: float | None = None
    retry_on: tuple = (Exception,)

    def delays(self, seed: int | None = None):
        """Yield the backoff delay before each retry. With ``jitter`` the
        stream is randomized but fully determined by ``seed`` — two
        producers seeded differently desynchronize, one producer replays
        identically."""
        rng = random.Random(seed) if self.jitter else None
        d = self.backoff_s
        i = 0
        while self.attempts is None or i < max(0, self.attempts - 1):
            delay = d if self.max_backoff_s is None \
                else min(d, self.max_backoff_s)
            if rng is not None:
                delay *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
            yield max(0.0, delay)
            d *= self.mult
            i += 1


def call_with_retry(fn, *args, policy: RetryPolicy = RetryPolicy(),
                    on_retry=None, seed: int | None = None, **kwargs):
    """Run ``fn(*args, **kwargs)``, retrying per ``policy``.

    ``on_retry(attempt, exc)`` is called before each backoff sleep (attempt
    is the 1-based number of the try that just failed) — callers log there.
    ``seed`` feeds the jitter stream (see :meth:`RetryPolicy.delays`).
    The final failure re-raises the last exception unchanged, so callers
    see the real error, not a wrapper — whether attempts ran out or the
    ``max_elapsed_s`` window closed."""
    delays = policy.delays(seed=seed)
    t0 = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:  # noqa: PERF203 — the retry loop
            if policy.attempts is not None and attempt >= max(1, policy.attempts):
                raise
            if (policy.max_elapsed_s is not None
                    and time.monotonic() - t0 >= policy.max_elapsed_s):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(next(delays, policy.backoff_s))
