"""Deterministic fault-injection registry.

A copy of the JAX package's ``runtime/faults.py`` (pure Python), with the
same spec grammar and the same firing rules, so one ``--inject`` spec
fires on the same invocations in both packages.

Stages declare named **fault sites** by calling :func:`fault_point`. In
the port so far that is ``serve.shard``, inside each shard's scan task of
the degraded-mode store; the training sites come with the training
launcher's ``--inject``. A :class:`FaultPlan` installed via
:func:`install_plan` (or the :func:`inject` context manager, or the
serving launcher's ``--inject`` flag) decides deterministically whether
that invocation crashes (:class:`~repro_torch.runtime.errors.InjectedFault`),
sleeps, or asks the caller to corrupt its output.

Determinism: a spec fires on the N-th invocation of its site
(``at=N``, a per-site counter) and/or on an exact invocation key match
(``key=...``), never on wall-clock or randomness, so a failure path
replays identically run after run.

Hot-path cost: with no plan installed ``fault_point`` is one module-level
``None`` check.

Spec string grammar (the CLI's ``--inject`` and ``FaultSpec.parse``)::

    site:kind[:opt=val]...
    kinds:  crash | delay | corrupt | fire
    opts:   at=N           fire on the N-th invocation of site (0-based)
            key=a/b/c      fire only when the invocation key == (a, b, c);
                           a trailing "/*" prefix-matches instead, e.g.
                           key=walker-0/* fires on that host's first
                           matching invocation whatever the rest of the key
                           (racy assignments stay killable deterministically)
            times=N|inf    firings before the spec is spent (default 1)
            delay=SECONDS  sleep length for kind=delay (default 0.05)

    walk.chunk:crash:at=5          crash the 6th chunk walked
    train.episode:crash:key=6/1    die right before training episode (6, 1)
    serve.shard:delay:key=1:delay=0.5:times=inf   shard 1 is always slow
    disk.write:corrupt:at=0        corrupt the first episode file written
    net.drop:fire:at=2             the 3rd frame sent vanishes on the wire
    net.disconnect:fire:at=5       the transport closes mid-conversation

``corrupt`` and ``fire`` are mechanically identical — the fault point
returns True and the CALLER implements the behaviour. ``corrupt`` names the
torn-output sites; ``fire`` is the generic signal used by sites whose
behaviour isn't a corruption (the ``net.*`` transport sites: the transport
drops / duplicates / reorders the frame or closes the socket when its site
fires, in the JAX package's transport).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

from repro_torch.runtime.errors import InjectedFault

KINDS = ("crash", "delay", "corrupt", "fire")

#: canonical site names (informative, not enforced — new subsystems add
#: sites freely; tests use ad-hoc names). The ``net.*`` sites live inside
#: the episode transport's send path (keyed by the frame's message key);
#: ``producer.episode`` fires at the top of a remote producer's episode
#: loop, keyed by (host, epoch, episode) so a chaos plan can kill one
#: specific producer host.
SITES = ("walk.chunk", "store.put", "disk.write", "train.episode",
         "serve.shard", "net.drop", "net.delay", "net.duplicate",
         "net.reorder", "net.disconnect", "producer.episode")


def _key_str(key) -> str | None:
    if key is None:
        return None
    if isinstance(key, (tuple, list)):
        return "/".join(str(k) for k in key)
    return str(key)


@dataclasses.dataclass
class FaultSpec:
    """One deterministic fault: fire ``kind`` at ``site`` when the
    invocation ordinal and/or key match."""

    site: str
    kind: str
    at: int | None = None       # per-site invocation ordinal (0-based)
    key: str | None = None      # "/"-joined invocation key to match
    times: float = 1            # firings before spent (float("inf") = always)
    delay_s: float = 0.05

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.at is None and self.key is None:
            # neither ordinal nor key: fire on every invocation (bounded
            # by `times`, which defaults to 1 = first invocation only)
            self.at = 0 if self.times == 1 else None

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        parts = spec.split(":")
        if len(parts) < 2:
            raise ValueError(f"fault spec {spec!r}: want site:kind[:opt=val]")
        site, kind, kw = parts[0], parts[1], {}
        for opt in parts[2:]:
            if "=" not in opt:
                raise ValueError(f"fault spec option {opt!r}: want opt=val")
            name, val = opt.split("=", 1)
            if name == "at":
                kw["at"] = int(val)
            elif name == "key":
                kw["key"] = val
            elif name == "times":
                kw["times"] = float("inf") if val == "inf" else int(val)
            elif name == "delay":
                kw["delay_s"] = float(val)
            else:
                raise ValueError(f"fault spec {spec!r}: unknown option "
                                 f"{name!r} (at/key/times/delay)")
        return cls(site, kind, **kw)

    def matches(self, ordinal: int, key_s: str | None) -> bool:
        if self.times <= 0:
            return False
        if self.at is not None and ordinal != self.at:
            return False
        if self.key is not None:
            if self.key.endswith("/*"):
                if key_s is None or not key_s.startswith(self.key[:-1]):
                    return False
            elif key_s != self.key:
                return False
        return True


class FaultPlan:
    """A set of :class:`FaultSpec`\\ s plus per-site invocation counters.

    Thread-safe: fault points fire from walk workers, pipeline stages and
    serving threads concurrently; the counter handshake is locked so an
    ``at=N`` spec fires exactly once even under races."""

    def __init__(self, specs=()):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec.parse(s)
                      for s in specs]
        self._counts: dict[str, int] = {}
        self._fired: list[tuple[str, str, object]] = []   # (site, kind, key)
        self._mu = threading.Lock()

    @property
    def fired(self) -> list:
        """(site, kind, key) log of every spec firing, in firing order."""
        with self._mu:
            return list(self._fired)

    def count(self, site: str) -> int:
        with self._mu:
            return self._counts.get(site, 0)

    def check(self, site: str, key=None) -> bool:
        """Advance ``site``'s counter; fire matching specs. Returns True if
        a ``corrupt`` or ``fire`` spec fired; raises/sleeps for
        crash/delay."""
        key_s = _key_str(key)
        with self._mu:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            todo = []
            for s in self.specs:
                if s.site == site and s.matches(n, key_s):
                    s.times -= 1
                    self._fired.append((site, s.kind, key))
                    todo.append(s)
        corrupt = False
        for s in todo:                     # outside the lock: may sleep/raise
            if s.kind == "delay":
                time.sleep(s.delay_s)
            elif s.kind in ("corrupt", "fire"):
                corrupt = True
            else:
                raise InjectedFault(site, key)
        return corrupt


# ------------------------------------------------------------------ registry
_PLAN: FaultPlan | None = None


def install_plan(plan: FaultPlan | None) -> None:
    """Install the process-wide plan (None = clear)."""
    global _PLAN
    _PLAN = plan


def clear_plan() -> None:
    install_plan(None)


def active_plan() -> FaultPlan | None:
    return _PLAN


def fault_point(site: str, key=None) -> bool:
    """Declare a fault site. No plan installed → immediate False (the
    no-op hot path). Returns True when a ``corrupt`` or ``fire`` spec
    fired; a ``crash`` spec raises :class:`InjectedFault`; ``delay``
    sleeps."""
    plan = _PLAN
    if plan is None:
        return False
    return plan.check(site, key)


@contextlib.contextmanager
def inject(*specs):
    """Scoped plan installation for tests::

        with inject("walk.chunk:crash:at=2") as plan:
            ...
        assert plan.fired
    """
    plan = FaultPlan(specs)
    prev = _PLAN
    install_plan(plan)
    try:
        yield plan
    finally:
        install_plan(prev)
