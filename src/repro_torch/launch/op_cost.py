"""Per-rank operations, bytes, memory and collective bytes of one step,
counted while it runs on tensors without storage.

The port's counterpart of the JAX package's ``launch/hlo_cost.py``, which
reads them off a compiled per-device HLO module. Here the step runs once
as one rank of its mesh on tensors without storage (the ``meta`` device:
shapes and dtypes, nothing allocated, nothing launched) and
:class:`OpCost`, a dispatch mode, sees every aten op it issues, the
backward's included:

* **operations**: 2 x M x N x K per matrix product, by PyTorch's own
  formulas (``torch.utils.flop_counter``), the rule ``hlo_cost`` applies to
  each ``dot``; an op without a formula that decomposes is counted through
  its parts. A CUDA kernel of the port given such tensors launches nothing
  and reports its own work (``kernels/build.py::traced``): #11 2 (hd +
  hd_v) per valid (query, key) pair, #7 6BSd + 4Bd.
* **bytes**: each op's operands and results, once each, and each kernel's
  own bytes. Nothing is fused, so the sum is an upper bound on what the
  card moves. Views, allocations and collectives move no bytes here.
* **memory**: the step's arguments are what the rank holds before it; its
  temp bytes are the peak, over the step, of the storage its ops made on
  the traced device and that is still referenced (a storage is freed when
  its last tensor goes, as the caching allocator frees it); its output
  bytes the new storage its results hold.
* **collectives**: the bytes this rank sends, by kind and by group
  (``collectives.py``'s ``COLLECTIVES`` and ``GROUP_BYTES``: the same
  counts the card's run keeps).

Loops are not special: every iteration runs, so no trip count is needed.
"""
from __future__ import annotations

import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import build
from repro_torch import collectives

_aten = torch.ops.aten
_DEVICE = torch.ops.prim.device.default
# aten ops seen not to decompose
_LEAVES: set = set()
# ops that allocate without moving bytes
_NO_BYTES = {_aten.empty, _aten.empty_strided, _aten.empty_like,
             _aten.new_empty, _aten.new_empty_strided}


def _flat(xs, out: list) -> list:
    """The tensors of ``xs`` and of the tuples, lists and dicts in it, at
    any depth (an op's arguments or results; a step's, whose caches are a
    list subclass)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _flat(x, out)
        elif isinstance(x, dict):
            _flat(x.values(), out)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class OpCost(TorchDispatchMode):
    """Counts operations, bytes and the live storage on the ``meta``
    device of everything run under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: dict = {}     # kernel -> {"calls", "flops", "bytes"}
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()   # storage -> bytes it made

    # ------------------------------------------------------------ memory
    def hold(self, tree) -> None:
        """Mark the storage of ``tree``'s tensors as held before the step
        (not counted in its temp bytes)."""
        for t in _flat((tree,), []):
            self._seen[t.untyped_storage()] = 0

    def _made(self, outs) -> None:
        for t in outs:
            if not t.is_meta:
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, n)

    def _freed(self, n: int) -> None:
        self.live -= n

    def new_bytes(self, tree) -> int:
        """The bytes of the storage that ``tree``'s tensors hold and the
        step made."""
        sts = {id(t.untyped_storage()): t.untyped_storage()
               for t in _flat((tree,), [])}
        return sum(self._seen.get(st, 0) for st in sts.values())

    # ------------------------------------------------------------- counts
    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def __enter__(self):
        self._sink, build.TRACE_SINK = build.TRACE_SINK, self.kernel
        return super().__enter__()

    def __exit__(self, *exc):
        build.TRACE_SINK = self._sink
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _DEVICE:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        aten = func.namespace == "aten"
        if formula is None and aten and packet not in _LEAVES:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            _LEAVES.add(packet)
        out = func(*args, **kwargs)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = _flat((out,), [])
        if aten and not func.is_view and packet not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in _flat(args, []))
            self.bytes += sum(_nbytes(t) for t in _flat(kwargs.values(), []))
            self.bytes += sum(_nbytes(t) for t in outs)
        self._made(outs)
        return out


def analyze(fn, args, *, held=()) -> dict:
    """Run ``fn(*args)`` once (on ``meta`` arguments; ``held``: other
    tensors the step reads, held before it) under :class:`OpCost`;
    returns ``{"flops", "bytes", "kernels", "temp_bytes", "output_bytes",
    "collectives" (bytes by kind and "total"), "groups" ({(kind, ranks):
    bytes}), "trace_s"}``."""
    collectives.reset_counts()
    t0 = time.perf_counter()
    with OpCost() as oc:
        oc.hold((args, held))
        out = fn(*args)
        output_bytes = oc.new_bytes(out)
    trace_s = time.perf_counter() - t0
    coll = dict(collectives.COLLECTIVES["by_kind"])
    coll["total"] = sum(coll.values())
    return {"flops": oc.flops, "bytes": oc.bytes, "kernels": oc.kernels,
            "temp_bytes": oc.peak, "output_bytes": output_bytes,
            "collectives": coll, "groups": dict(collectives.GROUP_BYTES),
            "trace_s": trace_s}
