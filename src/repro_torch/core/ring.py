"""The vertex shard's rings across ranks: ``torch.distributed`` point-to-point
sends in place of the JAX step's ``ppermute`` (``repro/core/hybrid.py``).

One process per rank; rank p sits at mesh coordinate
``NodePartition.shard_coord(p)`` (row-major over ``dims``, as
``compat.axis_flat_index`` numbers the JAX devices). A shift on axis ``a``
sends a tensor to the next rank on that ring (coordinate ``a`` plus one,
modulo its size) and receives the previous rank's into a buffer, all
transfers of one shift in one ``batch_isend_irecv``, so a sub-part's send
can run while the next sub-part trains.

Transport follows the ranks' devices, chosen before the process group
starts (:func:`backend_for`), never by catching an error:

* CPU ranks: ``gloo``, tensors sent as they are;
* CUDA ranks on distinct cards: ``nccl``, device tensors sent as they are;
* CUDA ranks that share one card (NCCL refuses two ranks on one device):
  ``gloo``, each tensor staged through a pinned host buffer.

bf16 tensors travel as their bytes (``gloo`` has no bf16 or int16).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def backend_for(device: torch.device, shared_card: bool) -> str:
    """The process-group backend for ranks on ``device``: ``gloo`` on the
    CPU and for CUDA ranks that share one card, ``nccl`` for CUDA ranks on
    distinct cards."""
    if device.type == "cuda" and not shared_card:
        return "nccl"
    return "gloo"


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


class VertexRing:
    """The shifts of one rank of a ``dims`` mesh over ``group`` (None: the
    default group), for tensors on ``device``."""

    def __init__(self, dims, rank: int, device: torch.device, group=None):
        self.dims = tuple(int(n) for n in dims)
        self.rank = rank
        self.group = group
        self.coord = tuple(int(c) for c in np.unravel_index(rank, self.dims))
        self.host_staged = (device.type == "cuda"
                            and dist.get_backend(group) == "gloo")
        self._pinned: dict = {}

    def _global(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def neighbours(self, axis: int) -> tuple[int, int]:
        """(next, previous) rank on ring ``axis``."""
        def at(step):
            c = list(self.coord)
            c[axis] = (c[axis] + step) % self.dims[axis]
            return self._global(int(np.ravel_multi_index(c, self.dims)))
        return at(1), at(-1)

    def _host(self, key, like: torch.Tensor) -> torch.Tensor:
        buf = self._pinned.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def start(self, sends, recvs, axis: int, tag: int) -> list:
        """Start the shift of ``sends`` along ring ``axis`` into ``recvs``
        (same shapes), message i tagged ``tag + i``; returns what
        :meth:`finish` takes. On a shared card the sends are copied to
        pinned host buffers first (the copy waits for the tensors' pending
        work)."""
        nxt, prv = self.neighbours(axis)
        ops, landing = [], []
        for i, (s, r) in enumerate(zip(sends, recvs)):
            if self.host_staged:
                hs = self._host(("send", tag + i), s)
                hs.copy_(s)
                hr = self._host(("recv", tag + i), r)
                landing.append((hr, r))
                s, r = hs, hr
            ops.append(dist.P2POp(dist.isend, _words(s), nxt, self.group,
                                  tag + i))
            ops.append(dist.P2POp(dist.irecv, _words(r), prv, self.group,
                                  tag + i))
        return [dist.batch_isend_irecv(ops), landing]

    @staticmethod
    def finish(pending: list) -> None:
        """Wait for started shifts; on a shared card copy what arrived from
        the host buffers into the receiving tensors."""
        for works, landing in pending:
            for w in works:
                w.wait()
            for host, dst in landing:
                dst.copy_(host)

    def all_sum(self, values) -> list[float]:
        """The float64 sum of ``values`` over every rank."""
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend(self.group) == "nccl" else "cpu")
        t = torch.tensor(list(values), dtype=torch.float64, device=dev)
        dist.all_reduce(t, group=self.group)
        return t.tolist()

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape) stacked in rank order, on the
        CPU."""
        src = t if dist.get_backend(self.group) == "nccl" else t.cpu()
        parts = [torch.empty_like(src) for _ in range(int(np.prod(self.dims)))]
        dist.all_gather([_words(p) for p in parts], _words(src.contiguous()),
                        group=self.group)
        return torch.cat([p.cpu() for p in parts])
