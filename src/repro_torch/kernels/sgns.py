"""Embedding-row kernels shared by training and serving.

This slice holds the row gather, which the two-tier retrieval scan uses to
fetch its survivors; the SGNS kernels of the JAX package's
``kernels/sgns.py`` join it with the training slice.

:func:`gather_rows` replaces the TPU kernel ``repro/kernels/sgns.py::
gather_rows`` (blocked row DMAs). Its CUDA source is
``csrc/gather_rows.cu``: one warp per output row, 16-byte loads when the
row allows. It is bound by bytes (each row read once and written once at
3.35 TB/s on an H100) and does no arithmetic; at serving sizes a launch
moves a few MB, so the launch itself is most of its time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# launches of each CUDA kernel of this module (counted where it launches)
LAUNCHES = {"gather_rows": 0}


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: (N, d) any dtype, (B,) integer ids -> (B, d)."""
    return table.index_select(0, idx.long())


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, d) table, (B,) int32 ids -> (B, d) rows in the table's dtype.

    A CUDA table goes to the kernel; a CPU table takes the plain version.
    Ids are not bounds-checked on the card (as on the TPU): the caller
    keeps them in [0, N).
    """
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("gather_rows: table must be a contiguous (N, d) "
                         f"tensor, got shape {tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.device != table.device:
        raise ValueError("gather_rows: idx must be a (B,) int32 tensor on "
                         f"{table.device}, got {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")
    idx = idx.contiguous()
    B, d = idx.shape[0], table.shape[1]
    out = torch.empty((B, d), dtype=table.dtype, device=table.device)
    if B == 0:
        return out
    lib = build.library("gather_rows")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.gather_rows(table.data_ptr(), idx.data_ptr(), B,
                             d * table.element_size(), out.data_ptr(), stream)
    build.check(rc, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out
