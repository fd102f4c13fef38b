"""Two-tier quantized retrieval: int8 first-pass scan + exact f32 rescore.

Counterpart of the JAX package's ``embed_serve/quant.py``. A symmetric
per-row int8 copy of each shard is scanned first (a quarter of the f32
bytes), keeping an over-fetched top-``m`` per query
(``m = ceil(k * overfetch)``); only the survivors' full-precision rows are
gathered back (``kernels.sgns.gather_rows``) and re-scored exactly. When
the candidate set holds the true top-k, the result equals the numpy oracle
exactly; the launcher's ``--check-recall`` gate checks that every run.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.embed_serve import topk as tk
from repro_torch.kernels import sgns as _k

INT8_QMAX = 127          # symmetric: values in [-127, 127]
DEFAULT_OVERFETCH = 4.0  # m = ceil(k * overfetch) tier-one survivors
_QUANT_CHUNK_ROWS = 1 << 20


def quantize_rows(table: torch.Tensor):
    """Symmetric per-row int8 quantization of a (N, d) table.

    Returns ``(q (N, d) int8, scale (N,) f32)`` on the table's device with
    ``scale_r = max|row_r| / 127`` (1.0 for an all-zero row) and
    ``q = clip(round_half_even(row / scale_r), -127, 127)``, computed in
    f32 exactly as the JAX package's numpy version does, so the two agree
    bitwise. bf16 rows are widened to f32 first (exact). Rows are done in
    chunks, so a large table is never widened whole.
    """
    N, d = table.shape
    q = torch.empty((N, d), dtype=torch.int8, device=table.device)
    scale = torch.empty((N,), dtype=torch.float32, device=table.device)
    for lo in range(0, N, _QUANT_CHUNK_ROWS):
        x = table[lo:lo + _QUANT_CHUNK_ROWS].float()
        amax = x.abs().amax(dim=1)
        sc = torch.where(amax > 0, amax / INT8_QMAX, torch.ones_like(amax))
        q[lo:lo + _QUANT_CHUNK_ROWS] = torch.round(x / sc[:, None]).clamp_(
            -INT8_QMAX, INT8_QMAX).to(torch.int8)
        scale[lo:lo + _QUANT_CHUNK_ROWS] = sc
    return q, scale


def dequantize_rows(q, scale) -> np.ndarray:
    """(N, d) int8 + (N,) f32 scales -> the (N, d) f32 reconstruction."""
    return (torch.as_tensor(q).float()
            * torch.as_tensor(scale).float()[:, None]).cpu().numpy()


def overfetch_m(k: int, overfetch: float, n_rows: int) -> int:
    """Tier-one candidate count: ceil(k * overfetch), at least k, clamped
    to the shard's rows (at m == n_rows the scan is exhaustive-exact)."""
    return max(1, min(max(k, math.ceil(k * overfetch)), n_rows))


def rescore_exact(table, queries, cand_idx, k: int, *, plain: bool = False):
    """Tier two: gather the surviving rows, re-score in f32, re-rank.

    table: the (N, d) full-precision shard; queries: (Q, d) f32;
    cand_idx: (Q, m) shard-local ids from the first pass (sentinel slots
    allowed: they gather row 0 but score -inf). The gather is the row
    kernel on the card and its plain version on the CPU (or anywhere, with
    ``plain``); the scores are an elementwise f32 product summed over d,
    which no TF32 setting touches. Returns ((Q, k) f32, (Q, k) i32).
    """
    Q, m = cand_idx.shape
    d = table.shape[1]
    idx = cand_idx.int()
    sentinel = idx == tk.IDX_SENTINEL
    safe = torch.where(sentinel, torch.zeros_like(idx), idx).reshape(-1)
    gather = _k.gather_rows_plain if plain else _k.gather_rows
    rows = gather(table, safe.contiguous()).reshape(Q, m, d).float()
    scores = (queries.float()[:, None, :] * rows).sum(dim=2)
    scores = torch.where(sentinel, torch.full_like(scores, tk.NEG_INF), scores)
    return tk.select_topk(scores, idx, k)


def topk_mips_quant_rescored(table, qtable, scales, queries, k: int, *,
                             overfetch: float = DEFAULT_OVERFETCH,
                             valid: int | None = None, plain: bool = False):
    """The full two-tier shard scan: int8 top-m, exact rescore to top-k.

    table and (qtable, scales) cover the same rows in the same order;
    ``valid`` masks rows past the shard's real ones in both tiers. Kernels
    or plain versions follow the tensors' device; ``plain`` runs the plain
    versions on any device (the store's ``quant_xla`` route).
    """
    n_rows = qtable.shape[0] if valid is None else valid
    m = overfetch_m(k, overfetch, n_rows)
    scan = tk.topk_mips_quant_plain if plain else tk.topk_mips_quant
    _, ci = scan(qtable, scales, queries, m, valid)
    return rescore_exact(table, queries, ci, k, plain=plain)
