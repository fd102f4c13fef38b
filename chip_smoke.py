#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

It imports nothing of JAX. Phases, each printing its own lines; any
failure ends the run with a non-zero exit:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build of every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (all sources compiled in parallel),
   with each kernel's registers and spills (``NO_SPILL``'s must have none);
2. every serving kernel against its plain PyTorch version on the card:
   integer tables (bitwise) at the JAX tests' shapes and at the full width
   d = 128 (the rowwise ``topk_rowwise`` on every case of the
   scan, and over many chunks with ties across their edges), then a
   seeded continuous 26,250,000 x 128 bf16 table (one
   card's share of the paper's 1.05 B nodes over 40 GPUs) served through
   ``ShardedEmbeddingStore.topk``, exact and int8, checked at recall 1.0
   against the plain scan; the exact and int8 scans' tensor-core scores
   (their test-only export) within a quarter of their error bound on the
   first 1,048,576 rows and on adversarial rows, and the share of pairs
   each filter passes on to the exact score; kernel, plain and library
   times beside the bound (the gather also with a warm L2; for both scans the bf16 tensor-core and bytes
   bounds they run at, the f32 CUDA-core one beside them), and both scans
   at the launcher's batch shape (1,048,576 rows, 8 queries) beside
   ``torch.topk``, and with those 8 padded by zero queries to the 256 rows
   the launcher sends, with the int8 scan's survivor share there;
3. the serving main path: a seeded 1,048,576 x 128 bf16 checkpoint written
   with the port's ``save_checkpoint``; every serving kernel against its
   plain version on that table and the launcher's own queries, at the
   shapes the launcher gives it, the rowwise kernel (#4) also bit for
   bit against the scan, and timed, with the split between its score and
   selection kernels; then the checkpoint served by
   ``repro_torch.launch.embed_serve.main`` at recall 1.0, exact and int8,
   with every kernel's launch count read around the two runs;
4. the SGNS kernels (``sgns_fused_update``, ``sgns_fused_grads``,
   ``sgns_grads``) against their plain versions at f32 and bf16, with
   heavy duplicates, an odd B and one index per table, at the JAX kernel
   tests' tolerances, and each run twice for bitwise repeatability; the
   bf16 tables also to within two bf16 steps of plain, so that no row's
   update can go missing, and ``sgns_fused_grads`` bitwise against
   ``sgns_grads`` on the rows it gathers; the row kernels of the unfused
   routes (``scatter_add_rows``, its row-wise reference, and
   ``gather_rows_rowwise``) bitwise against their plain versions and the
   blocked kernels bitwise against their row-wise references (the gather
   also at every vector width, from bases off 16-byte alignment, and past
   one wave of blocks), the scatter also over several
   position chunks with a 100-position hub run, for each kernel's own
   chunk size (the row-wise scatter also checked to launch one kernel per
   chunk and nothing else); one ``ops.sgns_step`` per kernel route against
   the ``ref`` route (the same composition, plain);
5. the per-card training shape: vertex and context tables of 26,250,000 x
   128 f32 (26.9 GB, made on the card from a seed) installed in the
   trainer, 4 sub-parts of 8,192-pair blocks of Zipf(1.1)-skewed ids,
   minibatch 256, 5 negatives from a 65,536-row pool; the kernels against
   their plain versions on one minibatch (on a compact copy of the rows it
   touches, and the full-table launch bitwise against that copy), a few
   episodes timed per route (edges/s) and one of each kernel route under
   the profiler, and one launch of each kernel timed beside its bound,
   its plain version and its library call; ``sgns_fused_update``,
   ``sgns_grads`` and ``sgns_fused_grads`` checked to be one device kernel
   per call, the last bitwise the second on its gathered rows; the launch
   floor (a one-element ``fill_``) beside ``gather_rows`` at this shape;
6. the kernels past the shapes they refused before (after every check
   that counts a call's kernels with the profiler, timed with CUDA
   events): #1, #2 and #4 bitwise against plain at d = 1, 100, 300 and
   1,000 on a 20,000-row table read padded to a multiple of 8 columns
   (each filter's scores within a quarter of their bound at every width),
   #1 and #2 at k = 8,000 and #4 at k = 1,500; ``sgns_fused_update`` past
   the on-chip sort's geometry (B = 1,041, 2,048, 8,192 at d = 64 and
   S = 16, and B + S > 16,384: one block an SM, the grid-wide sort) and
   ``sgns_fused_update``, ``sgns_fused_grads`` and ``sgns_grads`` with
   negatives too wide for a tile's shared memory ((d, S) = (512, 128),
   (128, 500): staged in chunks; (16,000, 3): the chunks' workspace in
   device memory), f32 and bf16, against plain at SGNS_TOL (the raw
   gradients also within the f32 summation bound of their products) and
   twice bitwise; each timed beside its plain version and bound;
7. the training main path: ``repro_torch.launch.train.main`` on the CI
   gate schedule at d = 128 (an SBM graph, AUC >= 0.62) and at the
   config's geometry (a 262,144-node power-law graph, minibatch 256, 5
   negatives, f32), the second run's checkpoint served by the serving
   launcher at recall 1.0; then the same launcher on ``--impl pallas`` and
   ``--impl pallas_fused`` on the CI gate and on ``--impl pallas`` at the
   config's geometry, served at recall 1.0; the CI gate at ``--dim 100``
   (a width the scans read padded), its checkpoint served at recall 1.0;
   the launch counts read around each run;
8. the paper's rings on two ranks sharing the card (``gloo``, each
   sub-part staged through pinned host memory, one process a rank started
   with the ``torchrun`` variables): the training launcher on the CI gate
   schedule, its AUC no more than 0.04 below the JAX launcher's on two
   devices (``REF_TWO_DEVICE_AUC``); then one episode (1,200 nodes x 128,
   k = 2) from two ``pallas_fused2`` ranks on the card against two plain
   CPU ranks on the same blocks and negatives, f32 and bf16, at SGNS_TOL,
   and its wall time beside one rank's; the ranks' launch counts summed;
9. the serving launcher's other legs on the phase-3 checkpoint, each a
   path with its own counts: ``--impl rowwise``, ``--quant int8
   --hot-rows 120``, the 3-shard chaos leg (shard 1 delayed past a 150 ms
   deadline, ``--expect-degraded``, recall against the surviving shards)
   and ``--metrics-dir`` + ``--trace`` (the files and the trace's
   ``serve_batch`` spans checked);
10. the flash-attention kernel (``flash_attention``, TPU kernel #11)
   against ``mha_plain`` on the card, f32 and bf16, at the five shapes of
   the JAX package's ``tests/test_flash_attention.py``, a case with rows
   that have no valid key, hd 128 and hd 8 with ragged tiles, and
   granite-3-2b's prefill (B = 4, H = 32, Hkv = 8, S = 2048, hd = 64;
   causal, and with a 512-key window) on the (B, S, H, hd) views the model
   passes; then timed at that prefill shape beside its bound (f32 CUDA
   cores and 3xTF32 tensor cores), ``mha_plain`` and PyTorch's
   ``scaled_dot_product_attention``, with the device kernels of one call
   of each;
11. the LM serving main path: ``repro_torch.launch.serve.main`` for
   granite-3-2b at full width (``--no-reduced``), batch 4, a 2,048-token
   prompt and 32 tokens, with exactly one flash launch per layer (40) and
   no masked prefill; then granite at full width and 2 layers, its
   prefill logits on the kernel route against the masked plain route
   within 2e-3;
12. a JSON line of per-kernel results (launches per path), the card's line,
   and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
SLEEP_CYCLES = 10_000_000          # a GPU sleep of about 5 ms (~1.98 GHz)
SERVE_ROWS = 26_250_000            # 1.05 B nodes over 40 GPUs, per card
CKPT_ROWS = 1 << 20
DIM = 128                          # configs/tencent_embedding.py
BATCH, K, BATCHES = 256, 10, 4
SGNS_TOL = {"float32": (2e-4, 1e-6), "bfloat16": (3e-2, 3e-3)}
CI_GATE = ["--graph-kind", "sbm", "--nodes", "1200", "--epochs", "12",
           "--episodes", "3", "--dim", "128", "--subparts", "2",
           "--minibatch", "32", "--negatives", "8", "--neg-pool", "2048",
           "--walk-workers", "2", "--pipeline-depth", "2",
           "--ckpt-every", "12", "--min-auc", "0.62"]
CONFIG_RUN = ["--graph-kind", "powerlaw", "--nodes", "262144", "--epochs",
              "1", "--episodes", "4", "--dim", "128", "--subparts", "4",
              "--minibatch", "256", "--negatives", "5", "--neg-pool",
              "65536", "--dtype", "float32"]
# flash attention: tests/test_flash_attention.py's tolerances (rtol, atol)
FLASH_TOL = {"float32": (2e-4, 2e-5), "bfloat16": (2e-2, 2e-2)}
# granite-3-2b's prefill at the LM path's batch and prompt
LM_B, LM_S, LM_TOKENS = 4, 2048, 32
FLASH_CASES = [  # B, H, Hkv, Sq, Skv, hd, causal, window
    (2, 4, 4, 64, 64, 32, True, 0), (1, 4, 2, 64, 128, 32, True, 0),
    (2, 2, 2, 96, 96, 16, True, 24), (1, 2, 1, 64, 64, 64, False, 0),
    (1, 8, 8, 128, 128, 8, True, 0),
    (1, 2, 1, 64, 32, 16, True, 8),      # rows 39.. have no valid key
    (2, 4, 2, 201, 77, 128, False, 0),   # hd 128 and 8, ragged tiles
    (1, 8, 4, 257, 257, 8, True, 0),
    (LM_B, 32, 8, LM_S, LM_S, 64, True, 0),
    (LM_B, 32, 8, LM_S, LM_S, 64, True, 512),
]
LM_ARGV = ["--arch", "granite-3-2b", "--no-reduced", "--batch", str(LM_B),
           "--prompt-len", str(LM_S), "--tokens", str(LM_TOKENS),
           "--device", "cuda"]
BF16_FLOP_PER_S = 989e12           # H100 SXM, dense bf16 tensor cores
TF32_FLOP_PER_S = 495e12           # H100 SXM, dense TF32 tensor cores
# kernels (mangled-name parts) that must not spill registers: #2's int8
# filter and export instantiations, #5's and #6's cooperative kernel and
# #3's gather
NO_SPILL = ("filter_kernelIa", "filter_export_kernelIa", "sgns_grads_coop",
            "gather_kernel")
# the kernels each kernel route of ops.sgns_step launches
ROUTE_KERNELS = {"pallas_fused2": ("sgns_fused_update",),
                 "pallas_fused": ("sgns_fused_grads", "scatter_add_rows"),
                 "pallas": ("gather_rows", "sgns_grads", "scatter_add_rows")}


def ptxas_report(log: str):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    entry function in an ``nvcc -Xptxas -v`` log."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            # drop the anonymous namespace's mangled name
            ns = re.match(r"_ZN(\d+)", name)
            short = name[ns.end() + int(ns.group(1)):] if ns else name
            out.append((short.lstrip("0123456789"), int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return out


def warm_kernel_ms(torch, fn, name_part, reps=40):
    """Device ms of the kernels whose name holds ``name_part`` over ``reps``
    calls of ``fn`` back to back under the profiler, L2 warm (each call
    finds what the last one read); None when the profiler kept none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if str(e.device_type).endswith("CUDA") and name_part in e.key]
    return sum(us) / len(us) / 1e3 if us else None


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def sgns_bound(B, S, d, uniq_rows, out_rows):
    """Least time of one SGNS minibatch on an H100: each of the
    ``uniq_rows`` distinct f32 rows the minibatch touches read once,
    ``out_rows`` rows written once, the indices and mask read once;
    6BSd + 4Bd operations at the f32 rate."""
    nbytes = uniq_rows * d * 4 + out_rows * d * 4 + (3 * B + S) * 4
    return bound_ms(nbytes, 6.0 * B * S * d + 4.0 * B * d)


def bf16_steps_off(torch, got, want, before):
    """Where a bf16 table updated by the kernel differs from the plain
    version's by more than the last bits allow. The two sum each row's
    gradients in another order, so their f32 totals may round to bf16
    updates one step apart, and the new rows to values one step apart (two
    across a power of two); a dropped or doubled update moves a row by
    more. A step is the spacing of bf16 values at that magnitude."""
    def step(x):
        s = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
        return torch.where(x == 0, torch.zeros_like(x), s)
    got, want, before = got.float(), want.float(), before.float()
    diff = (got - want).abs()
    return diff > 2 * step(want) + step(want - before)


def sgns_inputs(torch, dev, dtype, B, S, d, case, seed):
    """Numpy-seeded (vert, ctx, idx_v, idx_c, idx_n, mask) for the SGNS
    kernels: ``dup`` repeats ids, ``odd`` uses row 0, ``same`` one id a
    table; the mask in the tables' dtype, as the trainer passes it."""
    rng = np.random.default_rng(seed)
    Nv, Nc = max(70, B // 2), max(90, B // 2)
    iv = rng.integers(0, Nv, B).astype(np.int32)
    ic = rng.integers(0, Nc, B).astype(np.int32)
    inn = rng.integers(0, Nc, S).astype(np.int32)
    mask = (rng.random(B) > 0.15).astype(np.float32)
    if case == "dup":
        iv[::3], ic[::4], inn[0] = 3, 5, 5
    elif case == "odd":
        iv[0] = 0
    elif case == "same":
        iv[:], ic[:], inn[:], mask[:] = 7, 9, 9, 1.0
    tdt = getattr(torch, dtype)
    tables = [torch.from_numpy(rng.normal(0, 0.1, (n, d)).astype(
        np.float32)).to(dev, tdt) for n in (Nv, Nc)]
    return (*tables, *(torch.from_numpy(a).to(dev) for a in (iv, ic, inn)),
            torch.from_numpy(mask).to(dev, tdt))


def sgns_close(torch, err, name, got, want, rtol, atol, what, slack=0.0):
    """Fail unless |got - want| <= atol + rtol |want| (+ ``slack``)
    everywhere; keep the largest difference in err[name]."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs() + slack
    if bad.any():
        raise AssertionError(f"{name} {what}: kernel != plain at "
                             f"{int(bad.sum())} elements (max |diff| "
                             f"{diff.max().item():.3g})")
    err[name] = max(err[name], diff.max().item())


def check_sgns_kernels(torch, sgns, dev, err):
    """Both SGNS kernels against their plain versions, and twice against
    themselves, on numpy-seeded inputs. Returns the number of cases."""
    cases = 0

    def inputs(dtype, B, S, d, case, seed):
        return sgns_inputs(torch, dev, dtype, B, S, d, case, seed)

    def close(name, got, want, rtol, atol, what):
        sgns_close(torch, err, name, got, want, rtol, atol, what)

    for dtype in ("float32", "bfloat16"):
        for case, B, S, d in (("nodup", 64, 8, 64), ("dup", 64, 8, 64),
                              ("odd", 37, 4, 32), ("same", 128, 8, 32),
                              ("dup", 32, 8, DIM), ("dup", 256, 5, DIM)):
            what = f"{dtype} {case} B={B} S={S} d={d}"
            rtol, atol = SGNS_TOL[dtype]
            if case == "same" and dtype == "float32":
                rtol, atol = 1e-3, 1e-5   # a 128-term f32 sum reassociated
            x = inputs(dtype, B, S, d, case, seed=B + S + d)
            runs = [sgns.sgns_fused_update(x[0].clone(), x[1].clone(),
                                           *x[2:], 0.05) for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"sgns_fused_update {what}: two runs "
                                     f"differ")
            want = sgns.sgns_fused_update_plain(x[0].clone(), x[1].clone(),
                                                *x[2:], 0.05)
            close("sgns_fused_update", runs[0][2], want[2], 1e-4, 0.0,
                  f"{what} loss")
            for got_t, want_t, before in zip(runs[0][:2], want[:2], x[:2]):
                close("sgns_fused_update", got_t, want_t, rtol, atol, what)
                if dtype == "bfloat16":
                    off = bf16_steps_off(torch, got_t, want_t, before)
                    if off.any():
                        raise AssertionError(
                            f"sgns_fused_update {what}: {int(off.sum())} "
                            f"elements more than two bf16 steps from plain")
            runs = [sgns.sgns_fused_grads(*x) for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"sgns_fused_grads {what}: two runs "
                                     f"differ")
            want = sgns.sgns_fused_grads_plain(*x)
            close("sgns_fused_grads", runs[0][0], want[0], 1e-4, 0.0,
                  f"{what} loss")
            g_rtol, g_atol = ((1e-4, 1e-6) if dtype == "float32"
                              else SGNS_TOL[dtype])
            for got_t, want_t in zip(runs[0][1:], want[1:]):
                close("sgns_fused_grads", got_t, want_t, g_rtol, g_atol,
                      what)
            # one kernel on the same rows: bitwise #5 on the gathered rows
            rows = (x[0][x[2].long()], x[1][x[3].long()], x[1][x[4].long()])
            five = sgns.sgns_grads(*rows, x[5])
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(runs[0], five)):
                raise AssertionError(f"sgns_fused_grads {what}: != "
                                     f"sgns_grads on the gathered rows")
            cases += 1
    return cases


# the fused update past the on-chip sort's geometry (B, S, d): past one
# block an SM, at the reference's gate shape (tests/test_kernels.py:303),
# and past FUSED_SORT_CAP context positions
ANY_B_CASES = ((1041, 5, 128), (2048, 5, 128), (8192, 16, 64),
               (16400, 16, 64))
# negatives too wide for a tile's shared memory (B, S, d); the last with
# rows too wide for one row and one negative: the workspace in device
# memory
WIDE_NEG_CASES = ((256, 128, 512), (256, 500, 128), (16, 3, 16000))


def sum_bound(torch, terms_abs, n):
    """2 gamma_n T: how far two f32 sums of the same n products (fmaf or
    not, in any order) may lie apart, T their absolute sum (each within
    gamma_n T = n u / (1 - n u) T of the exact sum, u = 2^-24)."""
    u = 2.0 ** -24
    return 2 * n * u / (1 - n * u) * terms_abs


def check_any_shape_sgns(torch, sgns, dev, err, time_ms=None):
    """#7 at ANY_B_CASES (one block an SM striding over the tiles, the
    grid-wide sort) and #5, #6 and #7 at WIDE_NEG_CASES (the negatives
    staged in chunks), f32 and bf16, with repeated ids: against their plain
    versions at SGNS_TOL, twice for bitwise repeatability, the bf16 tables
    also within two bf16 steps, #6 bitwise #5 on its gathered rows. With
    ``time_ms``, each f32 case's kernel and plain device ms; returns
    {(kernel, B, S, d): (ms, plain_ms)} (empty without it). #5's and #6's
    raw gradients sum S + 1 (dv) or B (dn) products: past a few terms two
    f32 orders differ by more than SGNS_TOL's atol wherever the sum
    cancels, so there the bound also admits :func:`sum_bound` of the
    products' absolute sum (computed from the rows in f64)."""
    sms = sgns._sm_count(dev)
    times = {}

    def close(name, got, want, rtol, atol, what, slack=0.0):
        sgns_close(torch, err, name, got, want, rtol, atol, what, slack)

    def twice(name, fn, what):
        runs = [fn() for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"{name} {what}: two runs differ")
        return runs[0]

    for dtype in ("float32", "bfloat16"):
        rtol, atol = SGNS_TOL[dtype]
        for B, S, d in ANY_B_CASES + WIDE_NEG_CASES:
            what = f"{dtype} B={B} S={S} d={d}"
            x = sgns_inputs(torch, dev, dtype, B, S, d, "dup", seed=B + S + d)
            plan = sgns.plan_fused_update(B, S, d, sm_count=sms)
            wide = (B, S, d) in WIDE_NEG_CASES
            if (plan.chunk > 0) != wide or (
                    not wide and plan.sort_chunk == 0):
                raise AssertionError(f"sgns_fused_update {what}: plan {plan} "
                                     f"is not the path this case is for")
            got = twice("sgns_fused_update", lambda: sgns.sgns_fused_update(
                x[0].clone(), x[1].clone(), *x[2:], 0.05), what)
            want = sgns.sgns_fused_update_plain(x[0].clone(), x[1].clone(),
                                                *x[2:], 0.05)
            close("sgns_fused_update", got[2], want[2], 1e-4, 0.0,
                  f"{what} loss")
            for got_t, want_t, before in zip(got[:2], want[:2], x[:2]):
                close("sgns_fused_update", got_t, want_t, rtol, atol, what)
                if dtype == "bfloat16" and bf16_steps_off(
                        torch, got_t, want_t, before).any():
                    raise AssertionError(f"sgns_fused_update {what}: more "
                                         f"than two bf16 steps from plain")
            names = ["sgns_fused_update"]
            if wide:
                rows = (x[0][x[2].long()], x[1][x[3].long()],
                        x[1][x[4].long()])
                # each gradient's products' absolute sums, bounded in f64
                # with |g_pos|, |g_neg| <= m
                m64 = x[5].double()[:, None]
                v64, c64, n64 = (r.double().abs() for r in rows)
                slack = {"loss": 0.0, "dc": 0.0,
                         "dv": sum_bound(torch, m64 * (c64 + n64.sum(0)),
                                         S + 1),
                         "dn": sum_bound(torch, (m64 * v64).sum(0).expand(
                             S, d), B)}
                six = twice("sgns_fused_grads",
                            lambda: sgns.sgns_fused_grads(*x), what)
                want = sgns.sgns_fused_grads_plain(*x)
                close("sgns_fused_grads", six[0], want[0], 1e-4, 0.0,
                      f"{what} loss")
                for label, got_t, want_t in zip(("dv", "dc", "dn"), six[1:],
                                                want[1:]):
                    close("sgns_fused_grads", got_t, want_t, rtol, atol,
                          f"{what} {label}", slack[label])
                five = twice("sgns_grads",
                             lambda: sgns.sgns_grads(*rows, x[5]), what)
                if not all(torch.equal(a, b) for a, b in zip(six, five)):
                    raise AssertionError(f"sgns_fused_grads {what}: != "
                                         f"sgns_grads on the gathered rows")
                for label, got_t, want_t in zip(
                        ("loss", "dv", "dc", "dn"), five,
                        sgns.sgns_grads_plain(*rows, x[5])):
                    close("sgns_grads", got_t, want_t, rtol, atol,
                          f"{what} {label}", slack[label])
                names += ["sgns_fused_grads", "sgns_grads"]
            print(f"  {what}: {', '.join(names)} == plain; fused plan "
                  f"blocks={plan.blocks} tile rows={plan.bb} negatives a "
                  f"chunk={plan.chunk or S} sort chunk={plan.sort_chunk} "
                  f"work floats={plan.work_floats}")
            if time_ms is None or dtype != "float32":
                continue
            vc, cc = x[0].clone(), x[1].clone()
            calls = {"sgns_fused_update": (
                lambda: sgns.sgns_fused_update(vc, cc, *x[2:], 0.05),
                lambda: sgns.sgns_fused_update_plain(vc, cc, *x[2:], 0.05))}
            if wide:
                calls["sgns_fused_grads"] = (
                    lambda: sgns.sgns_fused_grads(*x),
                    lambda: sgns.sgns_fused_grads_plain(*x))
                calls["sgns_grads"] = (lambda: sgns.sgns_grads(*rows, x[5]),
                                       lambda: sgns.sgns_grads_plain(
                                           *rows, x[5]))
            uv = x[2].unique().numel()
            uc = torch.cat([x[3], x[4]]).unique().numel()
            for name, (kern, plain) in calls.items():
                # #7 reads and writes the unique rows; #5 and #6 read the
                # unique rows and write 2B + S gradient rows
                bound = sgns_bound(B, S, d, uv + uc,
                                   uv + uc if name == "sgns_fused_update"
                                   else 2 * B + S)
                ms = (time_ms(kern, 10), time_ms(plain, 5))
                times[(name, B, S, d)] = (*ms, bound)
                print(f"    {name} f32 B={B} S={S} d={d}: {ms[0]:.4f} ms "
                      f"(CUDA events), plain {ms[1]:.4f} ms, bound "
                      f"{bound[0]:.6f} ms ({bound[1]})")
    return times


# widths and depths the serving scans take past their compiled widths
WIDE_DIMS = (1, 100, 300, 1000)
WIDE_ROWS = 20_000
DEEP_K = {"topk_scan_exact": 8000, "topk_scan_int8": 8000,
          "topk_rowwise": 1500}


def check_wide_scans(torch, tk, quantize_rows, dev, err, time_ms=None, *,
                     dims=WIDE_DIMS, deep=True):
    """#1, #2 and #4 at d in WIDE_DIMS (a 20,000-row f32 table, its int8
    copy, 256 queries of which the last is zero, so every row ties at 0)
    bitwise against their plain versions, the kernels reading the table
    padded to a multiple of 8 columns (``tk.pad_columns``), the plain
    versions the real columns; at d = 128, #1 and #2 at k = 8,000 and #4 at
    k = 1,500; each filter's tensor-core scores within a quarter of their
    bound at every width. With ``time_ms``, each kernel's and plain
    version's device ms; returns {(kernel, d, k): (ms, plain_ms)}."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    times = {}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        (gv, gi), (wv, wi) = got, want
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            bad = (gi != wi).any(dim=1).nonzero()[:3].flatten().tolist()
            raise AssertionError(f"{name} {what}: != plain (queries {bad})")

    def ratio(tbl, qq, name, what):
        a, eps = tk.topk_filter_bounds(tbl, qq)
        exact = qq @ tbl.float().T
        r = ((a - exact).abs() / eps).nan_to_num(0.0).max().item()
        if not r <= 0.25:
            raise AssertionError(f"{name} filter {what}: |a - s| reaches "
                                 f"{r:.3g} eps (limit 0.25)")
        return r

    cases = [(d, 10) for d in dims] + [(DIM, None)] * deep
    for d, k in cases:
        table = torch.randn((WIDE_ROWS, d), generator=g, device=dev)
        q = torch.randn((BATCH, d), generator=g, device=dev)
        q[-1] = 0.0
        q8, sc = quantize_rows(table)
        pt, p8 = tk.pad_columns(table), tk.pad_columns(q8)
        runs = {
            "topk_scan_exact": (lambda kk: tk.topk_mips(pt, q, kk),
                                lambda kk: tk.topk_mips_plain(table, q, kk)),
            "topk_scan_int8": (
                lambda kk: tk.topk_mips_quant(p8, sc, q, kk),
                lambda kk: tk.topk_mips_quant_plain(q8, sc, q, kk)),
            "topk_rowwise": (lambda kk: tk.topk_mips_rowwise(pt, q, kk),
                             lambda kk: tk.topk_mips_rowwise_plain(
                                 table, q, kk))}
        for name, (kern, plain) in runs.items():
            kk = k or DEEP_K[name]
            what = f"d={d} k={kk}"
            same(name, kern(kk), plain(kk), what)
            if time_ms is not None:
                item = 1 if name == "topk_scan_int8" else 4
                bound = bound_ms(WIDE_ROWS * (d * item + 4 * (item == 1))
                                 + BATCH * d * 4 + BATCH * kk * 8,
                                 2.0 * BATCH * WIDE_ROWS * d)
                # the deep lists run for seconds: one call
                ms = (time_ms(lambda: kern(kk), 5 if k else 1),
                      time_ms(lambda: plain(kk), 3 if k else 1))
                times[(name, d, kk)] = (*ms, bound)
                print(f"    {name} {WIDE_ROWS} x {d} Q={BATCH} k={kk}: "
                      f"{ms[0]:.4f} ms (CUDA events), plain {ms[1]:.4f} "
                      f"ms, bound {bound[0]:.5f} ms ({bound[1]}, f32 rate)")
        if k is None:
            print(f"  d={d}: #1, #2 at k={DEEP_K['topk_scan_exact']} and #4 "
                  f"at k={DEEP_K['topk_rowwise']} == plain, {WIDE_ROWS} rows")
            continue
        rows = torch.cat([table[:4096], torch.zeros((64, d), device=dev),
                          q[:64] * 3.0])
        r1 = ratio(rows, q[:64], "topk_scan_exact", f"d={d}")
        r1b = ratio(rows.bfloat16(), q[:64], "topk_scan_exact",
                    f"d={d} bf16")
        r2 = ratio(q8[:4096], q[:64], "topk_scan_int8", f"d={d}")
        print(f"  d={d}: #1, #2, #4 == plain at k={k} on {WIDE_ROWS} rows; "
              f"filter |a - s| / eps {max(r1, r1b):.4g} (exact), {r2:.4g} "
              f"(int8); limit 0.25")
    return times


def check_route_kernels(torch, sgns, ops, dev, err, call_kernels):
    """The kernels of the unfused routes against their plain versions and
    the blocked row kernels against their row-wise references, on
    numpy-seeded inputs at the JAX tests' shapes and at d = 128; then one
    ``ops.sgns_step`` per kernel route against the ``ref`` route on the
    same tensors. Returns the number of cases."""
    cases = 0

    def same(name, got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: != reference (max |diff| "
                                 f"{(got.float() - want.float()).abs().max()})")

    def normal(rng, shape, std, dtype):
        return torch.from_numpy(rng.normal(0, std, shape).astype(
            np.float32)).to(dev, dtype)

    # sgns_grads (#5): rows gathered beforehand, the mask in f32 and in
    # the rows' dtype; test_kernels.py's tolerances, bitwise run to run
    for dtype in (torch.float32, torch.bfloat16):
        for B, d, S in ((128, 128, 16), (256, 64, 8), (512, 256, 32),
                        (64, 32, 4), (37, DIM, 5), (32, DIM, 8),
                        (256, DIM, 5)):
            rng = np.random.default_rng(B + d + S)
            x = [normal(rng, shape, 0.3, dtype)
                 for shape in ((B, d), (B, d), (S, d))]
            mask = torch.from_numpy((rng.random(B) > 0.2).astype(
                np.float32)).to(dev)
            for m in (mask, mask.to(dtype)):
                what = f"{dtype} B={B} S={S} d={d} mask {m.dtype}"
                runs = [sgns.sgns_grads(*x, m) for _ in range(2)]
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(*runs)):
                    raise AssertionError(f"sgns_grads {what}: two runs "
                                         f"differ")
                want = sgns.sgns_grads_plain(*x, m)
                diff = (runs[0][0] - want[0]).abs().item()
                if diff > 3e-5 + 3e-5 * want[0].abs().item():
                    raise AssertionError(f"sgns_grads {what}: loss off by "
                                         f"{diff}")
                rtol, atol = ((1e-4, 1e-5) if dtype == torch.float32
                              else SGNS_TOL["bfloat16"])
                for g, w in zip(runs[0][1:], want[1:]):
                    dd = (g.float() - w.float()).abs()
                    if (dd > atol + rtol * w.float().abs()).any():
                        raise AssertionError(f"sgns_grads {what}: kernel != "
                                             f"plain (max {dd.max()})")
                    err["sgns_grads"] = max(err["sgns_grads"], dd.max().item())
                cases += 1

    # scatter_add_rows (#9) == plain == scatter_add_rows_rowwise (#10),
    # bitwise: no duplicates, one index, runs within and across 8-row
    # blocks; upd in f32 (as the routes pass it) or the table's dtype; the
    # CI gate's B = 32 vertex and B + S = 40 context scatters at d = 128
    for dtype, upd_dtype in ((torch.float32, torch.float32),
                             (torch.bfloat16, torch.float32),
                             (torch.bfloat16, torch.bfloat16)):
        for case, N, B, d in (("nodup", 40, 32, 64), ("same", 40, 30, 64),
                              ("dup", 40, 30, 64), ("dup", 90, 32, DIM),
                              ("dup", 90, 40, DIM), ("dup", 90, 261, DIM),
                              ("dup", 5, 77, 20)):
            rng = np.random.default_rng(N + B + d)
            if case == "nodup":
                idx = rng.permutation(N)[:B]
            elif case == "same":
                idx = np.full(B, 3)
            else:
                idx = rng.integers(0, N, B)
                idx[::7] = 1
                idx[1:24:8] = idx[2:25:8] = idx[3:26:8] = 2
            idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
            table = normal(rng, (N, d), 1.0, dtype)
            upd = normal(rng, (B, d), 3e-3, upd_dtype)
            what = f"{dtype} upd {upd_dtype} {case} N={N} B={B} d={d}"
            got = sgns.scatter_add_rows(table.clone(), idx, upd)
            want = sgns.scatter_add_rows_plain(table.clone(), idx, upd)
            same("scatter_add_rows", got, want, what)
            ref = sgns.scatter_add_rows_rowwise(table.clone(), idx, upd)
            same("scatter_add_rows_rowwise", ref, want, what)
            same("scatter_add_rows vs scatter_add_rows_rowwise", got, ref,
                 what)
            cases += 1
    # more positions than one chunk holds (B = 3 P + 7, four launches in one
    # call) with a 100-position run of one hub row across the chunk edges
    for dtype, upd_dtype in ((torch.float32, torch.float32),
                             (torch.bfloat16, torch.float32),
                             (torch.bfloat16, torch.bfloat16)):
        P = sgns.plan_scatter(
            1, DIM, torch.empty(0, dtype=dtype).element_size(),
            torch.empty(0, dtype=upd_dtype).element_size()).positions
        B = 3 * P + 7
        rng = np.random.default_rng(B)
        idx = rng.integers(0, 500, B)
        idx[rng.choice(B, 100, replace=False)] = 7
        idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
        table = normal(rng, (500, DIM), 1.0, dtype)
        upd = normal(rng, (B, DIM), 3e-3, upd_dtype)
        what = f"{dtype} upd {upd_dtype} B={B} (P={P}) hub run of 100"
        got = sgns.scatter_add_rows(table.clone(), idx, upd)
        want = sgns.scatter_add_rows_plain(table.clone(), idx, upd)
        same("scatter_add_rows", got, want, what)
        ref = sgns.scatter_add_rows_rowwise(table.clone(), idx, upd)
        same("scatter_add_rows vs scatter_add_rows_rowwise", got, ref, what)
        cases += 1
    # the row-wise scatter (#10) over its own chunk edges: B = 3 P + 7 for
    # its planned P, a 100-position hub run across them; one call is one
    # scatter_rowwise launch per chunk and nothing else (no sort)
    for dtype, upd_dtype in ((torch.float32, torch.float32),
                             (torch.bfloat16, torch.float32),
                             (torch.bfloat16, torch.bfloat16)):
        sizes = (torch.empty(0, dtype=dtype).element_size(),
                 torch.empty(0, dtype=upd_dtype).element_size())
        P = sgns.plan_scatter_rowwise(*sizes)
        B = 3 * P + 7
        rng = np.random.default_rng(B + 1)
        idx = rng.integers(0, 700, B)
        idx[rng.choice(B, 100, replace=False)] = 9
        idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
        table = normal(rng, (700, DIM), 1.0, dtype)
        upd = normal(rng, (B, DIM), 3e-3, upd_dtype)
        what = (f"{dtype} upd {upd_dtype} B={B} (its own P={P}) hub run "
                f"of 100")
        ref = sgns.scatter_add_rows_rowwise(table.clone(), idx, upd)
        want = sgns.scatter_add_rows_plain(table.clone(), idx, upd)
        same("scatter_add_rows_rowwise", ref, want, what)
        got = sgns.scatter_add_rows(table.clone(), idx, upd)
        same("scatter_add_rows vs scatter_add_rows_rowwise", got, ref, what)
        calls = call_kernels(
            lambda: sgns.scatter_add_rows_rowwise(table, idx, upd), reps=2)
        if any(len(c) != 4 or not all("scatter_rowwise" in k for k in c)
               for c in calls):
            raise AssertionError(f"scatter_add_rows_rowwise {what}: "
                                 f"launched {calls}, not four "
                                 f"scatter_rowwise")
        cases += 1

    # gather_rows_rowwise (#8) == gather_rows (#3) == plain, bitwise
    for dtype in (torch.float32, torch.bfloat16):
        for N, d, B in ((50, 64, 20), (30, 32, 9), (64, 128, 64),
                        (1000, DIM, 1001), (77, 20, 333)):
            rng = np.random.default_rng(N + d + B)
            table = normal(rng, (N, d), 1.0, dtype)
            idx = torch.from_numpy(rng.integers(0, N, B).astype(
                np.int32)).to(dev)
            what = f"{dtype} N={N} d={d} B={B}"
            got = sgns.gather_rows_rowwise(table, idx)
            same("gather_rows_rowwise", got, sgns.gather_rows_plain(table, idx),
                 what)
            same("gather_rows vs gather_rows_rowwise",
                 sgns.gather_rows(table, idx), got, what)
            cases += 1
    # #3 at every vector width (16, 8, 4, 2 and 1 bytes: rows of f32 d =
    # 128, 6, 3, bf16 d = 7, 1, int8 d = 12, 7) and from bases 1 and 2
    # elements into a buffer (no longer 16-byte aligned); rows wider than
    # 32 vectors; B past one wave (the grid striding)
    for dtype, d, B in ((torch.float32, DIM, 1001), (torch.float32, 6, 333),
                        (torch.float32, 3, 333), (torch.bfloat16, 7, 333),
                        (torch.bfloat16, 1, 333), (torch.int8, 12, 333),
                        (torch.int8, 7, 333), (torch.uint8, DIM, 1001),
                        (torch.float32, 1026, 77),
                        (torch.bfloat16, 1, 300_000),
                        (torch.bfloat16, 1, 3_000_000)):
        for offset in (0, 1, 2):
            rng = np.random.default_rng(d + B + offset)
            N = 300
            flat = torch.from_numpy(rng.integers(
                -100, 100, offset + N * d).astype(np.float32)).to(dev, dtype)
            table = flat[offset:].view(N, d)
            idx = torch.from_numpy(rng.integers(0, N, B).astype(
                np.int32)).to(dev)
            what = (f"{dtype} d={d} B={B} base {offset} elements in "
                    f"({table.data_ptr() % 16} mod 16)")
            got = sgns.gather_rows(table, idx)
            same("gather_rows", got, sgns.gather_rows_plain(table, idx), what)
            same("gather_rows vs gather_rows_rowwise", got,
                 sgns.gather_rows_rowwise(table, idx), what)
            cases += 1

    # one step per kernel route against the ref route on the same tensors
    def inputs(dtype, B, S, d, case, seed):
        rng = np.random.default_rng(seed)
        Nv, Nc = max(70, B // 2), max(90, B // 2)
        iv = rng.integers(0, Nv, B).astype(np.int32)
        ic = rng.integers(0, Nc, B).astype(np.int32)
        inn = rng.integers(0, Nc, S).astype(np.int32)
        mask = (rng.random(B) > 0.15).astype(np.float32)
        if case == "dup":
            iv[::3], ic[::4], inn[0] = 3, 5, 5
        elif case == "same":
            iv[:], ic[:], inn[:], mask[:] = 7, 9, 9, 1.0
        tdt = getattr(torch, dtype)
        tables = [normal(rng, (n, d), 0.1, tdt) for n in (Nv, Nc)]
        return (*tables, *(torch.from_numpy(a).to(dev) for a in (iv, ic, inn)),
                torch.from_numpy(mask).to(dev, tdt))

    for dtype in ("float32", "bfloat16"):
        for case, B, S, d in (("dup", 64, 8, 64), ("dup", 37, 4, 32),
                              ("same", 128, 8, 32), ("dup", 32, 8, DIM),
                              ("dup", 256, 5, DIM)):
            x = inputs(dtype, B, S, d, case, seed=B + S + d)
            rtol, atol = SGNS_TOL[dtype]
            if case == "same" and dtype == "float32":
                rtol, atol = 1e-3, 1e-5   # a 128-term f32 sum reassociated
            want = ops.sgns_step(x[0].clone(), x[1].clone(), *x[2:], 0.05,
                                 impl="ref")
            for impl in ("pallas", "pallas_fused"):
                what = f"sgns_step impl={impl} {dtype} {case} B={B} d={d}"
                got = ops.sgns_step(x[0].clone(), x[1].clone(), *x[2:], 0.05,
                                    impl=impl)
                torch.cuda.synchronize()
                torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
                for g, w, before in zip(got[:2], want[:2], x[:2]):
                    torch.testing.assert_close(g.float(), w.float(),
                                               rtol=rtol, atol=atol)
                    if dtype == "bfloat16" and bf16_steps_off(
                            torch, g, w, before).any():
                        raise AssertionError(f"{what}: more than two bf16 "
                                             f"steps from the ref route")
                cases += 1
    return cases


def per_card_training(torch, sgns, dev, time_ms, wall_ms, call_kernels,
                      err):
    """The per-card training shape; prints edges/s per route and returns
    the timing records of the training kernels."""
    from repro_torch.configs.tencent_embedding import CONFIG
    from repro_torch.core import HybridConfig, HybridEmbeddingTrainer
    from repro_torch.core.partition import build_episode_blocks

    cfg = HybridConfig(dim=CONFIG.dim, lr=CONFIG.lr,
                       negatives=CONFIG.negatives,
                       minibatch=CONFIG.minibatch, subparts=CONFIG.subparts,
                       neg_pool=CONFIG.neg_pool, seed=SEED,
                       dtype=CONFIG.dtype)
    t0 = time.perf_counter()
    gd = torch.Generator(device=dev).manual_seed(SEED + 2)
    tables = []
    for _ in range(2):
        t = torch.empty((SERVE_ROWS, DIM), dtype=torch.float32, device=dev)
        for lo in range(0, SERVE_ROWS, 1 << 22):
            hi = min(lo + (1 << 22), SERVE_ROWS)
            t[lo:hi] = torch.randn((hi - lo, DIM), generator=gd,
                                   device=dev).mul_(0.1)
        tables.append(t)
    trainer = HybridEmbeddingTrainer(SERVE_ROWS, cfg, device=dev)
    trainer.set_embeddings(*tables)
    if trainer.vert.data_ptr() != tables[0].data_ptr():
        raise AssertionError("set_embeddings copied a device table")
    del tables
    # Zipf(1.1) ranks through a seeded permutation of the ids: minibatches
    # hold many duplicate rows, spread over the whole 13.4 GB of each table
    rng = np.random.default_rng(SEED + 3)
    perm = rng.permutation(SERVE_ROWS).astype(np.int64)
    n_pairs = 2 * cfg.subparts * CONFIG.block_cap
    ranks = (rng.zipf(1.1, size=(n_pairs, 2)) - 1) % SERVE_ROWS
    pairs = perm[ranks]
    eb = build_episode_blocks(pairs, trainer.part,
                              block_cap=CONFIG.block_cap,
                              pad_multiple=cfg.minibatch)
    staged = trainer.stage_blocks(eb)
    torch.cuda.synchronize()
    print(f"per-card training: 2 x {SERVE_ROWS} x {DIM} f32 tables and "
          f"{staged.num_samples} pairs in blocks of {eb.block_cap} on the "
          f"card in {time.perf_counter() - t0:.1f}s")

    # one minibatch of the staged blocks, kernel against plain
    B, S = cfg.minibatch, cfg.negatives
    iv, ic = staged.idx_v[0, 0, :B], staged.idx_c[0, 0, :B]
    mask = staged.mask[0, 0, :B]
    idx_n = trainer._pool_dev[torch.randint(
        0, cfg.neg_pool, (S,), generator=gd, device=dev)]
    vj = trainer.vert.view(cfg.subparts, -1, DIM)[0]
    ctx = trainer.ctx
    # compact copies of the touched rows; the remap is monotone, so the
    # sorted runs (and the kernel's sums) are those of the full tables
    uv, iv_c = torch.unique(iv, return_inverse=True)
    uc, icn_c = torch.unique(torch.cat([ic, idx_n]), return_inverse=True)
    small = (vj[uv.long()], ctx[uc.long()], iv_c.int(),
             icn_c[:B].int().contiguous(), icn_c[B:].int().contiguous(),
             mask)
    lr = cfg.lr
    got = sgns.sgns_fused_update(small[0].clone(), small[1].clone(),
                                 *small[2:], lr)
    want = sgns.sgns_fused_update_plain(small[0].clone(), small[1].clone(),
                                        *small[2:], lr)
    torch.cuda.synchronize()
    rtol, atol = SGNS_TOL["float32"]
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
        err["sgns_fused_update"] = max(err["sgns_fused_update"],
                                       (g - w).abs().max().item())
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    gg = sgns.sgns_fused_grads(*small)
    gp = sgns.sgns_fused_grads_plain(*small)
    torch.cuda.synchronize()
    torch.testing.assert_close(gg[0], gp[0], rtol=1e-4, atol=0.0)
    for g, w in zip(gg[1:], gp[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
        err["sgns_fused_grads"] = max(err["sgns_fused_grads"],
                                      (g - w).abs().max().item())
    # the same minibatch on the full tables: bitwise the compact result
    full = sgns.sgns_fused_update(vj, ctx, iv, ic, idx_n, mask, lr)
    torch.cuda.synchronize()
    if not (torch.equal(vj[uv.long()], got[0])
            and torch.equal(ctx[uc.long()], got[1])
            and torch.equal(full[2], got[2])):
        raise AssertionError("sgns_fused_update on the 13.4 GB tables != "
                             "the same launch on a compact copy")
    print(f"per-card minibatch (B={B}, S={S}, {uv.numel()} unique vertex "
          f"and {uc.numel()} unique context rows): kernels == plain within "
          f"tolerance; full tables == compact copy (bitwise)")

    # episodes: the first one warms up, the next ones are timed
    trainer.train_episode(staged)
    episodes = 3
    t0 = time.perf_counter()
    losses = [trainer.train_episode(staged) for _ in range(episodes)]
    dt = time.perf_counter() - t0
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"per-card episode losses {losses}")
    rate = staged.num_samples * episodes / dt
    print(f"per-card training impl pallas_fused2: {rate:.1f} edges/s, "
          f"{dt / episodes:.4f} "
          f"s/episode ({staged.num_samples} edges, "
          f"{-(-staged.num_samples // B)} minibatches), losses "
          f"{[round(x, 4) for x in losses]}")
    # where an episode's time goes: one more episode under the profiler
    from torch.profiler import ProfilerActivity, profile

    def profile_episode(label):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_episode(staged)
            wall = 1e3 * (time.perf_counter() - t0)
        stats = prof.key_averages()
        dev_ops = [e for e in stats if str(e.device_type).endswith("CUDA")]
        busy_ms = sum(e.self_device_time_total for e in dev_ops) / 1e3
        print(f"per-card {label} episode under the profiler: wall "
              f"{wall:.3f} ms, device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall:.1f} %)")
        for title, rows, attr in (
                ("device", dev_ops, "self_device_time_total"),
                ("host", [e for e in stats if e not in dev_ops],
                 "self_cpu_time_total")):
            top = sorted(rows, key=lambda e: -getattr(e, attr))[:6]
            print(f"  top {title} time: " + "; ".join(
                f"{e.key[:60]} {getattr(e, attr) / 1e3:.3f} ms x{e.count}"
                for e in top))

    profile_episode("pallas_fused2")
    # the other routes on the same blocks: a warm-up episode, then timed
    # ones (one for ref, whose scatter loops on the host over run ranks),
    # then one under the profiler for the kernel routes
    for impl in ("pallas_fused", "pallas", "ref"):
        trainer.cfg = dataclasses.replace(cfg, impl=impl)
        trainer.train_episode(staged)
        n_ep = 1 if impl == "ref" else episodes
        t0 = time.perf_counter()
        losses = [trainer.train_episode(staged) for _ in range(n_ep)]
        dt = time.perf_counter() - t0
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"per-card {impl} episode losses {losses}")
        print(f"per-card training impl {impl}: "
              f"{staged.num_samples * n_ep / dt:.1f} edges/s, "
              f"{dt / n_ep:.4f} s/episode")
        if impl != "ref":
            profile_episode(impl)
    trainer.cfg = cfg

    # the unfused routes' kernels on this minibatch: gradients of the
    # gathered rows against plain, and the context scatter of -lr * (dc ++
    # dn) over idx_c ++ idx_n bitwise against plain on the compact copy,
    # then on the full table bitwise against that copy
    v, c, n = vj[iv.long()], ctx[ic.long()], ctx[idx_n.long()]
    g5, p5 = sgns.sgns_grads(v, c, n, mask), sgns.sgns_grads_plain(v, c, n,
                                                                     mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(g5[0], p5[0], rtol=3e-5, atol=3e-5)
    for g, w in zip(g5[1:], p5[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        err["sgns_grads"] = max(err["sgns_grads"], (g - w).abs().max().item())
    icn = torch.cat([ic, idx_n])
    upd = torch.cat([g5[2], g5[3]]) * float(-np.float32(lr))
    cc = ctx[uc.long()]                      # the rows as the episodes left them
    got9 = sgns.scatter_add_rows(cc.clone(), icn_c.int(), upd)
    got10 = sgns.scatter_add_rows_rowwise(cc.clone(), icn_c.int(), upd)
    want9 = sgns.scatter_add_rows_plain(cc.clone(), icn_c.int(), upd)
    sgns.scatter_add_rows(ctx, icn, upd)
    g8 = sgns.gather_rows_rowwise(vj, iv)
    torch.cuda.synchronize()
    if not (torch.equal(got9, want9) and torch.equal(got10, want9)
            and torch.equal(ctx[uc.long()], got9)):
        raise AssertionError("scatter_add_rows at the per-card minibatch: "
                             "kernel, row-wise kernel, plain and the full "
                             "table disagree")
    if not (torch.equal(g8, sgns.gather_rows_plain(vj, iv))
            and torch.equal(g8, sgns.gather_rows(vj, iv))):
        raise AssertionError("gather_rows_rowwise at the per-card minibatch "
                             "!= gather_rows / plain")
    print(f"per-card minibatch, unfused routes: sgns_grads == plain within "
          f"tolerance; scatter_add_rows == row-wise == plain == full table, "
          f"gather_rows_rowwise == gather_rows == plain (bitwise)")

    uniq = uv.numel() + uc.numel()
    L = B + S
    row_bytes = DIM * 4

    def timed(kernel, plain, reps=50):
        return dict(ms=time_ms(kernel, reps), wall_ms=wall_ms(kernel, reps),
                    plain_ms=time_ms(plain, 20))

    recs = {
        "sgns_fused_update": dict(
            replaces="src/repro/kernels/sgns.py:535",
            **timed(lambda: sgns.sgns_fused_update(
                vj, ctx, iv, ic, idx_n, mask, lr),
                lambda: sgns.sgns_fused_update_plain(
                vj, ctx, iv, ic, idx_n, mask, lr)),
            library_ms=None, bound=sgns_bound(B, S, DIM, uniq, uniq)),
        "sgns_fused_grads": dict(
            replaces="src/repro/kernels/sgns.py:177",
            **timed(lambda: sgns.sgns_fused_grads(
                vj, ctx, iv, ic, idx_n, mask),
                lambda: sgns.sgns_fused_grads_plain(
                vj, ctx, iv, ic, idx_n, mask)),
            library_ms=None, bound=sgns_bound(B, S, DIM, uniq, 2 * B + S)),
        "sgns_grads": dict(
            replaces="src/repro/kernels/sgns.py:90",
            **timed(lambda: sgns.sgns_grads(v, c, n, mask),
                    lambda: sgns.sgns_grads_plain(v, c, n, mask)),
            library_ms=None,
            # (2B + S) rows read and written, the mask read
            bound=bound_ms(2 * (2 * B + S) * row_bytes + 4 * B,
                           6.0 * B * S * DIM + 4.0 * B * DIM)),
    }
    for r in recs.values():
        r["source"] = "src/repro_torch/kernels/csrc/sgns_update.cu"
    # the scatters time the context scatter in place on the 13.4 GB table;
    # bound: the update rows and ids read, each unique row read and written
    scatter_bound = bound_ms(L * row_bytes + 2 * uc.numel() * row_bytes
                             + 4 * L, float(L * DIM))
    library = time_ms(lambda: ctx.index_add_(0, icn.long(), upd), 50)
    # one launch per call and nothing else on the device: the ids are
    # sorted on chip, not by torch.sort
    calls = call_kernels(lambda: sgns.sgns_fused_update(
        vj, ctx, iv, ic, idx_n, mask, lr))
    if len(calls) != 1 or len(next(iter(calls))) != 1 or (
            "sgns_update_fused" not in next(iter(calls))[0]):
        raise AssertionError(f"sgns_fused_update at the per-card minibatch "
                             f"launched {calls}, not one sgns_update_fused")
    print(f"sgns_fused_update at the per-card minibatch: one device kernel "
          f"per call ({next(iter(calls))[0][:60]})")
    # #5 and #6 are each one cooperative kernel per call, and #6 is #5 on
    # the rows it gathers, bitwise
    for name, fn in (("sgns_grads", lambda: sgns.sgns_grads(v, c, n, mask)),
                     ("sgns_fused_grads", lambda: sgns.sgns_fused_grads(
                         vj, ctx, iv, ic, idx_n, mask))):
        calls = call_kernels(fn)
        if len(calls) != 1 or len(next(iter(calls))) != 1 or (
                "sgns_grads_coop" not in next(iter(calls))[0]):
            raise AssertionError(f"{name} at the per-card minibatch "
                                 f"launched {calls}, not one sgns_grads_coop")
        print(f"{name} at the per-card minibatch: one device kernel per call "
              f"({next(iter(calls))[0][:60]})")
    g6 = sgns.sgns_fused_grads(vj, ctx, iv, ic, idx_n, mask)
    g5 = sgns.sgns_grads(vj[iv.long()], ctx[ic.long()], ctx[idx_n.long()],
                         mask)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(g6, g5)):
        raise AssertionError("sgns_fused_grads at the per-card minibatch != "
                             "sgns_grads on the gathered rows")
    print("sgns_fused_grads at the per-card minibatch == sgns_grads on the "
          "gathered rows (bitwise)")
    calls = call_kernels(lambda: sgns.scatter_add_rows(ctx, icn, upd))
    if len(calls) != 1 or len(next(iter(calls))) != 1 or (
            "scatter_sorted" not in next(iter(calls))[0]):
        raise AssertionError(f"scatter_add_rows at the per-card minibatch "
                             f"launched {calls}, not one scatter_sorted")
    print(f"scatter_add_rows at the per-card minibatch: one device kernel "
          f"per call ({next(iter(calls))[0][:60]})")
    calls = call_kernels(lambda: sgns.scatter_add_rows_rowwise(ctx, icn, upd))
    if len(calls) != 1 or len(next(iter(calls))) != 1 or (
            "scatter_rowwise" not in next(iter(calls))[0]):
        raise AssertionError(f"scatter_add_rows_rowwise at the per-card "
                             f"minibatch launched {calls}, not one "
                             f"scatter_rowwise")
    print(f"scatter_add_rows_rowwise at the per-card minibatch: one device "
          f"kernel per call ({next(iter(calls))[0][:60]})")
    for name, fn in (("scatter_add_rows", sgns.scatter_add_rows),
                     ("scatter_add_rows_rowwise",
                      sgns.scatter_add_rows_rowwise)):
        recs[name] = dict(
            replaces=("src/repro/kernels/sgns.py:810" if name ==
                      "scatter_add_rows" else "src/repro/kernels/sgns.py:867"),
            source="src/repro_torch/kernels/csrc/scatter_rows.cu",
            **timed(lambda fn=fn: fn(ctx, icn, upd),
                    lambda: sgns.scatter_add_rows_plain(ctx, icn, upd)),
            library_ms=library, bound=scatter_bound)
    recs["gather_rows_rowwise"] = dict(
        replaces="src/repro/kernels/sgns.py:719",
        source="src/repro_torch/kernels/csrc/gather_rows.cu",
        **timed(lambda: sgns.gather_rows_rowwise(vj, iv),
                lambda: sgns.gather_rows_plain(vj, iv)),
        library_ms=time_ms(lambda: vj.index_select(0, iv), 50),
        # the unique rows read, B rows written, the ids read
        bound=bound_ms((uv.numel() + B) * row_bytes + 4 * B, 0.0))
    # #3 at the pallas route's shape, beside the launch floor: a
    # one-element fill_ timed the same two ways
    one = torch.zeros(1, device=dev)
    floor = (time_ms(lambda: one.fill_(1.0), 50),
             wall_ms(lambda: one.fill_(1.0), 50))
    g3 = (time_ms(lambda: sgns.gather_rows(vj, iv), 50),
          wall_ms(lambda: sgns.gather_rows(vj, iv), 50),
          time_ms(lambda: vj.index_select(0, iv), 50))
    print(f"launch floor (a one-element fill_): {floor[0]:.4f} device ms, "
          f"{floor[1]:.4f} ms wall")
    bound8 = recs["gather_rows_rowwise"]["bound"][0]
    print(f"gather_rows minibatch shape (B={B} f32 rows of {row_bytes} B): "
          f"{g3[0]:.4f} device ms/launch, {g3[1]:.4f} ms wall, index_select "
          f"{g3[2]:.4f} ms, bound {bound8:.6f} ms (bytes)")
    return recs


def check_filter_bound(torch, tk, shard, q, dev):
    """#1's tensor-core scores (the kernel's test-only export) within a
    quarter of their error bound of the exact scores: on the first
    1,048,576 rows of the per-card table against its queries, and on rows
    built against each term of the bound (cancellation, magnitudes over
    2^-30..2^30, rows along the queries' bf16 rounding error, f32 entries
    halfway between bf16 values)."""
    def worst(tbl, qq, what):
        a, eps = tk.topk_filter_bounds(tbl, qq)
        exact = qq @ tbl.float().T
        ratio = ((a - exact).abs() / eps).max().item()
        del a, eps, exact
        torch.cuda.empty_cache()
        if not ratio <= 0.25:
            raise AssertionError(f"topk_scan_exact filter {what}: |a - s| "
                                 f"reaches {ratio:.3g} eps (limit 0.25)")
        return ratio

    first = worst(shard[:CKPT_ROWS], q, f"{CKPT_ROWS} rows Q={q.shape[0]}")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    qa = torch.randn((64, DIM), generator=g, device=dev)
    qa[0] = (2.0 ** torch.randint(-4, 4, (DIM,), generator=g, device=dev)
             ) * (1 + 2.0 ** -8 - 2.0 ** -20)          # the worst split
    err = qa - qa.bfloat16().float()
    alt = torch.where(torch.arange(DIM, device=dev) % 2 == 0, 1.0, -1.0)
    sign = torch.randint(0, 2, (64, DIM), generator=g, device=dev) * 2.0 - 1
    mid = (2.0 ** torch.randint(-6, 6, (64, DIM), generator=g, device=dev)
           ) * (1 + 2.0 ** -8 - 2.0 ** -22)
    rows = torch.cat([
        (alt * 3e3).expand(64, DIM), alt * 1e4 * torch.sign(qa),
        sign * 2.0 ** (60 * torch.rand((64, DIM), generator=g, device=dev)
                       - 30),
        torch.sign(err) * 7.0,
        5.0 * err / err.norm(dim=1, keepdim=True).clamp_min(1e-30),
        mid * sign, mid * torch.sign(qa)]).contiguous()
    adv = [worst(rows.to(dt), qa, f"adversarial rows {dt}")
           for dt in (torch.float32, torch.bfloat16)]
    print(f"topk_scan_exact filter bound: max |a - s| / eps {first:.4g} on "
          f"{CKPT_ROWS} rows x {q.shape[0]} queries, {max(adv):.4g} on "
          f"adversarial rows (f32 and bf16 tables); limit 0.25")


def check_quant_filter_bound(torch, tk, q8, q, dev):
    """#2's tensor-core scores on int8 rows (the export, unscaled: the
    kernel compares them times the row's positive scale) within a quarter
    of their bound of the exact chain: on the first 1,048,576 rows of the
    per-card int8 table against its queries, and on +-127 rows along the
    queries' bf16 rounding error, against their signs and alternating, and
    all-zero rows. Returns the two worst ratios."""
    def worst(tbl, qq, what):
        a, eps = tk.topk_filter_bounds(tbl, qq)
        exact = qq @ tbl.float().T
        ratio = ((a - exact).abs() / eps).max().item()
        del a, eps, exact
        torch.cuda.empty_cache()
        if not ratio <= 0.25:
            raise AssertionError(f"topk_scan_int8 filter {what}: |a - s| "
                                 f"reaches {ratio:.3g} eps (limit 0.25)")
        return ratio

    first = worst(q8[:CKPT_ROWS], q, f"{CKPT_ROWS} int8 rows Q={q.shape[0]}")
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    qa = torch.randn((64, DIM), generator=g, device=dev)
    qa[0] = (2.0 ** torch.randint(-4, 4, (DIM,), generator=g, device=dev)
             ) * (1 + 2.0 ** -8 - 2.0 ** -20)          # the worst split
    err = qa - qa.bfloat16().float()
    alt = torch.where(torch.arange(DIM, device=dev) % 2 == 0, 1.0, -1.0)
    rows = torch.cat([
        127 * torch.sign(err), -127 * torch.sign(err),
        (127 * alt).expand(64, DIM), 127 * alt * torch.sign(qa),
        torch.zeros((64, DIM), device=dev),
        torch.randint(-127, 128, (64, DIM), generator=g, device=dev),
    ]).to(torch.int8).contiguous()
    adv = worst(rows, qa, "adversarial int8 rows")
    print(f"topk_scan_int8 filter bound: max |a - s| / eps {first:.4g} on "
          f"{CKPT_ROWS} int8 rows x {q.shape[0]} queries, {adv:.4g} on "
          f"adversarial int8 rows; limit 0.25")


def run_ranks(code, world, *args, timeout=600):
    """``python -c code *args`` once per rank from the checkout, with the
    ``torchrun`` variables set (one free localhost port); every rank must
    exit 0, and none outlives the call. Returns the ranks' outputs."""
    import os
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
               WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                              cwd=ROOT, env=dict(env, RANK=str(r),
                                                 LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {world} exited "
                                 f"{p.returncode}:\n{out[-3000:]}")
    return outs


def rank_lines(outs, tag):
    """The JSON each rank printed after ``tag``."""
    return [json.loads(next(line[len(tag) + 1:] for line in out.splitlines()
                            if line.startswith(tag + " "))) for out in outs]


# one episode of the ring on the CI gate's geometry, the blocks and the
# negative positions from a seed (each rank its own), on `device`
RING_EPISODE = r"""
import json, os, sys, time
import numpy as np, torch, torch.distributed as dist
from repro_torch.core import HybridConfig, HybridEmbeddingTrainer
from repro_torch.core.partition import build_episode_blocks
from repro_torch.kernels import sgns
dev, out = sys.argv[1], sys.argv[2]
world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
if world > 1:
    dist.init_process_group("gloo", init_method="tcp://localhost:"
                            + os.environ["MASTER_PORT"], world_size=world,
                            rank=rank)
if dev != "cpu":
    torch.cuda.set_device(dev)
rng = np.random.default_rng(11)
nodes = 1200
degrees = rng.integers(1, 20, nodes)
pairs = rng.integers(0, nodes, size=(40000, 2)).astype(np.int32)
res = {}
for dtype in ("float32", "bfloat16"):
    cfg = HybridConfig(dim=128, minibatch=32, negatives=8, subparts=2,
                       neg_pool=2048, lr=0.025, dtype=dtype)
    tt = HybridEmbeddingTrainer(nodes, cfg, degrees=degrees, dims=(1, world),
                                device=dev)
    tt.init_embeddings()
    eb = build_episode_blocks(pairs, tt.part, pad_multiple=32)
    draws = np.random.default_rng(100 + rank).integers(
        0, 2048, (world, 2, eb.block_cap // 32, 8))
    staged = tt.stage_blocks(eb)
    if dev != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = tt.train_episode(staged, lr=0.025, neg_draws=draws)
    if dev != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res[f"{dtype}_v"] = tt.embeddings().float().numpy()
    res[f"{dtype}_c"] = tt.context_embeddings().float().numpy()
    res[f"{dtype}_loss"], res[f"{dtype}_s"] = loss, dt
if rank == 0:
    np.savez(out, **res)
print("LAUNCHES " + json.dumps(sgns.LAUNCHES))
if world > 1:
    dist.destroy_process_group()
"""

# the training launcher in one rank's process; its summary and launches
RING_LAUNCHER = r"""
import json, sys
from repro_torch.launch import train
from repro_torch.kernels import sgns
argv = sys.argv[1:]
# the gate's one-device threshold off: ring_phase judges the AUC
i = argv.index("--min-auc")
r = train.main(argv[:i] + argv[i + 2:])
print("RESULT " + json.dumps({k: r[k] for k in ("auc", "episode_s",
                                                "edges_per_s", "ranks")}))
print("LAUNCHES " + json.dumps(sgns.LAUNCHES))
"""


# the JAX launcher's final AUC on the CI gate schedule on a (1, 2) mesh of
# host devices (XLA_FLAGS=--xla_force_host_platform_device_count=2 python
# -m repro.launch.train --arch tencent-embedding + the CI_GATE flags, on the
# CPU): two devices lose about 0.1 against one (0.6680 on one device, 0.5917
# on four), so the gate's 0.62 is a one-device threshold
REF_TWO_DEVICE_AUC = 0.5731


def ring_phase(torch, gate):
    """Two ranks on the one card (gloo, each sub-part staged through pinned
    host memory): the training launcher on the CI gate schedule, at an AUC
    no more than 0.04 below the JAX launcher's two-device run
    (REF_TWO_DEVICE_AUC; the one-rank run ``gate`` printed beside); then one
    episode's
    tables from two ``pallas_fused2`` ranks on the card against two plain
    CPU ranks on the same blocks and negatives, f32 and bf16, at SGNS_TOL,
    and the episode's wall time beside one rank's on the card. Returns the
    launches of each path (summed over its ranks)."""
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks(RING_LAUNCHER, 2, *CI_GATE, "--device", "cuda:0",
                         "--out-dir", str(Path(tmp) / "gate2"))
        res = rank_lines(outs, "RESULT")
        launched = rank_lines(outs, "LAUNCHES")
        paths["train_2ranks"] = {n: sum(c[n] for c in launched)
                                 for n in launched[0]}
        auc = res[0]["auc"]
        print(f"train main path CI gate on 2 ranks (one card, gloo): AUC "
              f"{auc:.4f} (one rank {gate['auc']:.4f}; the JAX launcher on "
              f"two devices {REF_TWO_DEVICE_AUC}), "
              f"{res[0]['edges_per_s']:.1f} edges/s, "
              f"{res[0]['episode_s']:.4f} s/episode; launches "
              f"{paths['train_2ranks']}")
        if not (auc >= REF_TWO_DEVICE_AUC - 0.04 and res[0]["ranks"] == 2):
            raise AssertionError(f"2-rank CI gate: AUC {auc} (JAX on two "
                                 f"devices {REF_TWO_DEVICE_AUC}), {res[0]}")
        if paths["train_2ranks"]["sgns_fused_update"] == 0:
            raise AssertionError("2-rank CI gate: sgns_fused_update never "
                                 "launched")
        card, cpu, one = (str(Path(tmp) / f"{n}.npz")
                          for n in ("card", "cpu", "one"))
        launched = rank_lines(run_ranks(RING_EPISODE, 2, "cuda:0", card),
                              "LAUNCHES")
        paths["ring_episode"] = {n: sum(c[n] for c in launched)
                                 for n in launched[0]}
        run_ranks(RING_EPISODE, 2, "cpu", cpu)
        run_ranks(RING_EPISODE, 1, "cuda:0", one)
        got, want, single = (np.load(p) for p in (card, cpu, one))
        for dtype in ("float32", "bfloat16"):
            rtol, atol = SGNS_TOL[dtype]
            for t in ("v", "c"):
                g, w = got[f"{dtype}_{t}"], want[f"{dtype}_{t}"]
                bad = np.abs(g - w) > atol + rtol * np.abs(w)
                if bad.any():
                    raise AssertionError(
                        f"2-rank episode {dtype} {t}: card != CPU ranks at "
                        f"{int(bad.sum())} elements (max |diff| "
                        f"{np.abs(g - w).max():.3g})")
            if not np.isclose(got[f"{dtype}_loss"], want[f"{dtype}_loss"],
                              rtol=1e-4, atol=0):
                raise AssertionError(f"2-rank episode {dtype} loss "
                                     f"{got[f'{dtype}_loss']} != "
                                     f"{want[f'{dtype}_loss']}")
            print(f"2-rank episode {dtype} (1200 nodes x 128, 40000 pairs, "
                  f"k = 2): card pallas_fused2 ranks == plain CPU ranks "
                  f"within {SGNS_TOL[dtype]}, loss "
                  f"{float(got[f'{dtype}_loss']):.6f}; episode wall "
                  f"{float(got[f'{dtype}_s']):.4f} s on 2 ranks, "
                  f"{float(single[f'{dtype}_s']):.4f} s on one rank")
        if paths["ring_episode"]["sgns_fused_update"] == 0:
            raise AssertionError("2-rank episode: sgns_fused_update never "
                                 "launched")
    return paths


def attention_pairs(Sq, Skv, causal, window) -> int:
    """(query, key) pairs a row-wise attention must score: the valid keys
    of each row (a row with none scores all Skv, as the kernel does)."""
    q = np.arange(Sq)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    hi = np.minimum(Skv - 1, q) if causal else np.full_like(q, Skv - 1)
    n = np.maximum(hi - lo + 1, 0)
    return int(np.where(n > 0, n, Skv).sum())


def check_flash_kernel(torch, fa, dev, err):
    """The flash kernel against ``mha_plain`` at :data:`FLASH_CASES`, f32 and
    bf16, on (B, S, H, hd) buffers passed as (B, H, S, hd) views; rows with
    no valid key also against the mean of v. Returns the number of cases."""
    cases = 0
    for dtype in ("float32", "bfloat16"):
        rtol, atol = FLASH_TOL[dtype]
        for i, (B, H, Hkv, Sq, Skv, hd, causal, window) in enumerate(
                FLASH_CASES):
            g = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
            q, k, v = (
                (0.5 * torch.randn(shape, generator=g, device=dev)).to(
                    getattr(torch, dtype)).transpose(1, 2)
                for shape in ((B, Sq, H, hd), (B, Skv, Hkv, hd),
                              (B, Skv, Hkv, hd)))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.mha_plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            what = (f"{dtype} B={B} H={H} Hkv={Hkv} Sq={Sq} Skv={Skv} "
                    f"hd={hd} causal={causal} window={window}")
            diff = (got.float() - want.float()).abs()
            bad = diff > atol + rtol * want.float().abs()
            if bad.any():
                raise AssertionError(f"flash_attention {what}: kernel != "
                                     f"plain at {int(bad.sum())} elements "
                                     f"(max |diff| {diff.max().item():.3g})")
            err[f"flash_attention {dtype}"] = max(
                err[f"flash_attention {dtype}"], diff.max().item())
            if window and Sq >= Skv + window:
                rows = slice(Skv + window - 1, None)
                mean_v = v.float().mean(dim=2, keepdim=True).repeat_interleave(
                    H // Hkv, dim=1)
                torch.testing.assert_close(
                    got[:, :, rows].float(),
                    mean_v.expand_as(got[:, :, rows]), rtol=rtol, atol=atol)
            cases += 1
    return cases


def time_flash(torch, fa, dev, time_ms, wall_ms, profiled_calls):
    """The flash kernel at granite-3-2b's prefill shape (f32, causal) on the
    views the model passes, beside its bound, ``mha_plain`` and
    ``scaled_dot_product_attention`` on k, v repeated to H heads (a
    yardstick the port never calls); the 512-key window and bf16 printed
    beside it, then the bound both ways (f32 CUDA cores; 3xTF32 tensor
    cores, the record's), the achieved rate, and the device kernels of one
    call of the kernel and of the yardstick. Returns the kernel's
    record."""
    B, H, Hkv, S, hd = LM_B, 32, 8, LM_S, 64
    g = torch.Generator(device=dev).manual_seed(SEED + 200)
    q, k, v = (torch.randn(shape, generator=g, device=dev).transpose(1, 2)
               for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:80",
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=True), 10),
        wall_ms=wall_ms(lambda: fa.flash_attention(q, k, v, causal=True), 10),
        plain_ms=time_ms(lambda: fa.mha_plain(q, k, v, causal=True), 3),
        library_ms=time_ms(lambda: sdpa(q, kr, vr, is_causal=True), 10))
    nbytes = 4 * (2 * B * H * S * hd + 2 * B * Hkv * S * hd)
    flops = 4.0 * B * H * hd * attention_pairs(S, S, True, 0)
    f32_bound = bound_ms(nbytes, flops)
    # the kernel's products take three TF32 tensor-core passes each
    tf32x3_ms = 1e3 * 3 * flops / TF32_FLOP_PER_S
    rec["bound"] = max((1e3 * nbytes / HBM_BYTES_PER_S, "bytes"),
                       (tf32x3_ms, "operations"))
    win_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                                window=512), 10)
    win_bound = bound_ms(nbytes, 4.0 * B * H * hd
                         * attention_pairs(S, S, True, 512))
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    bf16_ms = time_ms(lambda: fa.flash_attention(qb, kb, vb, causal=True), 10)
    print(f"flash_attention at B={B} H={H} Hkv={Hkv} S={S} hd={hd} f32 "
          f"causal: {rec['ms']:.4f} device ms/launch ({rec['wall_ms']:.4f} "
          f"wall), bound {f32_bound[0]:.4f} ms ({f32_bound[1]} at the f32 "
          f"CUDA-core rate; {1e3 * flops / BF16_FLOP_PER_S:.4f} ms at the "
          f"bf16 tensor-core rate), plain {rec['plain_ms']:.4f} ms, library "
          f"(sdpa) {rec['library_ms']:.4f} ms; window 512: {win_ms:.4f} ms, "
          f"bound {win_bound[0]:.4f} ms; bf16 inputs: {bf16_ms:.4f} ms")
    print(f"flash_attention 3xTF32 bound {tf32x3_ms:.4f} ms (3 x "
          f"{flops:.4g} flop at {TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s TF32), "
          f"achieved {flops / rec['ms'] / 1e9:.1f} effective TFLOP/s "
          f"({100 * tf32x3_ms / rec['ms']:.1f} % of the 3xTF32 bound); "
          f"sdpa {flops / rec['library_ms'] / 1e9:.1f} TFLOP/s")
    for label, fn in (("flash_attention", lambda: fa.flash_attention(
            q, k, v, causal=True)), ("sdpa", lambda: sdpa(q, kr, vr,
                                                          is_causal=True))):
        calls = profiled_calls(fn, 2)
        split = ([(key[:90], round(us, 1)) for us, key in calls[0]]
                 if calls else "not measured (the profiler kept no call)")
        print(f"{label} one call's device kernels (name, us): {split}")
    return rec


def lm_serving(torch, dev, counted):
    """The LM serving main path at full width, then the kernel route against
    the masked route at 2 layers. Returns the main path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import attention as lm_attn
    from repro_torch.models import transformer as tfm
    from repro_torch.train.train_step import synthetic_batch

    cfg = get_config("granite-3-2b")
    for name in lm_attn.ROUTE_CALLS:
        lm_attn.ROUTE_CALLS[name] = 0
    lm, launches = counted(lambda: lm_serve.main(LM_ARGV))
    routes = dict(lm_attn.ROUTE_CALLS)
    print(f"lm_serve main-path launches: {launches}; prefill "
          f"routes {routes}")
    layers, vocab = cfg.num_layers, cfg.vocab_size
    if not (launches["flash_attention"] == layers
            and routes == {"flash_calls": layers, "masked_calls": 0}):
        raise AssertionError(f"LM serving path: {launches} flash "
                             f"launches, routes {routes}; want {layers} "
                             f"flash launches and no masked prefill")
    logits, gen_tokens = lm["logits"], lm["tokens"]
    if not (tuple(logits.shape) == (LM_B, 1, vocab)
            and torch.isfinite(logits).all()
            and gen_tokens.shape == (LM_B, LM_TOKENS)
            and ((0 <= gen_tokens) & (gen_tokens < vocab)).all()):
        raise AssertionError(f"LM serving path: logits {tuple(logits.shape)}"
                             f" (finite: {bool(torch.isfinite(logits).all())}"
                             f"), tokens {gen_tokens.shape}")
    print(f"LM main path granite-3-2b full width, batch {LM_B}, prompt "
          f"{LM_S}, {LM_TOKENS} tokens: prefill {lm['prefill_s'] * 1e3:.1f} "
          f"ms, decode {lm['tok_per_s']:.1f} tok/s "
          f"({lm['decode_s'] * 1e3:.1f} ms for {LM_TOKENS - 1} steps); "
          f"first tokens {gen_tokens[:, :8].tolist()}")
    del lm, logits
    torch.cuda.empty_cache()
    # the kernel route against the masked plain route at full width, 2 layers
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params2 = tfm.init_params(cfg2, seed=SEED, device=dev)
    prompt = synthetic_batch(cfg2, LM_B, LM_S, seed=SEED)["tokens"]
    by_route = [lm_serve.run(params2, cfg2, prompt, new_tokens=1,
                             cache_len=LM_S + LM_TOKENS + 8, flash=flash)
                for flash in (True, False)]
    lf, lmask = (r["logits"] for r in by_route)
    torch.testing.assert_close(lf, lmask, rtol=2e-3, atol=2e-3)
    print(f"granite-3-2b full width, 2 layers: prefill logits on the flash "
          f"route == masked route within 2e-3 (max |diff| "
          f"{(lf - lmask).abs().max().item():.3g}; prefill "
          f"{by_route[0]['prefill_s'] * 1e3:.1f} vs "
          f"{by_route[1]['prefill_s'] * 1e3:.1f} ms)")
    # where a layer's time goes: one prefill and four decode steps of the
    # 2-layer model under the profiler
    batch = {"tokens": torch.as_tensor(prompt, device=dev)}
    cache_len = LM_S + LM_TOKENS + 8
    _, caches = profile_split(torch, "prefill (2 layers)", lambda: tfm.prefill(
        params2, batch, cfg2, cache_len))
    tok = batch["tokens"][:, -1:]
    profile_split(torch, "4 decode steps (2 layers)", lambda: [
        tfm.decode_step(params2, tok, caches, cfg2) for _ in range(4)])
    del params2, by_route, lf, lmask, caches
    torch.cuda.empty_cache()
    return launches


def profile_split(torch, label, run):
    """``run()`` once under the profiler: wall ms, the device's busy share
    and the top device ops by self device time. Returns ``run()``'s
    result."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev_ops = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in dev_ops) / 1e3
    top = sorted(dev_ops, key=lambda e: -e.self_device_time_total)[:6]
    print(f"LM {label} under the profiler: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f} %); top device ops: "
          + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3:.3f} "
                      f"ms x{e.count}" for e in top))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.embed_serve import topk as tk
    from repro_torch.embed_serve.quant import (DEFAULT_OVERFETCH,
                                               overfetch_m, quantize_rows,
                                               rescore_exact)
    from repro_torch.embed_serve.store import (ShardedEmbeddingStore,
                                               recall_at_k)
    from repro_torch.kernels import build, ops, sgns
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import embed_serve
    from repro_torch.launch import train as train_launcher
    from repro_torch.train.checkpoint import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    # ---------------------------------------------------------- phase 1
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} devices {torch.cuda.device_count()}")
    secs = build.build()
    print(f"built {sorted(build.SIGNATURES)} in {secs:.1f}s")
    spilled = []
    for name in sorted(build.SIGNATURES):
        log = build.library_path(name).with_suffix(".log")
        for fn, regs, st, ld in ptxas_report(
                log.read_text() if log.exists() else ""):
            print(f"  ptxas {name}: {fn[:70]}: {regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads")
            if (st or ld) and any(k in fn for k in NO_SPILL):
                spilled.append(fn)
    if spilled:
        raise AssertionError(f"kernels that must not spill do: {spilled}")

    # ---------------------------------------------------------- phase 2
    g = torch.Generator(device="cpu").manual_seed(SEED)
    err = {"topk_scan_exact": 0.0, "topk_scan_int8": 0.0, "topk_rowwise": 0.0,
           **{name: 0.0 for name in sgns.LAUNCHES},
           "flash_attention float32": 0.0, "flash_attention bfloat16": 0.0}

    def counted(run):
        """``run()`` with every launch count set to 0 just before it;
        returns its result and the counts read just after."""
        for counts in (tk.LAUNCHES, sgns.LAUNCHES, fa.LAUNCHES):
            for name in counts:
                counts[name] = 0
        out = run()
        return out, {**tk.LAUNCHES, **sgns.LAUNCHES, **fa.LAUNCHES}

    def int_table(n, d, lo=-4, hi=5):
        return torch.randint(lo, hi, (n, d), generator=g).float().to(dev)

    def check_pair(kind, got, want, what):
        torch.cuda.synchronize()
        (gv, gi), (wv, wi) = got, want
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            bad = (gi != wi).any(dim=1).nonzero()[:3].flatten().tolist()
            raise AssertionError(f"{kind} {what}: kernel != plain "
                                 f"(first rows {bad})")
        diff = (gv - wv)[torch.isfinite(wv)]
        if diff.numel():
            err[kind] = max(err[kind], diff.abs().max().item())

    def check_exact(tbl, q, k, valid, what):
        """The scan (#1) and the rowwise kernel (#4) against their
        plain version (the same function)."""
        want = tk.topk_mips_plain(tbl, q, k, valid)
        check_pair("topk_scan_exact", tk.topk_mips(tbl, q, k, valid), want,
                   what)
        check_pair("topk_rowwise", tk.topk_mips_rowwise(tbl, q, k, valid),
                   want, what)

    def check_quant(tbl, q, m, valid, what):
        q8, sc = quantize_rows(tbl)
        check_pair("topk_scan_int8", tk.topk_mips_quant(q8, sc, q, m, valid),
                   tk.topk_mips_quant_plain(q8, sc, q, m, valid), what)

    def check_gather(tbl, idx, what):
        got = sgns.gather_rows(tbl, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, sgns.gather_rows_plain(tbl, idx)):
            raise AssertionError(f"gather_rows {what}: kernel != plain")

    def check_serving_shape(tbl, q8, sc, q, exact_plain, what):
        """Every kernel against its plain version at the shapes the serving
        path gives it: the exact scan, the int8 first pass (m survivors)
        and the gather of those survivors. Returns the gather's ids."""
        m = overfetch_m(K, DEFAULT_OVERFETCH, tbl.shape[0])
        check_pair("topk_scan_exact", tk.topk_mips(tbl, q, K), exact_plain,
                   f"{what} k={K}")
        cand = tk.topk_mips_quant(q8, sc, q, m)
        check_pair("topk_scan_int8", cand,
                   tk.topk_mips_quant_plain(q8, sc, q, m), f"{what} m={m}")
        gidx = cand[1].reshape(-1).contiguous()
        check_gather(tbl, gidx, f"{what} B={gidx.numel()}")
        return m, gidx

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for k, n, nq, d in ((1, 230, 17, 32), (10, 230, 17, 32),
                            (100, 130, 5, 32), (10, 1001, 37, DIM),
                            (100, 4099, 300, DIM)):
            tbl = int_table(n, d).to(dtype)
            q = int_table(nq, d)
            check_exact(tbl, q, k, n, f"{dtype} k={k} N={n} Q={nq} d={d}")
            check_exact(tbl, q, k, n - 3, f"{dtype} k={k} valid=N-3")
            cases += 2
        # heavy ties within tiles and across splits: 6 distinct rows
        base = int_table(6, DIM)
        pick = torch.randint(0, 6, (300_000,), generator=g).to(dev)
        tbl = base[pick].to(dtype)
        q = int_table(19, DIM)
        check_exact(tbl, q, 100, tbl.shape[0], f"{dtype} heavy ties")
        check_quant(tbl, q, 400, tbl.shape[0], f"{dtype} heavy ties m=400")
        cases += 2
        # the rowwise kernel over many chunks (a small score
        # scratch): the ties at the k-th key run across every chunk edge
        scratch = tk.ROWWISE_SCRATCH_BYTES
        try:
            for k, valid, chunk in ((10, 300_000, 4096),
                                    (100, 299_993, 1024), (1, 70_001, 128)):
                tk.ROWWISE_SCRATCH_BYTES = 4 * q.shape[0] * chunk
                what = (f"{dtype} heavy ties k={k} valid={valid} chunks of "
                        f"{chunk}")
                assert tk.plan_topk_rowwise(q.shape[0], DIM, k,
                                            valid).chunks > 1
                got = tk.topk_mips_rowwise(tbl, q, k, valid)
                check_pair("topk_rowwise", got, tk.topk_mips(tbl, q, k, valid),
                           f"{what} against the scan")
                check_pair("topk_rowwise", got,
                           tk.topk_mips_plain(tbl, q, k, valid), what)
                cases += 1
        finally:
            tk.ROWWISE_SCRATCH_BYTES = scratch
    # rows >= valid never surface, even when their scores would win
    tbl = torch.full((64, 8), -2.0, device=dev)
    tbl[40:] = 0.0
    q = torch.ones((3, 8), device=dev)
    v, i = tk.topk_mips(tbl, q, 5, 40)
    torch.cuda.synchronize()
    assert int(i.max()) < 40, "padded rows returned"
    check_exact(tbl, q, 50, 40, "k > valid")
    cases += 2
    for m in (40, 400):
        for n, nq in ((5000, 37), (130, 5)):
            tbl = int_table(n, DIM)
            q = int_table(nq, DIM)
            check_quant(tbl, q, min(m, n), n, f"m={m} N={n} Q={nq}")
            check_quant(tbl, q, min(m, n - 7), n - 7, f"m={m} valid=N-7")
            cases += 2
    # int8 rows of d % 16 == 8 stage by 8-byte copies
    tbl, q = int_table(1000, 40), int_table(9, 40)
    check_quant(tbl, q, 40, 997, "d=40 m=40 valid=N-3")
    cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        for n, d, b in ((1000, DIM, 1001), (77, 20, 333), (5, 24, 7)):
            tbl = int_table(n, d).to(dtype)
            idx = torch.randint(0, n, (b,), generator=g).int().to(dev)
            check_gather(tbl, idx, f"{dtype} N={n} d={d} B={b}")
            cases += 1
    # the two-tier scan on the card equals the exact scan (integer data)
    tbl = int_table(4099, DIM).bfloat16()
    q = int_table(64, DIM)
    q8, sc = quantize_rows(tbl)
    _, ci = tk.topk_mips_quant(q8, sc, q, 40)
    got = rescore_exact(tbl, q, ci, 10)
    want = tk.topk_mips_plain(tbl, q, 10)
    check_pair("topk_scan_exact", got, want, "two-tier == exact")
    cases += 1
    print(f"kernels == plain on {cases} integer cases (bitwise; "
          f"topk_rowwise on each topk_scan_exact case, and over many chunks "
          f"== scan == plain)")

    # the per-card serving table, made on the card from a seed
    gd = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.empty((SERVE_ROWS, DIM), dtype=torch.bfloat16, device=dev)
    for lo in range(0, SERVE_ROWS, 1 << 22):
        hi = min(lo + (1 << 22), SERVE_ROWS)
        table[lo:hi] = torch.randn((hi - lo, DIM), generator=gd,
                                   device=dev).mul_(0.1)
    t0 = time.perf_counter()
    store = ShardedEmbeddingStore.from_array(table, devices=[dev],
                                             keep_host_table=False,
                                             quant="int8")
    torch.cuda.synchronize()
    print(f"store: {SERVE_ROWS} x {DIM} bf16 + int8 tier on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    shard = store.shards[0]
    q8, sc = store.qshards[0]
    recalls = []
    for b in range(BATCHES):
        rows = torch.randint(0, SERVE_ROWS, (BATCH,), generator=gd,
                             device=dev)
        q = shard[rows].float() + 0.05 * torch.randn(
            (BATCH, DIM), generator=gd, device=dev)
        pv, pi = tk.topk_mips_plain(shard, q, K)
        for impl in ("pallas", "quant"):
            gv, gi = store.topk(q, K, impl=impl)
            gi_t = torch.as_tensor(gi).to(dev).long()
            truth = (shard[gi_t].float() * q[:, None, :]).sum(2)
            r = recall_at_k(gi, pi.cpu().numpy(),
                            got_vals=truth.cpu().numpy(),
                            oracle_vals=pv.cpu().numpy())
            recalls.append(r)
            if impl == "pallas":
                err["topk_scan_exact"] = max(
                    err["topk_scan_exact"],
                    (torch.as_tensor(gv).to(dev) - pv).abs().max().item())
            if r < 1.0:
                raise AssertionError(f"batch {b} {impl}: recall {r} < 1.0 "
                                     f"against the plain scan")
    print(f"{SERVE_ROWS}-row serving: recall@{K} vs plain on the card "
          f"{min(recalls)} (min of {len(recalls)} batch results)")

    # the last batch's inputs, checked kernel == plain and then timed
    m, gidx = check_serving_shape(shard, q8, sc, q, (pv, pi),
                                  f"{SERVE_ROWS} rows Q={BATCH}")
    print(f"{SERVE_ROWS}-row serving shape: exact scan, int8 scan (m={m}) "
          f"and gather (B={gidx.numel()}) == plain (bitwise)")

    # L2 (50 MB) is flushed before every timed call, since the serving
    # path finds the rows the gather reads cold, just after a scan of
    # gigabytes. A microsecond kernel's wall time between two CUDA events
    # is mostly its wrapper's enqueue on the host, so the times that stand
    # beside the bounds are device times, from the profiler. The flush
    # rewrites 256 MiB with an op no timed function launches (torch.sort
    # fills bytes, so a uint8 zero_ would not do)
    from torch.profiler import ProfilerActivity, profile
    flush = torch.zeros(32 << 20, dtype=torch.int64, device=dev)
    pad = torch.zeros(8, dtype=torch.int32, device=dev)

    def device_events(run):
        """(start us, duration us, name) of each kernel ``run()`` launches,
        in the order the card ran them."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return sorted((e.time_range.start, e.time_range.elapsed_us(), e.key)
                      for e in prof.events()
                      if str(e.device_type).endswith("CUDA"))

    flush.bitwise_not_()
    flush_events = device_events(flush.bitwise_not_)
    if len(flush_events) != 1:
        raise AssertionError(f"the profiler saw {flush_events} for one "
                             f"flush")
    _, flush_us, flush_key = flush_events[0]

    def profiled_calls(fn, reps):
        """The kernels of each of ``reps`` calls of ``fn`` with a cold L2,
        as lists of (device us, name): the calls run each after a flush,
        under the profiler, and a call is the kernels between two recorded
        flushes, the flushes left out. The profiler can drop the first
        kernels of a session (a few, or in some processes most of the
        session), so each session starts with eight small kernels of
        another kind, only the calls after the first recorded flush count
        as whole, and a session that kept fewer than half its flushes is
        run again. None after three such sessions."""
        fn()

        def run():
            for _ in range(8):
                pad.add_(1)
            for _ in range(reps):
                flush.bitwise_not_()
                fn()
        for _ in range(3):
            events = device_events(run)
            flushes = [i for i, (_, us, key) in enumerate(events)
                       if key == flush_key and us > flush_us / 2]
            if len(flushes) >= max(1, reps / 2):
                break
            print(f"  note: the profiler kept {len(flushes)} of {reps} "
                  f"flushes among {len(events)} kernels")
        else:
            return None
        ends = flushes[1:] + [len(events)]
        return [[(us, key) for _, us, key in events[f + 1:e]]
                for f, e in zip(flushes, ends)]

    def time_ms(fn, reps):
        """Device ms of one call of ``fn`` with a cold L2: the duration of
        every kernel of the calls ``profiled_calls`` recorded, summed and
        divided by their number; after three sessions that kept too few
        calls, timed with CUDA events instead (``event_ms``)."""
        calls = profiled_calls(fn, reps)
        if calls is None:
            print(f"  note: {reps} calls timed with CUDA events behind a "
                  f"GPU sleep")
            return event_ms(fn, reps)
        sizes = sorted({len(c) for c in calls})
        if len(sizes) > 1:
            print(f"  note: calls of {sizes} kernels in one timing")
        return sum(us for c in calls for us, _ in c) / len(calls) / 1e3

    def event_ms(fn, reps):
        """Device ms of one call of ``fn`` with a cold L2, from CUDA events:
        each call follows a flush and a GPU sleep long enough for the host
        to enqueue the events and the call behind it, so the card runs
        them back to back and the events bracket the call's device work."""
        total = 0.0
        for _ in range(reps):
            flush.bitwise_not_()
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / reps

    def call_kernels(fn, reps=5):
        """The names of the device kernels of each recorded call of ``fn``
        (``profiled_calls``), as a set of tuples."""
        calls = profiled_calls(fn, reps)
        if calls is None:
            raise AssertionError(f"the profiler kept too few of {reps} "
                                 f"flushes to count a call's kernels")
        return {tuple(key for _, key in c) for c in calls}

    def wall_ms(fn, reps):
        """Ms between CUDA events around one call of ``fn`` just after an L2
        flush, averaged over ``reps`` calls: the card's launch latency and
        the call's device time (the host has enqueued the call while the
        flush runs)."""
        fn()
        total = 0.0
        for _ in range(reps):
            flush.bitwise_not_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / reps

    n_rows, Qn, d = SERVE_ROWS, BATCH, DIM
    # #1's filter: the pairs it passes on to the exact chain at this shape
    survivors = torch.zeros(1, dtype=torch.int64, device=dev)
    check_pair("topk_scan_exact",
               tk.topk_mips(shard, q, K, survivors=survivors), (pv, pi),
               f"{SERVE_ROWS} rows Q={BATCH} (counted)")
    n_surv = survivors.item()
    print(f"topk_scan_exact filter at {SERVE_ROWS} x {DIM} bf16, Q={BATCH}, "
          f"k={K}: {n_surv} of {Qn * n_rows} pairs rescored exactly "
          f"({100 * n_surv / (Qn * n_rows):.4f} %)")
    check_filter_bound(torch, tk, shard, q, dev)
    # the bounds #1 runs at: its products once on the bf16 tensor cores,
    # the survivors' chains on the f32 CUDA cores, the table read once
    nbytes = n_rows * d * 2 + Qn * d * 4 + Qn * K * 8
    tc_ms = 1e3 * (2.0 * Qn * n_rows * d / BF16_FLOP_PER_S
                   + 2.0 * n_surv * d / FP32_FLOP_PER_S)
    f32_bound = bound_ms(nbytes, 2.0 * Qn * n_rows * d)
    results = []
    # #2's filter likewise, on the int8 tier's rows and scales
    check_pair("topk_scan_int8",
               tk.topk_mips_quant(q8, sc, q, m, survivors=survivors),
               tk.topk_mips_quant_plain(q8, sc, q, m),
               f"{SERVE_ROWS} int8 rows Q={BATCH} m={m} (counted)")
    n_surv8 = survivors.item()
    print(f"topk_scan_int8 filter at {SERVE_ROWS} x {DIM} int8, Q={BATCH}, "
          f"m={m}: {n_surv8} of {Qn * n_rows} pairs rescored exactly "
          f"({100 * n_surv8 / (Qn * n_rows):.4f} %)")
    check_quant_filter_bound(torch, tk, q8, q, dev)
    # #2 runs at the same bounds on its N (d + 4) bytes of rows and scales
    nbytes8 = n_rows * (d + 4) + Qn * d * 4 + Qn * m * 8
    tc8_ms = 1e3 * (2.0 * Qn * n_rows * d / BF16_FLOP_PER_S
                    + 2.0 * n_surv8 * d / FP32_FLOP_PER_S)
    f32_bound8 = bound_ms(nbytes8, 2.0 * Qn * n_rows * d + Qn * n_rows)
    rec = {
        "topk_scan_exact": dict(
            source="src/repro_torch/kernels/csrc/topk_scan.cu",
            replaces="src/repro/embed_serve/topk.py:264",
            ms=time_ms(lambda: tk.topk_mips(shard, q, K), 5),
            plain_ms=time_ms(lambda: tk.topk_mips_plain(shard, q, K), 1),
            bound=max((1e3 * nbytes / HBM_BYTES_PER_S, "bytes"),
                      (tc_ms, "operations"))),
        "topk_scan_int8": dict(
            source="src/repro_torch/kernels/csrc/topk_scan.cu",
            replaces="src/repro/embed_serve/topk.py:300",
            ms=time_ms(lambda: tk.topk_mips_quant(q8, sc, q, m), 5),
            plain_ms=time_ms(
                lambda: tk.topk_mips_quant_plain(q8, sc, q, m), 1),
            bound=max((1e3 * nbytes8 / HBM_BYTES_PER_S, "bytes"),
                      (tc8_ms, "operations"))),
        "gather_rows": dict(
            source="src/repro_torch/kernels/csrc/gather_rows.cu",
            replaces="src/repro/kernels/sgns.py:687",
            ms=time_ms(lambda: sgns.gather_rows(shard, gidx), 50),
            plain_ms=time_ms(lambda: sgns.gather_rows_plain(shard, gidx), 50),
            library_ms=time_ms(lambda: shard.index_select(0, gidx), 50),
            # the unique rows read, B rows written, the ids read
            bound=bound_ms((torch.unique(gidx).numel() + gidx.numel()) * d
                           * 2 + 4 * gidx.numel(), 0.0)),
    }
    rec["topk_scan_exact"]["wall_ms"] = wall_ms(
        lambda: tk.topk_mips(shard, q, K), 5)
    rec["topk_scan_int8"]["wall_ms"] = wall_ms(
        lambda: tk.topk_mips_quant(q8, sc, q, m), 5)
    rec["gather_rows"]["wall_ms"] = wall_ms(
        lambda: sgns.gather_rows(shard, gidx), 50)
    r = rec["gather_rows"]
    warm = warm_kernel_ms(torch, lambda: sgns.gather_rows(shard, gidx),
                          "gather_kernel")
    print(f"gather_rows serving shape (B={gidx.numel()} bf16 rows of "
          f"{2 * d} B): {r['ms']:.4f} device ms/launch, {r['wall_ms']:.4f} ms "
          f"wall, index_select {r['library_ms']:.4f} ms, bound "
          f"{r['bound'][0]:.6f} ms ({r['bound'][1]}); L2 warm (the same rows "
          f"again) " + (f"{warm:.4f} ms" if warm else "not measured"))
    tf = shard.float()
    rec["topk_scan_exact"]["library_ms"] = time_ms(
        lambda: torch.topk(q @ tf.T, K), 2)
    del tf
    torch.cuda.empty_cache()
    r = rec["topk_scan_exact"]
    print(f"topk_scan_exact bounds at {SERVE_ROWS} x {DIM} bf16, Q={BATCH}: "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}; table bytes once "
          f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms, bf16 tensor cores "
          f"{tc_ms:.4f} ms for one pass and the survivors), "
          f"{f32_bound[0]:.4f} ms at the f32 CUDA-core rate; kernel "
          f"{r['ms']:.3f} ms = {100 * r['bound'][0] / r['ms']:.1f} % of its "
          f"bound")
    r = rec["topk_scan_int8"]
    print(f"topk_scan_int8 bounds at {SERVE_ROWS} x {DIM} int8, Q={BATCH}, "
          f"m={m}: {r['bound'][0]:.4f} ms ({r['bound'][1]}; rows and scales "
          f"once {1e3 * nbytes8 / HBM_BYTES_PER_S:.4f} ms, bf16 tensor cores "
          f"{tc8_ms:.4f} ms for one pass and the survivors), "
          f"{f32_bound8[0]:.4f} ms at the f32 CUDA-core rate; kernel "
          f"{r['ms']:.3f} ms = {100 * r['bound'][0] / r['ms']:.1f} % of its "
          f"bound")
    # the launcher's batch shape: a 1,048,576-row table, 8 queries
    small, q8b = shard[:CKPT_ROWS], q[:8].contiguous()
    check_pair("topk_scan_exact", tk.topk_mips(small, q8b, K),
               [t[:8] for t in tk.topk_mips_plain(small, q, K)],
               f"{CKPT_ROWS} rows Q=8")
    # and as the launcher sends it: padded with zero queries to its 256
    qpad = torch.zeros((BATCH, DIM), device=dev)
    qpad[:8] = q8b
    check_pair("topk_scan_exact", tk.topk_mips(small, qpad, K),
               tk.topk_mips_plain(small, qpad, K),
               f"{CKPT_ROWS} rows Q=8 padded to {BATCH}")
    tf = small.float()
    launcher_ms = (time_ms(lambda: tk.topk_mips(small, q8b, K), 20),
                   time_ms(lambda: torch.topk(q8b @ tf.T, K), 20),
                   time_ms(lambda: tk.topk_mips(small, qpad, K), 10))
    del tf
    torch.cuda.empty_cache()
    print(f"topk_scan_exact at the launcher's batch ({CKPT_ROWS} x {DIM} "
          f"bf16, Q=8, k={K}): {launcher_ms[0]:.4f} device ms/launch, "
          f"library (torch.topk(q @ T.float().T)) {launcher_ms[1]:.4f} ms, "
          f"bytes bound {1e3 * CKPT_ROWS * DIM * 2 / HBM_BYTES_PER_S:.4f} "
          f"ms; padded with zero queries to {BATCH} as the launcher sends "
          f"it: {launcher_ms[2]:.4f} ms")
    # #2 at the launcher's batch: the first 1,048,576 int8 rows, m = 40 for
    # its 8 queries, alone and padded with zero queries to 256
    s8, ss = q8[:CKPT_ROWS], sc[:CKPT_ROWS]
    m_l = overfetch_m(K, DEFAULT_OVERFETCH, CKPT_ROWS)
    shares = []
    for qq, what in ((q8b, "Q=8"), (qpad, f"Q=8 padded to {BATCH}")):
        check_pair("topk_scan_int8",
                   tk.topk_mips_quant(s8, ss, qq, m_l, survivors=survivors),
                   [t[:qq.shape[0]] for t in tk.topk_mips_quant_plain(
                       s8, ss, qpad, m_l)],
                   f"{CKPT_ROWS} int8 rows {what} m={m_l}")
        shares.append(survivors.item())
    qf = s8.float()
    launcher8_ms = (time_ms(lambda: tk.topk_mips_quant(s8, ss, q8b, m_l), 20),
                    time_ms(lambda: torch.topk((q8b @ qf.T) * ss, m_l), 20),
                    time_ms(lambda: tk.topk_mips_quant(s8, ss, qpad, m_l), 10))
    del qf
    torch.cuda.empty_cache()
    print(f"topk_scan_int8 at the launcher's batch ({CKPT_ROWS} x {DIM} "
          f"int8, Q=8, m={m_l}): {launcher8_ms[0]:.4f} device ms/launch, "
          f"library (torch.topk((q @ Q8.float().T) * s)) "
          f"{launcher8_ms[1]:.4f} ms, bytes bound "
          f"{1e3 * CKPT_ROWS * (DIM + 4) / HBM_BYTES_PER_S:.4f} ms; padded "
          f"with zero queries to {BATCH}: {launcher8_ms[2]:.4f} ms; pairs "
          f"rescored {shares[0]} of {8 * CKPT_ROWS} "
          f"({100 * shares[0] / (8 * CKPT_ROWS):.4f} %), padded {shares[1]} "
          f"of {BATCH * CKPT_ROWS} "
          f"({100 * shares[1] / (BATCH * CKPT_ROWS):.4f} %)")
    qf = q8.float()
    rec["topk_scan_int8"]["library_ms"] = time_ms(
        lambda: torch.topk((q @ qf.T) * sc, m), 2)
    del qf, table, store, shard, q8, sc
    torch.cuda.empty_cache()
    for name, r in rec.items():
        print(f"{name}: {r['ms']:.3f} device ms/launch ({r['wall_ms']:.3f} "
              f"wall), bound {r['bound'][0]:.5f} ms ({r['bound'][1]}), plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, "
              f"max |kernel - plain| {err[name]:.3g}")

    # ---------------------------------------------------------- phase 3
    # the 1 M-row checkpoint lives until phase 9, which serves it again
    serve_dir = tempfile.TemporaryDirectory()
    ckpt = str(Path(serve_dir.name) / "embeddings.npz")
    gc = torch.Generator(device="cpu").manual_seed(SEED + 1)
    tables = {name: (0.1 * torch.randn((CKPT_ROWS, DIM), generator=gc)
                     ).bfloat16() for name in ("vertex", "context")}
    save_checkpoint(ckpt, tables, step=1)
    del tables

    def serve(*extra):
        return embed_serve.main(
            ["--ckpt", ckpt, "--k", str(K), "--queries", str(BATCH),
             "--check-recall", "1.0", "--device", "cuda", *extra])

    # the kernels against their plain versions on the main path's own table
    # and queries (the launcher's seed), at its padded batch; the
    # rowwise kernel also against the scan, bit for bit, and timed
    # here, before the launchers' numpy oracles run: after them the
    # profiler drops the first kernels of each session
    main_store = ShardedEmbeddingStore.load(ckpt, devices=[dev],
                                            quant="int8")
    rows = np.random.default_rng(SEED).integers(0, CKPT_ROWS, BATCH)
    q = main_store.host_table[rows].float().to(dev)
    shard = main_store.shards[0]
    q8, sc = main_store.qshards[0]
    exact_plain = tk.topk_mips_plain(shard, q, K)
    what = f"{CKPT_ROWS} rows (main path) Q={BATCH}"
    check_serving_shape(shard, q8, sc, q, exact_plain, what)
    rowwise = tk.topk_mips_rowwise(shard, q, K)
    check_pair("topk_rowwise", rowwise, exact_plain, what)
    check_pair("topk_rowwise", rowwise, tk.topk_mips(shard, q, K),
               f"{what} against the scan")
    print(f"{CKPT_ROWS}-row main-path shape: exact scan, int8 scan, gather "
          f"and rowwise top-k == plain, rowwise == scan "
          f"(bitwise)")
    tf = shard.float()
    rec["topk_rowwise"] = dict(
        source="src/repro_torch/kernels/csrc/topk_rowwise.cu",
        replaces="src/repro/embed_serve/topk.py:382",
        ms=time_ms(lambda: tk.topk_mips_rowwise(shard, q, K), 3),
        wall_ms=wall_ms(lambda: tk.topk_mips_rowwise(shard, q, K), 2),
        plain_ms=time_ms(lambda: tk.topk_mips_plain(shard, q, K), 5),
        library_ms=time_ms(lambda: torch.topk(q @ tf.T, K), 5),
        bound=bound_ms(CKPT_ROWS * DIM * 2 + BATCH * DIM * 4
                       + BATCH * K * 8, 2.0 * BATCH * CKPT_ROWS * DIM))
    # where #4's time goes: its score and selection kernels, per chunk
    def kind(key):
        return next((n for n in ("score_kernel", "select_kernel") if n in key),
                    key[:40])

    calls = profiled_calls(lambda: tk.topk_mips_rowwise(shard, q, K), 3)
    if calls:
        chunks = tk.plan_topk_rowwise(BATCH, DIM, K, CKPT_ROWS).chunks
        split = [(kind(key), round(us, 1)) for us, key in calls[0]]
        print(f"topk_rowwise device us per kernel, in launch order (one call "
              f"of {chunks} chunks): {split}")
    del main_store, shard, q8, sc, tf
    torch.cuda.empty_cache()
    r = rec["topk_rowwise"]
    print(f"topk_rowwise at {CKPT_ROWS} x {DIM} bf16, Q={BATCH}, k={K}: "
          f"{r['ms']:.3f} device ms/launch ({r['wall_ms']:.3f} wall), bound "
          f"{r['bound'][0]:.5f} ms ({r['bound'][1]}), plain "
          f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, max "
          f"|kernel - plain| {err['topk_rowwise']:.3g}")

    served, launches = counted(lambda: {
        "int8" if extra else "exact": serve(*extra)
        for extra in ([], ["--quant", "int8"])})
    paths = {"serve": launches}
    print(f"serving main-path launches: {launches}")
    missing = [n for n in ("topk_scan_exact", "topk_scan_int8", "gather_rows")
               if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving main "
                             f"path: {missing}")

    # ---------------------------------------------------------- phase 4
    cases = check_sgns_kernels(torch, sgns, dev, err)
    print(f"sgns kernels == plain within tolerance on {cases} cases each "
          f"(f32, bf16; dup, odd B, one index; bf16 tables within two "
          f"bf16 steps), bitwise repeatable")
    cases = check_route_kernels(torch, sgns, ops, dev, err, call_kernels)
    print(f"unfused-route kernels on {cases} cases: sgns_grads == plain "
          f"within tolerance and bitwise repeatable; scatter_add_rows == "
          f"plain == scatter_add_rows_rowwise (also over #10's own chunk "
          f"edges, one scatter_rowwise launch per chunk) and gather_rows == "
          f"gather_rows_rowwise == plain (bitwise); sgns_step pallas and "
          f"pallas_fused == ref route within tolerance (bf16 within two bf16 "
          f"steps)")

    # ---------------------------------------------------------- phase 5
    rec.update(per_card_training(torch, sgns, dev, time_ms, wall_ms,
                                 call_kernels, err))
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 6
    # the kernels past the shapes they refused before: after every check
    # that counts a call's kernels with the profiler (run before those,
    # they left it dropping later sessions' kernels), timed with CUDA
    # events
    check_wide_scans(torch, tk, quantize_rows, dev, err, event_ms)
    torch.cuda.empty_cache()
    check_any_shape_sgns(torch, sgns, dev, err, event_ms)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 7
    def train_run(name, argv, out_dir, serve=False):
        """The training launcher (then, with ``serve``, the serving
        launcher on its checkpoint at recall 1.0); returns its summary."""
        r = train_launcher.main([*argv, "--out-dir", out_dir,
                                 "--device", "cuda"])
        print(f"train main path {name}: AUC {r['auc']:.4f}, "
              f"{r['edges_per_s']:.1f} edges/s, {r['episode_s']:.4f} "
              f"s/episode over {r['episodes']} episodes")
        if serve:
            s = embed_serve.main(
                ["--ckpt", r["checkpoint"], "--k", str(K), "--queries",
                 str(BATCH), "--check-recall", "1.0", "--device", "cuda"])
            print(f"served the {name} checkpoint: recall {s['recall']}, "
                  f"p50 {s['p50_ms']:.2f} ms")
        return r

    gate_name = "CI gate (sbm 1200 nodes, bf16)"
    config_name = "config geometry (powerlaw 262144 nodes, f32)"
    with tempfile.TemporaryDirectory() as tmp:
        (gate, _), paths["train"] = counted(lambda: (
            train_run(gate_name, CI_GATE, str(Path(tmp) / "gate")),
            train_run(config_name, CONFIG_RUN, str(Path(tmp) / "config"),
                      serve=True)))
        # a width the scan kernels read padded: trained and served on the
        # card, recall 1.0
        _, paths["train_dim100"] = counted(lambda: train_run(
            "CI gate at --dim 100", [*CI_GATE[:CI_GATE.index("--dim")],
                                     "--dim", "100",
                                     *CI_GATE[CI_GATE.index("--dim") + 2:]],
            str(Path(tmp) / "dim100"), serve=True))
        gates = {"pallas_fused2": gate}
        for impl in ("pallas", "pallas_fused"):
            def routed(impl=impl):
                argv = [*CI_GATE, "--impl", impl]
                runs = [train_run(f"{gate_name} impl {impl}", argv,
                                  str(Path(tmp) / f"gate_{impl}"))]
                if impl == "pallas":
                    runs.append(train_run(
                        f"{config_name} impl {impl}",
                        [*CONFIG_RUN, "--impl", impl],
                        str(Path(tmp) / f"config_{impl}"), serve=True))
                return runs[0]
            gates[impl], paths[f"train_{impl}"] = counted(routed)
    for impl, r in gates.items():
        if not r["auc"] >= 0.62:
            raise AssertionError(f"CI gate impl {impl}: AUC {r['auc']} < 0.62")
    for path, counts in paths.items():
        print(f"{path} main-path launches: {counts}")
    for impl, names in ROUTE_KERNELS.items():
        path = "train" if impl == "pallas_fused2" else f"train_{impl}"
        missing = [n for n in names if paths[path][n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the training "
                                 f"route {impl}: {missing}")
    missing = [n for n in ("sgns_fused_update", "topk_scan_exact")
               if paths["train_dim100"][n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the --dim 100 "
                             f"path: {missing}")

    for name in ("sgns_fused_update", "sgns_fused_grads", "sgns_grads",
                 "scatter_add_rows", "scatter_add_rows_rowwise",
                 "gather_rows_rowwise"):
        r = rec[name]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"{name}: {r['ms']:.4f} device ms/launch ({r['wall_ms']:.4f} "
              f"wall), bound {r['bound'][0]:.6f} ms ({r['bound'][1]}), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, max |kernel - plain| "
              f"{err[name]:.3g}")

    # ---------------------------------------------------------- phase 8
    paths.update(ring_phase(torch, gate))

    # ---------------------------------------------------------- phase 9
    # the serving launcher's other legs on the phase-3 checkpoint, each a
    # path of its own: the flags and the kernels each must launch (run
    # last: nothing is profiled after their numpy oracles)
    mdir = Path(serve_dir.name) / "metrics"
    tpath = Path(serve_dir.name) / "trace.json"
    legs = {
        "serve_rowwise": (["--impl", "rowwise"], ("topk_rowwise",)),
        "serve_hot": (["--quant", "int8", "--hot-rows", "120"],
                      ("topk_scan_exact", "topk_scan_int8", "gather_rows")),
        "serve_degraded": (
            ["--shards", "3", "--shard-timeout-ms", "150", "--inject",
             "serve.shard:delay:key=1:delay=1.0:times=inf",
             "--expect-degraded"], ("topk_scan_exact",)),
        "serve_telemetry": (["--metrics-dir", str(mdir), "--trace",
                             str(tpath)], ("topk_scan_exact",)),
    }
    for path, (extra, names) in legs.items():
        served[path], paths[path] = counted(lambda: serve(*extra))
        print(f"{path} main-path launches: {paths[path]}")
        missing = [n for n in names if paths[path][n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {missing}")
    deg = served["serve_degraded"]
    if not (deg["degraded"] > 0 and 1 in deg["failed_shards"]):
        raise AssertionError(f"degraded leg: {deg}")
    trace = json.loads(tpath.read_text())
    n_spans = sum(e.get("name") == "serve_batch" and e["ph"] == "X"
                  for e in trace["traceEvents"])
    summary = json.loads((mdir / "metrics_summary.json").read_text())
    if not ((mdir / "metrics.jsonl").exists() and n_spans > 0
            and summary["histograms"]["serve.request_s"]["count"] == BATCH):
        raise AssertionError(f"telemetry leg: {n_spans} serve_batch spans, "
                             f"summary {sorted(summary)}")
    print(f"telemetry leg: {n_spans} serve_batch spans in the trace, "
          f"metrics.jsonl and metrics_summary.json written")
    serve_dir.cleanup()
    for mode, r in served.items():
        print(f"main path {mode}: {r['qps']:.1f} QPS, p50 {r['p50_ms']:.2f} "
              f"ms, p99 {r['p99_ms']:.2f} ms, recall {r['recall']:.4f}, "
              f"{r['batches']} batches, {r['degraded']} degraded requests, "
              f"failed shards {r['failed_shards']}")

    # ---------------------------------------------------------- phase 10
    cases = check_flash_kernel(torch, fa, dev, err)
    print(f"flash_attention == mha_plain on {cases} cases (f32 rtol 2e-4 "
          f"atol 2e-5, bf16 2e-2; rows with no valid key == mean of v); max "
          f"|kernel - plain| f32 {err['flash_attention float32']:.3g}, bf16 "
          f"{err['flash_attention bfloat16']:.3g}")
    err["flash_attention"] = err["flash_attention float32"]
    rec["flash_attention"] = time_flash(torch, fa, dev, time_ms, wall_ms,
                                        profiled_calls)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 11
    paths["lm_serve"] = lm_serving(torch, dev, counted)

    # ---------------------------------------------------------- phase 12
    for name, r in rec.items():
        # the ranks' paths count only the training kernels
        by_path = {path: counts.get(name, 0)
                   for path, counts in paths.items()}
        results.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": err[name], "ms": r["ms"], "wall_ms": r["wall_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    print(f"kernels: {', '.join(rec)} (total run "
          f"{time.perf_counter() - t_start:.1f}s)")
    print(json.dumps({"kernels": results}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
