#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

It imports nothing of JAX. Phases, each printing its own lines; any
failure ends the run with a non-zero exit:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build of every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (all sources compiled in parallel);
2. every serving kernel against its plain PyTorch version on the card:
   integer tables (bitwise) at the JAX tests' shapes and at the full width
   d = 128, then a seeded continuous 26,250,000 x 128 bf16 table (one
   card's share of the paper's 1.05 B nodes over 40 GPUs) served through
   ``ShardedEmbeddingStore.topk``, exact and int8, checked at recall 1.0
   against the plain scan; kernel, plain and library times beside the
   bound;
3. the serving main path: a seeded 1,048,576 x 128 bf16 checkpoint written
   with the port's ``save_checkpoint`` and served by
   ``repro_torch.launch.embed_serve.main`` at recall 1.0, exact and int8,
   with every kernel's launch count read around the two runs; then every
   serving kernel against its plain version on that table and the
   launcher's own queries, at the shapes the launcher gives it;
4. the SGNS kernels (``sgns_fused_update``, ``sgns_fused_grads``) against
   their plain versions at f32 and bf16, with heavy duplicates, an odd B
   and one index per table, at the JAX kernel tests' tolerances, and each
   run twice for bitwise repeatability; the bf16 tables also to within
   two bf16 steps of plain, so that no row's update can go missing;
5. the per-card training shape: vertex and context tables of 26,250,000 x
   128 f32 (26.9 GB, made on the card from a seed) installed in the
   trainer, 4 sub-parts of 8,192-pair blocks of Zipf(1.1)-skewed ids,
   minibatch 256, 5 negatives from a 65,536-row pool; the kernels against
   their plain versions on one minibatch (on a compact copy of the rows it
   touches, and the full-table launch bitwise against that copy), a few
   episodes timed (edges/s), and one launch of each kernel timed beside
   its bound and its plain version;
6. the training main path: ``repro_torch.launch.train.main`` on the CI
   gate schedule at d = 128 (an SBM graph, AUC >= 0.62) and at the
   config's geometry (a 262,144-node power-law graph, minibatch 256, 5
   negatives, f32), the second run's checkpoint served by the serving
   launcher at recall 1.0, with the launch counts read around the three
   runs;
7. a JSON line of per-kernel results, the card's line, and as the last
   line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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


def check_sgns_kernels(torch, sgns, dev, err):
    """Both SGNS kernels against their plain versions, and twice against
    themselves, on numpy-seeded inputs. Returns the number of cases."""
    cases = 0

    def inputs(dtype, B, S, d, case, seed):
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
        # the mask in the tables' dtype, as the trainer passes it
        return (*tables, *(torch.from_numpy(a).to(dev) for a in (iv, ic, inn)),
                torch.from_numpy(mask).to(dev, tdt))

    def close(name, got, want, rtol, atol, what):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        bad = diff > atol + rtol * want.float().abs()
        if bad.any():
            raise AssertionError(f"{name} {what}: kernel != plain at "
                                 f"{int(bad.sum())} elements (max |diff| "
                                 f"{diff.max().item():.3g})")
        err[name] = max(err[name], diff.max().item())

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
            cases += 1
    return cases


def per_card_training(torch, sgns, dev, time_ms, err):
    """The per-card training shape; prints edges/s and returns the timing
    records of the two SGNS kernels."""
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
    iv, ic = staged.idx_v[0, :B], staged.idx_c[0, :B]
    mask = staged.mask[0, :B]
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
    print(f"per-card training: {rate:.1f} edges/s, {dt / episodes:.4f} "
          f"s/episode ({staged.num_samples} edges, "
          f"{-(-staged.num_samples // B)} minibatches), losses "
          f"{[round(x, 4) for x in losses]}")
    # where an episode's time goes: one more episode under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_episode(staged)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    stats = prof.key_averages()
    dev_ops = [e for e in stats if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in dev_ops) / 1e3
    print(f"per-card episode under the profiler: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for title, rows, attr in (
            ("device", dev_ops, "self_device_time_total"),
            ("host", [e for e in stats if e not in dev_ops],
             "self_cpu_time_total")):
        top = sorted(rows, key=lambda e: -getattr(e, attr))[:6]
        print(f"  top {title} time: " + "; ".join(
            f"{e.key[:60]} {getattr(e, attr) / 1e3:.3f} ms x{e.count}"
            for e in top))

    uniq = uv.numel() + uc.numel()
    recs = {
        "sgns_fused_update": dict(
            replaces="src/repro/kernels/sgns.py:535",
            ms=time_ms(lambda: sgns.sgns_fused_update(
                vj, ctx, iv, ic, idx_n, mask, lr), 50),
            plain_ms=time_ms(lambda: sgns.sgns_fused_update_plain(
                vj, ctx, iv, ic, idx_n, mask, lr), 20),
            library_ms=None, bound=sgns_bound(B, S, DIM, uniq, uniq)),
        "sgns_fused_grads": dict(
            replaces="src/repro/kernels/sgns.py:177",
            ms=time_ms(lambda: sgns.sgns_fused_grads(
                vj, ctx, iv, ic, idx_n, mask), 50),
            plain_ms=time_ms(lambda: sgns.sgns_fused_grads_plain(
                vj, ctx, iv, ic, idx_n, mask), 20),
            library_ms=None, bound=sgns_bound(B, S, DIM, uniq, 2 * B + S)),
    }
    for r in recs.values():
        r["source"] = "src/repro_torch/kernels/csrc/sgns_update.cu"
    return recs


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
    from repro_torch.kernels import build
    from repro_torch.kernels import sgns
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
    for name in sorted(build.SIGNATURES):
        log = build.library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---------------------------------------------------------- phase 2
    g = torch.Generator(device="cpu").manual_seed(SEED)
    err = {"topk_scan_exact": 0.0, "topk_scan_int8": 0.0, "gather_rows": 0.0,
           "sgns_fused_grads": 0.0, "sgns_fused_update": 0.0}

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
        check_pair("topk_scan_exact", tk.topk_mips(tbl, q, k, valid),
                   tk.topk_mips_plain(tbl, q, k, valid), what)

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
    print(f"kernels == plain on {cases} integer cases (bitwise)")

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
        for impl in ("exact", "quant"):
            gv, gi = store.topk(q, K, impl=impl)
            gi_t = torch.as_tensor(gi).to(dev).long()
            truth = (shard[gi_t].float() * q[:, None, :]).sum(2)
            r = recall_at_k(gi, pi.cpu().numpy(),
                            got_vals=truth.cpu().numpy(),
                            oracle_vals=pv.cpu().numpy())
            recalls.append(r)
            if impl == "exact":
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

    # CUDA events around each launch, after a warm-up; L2 (50 MB) is
    # flushed before every launch, since the serving path finds the rows
    # the gather reads cold, just after a scan of gigabytes
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, reps):
        fn()
        total = 0.0
        for _ in range(reps):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / reps

    n_rows, Qn, d = SERVE_ROWS, BATCH, DIM
    results = []
    rec = {
        "topk_scan_exact": dict(
            source="src/repro_torch/kernels/csrc/topk_scan.cu",
            replaces="src/repro/embed_serve/topk.py:264",
            ms=time_ms(lambda: tk.topk_mips(shard, q, K), 5),
            plain_ms=time_ms(lambda: tk.topk_mips_plain(shard, q, K), 1),
            bound=bound_ms(n_rows * d * 2 + Qn * d * 4 + Qn * K * 8,
                           2.0 * Qn * n_rows * d)),
        "topk_scan_int8": dict(
            source="src/repro_torch/kernels/csrc/topk_scan.cu",
            replaces="src/repro/embed_serve/topk.py:300",
            ms=time_ms(lambda: tk.topk_mips_quant(q8, sc, q, m), 5),
            plain_ms=time_ms(
                lambda: tk.topk_mips_quant_plain(q8, sc, q, m), 1),
            bound=bound_ms(n_rows * (d + 4) + Qn * d * 4 + Qn * m * 8,
                           2.0 * Qn * n_rows * d + Qn * n_rows)),
        "gather_rows": dict(
            source="src/repro_torch/kernels/csrc/gather_rows.cu",
            replaces="src/repro/kernels/sgns.py:687",
            ms=time_ms(lambda: sgns.gather_rows(shard, gidx), 50),
            plain_ms=time_ms(lambda: sgns.gather_rows_plain(shard, gidx), 50),
            library_ms=time_ms(lambda: shard.index_select(0, gidx), 50),
            bound=bound_ms(gidx.numel() * (2 * d * 2 + 4), 0.0)),
    }
    tf = shard.float()
    rec["topk_scan_exact"]["library_ms"] = time_ms(
        lambda: torch.topk(q @ tf.T, K), 2)
    del tf
    torch.cuda.empty_cache()
    qf = q8.float()
    rec["topk_scan_int8"]["library_ms"] = time_ms(
        lambda: torch.topk((q @ qf.T) * sc, m), 2)
    del qf, table, store, shard, q8, sc
    torch.cuda.empty_cache()
    for name, r in rec.items():
        print(f"{name}: {r['ms']:.3f} ms/launch, bound {r['bound'][0]:.3f} "
              f"ms ({r['bound'][1]}), plain {r['plain_ms']:.3f} ms, library "
              f"{r['library_ms']:.3f} ms, max |kernel - plain| "
              f"{err[name]:.3g}")

    # ---------------------------------------------------------- phase 3
    gc = torch.Generator(device="cpu").manual_seed(SEED + 1)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "embeddings.npz")
        tables = {name: (0.1 * torch.randn((CKPT_ROWS, DIM), generator=gc)
                         ).bfloat16() for name in ("vertex", "context")}
        save_checkpoint(ckpt, tables, step=1)
        for counts in (tk.LAUNCHES, sgns.LAUNCHES):
            for name in counts:
                counts[name] = 0
        served = {}
        for extra in ([], ["--quant", "int8"]):
            served["int8" if extra else "exact"] = embed_serve.main(
                ["--ckpt", ckpt, "--k", str(K), "--queries", str(BATCH),
                 "--check-recall", "1.0", "--device", "cuda", *extra])
        launches = {**tk.LAUNCHES, **sgns.LAUNCHES}
        # the kernels against their plain versions on the main path's own
        # table and queries (the launcher's seed), at its padded batch
        main_store = ShardedEmbeddingStore.load(ckpt, devices=[dev],
                                                quant="int8")
        rows = np.random.default_rng(SEED).integers(0, CKPT_ROWS, BATCH)
        q = main_store.host_table[rows].float().to(dev)
        shard = main_store.shards[0]
        q8, sc = main_store.qshards[0]
        check_serving_shape(shard, q8, sc, q, tk.topk_mips_plain(shard, q, K),
                            f"{CKPT_ROWS} rows (main path) Q={BATCH}")
        del main_store, shard, q8, sc
    print(f"{CKPT_ROWS}-row main-path shape: exact scan, int8 scan and "
          f"gather == plain (bitwise)")
    for mode, s in served.items():
        print(f"main path {mode}: {s['qps']:.1f} QPS, p50 {s['p50_ms']:.2f} "
              f"ms, p99 {s['p99_ms']:.2f} ms, recall {s['recall']:.4f}, "
              f"{s['batches']} batches")
    print(f"serving main-path launches: {launches}")
    missing = [n for n in rec if launches.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving main "
                             f"path: {missing}")

    # ---------------------------------------------------------- phase 4
    cases = check_sgns_kernels(torch, sgns, dev, err)
    print(f"sgns kernels == plain within tolerance on {cases} cases each "
          f"(f32, bf16; dup, odd B, one index; bf16 tables within two "
          f"bf16 steps), bitwise repeatable")

    # ---------------------------------------------------------- phase 5
    rec.update(per_card_training(torch, sgns, dev, time_ms, err))
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 6
    with tempfile.TemporaryDirectory() as tmp:
        for counts in (tk.LAUNCHES, sgns.LAUNCHES):
            for name in counts:
                counts[name] = 0
        gate = train_launcher.main(
            [*CI_GATE, "--out-dir", str(Path(tmp) / "gate"),
             "--device", "cuda"])
        config_run = train_launcher.main(
            [*CONFIG_RUN, "--out-dir", str(Path(tmp) / "config"),
             "--device", "cuda"])
        served_train = embed_serve.main(
            ["--ckpt", config_run["checkpoint"], "--k", str(K), "--queries",
             str(BATCH), "--check-recall", "1.0", "--device", "cuda"])
        train_launches = {**tk.LAUNCHES, **sgns.LAUNCHES}
    for name, r in (("CI gate (sbm 1200 nodes, bf16)", gate),
                    ("config geometry (powerlaw 262144 nodes, f32)",
                     config_run)):
        print(f"train main path {name}: AUC {r['auc']:.4f}, "
              f"{r['edges_per_s']:.1f} edges/s, {r['episode_s']:.4f} "
              f"s/episode over {r['episodes']} episodes")
    if not gate["auc"] >= 0.62:
        raise AssertionError(f"CI gate AUC {gate['auc']} < 0.62")
    print(f"served the trained checkpoint: recall {served_train['recall']}, "
          f"p50 {served_train['p50_ms']:.2f} ms")
    print(f"training main-path launches: {train_launches}")
    if train_launches["sgns_fused_update"] == 0:
        raise AssertionError("sgns_fused_update never launched on the "
                             "training main path")
    launches["sgns_fused_update"] = train_launches["sgns_fused_update"]
    launches["sgns_fused_grads"] = train_launches["sgns_fused_grads"]
    for name in ("sgns_fused_update", "sgns_fused_grads"):
        r = rec[name]
        print(f"{name}: {r['ms']:.4f} ms/launch, bound {r['bound'][0]:.5f} "
              f"ms ({r['bound'][1]}), plain {r['plain_ms']:.4f} ms, library "
              f"none, max |kernel - plain| {err[name]:.3g}")

    # ---------------------------------------------------------- phase 7
    for name, r in rec.items():
        results.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[name],
            "max_abs_err": err[name], "ms": r["ms"],
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
