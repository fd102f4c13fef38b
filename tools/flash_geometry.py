#!/usr/bin/env python3
"""The flash kernel's instances at other block geometries, on one CUDA card.

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` once per
geometry given (``--geom``, for hd 128 and MLA's (192, 128) alike, or
``--geom128`` / ``--geom192`` each), from a copy of the source whose
``GeomOf`` instance is rewritten to it, one build for a pair of them
(``--pair G128:G192``), and any other copy of the source (``--source``,
e.g. a parent commit's), all with one ``nvcc`` each started together. For every build it checks the
wide instances and hd 64 against ``mha_plain`` (f32 and bf16, ragged
tiles, a window) and prints, per instance, the registers, spill and shared
bytes and resident blocks an SM the card reports (when the source exports
them), then the f32 causal times at ``chip_smoke.py``'s timed shapes: CUDA
events over 10 launches after 2, in turns over the builds, the lower of two
turns, beside ``scaled_dot_product_attention`` (k and v repeated to H
heads) in the same call. A geometry is ``warps,m_tiles,key_tile,
separate_lo``, the four arguments of the .cu's ``Geom``.

    python3 tools/flash_geometry.py --geom 8,1,32,0 --geom 8,1,32,1 \\
        --source tmp_parent/flash_attention.cu

Run it from the root of the checkout.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# B, H, Hkv, S, hd, hd_v (causal, f32): granite's prefill, the hd-128
# families' (phi3.5-moe, jamba, llava) and deepseek-v3's MLA
SHAPES = {"hd64": (4, 32, 8, 2048, 64, 64),
          "hd128": (2, 32, 8, 2048, 128, 128),
          "mla": (1, 128, 128, 2048, 192, 128)}
# B, H, Hkv, Sq, Skv, hd, hd_v, causal, window: ragged rows and keys
CASES = [(2, 4, 2, 201, 77, 128, 128, False, 0),
         (1, 4, 2, 150, 230, 128, 128, True, 0),
         (1, 2, 2, 190, 190, 128, 128, True, 70),
         (2, 4, 4, 201, 77, 192, 128, False, 0),
         (1, 8, 2, 300, 300, 192, 128, True, 40),
         (1, 2, 1, 100, 40, 192, 128, True, 8),
         (2, 8, 2, 300, 300, 64, 64, True, 50)]
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (2e-2, 2e-2)}


def patched(text: str, g128, g192) -> str:
    """The source with the wide instances' ``GeomOf`` set to a geometry
    each (None: the source's own)."""
    for hd, g in ((128, g128), (192, g192)):
        if g:
            text, n = re.subn(
                rf"(struct GeomOf<{hd}, 128> {{\s*using G = Geom<)[^>]*>",
                rf"\g<1>{', '.join(map(str, g))}>", text)
            if n != 1:
                raise ValueError(f"no GeomOf<{hd}, 128> in the source")
    return text


def build_all(variants):
    """variants: [(label, source text)] -> {label: CDLL}, all built at once
    under build/torch_kernels/variants/."""
    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for label, text in variants:
        h = hashlib.sha1(text.encode()).hexdigest()[:12]
        src, so = out_dir / f"flash-{h}.cu", out_dir / f"flash-{h}.so"
        src.write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs.append((label, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for label, so, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{label}: nvcc exit {p.returncode}\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES["flash_attention"].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
        print(f"{label}: built; ptxas lines with a spill: {spills or 'none'}")
    print(f"built {len(procs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--geom", action="append", default=[],
                    help="warps,m_tiles,key_tile,separate_lo for both wide "
                    "instances")
    ap.add_argument("--geom128", action="append", default=[])
    ap.add_argument("--geom192", action="append", default=[])
    ap.add_argument("--pair", action="append", default=[],
                    help="G128:G192, one build with a geometry each")
    ap.add_argument("--source", action="append", default=[])
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    src = (build.CSRC / "flash_attention.cu").read_text()
    parse = lambda s: tuple(int(x) for x in s.split(","))  # noqa: E731
    variants = [("default", src)]
    variants += [(f"both {g}", patched(src, parse(g), parse(g)))
                 for g in args.geom]
    variants += [(f"hd128 {g}", patched(src, parse(g), None))
                 for g in args.geom128]
    variants += [(f"mla {g}", patched(src, None, parse(g)))
                 for g in args.geom192]
    variants += [(f"pair {g}", patched(src, *map(parse, g.split(":"))))
                 for g in args.pair]
    variants += [(f"source {s}", Path(s).read_text()) for s in args.source]
    libs = build_all(variants)

    print(f"card: {torch.cuda.get_device_name(0)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    bad = 0
    for label, lib in libs.items():
        build._LIBS["flash_attention"] = lib
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            if hasattr(lib, "flash_attention_info"):
                for hd, hd_v in ((128, 128), (192, 128), (64, 64)):
                    print(f"{label} {dtype} ({hd}, {hd_v}): "
                          f"{fa.kernel_info(dt, hd, hd_v, lib)}")
            rtol, atol = TOL[dtype]
            worst = 0.0
            for i, (B, H, Hkv, Sq, Skv, hd, hd_v, causal, window) in \
                    enumerate(CASES):
                g = torch.Generator(device=dev).manual_seed(500 + i)
                q, k, v = ((0.5 * torch.randn(s, generator=g, device=dev))
                           .to(dt).transpose(1, 2)
                           for s in ((B, Sq, H, hd), (B, Skv, Hkv, hd),
                                     (B, Skv, Hkv, hd_v)))
                got = fa.flash_attention(q, k, v, causal=causal,
                                         window=window).float()
                want = fa.mha_plain(q, k, v, causal=causal,
                                    window=window).float()
                diff = (got - want).abs()
                worst = max(worst, diff.max().item())
                if (diff > atol + rtol * want.abs()).any():
                    bad += 1
                    print(f"{label} {dtype} case {i}: kernel != plain "
                          f"(max |diff| {diff.max().item():.3g})")
            print(f"{label} {dtype}: {len(CASES)} cases, max |kernel - "
                  f"plain| {worst:.3g}", flush=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def time_ms(fn):
        for _ in range(2):
            fn()
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 10

    for name, (B, H, Hkv, S, hd, hd_v) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(300)
        q, k, v = (torch.randn(s, generator=g, device=dev).transpose(1, 2)
                   for s in ((B, S, H, hd), (B, S, Hkv, hd),
                             (B, S, Hkv, hd_v)))
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
        flops = 2.0 * (hd + hd_v) * B * H * fa.valid_pairs(S, S, True, 0)
        bound = 1e3 * 3 * flops / 495e12
        lib_ms = min(time_ms(lambda: sdpa(q, kr, vr, is_causal=True))
                     for _ in range(2))
        times = {label: [] for label in libs}
        for _ in range(2):
            for label, lib in libs.items():
                build._LIBS["flash_attention"] = lib
                times[label].append(time_ms(
                    lambda: fa.flash_attention(q, k, v, causal=True)))
        for label, ts in times.items():
            ms = min(ts)
            print(f"{name} B={B} H={H}/{Hkv} S={S} ({hd}, {hd_v}) f32 "
                  f"causal, {label}: {ms:.4f} ms ({ts[0]:.4f}, {ts[1]:.4f}),"
                  f" {100 * bound / ms:.1f} % of the 3xTF32 bound "
                  f"{bound:.4f} ms, {lib_ms / ms:.2f}x the library "
                  f"(sdpa {lib_ms:.4f} ms)", flush=True)
        del q, k, v, kr, vr
        torch.cuda.empty_cache()
    print(f"{'FAILED' if bad else 'ok'}: {bad} case(s) out of tolerance")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
