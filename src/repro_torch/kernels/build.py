"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, and loaded with ``ctypes``. A
library is built at its first use, never at import, under
``build/torch_kernels/`` at the root of the checkout; its file name carries
a hash of the source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. :func:`build` compiles several sources at
once, one ``nvcc`` process each, all started together.

Every C entry point takes its pointers and the stream as ``c_void_p``,
launches on the stream it is given, allocates nothing and returns
``cudaGetLastError()``; :func:`check` turns a non-zero return into an
exception.

A wrapper given tensors without storage (on the ``meta`` device, as the
dry-run traces a rank of a cluster) builds and launches nothing: it makes
its outputs as the kernel would and reports the kernel's work to
:func:`traced`, which hands it to the op counter (``launch/op_cost.py``)
while one is active.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_uint)
# source name -> {C function: argtypes}; every function returns an int
SIGNATURES = {
    "topk_scan": {
        # dtype, width, qw, table, scales, queries, Q, d, valid, k,
        # rows_per_split, splits, part_v, part_i, counts, gtau, stream
        "topk_filter_partials": [_I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _P, _P, _P, _P, _P],
        # part_v, part_i, gtau, Q, splits, k, out_v, out_i, stream
        "topk_filter_merge": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
        # dtype, width, qw, table, queries, Q, d, n, a, eps, stream
        "topk_filter_export": [_I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P],
    },
    "topk_rowwise": {
        # dtype, table, queries, Q, d, valid, k, chunk_rows, scratch,
        # out_v, out_i, candidates, candidate cap, stream
        "topk_rowwise": [_I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                         _P],
    },
    "gather_rows": {
        # table, idx, B, row_bytes, vec_bytes, lanes_log2, blocks, out,
        # stream
        "gather_rows": [_P, _P, _I, _LL, _I, _I, _I, _P, _P],
        # table, idx, B, row_bytes, out, stream
        "gather_rows_rowwise": [_P, _P, _I, _LL, _P, _P],
    },
    "sgns_update": {
        # dtype, mask_bf16, vert, ctx, idx_v, idx_c, idx_n, mask, B, S, d,
        # lr, bb, nblk, blocks, smem, nc, work_floats, sort_chunk,
        # sort_keys, f32 scratch, int32 scratch, loss slot, accumulate,
        # stream
        "sgns_fused_update": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _F, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                              _P, _I, _P],
        # dtype, mask_bf16, vert, ctx, idx_v, idx_c, idx_n, mask, B, S, d,
        # bb, blocks, smem, nc, work_floats, work, dv, dc, dn_part,
        # loss_part, dn, loss, stream
        "sgns_fused_grads": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                             _P],
        # dtype, mask_bf16, v, c, n, mask, B, S, d, bb, blocks, smem, nc,
        # work_floats, work, dv, dc, dn_part, loss_part, dn, loss, stream
        "sgns_grads": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _I, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "scatter_rows": {
        # dtype, upd_f32, table, idx, upd, B, d, positions per chunk,
        # stream
        "scatter_add_rows": [_I, _I, _P, _P, _P, _I, _I, _I, _P],
        # dtype, upd_f32, table, idx, upd, B, d, positions per chunk,
        # stream
        "scatter_add_rows_rowwise": [_I, _I, _P, _P, _P, _I, _I, _I, _P],
    },
    "flash_attention": {
        # dtype, hd, hd_v, q, k, v, out, B, H, Hkv, Sq, Skv, causal,
        # window, scale, strides (batch, head, row) of q, k, v and out,
        # stream
        "flash_attention_fwd": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _F, *[_LL] * 12, _P],
        # dtype, hd, hd_v, out (8 int32)
        "flash_attention_info": [_I, _I, _I, _P],
    },
    "threefry": {
        # key words, T, S, span, kneg scratch, out, stream
        "negative_positions": [_U, _U, _LL, _I, _U, _P, _P, _P],
        # key words, n, kind, scale, out, stream
        "fill_random": [_U, _U, _LL, _I, _F, _P, _P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
_MU = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as PyTorch finds it, else
    ``nvcc`` on the PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names=tuple(SIGNATURES)) -> float:
    """Compile every named source that has no library yet, all in parallel.

    Returns the wall seconds spent; raises with the compiler's output if
    any build fails. The compiler's report (registers, shared memory,
    spills: ``-Xptxas -v``) is kept beside each library as ``.log``.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    with _MU:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


# the op counter's sink while it traces: fn(name, flops, nbytes)
TRACE_SINK = None


def traced(name: str, flops: float, nbytes: float) -> None:
    """Report one shape-only call of kernel ``name``: the operations it
    does and the bytes it must move."""
    if TRACE_SINK is not None:
        TRACE_SINK(name, flops, nbytes)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")
