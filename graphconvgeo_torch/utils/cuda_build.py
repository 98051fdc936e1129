"""Build-on-first-use for the hand-written CUDA kernels, and their launch counts.

Each ``csrc/<stem>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``graphconvgeo_torch/_build/``,
stamped with a hash of the source and the flags (edits rebuild), and is
loaded with ctypes. :func:`build` starts one ``nvcc`` per source, all at
once. Nothing here runs at import time: the CPU-only test machine imports
every module but never builds.

``launch_counts`` holds one plain integer per kernel; each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNEL_SOURCES = {
    "bsr_flat": "bsr_flat.cu",
    "gat_tiled": "gat_tiled.cu",
    "sddmm_bsr": "sddmm_bsr.cu",
    "gather": "gather.cu",
    "dense_3xtf32": "dense_3xtf32.cu",
}

launch_counts: dict = {
    "bsr_flat_matmul": 0,
    "bsr_flat_matmul_bf16": 0,
    "bsr_matmul": 0,
    "sddmm_bsr": 0,
    "gather_rows": 0,
    "gat_scores": 0,
    "gat_tile_fwd": 0,
    "gat_tile_bwd_row": 0,
    "gat_tile_bwd_col": 0,
    "gat_tile_fwd_bf16": 0,
    "gat_tile_bwd_row_bf16": 0,
    "gat_tile_bwd_col_bf16": 0,
    "dot_attn_fwd": 0,
    "dot_attn_bwd_row": 0,
    "dot_attn_bwd_col": 0,
    "dense_nn": 0,
    "dense_nt": 0,
    "dense_tn": 0,
}
# stem -> {"seconds": wall seconds of its nvcc, "ptxas": the compiler's
# register / shared-memory report}; filled by builds made in this process
build_log: dict = {}
_LIBS: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def lib_path(stem: str) -> str:
    src = os.path.join(SRC_DIR, KERNEL_SOURCES[stem])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build(stems=None) -> dict:
    """Compile every listed kernel library that is not built yet, one
    ``nvcc`` per source, all started together. Raises with the compiler's
    output if any fails. Returns :data:`build_log`."""
    stems = list(KERNEL_SOURCES) if stems is None else list(stems)
    todo = [s for s in stems if not os.path.exists(lib_path(s))]
    if not todo:
        return build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for stem in todo:
        tmp = f"{lib_path(stem)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, KERNEL_SOURCES[stem])]
        procs[stem] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for stem, (tmp, t0, proc) in procs.items():
        output, _ = proc.communicate()
        build_log[stem] = {"seconds": time.perf_counter() - t0, "ptxas": output.strip()}
        if proc.returncode != 0:
            failed.append(f"{stem}:\n{output}")
        else:
            os.replace(tmp, lib_path(stem))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return build_log


def load(stem: str) -> ctypes.CDLL:
    """The kernel library for ``stem``, built first if needed. The first
    call of a process hashes the source; later calls return the loaded
    library (a wrapper calls this on every launch)."""
    if stem not in _LIBS:
        path = lib_path(stem)
        build([stem])
        _LIBS[stem] = ctypes.CDLL(path)
    return _LIBS[stem]
