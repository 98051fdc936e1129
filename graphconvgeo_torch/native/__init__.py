"""Native (C++) fast paths for host-side preprocessing.

Build-on-first-use: each ``.cpp`` here compiles with g++ into a shared
library under ``graphconvgeo_torch/_build/`` (content-hash-stamped, so edits
rebuild). Callers fall back to pure-Python implementations if the toolchain
is missing.

Components:
- ``projection.cpp`` — @-mention clique projection (the reference's
  ``efficient_collaboration_weighted_projected_graph2`` hot loop);
- ``clustering.cpp`` — label-propagation communities for the SpMM
  tile-coverage reordering.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB_CACHE: dict = {}


def _load_lib(stem: str) -> ctypes.CDLL:
    src = os.path.join(_DIR, f"{stem}.cpp")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:12]
    lib = os.path.join(BUILD_DIR, f"_{stem}_{h}.so")
    if lib in _LIB_CACHE:
        return _LIB_CACHE[lib]
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", src, "-o", tmp],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, lib)
    dll = ctypes.CDLL(lib)
    _LIB_CACHE[lib] = dll
    return dll


_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def project_cliques(ext_neighbors: dict, n_users: int):
    """C++ clique expansion. ``ext_neighbors``: external account -> list of
    dataset-user ids. Returns (src, dst) int64 arrays of projected edges."""
    dll = _load_lib("projection")
    dll.count_clique_edges.argtypes = [_i64p, ctypes.c_int64]
    dll.count_clique_edges.restype = ctypes.c_int64
    dll.project_cliques.argtypes = [_i64p, ctypes.c_int64, _i64p, _i64p, _i64p]
    dll.project_cliques.restype = ctypes.c_int64

    groups = [np.asarray(v, dtype=np.int64) for v in ext_neighbors.values() if len(v) >= 2]
    if not groups:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    offsets = np.zeros(len(groups) + 1, dtype=np.int64)
    np.cumsum([len(g) for g in groups], out=offsets[1:])
    members = np.concatenate(groups)
    total = dll.count_clique_edges(offsets, len(groups))
    src = np.empty(total, dtype=np.int64)
    dst = np.empty(total, dtype=np.int64)
    n = dll.project_cliques(offsets, len(groups), members, src, dst)
    assert n == total, (n, total)
    return src, dst


def label_propagation(indptr: np.ndarray, indices: np.ndarray, *, iters: int = 10) -> np.ndarray:
    """Community labels via synchronous label propagation (deterministic)."""
    dll = _load_lib("clustering")
    dll.label_propagation.argtypes = [_i64p, _i32p, ctypes.c_int64, ctypes.c_int32, _i32p]
    dll.label_propagation.restype = None
    n = len(indptr) - 1
    labels = np.arange(n, dtype=np.int32)
    dll.label_propagation(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        n,
        iters,
        labels,
    )
    return labels
