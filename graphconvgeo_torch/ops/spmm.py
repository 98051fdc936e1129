"""Sparse-matrix × dense-matrix products (the framework's hot op).

The reference computes one GCN propagation as
``theano.sparse.structured_dot(A_hat, H.dot(W))``
(``gcnmodel.py :: SparseConvolutionDenseLayer``); its backward is
``A_hatᵀ · G``. Here each product is an autograd Function whose backward
runs the same product on the transpose operand; the sparse operand is a
constant (no gradient flows into edge values).

Backends of this port:
- ``bell``   — degree-bucketed gathers (:class:`BucketedEll`), plain PyTorch.
- ``hybrid`` — dense 256² tiles through the hand-written CUDA kernel
  (:mod:`graphconvgeo_torch.ops.spmm_bsr`) plus a bucketed-ELL or
  :class:`CachedBell` rest.
- ``auto``   — ``hybrid`` when enough edge mass sits in dense tiles, else
  ``bell``.

The JAX package's ``ell``, ``bsr`` and ``oracle`` backends and the
factorized adjacency are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import torch

from graphconvgeo_torch.ops.spmm_bsr import spmm_bsr_flat
from graphconvgeo_torch.sparse.formats import (
    BsrFlat,
    BucketedEll,
    CachedBell,
    SlabbedBell,
    SparseGraph,
    to_device,
)

# ELL slots folded into one gather step; bounds the [N, chunk, F] temporary.
_ELL_CHUNK = 8
# cap on the [N, chunk, F] gather high-water, in floats (4 GB of float32)
_ELL_BUDGET_FLOATS = 1 << 30

# Minimum fraction of edges in dense 256×256 tiles for ``auto`` to pick the
# hybrid path (the JAX package's measured break-even; kept so both packages
# resolve the same backend on the same graph).
_HYBRID_COVERAGE_THRESHOLD = 0.2

_NOT_PORTED = {
    "ell": "the remaining single-device backends",
    "bsr": "the remaining single-device backends",
    "oracle": "the remaining single-device backends",
    "factorized": "the factorized-adjacency slice",
}


def _ell_matvec(indices: torch.Tensor, values: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out[i] = Σ_k values[i,k] · h[indices[i,k]], over slot chunks: each step
    gathers ``chunk`` rows of h per output row (high-water [N, chunk, F]).

    The chunk width scales inversely with the row count so narrow, deep
    blocks (hub buckets) still issue large gathers per step."""
    n, k = indices.shape
    f = h.shape[1]
    chunk = min(max(_ELL_CHUNK, 4096 // max(n, 1)), k)
    chunk = max(1, min(chunk, _ELL_BUDGET_FLOATS // max(n * f, 1)))
    out = None
    for c0 in range(0, k, chunk):
        idx = indices[:, c0 : c0 + chunk]
        val = values[:, c0 : c0 + chunk]
        g = h.index_select(0, idx.reshape(-1)).view(n, idx.shape[1], f)
        part = torch.einsum("nc,ncf->nf", val, g.to(val.dtype))
        out = part if out is None else out + part
    return out


def _bell_matvec(bell: BucketedEll, h: torch.Tensor) -> torch.Tensor:
    """Degree-bucketed SpMM: per-bucket ELL matvecs on permuted rows, then one
    gather to restore row order."""
    outs = [_ell_matvec(i, v, h) for i, v in zip(bell.indices, bell.values)]
    out_sorted = torch.cat(outs, dim=0)
    if bell.natural:  # rows were bucket-grouped in place — no restore gather
        return out_sorted
    return out_sorted.index_select(0, bell.inv_perm)


class _BellCore(torch.autograd.Function):
    """out = bell @ h; dh = bell_t @ g."""

    @staticmethod
    def forward(ctx, h, bell, bell_t):
        ctx.bell_t = bell_t
        return _bell_matvec(bell, h)

    @staticmethod
    def backward(ctx, g):
        return _bell_matvec(ctx.bell_t, g.contiguous()), None, None


def spmm_bell(bell: BucketedEll, bell_t: BucketedEll, h: torch.Tensor) -> torch.Tensor:
    """Bucketed-ELL SpMM, differentiable in ``h`` (``bell_t`` drives the
    backward gather)."""
    return _BellCore.apply(h, bell, bell_t)


def resolve_backend(graph: SparseGraph) -> str:
    """``hybrid`` when enough edge mass falls in dense tiles (community-
    reordered mention graphs), ``bell`` otherwise."""
    cov = graph.tile_coverage()
    return "hybrid" if cov >= _HYBRID_COVERAGE_THRESHOLD else "bell"


def device_operands(graph: SparseGraph, backend: str = "auto", device="cpu") -> tuple:
    """The (fmt, fmt_t) operands for a backend, moved to ``device``."""
    if backend == "auto":
        backend = resolve_backend(graph)
    if backend == "bell":
        ops = (graph.bell(), graph.bell_t())
    elif backend == "hybrid":
        ops = (graph.hybrid(), graph.hybrid_t())
    elif backend in _NOT_PORTED:
        raise NotImplementedError(
            f"spmm backend {backend!r} is not ported yet; it comes with "
            f"{_NOT_PORTED[backend]} (ROADMAP.md)"
        )
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return to_device(ops, device)


def spmm_cached_bell(cb: CachedBell, h: torch.Tensor) -> torch.Tensor:
    """Residual SpMM with the hot-column split: hot edges gather from the
    compact ``h[hot_ids]`` table, cold edges from the full matrix. Autograd
    scatters the compact cotangent back into dh."""
    h_hot = h.index_select(0, cb.hot_ids)
    out = spmm_bell(cb.cold, cb.cold_t, h)
    return out + spmm_bell(cb.hot, cb.hot_t, h_hot)


def spmm_slabbed(sb: SlabbedBell, w0: torch.Tensor) -> torch.Tensor:
    """X·W0 with the Zipf-head dense slab: ``slab @ W0[cols]`` (one dense
    matrix product) + the residual gather SpMM. Differentiable in w0."""
    w_head = w0.index_select(0, sb.cols)
    out = torch.matmul(sb.slab, w_head)
    if isinstance(sb.rest, CachedBell):
        out = out + spmm_cached_bell(sb.rest, w0)[: out.shape[0]]
    elif sb.rest is not None:
        out = out + spmm_bell(sb.rest, sb.rest_t, w0)[: out.shape[0]]
    return out


def spmm_operands(fmt, fmt_t, h: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """SpMM against operand objects (format-dispatched)."""
    if isinstance(fmt, SlabbedBell):
        return spmm_slabbed(fmt, h)[:n_rows]
    if isinstance(fmt, CachedBell):
        return spmm_cached_bell(fmt, h)[:n_rows]
    if isinstance(fmt, BucketedEll):
        return spmm_bell(fmt, fmt_t, h)[:n_rows]
    if isinstance(fmt, BsrFlat):
        return spmm_bsr_flat(fmt, fmt_t, h)[:n_rows]
    if isinstance(fmt, tuple):  # hybrid (BsrFlat | None, rest | None)
        bsr_p, rest = fmt
        bsr_tp, rest_t = fmt_t
        out = None
        if bsr_p is not None:
            out = spmm_bsr_flat(bsr_p, bsr_tp, h)[:n_rows]
        if rest is not None:
            if isinstance(rest, CachedBell):
                o2 = spmm_cached_bell(rest, h)[:n_rows]
            else:
                o2 = spmm_bell(rest, rest_t, h)[:n_rows]
            out = o2 if out is None else out + o2
        if out is None:  # empty matrix
            out = h.new_zeros((n_rows, h.shape[1]))
        return out
    raise TypeError(f"unknown sparse operand type {type(fmt)}")
