"""Sparse-matrix × dense-matrix products (the framework's hot op).

The reference computes one GCN propagation as
``theano.sparse.structured_dot(A_hat, H.dot(W))``
(``gcnmodel.py :: SparseConvolutionDenseLayer``); its backward is
``A_hatᵀ · G``. Here each product is an autograd Function whose backward
runs the same product on the transpose operand; the standard products treat
the sparse operand as a constant (no gradient flows into edge values). For
trainable edge weights :func:`spmm_ell_trainable` also returns the value
gradient, by SDDMM (``ops/sddmm.py``).

Backends of this port (the JAX package's single-device set):
- ``ell``    — row-padded gathers (:class:`EllMatrix`), plain PyTorch.
- ``bell``   — degree-bucketed gathers (:class:`BucketedEll`), plain PyTorch.
- ``bsr``    — dense 128² tiles over padded per-row-block tile lists
  (:class:`BsrMatrix`) through the hand-written CUDA kernel
  (:mod:`graphconvgeo_torch.ops.spmm_bsr`).
- ``hybrid`` — dense 256² tiles (:class:`BsrFlat`) through the same CUDA
  body plus a bucketed-ELL or :class:`CachedBell` rest.
- ``oracle`` — a segment-sum reference over the ELL operand (the eager
  :func:`spmm`); as a model backend it runs the ``ell`` path, as in JAX.
- ``auto``   — ``hybrid`` when enough edge mass sits in dense tiles, else
  ``bell``.

The factorized projection adjacency is not a backend of a
:class:`SparseGraph` but an operand of its own
(:class:`~graphconvgeo_torch.sparse.factorized.FactorizedAdjacency`), which
:func:`spmm_operands` dispatches to :func:`spmm_factorized`, as in JAX.

``gather_dtype`` (e.g. ``torch.bfloat16``) casts h before the gathers of
the bucketed products; their sums stay float32 and the output follows h's
dtype. On the factorized operand it also sets the tiles' contraction.
"""

from __future__ import annotations

import torch

from graphconvgeo_torch.ops import dense
from graphconvgeo_torch.ops.sddmm import sddmm_ell
from graphconvgeo_torch.ops.spmm_bsr import spmm_bsr, spmm_bsr_flat
from graphconvgeo_torch.sparse.formats import (
    BsrFlat,
    BsrMatrix,
    BucketedEll,
    CachedBell,
    EllMatrix,
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


def spmm_oracle(indices: torch.Tensor, values: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Segment-sum reference: out[i] = Σ_k values[i,k] · h[indices[i,k]]
    (one gather, one ``index_add``; differentiated by autograd)."""
    n, k = indices.shape
    gathered = h.index_select(0, indices.reshape(-1)) * values.reshape(-1, 1)
    seg = torch.arange(n, device=h.device).repeat_interleave(k)
    return gathered.new_zeros((n, h.shape[1])).index_add(0, seg, gathered)


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


class _GatherCore(torch.autograd.Function):
    """out = matvec(mat, h); dh = matvec(mat_t, g) — the gather products
    (ELL, bucketed ELL) with the edge values as constants. The cotangent is
    cast to h's dtype before its gathers, and dh to h's dtype after, as the
    JAX package's ``_spmm_bell_bwd`` does (a no-op for float32 h)."""

    @staticmethod
    def forward(ctx, h, matvec, mat, mat_t):
        ctx.matvec, ctx.mat_t, ctx.h_dtype = matvec, mat_t, h.dtype
        return matvec(mat, h)

    @staticmethod
    def backward(ctx, g):
        dh = ctx.matvec(ctx.mat_t, g.to(ctx.h_dtype).contiguous()).to(ctx.h_dtype)
        return dh, None, None, None


def _ell_apply(mat: EllMatrix, h: torch.Tensor) -> torch.Tensor:
    return _ell_matvec(mat.indices, mat.values, h)


def spmm_ell(mat: EllMatrix, mat_t: EllMatrix, h: torch.Tensor) -> torch.Tensor:
    """ELL SpMM, differentiable in ``h`` (``mat_t`` drives the backward
    gather). Returns ``mat``'s rows."""
    return _GatherCore.apply(h, _ell_apply, mat, mat_t)[: mat.indices.shape[0]]


class _EllTrainCore(torch.autograd.Function):
    """out = ell(values) @ h; dh = ell_t @ g and dvalues = SDDMM(g, h) on
    the pattern. ``values_t`` serves the backward only, so it gets no
    gradient of its own."""

    @staticmethod
    def forward(ctx, values, h, indices, indices_t, values_t):
        ctx.save_for_backward(values, h, indices, indices_t, values_t)
        return _ell_matvec(indices, values, h)

    @staticmethod
    def backward(ctx, g):
        values, h, indices, indices_t, values_t = ctx.saved_tensors
        g = g.contiguous()
        dvalues = dh = None
        if ctx.needs_input_grad[0]:
            # dL/dvalues[i,k] = <g[i], h[indices[i,k]]>
            dvalues = sddmm_ell(indices, g.to(values.dtype), h.to(values.dtype))
        if ctx.needs_input_grad[1]:
            dh = _ell_matvec(indices_t, values_t, g)
        return dvalues, dh, None, None, None


def spmm_ell_trainable(mat: EllMatrix, mat_t: EllMatrix, h: torch.Tensor) -> torch.Tensor:
    """ELL SpMM whose backward also yields the edge-value gradient (SDDMM),
    for trainable edge weights: differentiable in ``mat.values`` and ``h``.
    Keep ``mat_t.values`` consistent with ``mat.values`` between optimizer
    steps (the transpose carries no gradient of its own)."""
    out = _EllTrainCore.apply(mat.values, h, mat.indices, mat_t.indices, mat_t.values)
    return out[: mat.indices.shape[0]]


def spmm_bell(
    bell: BucketedEll, bell_t: BucketedEll, h: torch.Tensor, *, gather_dtype=None
) -> torch.Tensor:
    """Bucketed-ELL SpMM, differentiable in ``h`` (``bell_t`` drives the
    backward gather). ``gather_dtype`` casts h before the row gathers (e.g.
    bfloat16); the sums stay float32 and the output follows h's dtype."""
    if gather_dtype is not None and gather_dtype != h.dtype:
        return _GatherCore.apply(h.to(gather_dtype), _bell_matvec, bell, bell_t).to(h.dtype)
    return _GatherCore.apply(h, _bell_matvec, bell, bell_t)


def resolve_backend(graph: SparseGraph) -> str:
    """``hybrid`` when enough edge mass falls in dense tiles (community-
    reordered mention graphs), ``bell`` otherwise."""
    cov = graph.tile_coverage()
    return "hybrid" if cov >= _HYBRID_COVERAGE_THRESHOLD else "bell"


def device_operands(graph: SparseGraph, backend: str = "auto", device="cpu") -> tuple:
    """The (fmt, fmt_t) operands for a backend, moved to ``device``."""
    if backend == "auto":
        backend = resolve_backend(graph)
    if backend in ("ell", "oracle"):
        ops = (graph.ell(), graph.ell_t())
    elif backend == "bell":
        ops = (graph.bell(), graph.bell_t())
    elif backend == "bsr":
        ops = (graph.bsr(), graph.bsr_t())
    elif backend == "hybrid":
        ops = (graph.hybrid(), graph.hybrid_t())
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return to_device(ops, device)


def spmm_cached_bell(cb: CachedBell, h: torch.Tensor, *, gather_dtype=None) -> torch.Tensor:
    """Residual SpMM with the hot-column split: hot edges gather from the
    compact ``h[hot_ids]`` table, cold edges from the full matrix. Autograd
    scatters the compact cotangent back into dh."""
    h_hot = h.index_select(0, cb.hot_ids)
    out = spmm_bell(cb.cold, cb.cold_t, h, gather_dtype=gather_dtype)
    return out + spmm_bell(cb.hot, cb.hot_t, h_hot, gather_dtype=gather_dtype)


def spmm_slabbed(sb: SlabbedBell, w0: torch.Tensor, *, gather_dtype=None) -> torch.Tensor:
    """X·W0 with the Zipf-head dense slab: ``slab @ W0[cols]`` + the residual
    gather SpMM. Differentiable in w0.

    As in JAX, ``W0[cols]`` is rounded to the slab's dtype and the product
    is summed in float32 whatever that dtype (``preferred_element_type``),
    then cast to w0's: each bf16 × bf16 product is exact in float32, so the
    terms are JAX's and only the summation order differs. Where
    ``ops/dense.py`` engages, the 3×TF32 kernel reads a bf16 slab and
    W0[cols] as they are (exact in TF32: one term); elsewhere both are
    widened to float32 for ``torch.matmul``. The caller keeps TF32 off for
    float32 products (``chip_smoke.py`` asserts it)."""
    w_head = w0.index_select(0, sb.cols).to(sb.slab.dtype)
    out = dense.matmul(sb.slab, w_head, torch.float32).to(w0.dtype)
    if isinstance(sb.rest, CachedBell):
        out = out + spmm_cached_bell(sb.rest, w0, gather_dtype=gather_dtype)[: out.shape[0]]
    elif sb.rest is not None:
        out = out + spmm_bell(sb.rest, sb.rest_t, w0, gather_dtype=gather_dtype)[: out.shape[0]]
    return out


def spmm_operands(fmt, fmt_t, h: torch.Tensor, *, n_rows: int, gather_dtype=None) -> torch.Tensor:
    """SpMM against operand objects (format-dispatched). ``gather_dtype``
    reaches the bucketed products' gathers and, on the factorized operand,
    its gathers and its tiles' contraction alike (both round the operator's
    inputs to the same dtype, as the JAX package pairs them)."""
    from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency, spmm_factorized

    if isinstance(fmt, FactorizedAdjacency):
        return spmm_factorized(fmt, h, gather_dtype=gather_dtype, mxu_dtype=gather_dtype)[:n_rows]
    if isinstance(fmt, SlabbedBell):
        return spmm_slabbed(fmt, h, gather_dtype=gather_dtype)[:n_rows]
    if isinstance(fmt, CachedBell):
        return spmm_cached_bell(fmt, h, gather_dtype=gather_dtype)[:n_rows]
    if isinstance(fmt, BucketedEll):
        return spmm_bell(fmt, fmt_t, h, gather_dtype=gather_dtype)[:n_rows]
    if isinstance(fmt, EllMatrix):
        return spmm_ell(fmt, fmt_t, h)[:n_rows]
    if isinstance(fmt, BsrMatrix):
        return spmm_bsr(fmt, fmt_t, h)[:n_rows]
    if isinstance(fmt, BsrFlat):
        return spmm_bsr_flat(fmt, fmt_t, h)[:n_rows]
    if isinstance(fmt, tuple):  # hybrid (BsrFlat | BsrMatrix | None, rest | None)
        bsr_p, rest = fmt
        bsr_tp, rest_t = fmt_t
        out = None
        if isinstance(bsr_p, BsrFlat):
            out = spmm_bsr_flat(bsr_p, bsr_tp, h)[:n_rows]
        elif bsr_p is not None:
            out = spmm_bsr(bsr_p, bsr_tp, h)[:n_rows]
        if rest is not None:
            if isinstance(rest, CachedBell):
                o2 = spmm_cached_bell(rest, h, gather_dtype=gather_dtype)[:n_rows]
            else:
                o2 = spmm_bell(rest, rest_t, h, gather_dtype=gather_dtype)[:n_rows]
            out = o2 if out is None else out + o2
        if out is None:  # empty matrix
            out = h.new_zeros((n_rows, h.shape[1]))
        return out
    raise TypeError(f"unknown sparse operand type {type(fmt)}")


def spmm(graph: SparseGraph, h: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """SpMM against a host-managed :class:`SparseGraph`, with the operands
    moved to ``h``'s device (eager API; a model builds its operands once
    with :func:`device_operands` and calls :func:`spmm_operands`).

    ``h`` must have ``graph.shape[1]`` rows (padding rows beyond that are
    allowed and ignored). Returns ``graph.shape[0]`` rows."""
    if backend == "oracle":
        ell = to_device(graph.ell(), h.device)
        return spmm_oracle(ell.indices, ell.values, h)[: graph.shape[0]]
    fmt, fmt_t = device_operands(graph, backend, h.device)
    return spmm_operands(fmt, fmt_t, h, n_rows=graph.shape[0])
