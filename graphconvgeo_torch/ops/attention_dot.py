"""Dot-product edge attention over a :class:`TiledAttentionPattern`: the
attention of UniMP's graph transformer layer (Shi et al., *Masked Label
Prediction*, IJCAI 2021; ``models/transformer.py``), three hand-written
CUDA kernels, their plain versions and the layer's autograd Function.

The JAX package has no such layer, so these kernels replace no TPU kernel
(as rows S and D of PERF.md's kernel table). For heads h of f columns, the
score of edge (i, j) is ``⟨q_i, k_j⟩ · scale`` (``scale = 1/√f``), α the
softmax of the scores over row i's edges and κ the attention dropout, kept
exactly where ``ops/dropout.py :: entry_keep`` keeps the GAT's entry of the
same row, column and head (``ops/attention_tiled.py :: _edge_keep``):

- :func:`dot_attn_fwd` — ``out_i = Σ_j κα_ij v_j``, the row maxima m and
  sums den (m = 0, den = 1, out = 0 for a row with no edge);
- :func:`dot_attn_bwd_row` — ``c_i = ⟨g_i, out_i⟩``, ``ds_ij = α(κ⟨g_i,
  v_j⟩ − c_i)`` and ``dq_i = scale · Σ_j ds_ij k_j``;
- :func:`dot_attn_bwd_col` — ``dk_j = scale · Σ_i ds_ij q_i`` and ``dv_j =
  Σ_i κα_ij g_i``.

The sweeps walk the pattern's whole edge lists, ``att.all_edges`` by row
and ``att.all_edges_t`` by column (the tiled and the rest's edges, as the
GAT's layer walks them), on every device. Each recomputes the scores from
the rows it gathers: no per-edge array is stored (``csrc/gat_tiled.cu``'s
note says why). q, k and v are column blocks of the layer's packed
projection ``p = [q | k | v | r]`` ([rows, ld], ``ld ≥ 3·H·f``), read in
place with its row stride; the backward writes dq, dk and dv into the same
blocks of one gradient array, with no copy. Each wrapper takes its plain
PyTorch version for CPU tensors and launches the kernel for CUDA tensors
(or raises); the plain versions are the kernels' edge walk in torch ops, a
chunk of edges at a time, and sum the same products in another order.

:class:`_TiledDotAttnCore` is the layer's attention: forward ``(out, r)``
from ``p`` (r = ``p``'s columns past 3·H·f, copied out, so that the gated
residual reads it and its gradient goes back into the same gradient array);
backward the two sweeps. Each forward and each backward application adds
the pattern's edges to ``profiling.counters["dot_attn_edges"]``. Memory at
Twitter-US size (449,694 rows, 4 heads of 150): p is 4.32 GB, out, r and
each [n, H·f] gradient 1.08 GB, m and den 7 MB each; the Function saves p,
out, m and den.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from graphconvgeo_torch.ops.attention_tiled import (
    EDGE_MAX_F,
    _edge_chunks,
    _edge_keep,
    _keep_scale,
    _route,
)
from graphconvgeo_torch.utils import cuda_build, profiling

_NEG = -1e30
_M32 = 0xFFFFFFFF


def softmax_scale(f: int) -> float:
    """1/√f in float32, the scores' scale for heads of ``f`` columns."""
    return float(np.float32(1.0 / math.sqrt(f)))


def _blocks(p: torch.Tensor, heads: int, width: int) -> tuple:
    """The [rows, H, f] views of q, k and v in ``p``'s first 3·width
    columns."""
    rows, f = p.shape[0], width // heads
    return tuple(p[:, i * width:(i + 1) * width].reshape(rows, heads, f) for i in range(3))


def _keep(att, rows, cols, heads, seed, rate):
    return _edge_keep(rows, cols, heads=heads, n_cols=att.n_cols,
                      head_stride=att.n_rows * att.n_cols, seed=seed, rate=rate)


def _scores(qh, kh, rows, cols, scale):
    return (qh[rows] * kh[cols]).sum(-1) * scale


# ------------------------------------------------------- plain versions
def dot_attn_fwd_plain(att, p, heads, width, *, scale, seed, rate):
    """(out [n_rows, width], m [n_rows, H], den [n_rows, H]) over
    ``att.all_edges``: per row the max m of its edges' scores, ``den = Σ
    exp(sc − m)`` and ``out = Σ κ·exp(sc − m)·v_j / den``."""
    edges = att.all_edges
    qh, kh, vh = _blocks(p, heads, width)
    n = att.n_rows
    m = p.new_full((n, heads), _NEG)
    for rows, cols in _edge_chunks(edges, 2 * width):
        m.scatter_reduce_(0, rows[:, None].expand(-1, heads), _scores(qh, kh, rows, cols, scale),
                          "amax")
    den = p.new_zeros((n, heads))
    o = p.new_zeros((n, heads, width // heads))
    for rows, cols in _edge_chunks(edges, 2 * width):
        e = torch.exp(_scores(qh, kh, rows, cols, scale) - m[rows])
        den.index_add_(0, rows, e)
        if rate > 0.0:
            e = e * _keep(att, rows, cols, heads, seed, rate)
        o.index_add_(0, rows, e[..., None] * vh[cols])
    m = torch.where(m > _NEG / 2, m, 0.0)
    den = torch.where(den > 0, den, 1.0)
    return o.div_(den[:, :, None]).view(n, width), m, den


def _edge_ds(att, rows, cols, qh, kh, vh, gh, m, den, c, *, scale, seed, rate):
    """(κα [e,H], ds [e,H]) of a chunk of edges (rows[k], cols[k]): α =
    exp(sc − m_i) / den_i, ds = α(κ⟨g_i, v_j⟩ − c_i)."""
    alpha = torch.exp(_scores(qh, kh, rows, cols, scale) - m[rows]) / den[rows]
    gv = (gh[rows] * vh[cols]).sum(-1)
    kalpha = alpha
    if rate > 0.0:
        kf = _keep(att, rows, cols, m.shape[1], seed, rate)
        gv, kalpha = kf * gv, kf * alpha
    return kalpha, alpha * (gv - c[rows])


def dot_attn_bwd_row_plain(att, p, out, g, m, den, heads, width, *, scale, seed, rate):
    """(dq [n_rows, width], c [n_rows, H]) over ``att.all_edges``: ``c_i =
    ⟨g_i, out_i⟩`` per head and ``dq_i = scale · Σ_j ds_ij k_j``."""
    qh, kh, vh = _blocks(p, heads, width)
    n, f = att.n_rows, width // heads
    gh = g.reshape(n, heads, f)
    c = (gh * out.reshape(n, heads, f)).sum(-1)
    dq = p.new_zeros((n, heads, f))
    for rows, cols in _edge_chunks(att.all_edges, 2 * width):
        _, ds = _edge_ds(att, rows, cols, qh, kh, vh, gh, m, den, c, scale=scale, seed=seed,
                         rate=rate)
        dq.index_add_(0, rows, (ds * scale)[..., None] * kh[cols])
    return dq.view(n, width), c


def dot_attn_bwd_col_plain(att, p, g, m, den, c, heads, width, *, scale, seed, rate):
    """(dk, dv [n_cols, width]) over ``att.all_edges_t``: ``dk_j = scale ·
    Σ_i ds_ij q_i`` and ``dv_j = Σ_i κα_ij g_i``."""
    qh, kh, vh = _blocks(p, heads, width)
    n, f = att.n_rows, width // heads
    gh = g.reshape(n, heads, f)
    dk = p.new_zeros((att.n_cols, heads, f))
    dv = torch.zeros_like(dk)
    for cols, rows in _edge_chunks(att.all_edges_t, 2 * width):
        kalpha, ds = _edge_ds(att, rows, cols, qh, kh, vh, gh, m, den, c, scale=scale,
                              seed=seed, rate=rate)
        dk.index_add_(0, cols, (ds * scale)[..., None] * qh[rows])
        dv.index_add_(0, cols, kalpha[..., None] * gh[rows])
    return dk.view(-1, width), dv.view(-1, width)


# ------------------------------------------------------- CUDA wrappers
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# trailing scalars of every entry: scale, dropout, seed, keep_thr, keep_scale,
# n_cols, head_stride, stream; before them n (rows or columns), ld, heads, f
_TAIL = [_I] * 4 + [_F, _I, _U, _U, _F, _U, _U, _P]
_ENTRIES = {
    "dot_attn_fwd": ("dot_attn_fwd_f32", [_P] * 8 + _TAIL),
    "dot_attn_bwd_row": ("dot_attn_bwd_row_f32", [_P] * 11 + _TAIL),
    "dot_attn_bwd_col": ("dot_attn_bwd_col_f32", [_P] * 11 + _TAIL),
}


def _check(att, p, heads, width, named):
    """Refuse what the kernels do not take: a head outside (0,
    :data:`EDGE_MAX_F`] columns, p without its q, k, v blocks or rows for
    the pattern's rows and columns, and any of ``named`` — (name, tensor,
    shape) — not float32 on p's device, of another shape or not
    contiguous."""
    f = width // heads
    if width % heads or not (0 < f <= EDGE_MAX_F and 0 < heads <= 65535):
        raise ValueError(f"the dot-attention kernels take heads of 0 < f <= {EDGE_MAX_F} "
                         f"columns, got width {width} in {heads} heads")
    if p.dtype != torch.float32 or p.dim() != 2 or p.stride(1) != 1:
        raise ValueError("p must be a float32 [rows, ld] array with unit column stride")
    if p.shape[1] < 3 * width or p.shape[0] != att.n_rows or att.n_rows != att.n_cols:
        raise ValueError(f"p must be [{att.n_rows}, >= {3 * width}] over a square pattern, "
                         f"got {tuple(p.shape)} for {att.n_rows} x {att.n_cols}")
    for name, t, shape in named:
        if t.device != p.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {p.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}, got {tuple(t.shape)}")


def _launch(kernel, att, ptrs, n, ld, heads, f, *, scale, seed, rate, device):
    thr, keep = _keep_scale(rate) if rate > 0.0 else (0, 1.0)
    symbol, argtypes = _ENTRIES[kernel]
    fn = getattr(cuda_build.load("gat_tiled"), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*ptrs, n, ld, heads, f, float(scale), int(rate > 0.0), int(seed) & _M32, thr,
                 keep, att.n_cols & _M32, (att.n_rows * att.n_cols) & _M32,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {err}")
    cuda_build.launch_counts[kernel] += 1


def _qkv_ptrs(p, width):
    base, item = p.data_ptr(), p.element_size()
    return [base + i * width * item for i in range(3)]


def dot_attn_fwd(att, p, heads, width, *, scale, seed, rate):
    """(out [n_rows, width], m, den [n_rows, H]) of the forward sweep over
    ``att.all_edges``; p [n_rows, ld] holds q, k, v in its first 3·width
    columns."""
    if not _route(p):
        return dot_attn_fwd_plain(att, p, heads, width, scale=scale, seed=seed, rate=rate)
    edges = att.all_edges
    _check(att, p, heads, width, [])
    n = att.n_rows
    out = torch.empty((n, width), dtype=torch.float32, device=p.device)
    m = torch.empty((n, heads), dtype=torch.float32, device=p.device)
    den = torch.empty_like(m)
    ptrs = [edges.ptr.data_ptr(), edges.idx.data_ptr(), *_qkv_ptrs(p, width),
            out.data_ptr(), m.data_ptr(), den.data_ptr()]
    _launch("dot_attn_fwd", att, ptrs, n, p.stride(0), heads, width // heads, scale=scale,
            seed=seed, rate=rate, device=p.device)
    return out, m, den


def dot_attn_bwd_row(att, p, out, g, m, den, dp, heads, width, *, scale, seed, rate):
    """c [n_rows, H] of the row sweep over ``att.all_edges``, writing dq into
    the first width columns of ``dp`` (p's layout; on the CPU ``dp`` takes
    the plain version's dq by copy)."""
    if not _route(p):
        dq, c = dot_attn_bwd_row_plain(att, p, out, g, m, den, heads, width, scale=scale,
                                       seed=seed, rate=rate)
        dp[:, :width] = dq
        return c
    edges = att.all_edges
    n = att.n_rows
    _check(att, p, heads, width, [("out", out, (n, width)), ("g", g, (n, width)),
                                  ("m", m, (n, heads)), ("den", den, (n, heads))])
    if dp.shape != p.shape or dp.stride() != p.stride() or dp.device != p.device:
        raise ValueError("dp must have p's shape, strides and device")
    c = torch.empty_like(m)
    ptrs = [edges.ptr.data_ptr(), edges.idx.data_ptr(), *_qkv_ptrs(p, width), out.data_ptr(),
            g.data_ptr(), m.data_ptr(), den.data_ptr(), dp.data_ptr(), c.data_ptr()]
    _launch("dot_attn_bwd_row", att, ptrs, n, p.stride(0), heads, width // heads, scale=scale,
            seed=seed, rate=rate, device=p.device)
    return c


def dot_attn_bwd_col(att, p, g, m, den, c, dp, heads, width, *, scale, seed, rate):
    """The column sweep over ``att.all_edges_t``, writing dk and dv into
    columns width … 3·width of ``dp``."""
    if not _route(p):
        dk, dv = dot_attn_bwd_col_plain(att, p, g, m, den, c, heads, width, scale=scale,
                                        seed=seed, rate=rate)
        dp[:, width:2 * width] = dk
        dp[:, 2 * width:3 * width] = dv
        return
    edges_t = att.all_edges_t
    n = att.n_rows
    _check(att, p, heads, width, [("g", g, (n, width)), ("m", m, (n, heads)),
                                  ("den", den, (n, heads)), ("c", c, (n, heads))])
    if dp.shape != p.shape or dp.stride() != p.stride() or dp.device != p.device:
        raise ValueError("dp must have p's shape, strides and device")
    dks = _qkv_ptrs(dp, width)
    ptrs = [edges_t.ptr.data_ptr(), edges_t.idx.data_ptr(), *_qkv_ptrs(p, width), g.data_ptr(),
            m.data_ptr(), den.data_ptr(), c.data_ptr(), dks[1], dks[2]]
    _launch("dot_attn_bwd_col", att, ptrs, att.n_cols, p.stride(0), heads, width // heads,
            scale=scale, seed=seed, rate=rate, device=p.device)


# ---------------------------------------------------------- the layer
class _TiledDotAttnCore(torch.autograd.Function):
    """UniMP's attention over a tiled pattern's whole edge lists,
    differentiable in ``p = [q | k | v | r]``: forward (out, r), r =
    ``p``'s columns past 3·width copied out; backward the row and column
    sweeps, which write dq, dk and dv into one gradient array of ``p``'s
    layout, and r's gradient copied into its columns."""

    @staticmethod
    def forward(ctx, p, att, heads, width, seed, rate):
        scale = softmax_scale(width // heads)
        out, m, den = dot_attn_fwd(att, p, heads, width, scale=scale, seed=seed, rate=rate)
        profiling.counters["dot_attn_edges"] += att.all_edges.nnz
        ctx.att, ctx.heads, ctx.width, ctx.seed, ctx.rate = att, heads, width, seed, rate
        ctx.save_for_backward(p, out, m, den)
        return out, p[:, 3 * width:].contiguous()

    @staticmethod
    def backward(ctx, g, g_r):
        att, heads, width = ctx.att, ctx.heads, ctx.width
        p, out, m, den = ctx.saved_tensors
        kw = dict(scale=softmax_scale(width // heads), seed=ctx.seed, rate=ctx.rate)
        dp = torch.empty_like(p)
        g = g.contiguous()
        c = dot_attn_bwd_row(att, p, out, g, m, den, dp, heads, width, **kw)
        dot_attn_bwd_col(att, p, g, m, den, c, dp, heads, width, **kw)
        dp[:, 3 * width:] = g_r  # autograd gives zeros for an r left unused
        profiling.counters["dot_attn_edges"] += att.all_edges.nnz
        return dp, None, None, None, None, None


def dot_attention_tiled(att, p: torch.Tensor, heads: int, width: int, *, attn_dropout: float = 0.0,
                        seed: int = 0) -> tuple:
    """Multi-head dot-product attention over ``att``'s whole pattern: p
    [n, ld] float32 holds q, k and v (each [n, width], ``heads`` heads of
    width/heads columns) in its first 3·width columns → (out [n, width],
    ``p[:, 3·width:]`` copied). Attention dropout drops weights after the
    softmax by the position-keyed hash under the integer ``seed``,
    recomputed in every sweep."""
    rate = float(attn_dropout)
    return _TiledDotAttnCore.apply(p, att, int(heads), int(width),
                                   int(seed) if rate > 0.0 else 0, rate)
