"""Tiled (flash-style) GAT attention: three hand-written CUDA kernels, their
plain versions and the layer's autograd Function.

Port of ``graphconvgeo_tpu/ops/attention_tiled.py``. One layer is three
sweeps over a :class:`TiledAttentionPattern`:

- :func:`gat_tile_fwd` — per row: max ``m``, unnormalized aggregation ``o``
  and denominators ``den``;
- :func:`gat_tile_bwd_row` — ``ds`` (the per-edge ``g_i·z_j``);
- :func:`gat_tile_bwd_col` — ``dz`` and ``dd`` (the transpose sweep,
  ``(κα)ᵀ·g``).

Each wrapper takes its plain PyTorch version for CPU tensors and launches
``csrc/gat_tiled.cu`` for CUDA tensors (or raises); there is no fallback
from one to the other. Kernel and plain version walk the same compressed
edge lists: by default the tiled edges (``att.edges`` by row,
``att.edges_t`` by column), or the lists passed as ``edges``. The plain
versions are the kernels' algorithm in torch ops — a segment max, exp and
``index_add_`` over the list, a chunk of edges at a time, gathering a
head's first f columns — and sum the same products in another order.

The layer (:class:`_TiledGatCore`) walks the whole pattern's lists
(``att.all_edges``, ``att.all_edges_t``: the tiled edges and the bucketed
rest's together) on every device and at every precision, so the forward's
(m, den, o) and the backward's ds, dz and dd come straight from the three
sweeps. JAX's layer sweeps its tiles, runs its bucketed rest apart and
merges the two softmax states by exp-rescale: the same softmax over each
row's edges, summed in another order.

``mxu_precision`` picks the contractions' arithmetic, as the JAX package's
argument of that name does: None or ``"highest"`` is float32;
``"default"`` (the TPU's ``Precision.DEFAULT``, one bf16 MXU pass) rounds
both operands of each contraction to bf16 (nearest-even) and sums the
products in float32 — the forward's ``bf16(κe)·bf16(z)`` (``den`` stays
the sum of the unrounded e), the ds sweep's ``bf16(g)·bf16(z)``, the
column sweep's ``bf16(κα)·bf16(g)`` and ``bf16(g)·bf16(z)``. Nothing else
is rounded: the max, exp, den and keep hash stay float32. Every edge is
rounded alike, the rest's too (JAX's rest takes no precision argument).
The kernels launch a variant of their own under it (launch counts
``gat_tile_fwd_bf16``, ``gat_tile_bwd_row_bf16``,
``gat_tile_bwd_col_bf16``). JAX's fused forward rounds each e under the
running tile max and rescales later; the port rounds it under the row's
final max: on the TPU the two differ in the last bf16 bit of a term (XLA on
the CPU ignores DEFAULT and computes float32). Kernels and plain versions
read only the listed edges, so where z (or g) holds Inf or NaN in a column
off a row's edges they give the sparse answer (JAX's dense tiles spread
0·Inf = NaN there).

The backward math (one autograd Function for the whole layer)::

    dα = g·zᵀ;  c_i = ⟨g_i, out_i⟩;  draw = α(κ·dα − c)·σ'(raw)
    ds_i = Σ_j draw;  dd_j = Σ_i draw;  dz_j = Σ_i κα_ij g_i

needs only (m, den) beyond the inputs: the backward recomputes
``e = exp(raw − m)`` under the row's shift. Attention dropout κ is a
position-keyed hash of each entry (``ops/dropout.py :: entry_keep``),
recomputed in every sweep, so the dropped operator differentiates exactly.

The layer's Z = H W is the caller's (``ops/attention.py :: gat_layer``, on
the 3×TF32 dense kernel). Each forward and each backward run of the layer
adds the pattern's rest edges (those outside the dense tiles, which its
sweeps walk with the tiled ones) to
``profiling.counters["attn_rest_edges"]``. Memory at Twitter-World size
(1.4M rows, 4 heads of f = 225 padded to Fp = 256): each [Npad, H, Fp]
float32 array (zp, o, gp, dz) is 5.7 GB and each [n, H·f] one 5.04 GB. The
forward normalizes o in place; the backward frees gp after the sweeps and
adds the chain through s and d into dz's real columns in place.
:class:`_TiledGatCore` saves z, out and zp (15.8 GB), under remat only from
a layer's recompute to the end of its backward (the 900-900 model's peak:
PERF.md §5).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from graphconvgeo_torch.ops.dropout import entry_keep
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern
from graphconvgeo_torch.sparse.formats import _round_up
from graphconvgeo_torch.utils import cuda_build, profiling

_NEG = -1e30
_M32 = 0xFFFFFFFF
KERNEL_BLOCK = 128  # the CUDA kernels' tile edge
F_ALIGN = 128  # the CUDA kernels' column chunk; _prep pads the head width to it
EDGE_MAX_FP = 512  # the kernels hold a head's Fp / 128 passes in registers
# a plain version's chunk of edges materializes at most this many floats per
# temporary (256 MB)
_TILE_CHUNK_FLOATS = 1 << 26


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _leaky_grad(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, slope).to(x.dtype)


def _keep_scale(rate: float) -> tuple:
    """(hash threshold, 1/(1−rate)) of ``entry_keep`` for the kernels."""
    thr = min(int(rate * (1 << 31)), (1 << 31) - 1)
    return thr, float(np.float32(1.0) / np.float32(1.0 - rate))


MXU_PRECISIONS = (None, "highest", "default")


def _bf16_operands(mxu_precision) -> bool:
    """True when ``mxu_precision`` asks for bf16-operand contractions."""
    if mxu_precision not in MXU_PRECISIONS:
        raise ValueError(f"mxu_precision must be one of {MXU_PRECISIONS}, got {mxu_precision!r}")
    return mxu_precision == "default"


def _operand(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A contraction operand: rounded to bf16 (nearest-even) and widened back
    under ``bf16``, so the float32 product of two operands is exact."""
    return x.to(torch.bfloat16).float() if bf16 else x


def _edge_keep(rows, cols, *, heads, n_cols, head_stride, seed, rate):
    """[nnz, H] keep/(1−rate) of the edges (rows[k], cols[k]): entry
    ``rows·n_cols + cols + h·head_stride``, uint32-wrapped (the ids of JAX's
    tiles and rest alike)."""
    hs = torch.arange(heads, device=rows.device, dtype=torch.int64) * (head_stride & _M32)
    eid = rows[:, None] * (n_cols & _M32) + cols[:, None] + hs
    return entry_keep(eid, seed, rate).float() / (1.0 - rate)


def _edges_of(att, edges, default: str):
    """The lists a sweep walks: ``edges``, else the pattern's attribute
    ``default``."""
    return getattr(att, default) if edges is None else edges


def _edge_chunks(edges, width: int):
    """(major, minor) int64 indices of the list's entries, at most
    ``_TILE_CHUNK_FLOATS // width`` at a time, so that a [chunk, width]
    temporary stays within :data:`_TILE_CHUNK_FLOATS`."""
    step = max(1, _TILE_CHUNK_FLOATS // width)
    for k0 in range(0, edges.nnz, step):
        k = torch.arange(k0, min(k0 + step, edges.nnz), dtype=edges.ptr.dtype,
                         device=edges.ptr.device)
        yield torch.searchsorted(edges.ptr, k, right=True) - 1, edges.idx[k0 : k0 + step].long()


# ------------------------------------------------------- plain versions
def gat_tile_fwd_plain(att, s, d, z, *, slope, seed, rate, f=None, mxu_precision=None,
                       edges=None):
    """(o [Npad,H,Fp], den [Npad,H], m [Npad,H]) over ``edges`` (by row,
    default ``att.edges``): per row the max ``m`` of its edges' scores
    (``_NEG`` without an edge), then ``den = Σ exp(sc − m)`` and ``o = Σ
    κ·exp(sc − m)·z_j`` over each head's first f columns (default Fp), 0
    past them; κe and z rounded to bf16 under ``mxu_precision="default"``."""
    bf16 = _bf16_operands(mxu_precision)
    edges = _edges_of(att, edges, "edges")
    heads, fp = z.shape[1], z.shape[2]
    f = fp if f is None else int(f)
    m = s.new_full(s.shape, _NEG)
    for rows, cols in _edge_chunks(edges, heads * f):
        sc = _leaky(s[rows] + d[cols], slope)
        m.scatter_reduce_(0, rows[:, None].expand(-1, heads), sc, "amax")
    den = torch.zeros_like(s)
    o = z.new_zeros((s.shape[0], heads, fp))
    for rows, cols in _edge_chunks(edges, heads * f):
        e = torch.exp(_leaky(s[rows] + d[cols], slope) - m[rows])
        den.index_add_(0, rows, e)
        if rate > 0.0:
            e = e * _edge_keep(rows, cols, heads=heads, n_cols=att.n_cols,
                               head_stride=att.n_rows * att.n_cols, seed=seed, rate=rate)
        o[..., :f].index_add_(0, rows, _operand(e, bf16)[..., None] * _operand(z[cols, :, :f], bf16))
    return o, den, m


def _edge_terms(att, rows, cols, s, d, m, den, c, z, g, *, f, slope, seed, rate, bf16):
    """Shared by both backward versions, for a chunk of edges (rows[k],
    cols[k]): (κα [e,H], draw [e,H], g_i [e,H,f]) with α = exp(sc − m_i) /
    den_i, dα = g_i·z_j (of bf16 operands under ``bf16``, as g_i is
    returned) and draw = α(κ·dα − c_i)·σ'(raw)."""
    raw = s[rows] + d[cols]
    alpha = torch.exp(_leaky(raw, slope) - m[rows]) / den[rows]
    g_i = _operand(g[rows, :, :f], bf16)
    dalpha = (g_i * _operand(z[cols, :, :f], bf16)).sum(-1)
    kalpha = alpha
    if rate > 0.0:
        kf = _edge_keep(rows, cols, heads=s.shape[1], n_cols=att.n_cols,
                        head_stride=att.n_rows * att.n_cols, seed=seed, rate=rate)
        dalpha, kalpha = kf * dalpha, kf * alpha
    return kalpha, alpha * (dalpha - c[rows]) * _leaky_grad(raw, slope), g_i


def gat_tile_bwd_row_plain(att, s, d, m, den, c, z, g, *, slope, seed, rate, f=None,
                           mxu_precision=None, edges=None):
    """ds [Npad, H]: ``Σ_j α(κ·dα − c)·σ'(raw)`` over each row's entries of
    ``edges`` (by row, default ``att.edges``); ``f`` and ``mxu_precision``
    as in :func:`gat_tile_fwd_plain`."""
    bf16 = _bf16_operands(mxu_precision)
    edges = _edges_of(att, edges, "edges")
    heads = z.shape[1]
    f = z.shape[2] if f is None else int(f)
    ds = torch.zeros_like(s)
    for rows, cols in _edge_chunks(edges, heads * f):
        _, draw, _ = _edge_terms(att, rows, cols, s, d, m, den, c, z, g, f=f, slope=slope,
                                 seed=seed, rate=rate, bf16=bf16)
        ds.index_add_(0, rows, draw)
    return ds


def gat_tile_bwd_col_plain(att, s, d, m, den, c, z, g, *, slope, seed, rate, f=None,
                           mxu_precision=None, edges=None):
    """(dz [Mpad,H,Fp], dd [Mpad,H]) over ``edges`` (by column, default
    ``att.edges_t``): ``dz_j = Σ_i κα_ij g_i`` over each head's first f
    columns (0 past them) and ``dd_j = Σ_i draw_ij``; κα and g rounded to
    bf16 under ``mxu_precision="default"``."""
    bf16 = _bf16_operands(mxu_precision)
    edges_t = _edges_of(att, edges, "edges_t")
    heads = z.shape[1]
    f = z.shape[2] if f is None else int(f)
    dz = torch.zeros_like(z)
    dd = torch.zeros_like(d)
    for cols, rows in _edge_chunks(edges_t, heads * f):
        kalpha, draw, g_i = _edge_terms(att, rows, cols, s, d, m, den, c, z, g, f=f, slope=slope,
                                        seed=seed, rate=rate, bf16=bf16)
        dd.index_add_(0, cols, draw)
        dz[..., :f].index_add_(0, cols, _operand(kalpha, bf16)[..., None] * g_i)
    return dz, dd


# ------------------------------------------------------- CUDA wrappers
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# trailing scalars of every entry: contract_bf16, slope, dropout, seed,
# keep_thr, keep_scale, n_cols, head_stride, stream; before them the entry's
# sizes
_TAIL = [_I, _F, _I, _U, _U, _F, _U, _U, _P]
_ENTRIES = {
    # n_rows, heads, fp, f
    "gat_tile_fwd": ("gat_tile_fwd_f32", [_P] * 8 + [_I] * 4 + _TAIL),
    # n_rows_padded, heads, fp, f
    "gat_tile_bwd_row": ("gat_tile_bwd_row_f32", [_P] * 10 + [_I] * 4 + _TAIL),
    # n_cols_padded, heads, fp, f
    "gat_tile_bwd_col": ("gat_tile_bwd_col_f32", [_P] * 11 + [_I] * 4 + _TAIL),
}
# the launch count of each kernel's bf16-operand variant
BF16_COUNTS = {k: f"{k}_bf16" for k in _ENTRIES}


def _kernel_fn(kernel: str):
    symbol, argtypes = _ENTRIES[kernel]
    fn = getattr(cuda_build.load("gat_tiled"), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(att, index_arrays, rows_arrays, wide_arrays, fp, f=None):
    """Refuse what the kernels do not take: ``rows_arrays`` are [rows, H]
    (``d`` over the padded columns, the others over the padded rows),
    ``wide_arrays`` [rows, H, fp] (``z`` over the padded columns); ``f``
    (default fp) is the head's real width."""
    dev = wide_arrays[0][1].device
    if att.block != KERNEL_BLOCK:
        raise ValueError(f"gat_tiled kernels take block {KERNEL_BLOCK}, got {att.block}")
    if fp % F_ALIGN:
        raise ValueError(f"gat_tiled kernels take a head width that is a multiple of {F_ALIGN}, got {fp}")
    f = fp if f is None else f
    if not (fp <= EDGE_MAX_FP and 0 < f <= fp):
        raise ValueError(f"the edge kernels take 0 < f <= Fp <= {EDGE_MAX_FP}, got f {f}, Fp {fp}")
    heads = wide_arrays[0][1].shape[1]
    npad, mpad = att.n_row_blocks * att.block, att.n_col_blocks * att.block
    named = [(n, t, torch.int32, None) for n, t in index_arrays]
    named += [(n, t, torch.float32, (mpad if n == "d" else npad, heads)) for n, t in rows_arrays]
    named += [(n, t, torch.float32, (mpad if n == "z" else npad, heads, fp)) for n, t in wide_arrays]
    for name, t, dtype, shape in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, z on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in wide_arrays:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(kernel, att, ptrs, sizes, *, slope, seed, rate, bf16, device):
    thr, scale = _keep_scale(rate) if rate > 0.0 else (0, 1.0)
    fn = _kernel_fn(kernel)
    with torch.cuda.device(device):
        err = fn(
            *ptrs, *sizes, int(bf16), float(slope), int(rate > 0.0), int(seed) & _M32,
            thr, scale, att.n_cols & _M32, (att.n_rows * att.n_cols) & _M32,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {err}")
    cuda_build.launch_counts[BF16_COUNTS[kernel] if bf16 else kernel] += 1


def _route(z: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version."""
    if z.device.type == "cpu":
        return False
    if z.device.type != "cuda":
        raise ValueError(f"gat_tiled runs on cpu or cuda, got {z.device}")
    return True


def gat_tile_fwd(att, s, d, z, *, slope, seed, rate, f=None, mxu_precision=None, edges=None):
    """(o [Npad,H,Fp], den [Npad,H], m [Npad,H]) of the forward sweep.
    s [Npad,H], d [Mpad,H], z [Mpad,H,Fp] float32; ``f`` (default Fp) is the
    head's real width: the sweep gathers z's first f columns of each head
    and writes o's others as 0. ``mxu_precision`` as in the module
    docstring. ``edges`` (by row; default ``att.edges``, the tiled edges)
    are the lists the sweep walks: ``att.all_edges`` is the whole
    pattern."""
    if not _route(z):
        return gat_tile_fwd_plain(att, s, d, z, slope=slope, seed=seed, rate=rate, f=f,
                                  mxu_precision=mxu_precision, edges=edges)
    bf16 = _bf16_operands(mxu_precision)
    edges = _edges_of(att, edges, "edges")
    heads, fp = z.shape[1], z.shape[2]
    f = fp if f is None else int(f)
    _check_cuda_operands(att, [("row_ptr", edges.ptr), ("col", edges.idx)],
                         [("s", s), ("d", d)], [("z", z)], fp, f)
    npad = att.n_row_blocks * att.block
    o = torch.empty((npad, heads, fp), dtype=torch.float32, device=z.device)
    den = torch.empty((npad, heads), dtype=torch.float32, device=z.device)
    m = torch.empty((npad, heads), dtype=torch.float32, device=z.device)
    ptrs = [t.data_ptr() for t in (edges.ptr, edges.idx, s, d, z, o, den, m)]
    _launch("gat_tile_fwd", att, ptrs, (npad, heads, fp, f),
            slope=slope, seed=seed, rate=rate, bf16=bf16, device=z.device)
    return o, den, m


def gat_tile_bwd_row(att, s, d, m, den, c, z, g, *, slope, seed, rate, f=None,
                     mxu_precision=None, edges=None):
    """ds [Npad, H] of the row sweep. m, den, c [Npad,H]; g [Npad,H,Fp];
    ``f``, ``mxu_precision`` and ``edges`` (by row) as in
    :func:`gat_tile_fwd` (the sweep gathers the first f columns of each
    head of z and g)."""
    if not _route(z):
        return gat_tile_bwd_row_plain(att, s, d, m, den, c, z, g, slope=slope, seed=seed,
                                      rate=rate, f=f, mxu_precision=mxu_precision, edges=edges)
    bf16 = _bf16_operands(mxu_precision)
    edges = _edges_of(att, edges, "edges")
    heads, fp = z.shape[1], z.shape[2]
    f = fp if f is None else int(f)
    _check_cuda_operands(
        att, [("row_ptr", edges.ptr), ("col", edges.idx)],
        [("s", s), ("d", d), ("m", m), ("den", den), ("c", c)], [("z", z), ("g", g)], fp, f,
    )
    ds = torch.empty_like(s)
    ptrs = [t.data_ptr() for t in (edges.ptr, edges.idx, s, d, m, den, c, z, g, ds)]
    _launch("gat_tile_bwd_row", att, ptrs, (att.n_row_blocks * att.block, heads, fp, f),
            slope=slope, seed=seed, rate=rate, bf16=bf16, device=z.device)
    return ds


def gat_tile_bwd_col(att, s, d, m, den, c, z, g, *, slope, seed, rate, f=None,
                     mxu_precision=None, edges=None):
    """(dz [Mpad,H,Fp], dd [Mpad,H]) of the column sweep; ``f`` and
    ``mxu_precision`` as in :func:`gat_tile_fwd` (the sweep writes dz's
    columns past f as 0); ``edges`` by column, default ``att.edges_t``
    (``att.all_edges_t`` is the whole pattern)."""
    if not _route(z):
        return gat_tile_bwd_col_plain(att, s, d, m, den, c, z, g, slope=slope, seed=seed,
                                      rate=rate, f=f, mxu_precision=mxu_precision, edges=edges)
    bf16 = _bf16_operands(mxu_precision)
    edges_t = _edges_of(att, edges, "edges_t")
    heads, fp = z.shape[1], z.shape[2]
    f = fp if f is None else int(f)
    _check_cuda_operands(
        att, [("col_ptr", edges_t.ptr), ("row", edges_t.idx)],
        [("s", s), ("d", d), ("m", m), ("den", den), ("c", c)], [("z", z), ("g", g)], fp, f,
    )
    dz = torch.empty_like(z)
    dd = torch.empty_like(d)
    ptrs = [t.data_ptr() for t in (edges_t.ptr, edges_t.idx, s, d, m, den, c, z, g, dz, dd)]
    _launch("gat_tile_bwd_col", att, ptrs, (att.n_col_blocks * att.block, heads, fp, f),
            slope=slope, seed=seed, rate=rate, bf16=bf16, device=z.device)
    return dz, dd


# ---------------------------------------------------------- the layer
def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    if a.shape[0] == rows:
        return a
    return F.pad(a, (0, 0) * (a.dim() - 1) + (0, rows - a.shape[0]))


def _pad_heads(x_heads: torch.Tensor, rows: int, fp: int) -> torch.Tensor:
    """[r, H, f] → [rows, H, Fp], zero-padded: the kernels' wide layout."""
    pad = (0, fp - x_heads.shape[2], 0, 0, 0, rows - x_heads.shape[0])
    return F.pad(x_heads, pad).contiguous()


def _prep(att: TiledAttentionPattern, z, a_src, a_dst):
    """Padded sweep operands: zp [Mpad,H,Fp], s [Npad,H] (rows of z up to
    n_rows), d [Mpad,H]."""
    heads, f = a_src.shape
    n = att.n_rows
    npad = att.n_row_blocks * att.block
    mpad = att.n_col_blocks * att.block
    z_heads = z.reshape(z.shape[0], heads, f)
    zp = _pad_heads(z_heads, mpad, _round_up(f, F_ALIGN))
    s = _pad_rows(torch.einsum("nhf,hf->nh", z_heads[:n], a_src), npad).contiguous()
    d = _pad_rows(torch.einsum("nhf,hf->nh", z_heads, a_dst), mpad).contiguous()
    return zp, s, d


def _bwd_operands(att: TiledAttentionPattern, a_src, g, out):
    """The backward sweeps' operands beyond the forward's: gp [Npad,H,Fp]
    and c = ⟨g, out⟩ per row and head [Npad,H]."""
    heads, f = a_src.shape
    n = att.n_rows
    npad = att.n_row_blocks * att.block
    g_heads = g.contiguous().view(n, heads, f)
    gp = _pad_heads(g_heads, npad, _round_up(f, F_ALIGN))
    c = _pad_rows(torch.einsum("nhf,nhf->nh", g_heads, out.view(n, heads, f)), npad).contiguous()
    return gp, c


def _layer_fwd(att, z, a_src, a_dst, *, seed, slope, rate, mxu_precision=None):
    """(out [n, H·f], s, d, m, den, zp): the forward sweep walks every edge
    of the pattern, so its (m, den, o) are each row's; rows with no edge get
    m = 0 and den = 1."""
    heads, f = a_src.shape
    n = att.n_rows
    zp, s, d = _prep(att, z, a_src, a_dst)
    o, den, m = gat_tile_fwd(att, s, d, zp, slope=slope, seed=seed, rate=rate, f=f,
                             mxu_precision=mxu_precision, edges=att.all_edges)
    profiling.counters["attn_rest_edges"] += att.rest_nnz
    m = torch.where(m > _NEG / 2, m, 0.0)
    den = torch.where(den > 0, den, 1.0)
    # in place: at World each [Npad, H, Fp] temporary is 5.7 GB
    out = o.div_(den[..., None])[:n, :, :f].reshape(n, heads * f)
    return out, s, d, m, den, zp


class _TiledGatCore(torch.autograd.Function):
    """The whole tiled layer, differentiable in z, a_src and a_dst; its
    backward is the JAX package's ``_tiled_gat_bwd``: c = ⟨g, out⟩, ds from
    the row sweep, dz and dd from the column sweep (each over every edge of
    the pattern), then the chain through s = z·a_src and d = z·a_dst. The
    forward's padded zp is kept for the backward sweeps; ``mxu_precision``
    reaches every sweep."""

    @staticmethod
    def forward(ctx, z, a_src, a_dst, att, seed, slope, rate, mxu_precision):
        out, s, d, m, den, zp = _layer_fwd(att, z, a_src, a_dst, seed=seed, slope=slope, rate=rate,
                                           mxu_precision=mxu_precision)
        ctx.att, ctx.seed, ctx.slope, ctx.rate = att, seed, slope, rate
        ctx.mxu_precision = mxu_precision
        ctx.save_for_backward(z, a_src, a_dst, out, s, d, m, den, zp)
        return out

    @staticmethod
    def backward(ctx, g):
        att = ctx.att
        z, a_src, a_dst, out, s, d, m, den, zp = ctx.saved_tensors
        heads, f = a_src.shape
        n, rows = att.n_rows, z.shape[0]
        z_heads = z.view(rows, heads, f)
        gp, c = _bwd_operands(att, a_src, g, out)
        kw = dict(slope=ctx.slope, seed=ctx.seed, rate=ctx.rate, f=f,
                  mxu_precision=ctx.mxu_precision)
        ds = gat_tile_bwd_row(att, s, d, m, den, c, zp, gp, edges=att.all_edges, **kw)
        dzp, dd = gat_tile_bwd_col(att, s, d, m, den, c, zp, gp, edges=att.all_edges_t, **kw)
        del gp
        profiling.counters["attn_rest_edges"] += att.rest_nnz
        # the chain through s and d, in place on dzp's real columns (the
        # outer products d·a are the einsums' "nh,hf->nhf")
        dz_heads = dzp[:rows, :, :f]
        dz_heads += dd[:rows, :, None] * a_dst
        dz_heads[:n] += ds[:n, :, None] * a_src
        da_src = torch.einsum("nh,nhf->hf", ds[:n], z_heads[:n])
        da_dst = torch.einsum("nh,nhf->hf", dd[:rows], z_heads)
        return dz_heads.reshape(z.shape), da_src, da_dst, None, None, None, None, None


def gat_attention_tiled(
    att: TiledAttentionPattern,
    hw: torch.Tensor,
    a_src: torch.Tensor,
    a_dst: torch.Tensor,
    *,
    negative_slope: float = 0.2,
    attn_dropout: float = 0.0,
    seed: int = 0,
    mxu_precision: Optional[str] = None,
) -> torch.Tensor:
    """Multi-head GAT attention over a tiled pattern: hw [M, heads·f]
    covering the pattern's column space → [n_rows, heads·f]. Attention
    dropout drops weights after the softmax by the position-keyed hash
    keyed with the integer ``seed``, recomputed in every sweep. The sweeps
    run in float32 (bf16 inputs are widened; their gradients come back in
    their dtype), and so does the output, as in JAX. ``mxu_precision``
    (None | "highest" | "default") picks the tile contractions' arithmetic
    per call, forward and backward (module docstring)."""
    _bf16_operands(mxu_precision)  # refuse an unknown precision before any work
    rate = float(attn_dropout)
    return _TiledGatCore.apply(
        hw.float(), a_src.float(), a_dst.float(), att, int(seed) if rate > 0.0 else 0,
        float(negative_slope), rate, mxu_precision,
    )
