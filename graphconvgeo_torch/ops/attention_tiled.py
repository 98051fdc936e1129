"""Tiled (flash-style) GAT attention: four hand-written CUDA kernels, their
plain versions and the layer's autograd Function.

Port of ``graphconvgeo_tpu/ops/attention_tiled.py``. One layer is the scores
and three sweeps over a :class:`TiledAttentionPattern`:

- :func:`gat_scores` — ``s = z·a_src`` (rows below n_rows) and ``d =
  z·a_dst`` per head;
- :func:`gat_tile_fwd` — per row: max ``m``, denominators ``den`` and the
  normalized aggregation ``out``;
- :func:`gat_tile_bwd_row` — ``c = ⟨g, out⟩`` and ``ds`` (the per-edge
  ``g_i·z_j``);
- :func:`gat_tile_bwd_col` — ``dd`` and ``dz`` (the transpose sweep,
  ``(κα)ᵀ·g``, plus the chain through s and d).

Each wrapper takes its plain PyTorch version for CPU tensors and launches
``csrc/gat_tiled.cu`` for CUDA tensors (or raises); there is no fallback
from one to the other. Kernel and plain version walk the same compressed
edge lists: by default the tiled edges (``att.edges`` by row,
``att.edges_t`` by column), or the lists passed as ``edges``. The plain
versions are the kernels' algorithm in torch ops — a segment max, exp and
``index_add_`` over the list, a chunk of edges at a time — and sum the same
products in another order. Both read and write the model's own float32
``[rows, H·f]`` arrays (z, g, out, dz: head h is columns ``h·f`` to
``h·f + f``) in place, with no padded copy; the ``[rows, H]`` vectors (s,
m, den, c, ds by the pattern's padded rows, d and dd by its padded
columns) are padded to the tile grid. The kernels take a head of up to
:data:`EDGE_MAX_F` columns, of any width and alignment.

The layer (:class:`_TiledGatCore`) walks the whole pattern's lists
(``att.all_edges``, ``att.all_edges_t``: the tiled edges and the bucketed
rest's together) on every device and at every precision, so the forward's
(m, den, out) and the backward's c, ds, dd and dz come straight from the
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
is rounded: the max, exp, den, keep hash, c, the chain, s and d stay
float32. Every edge is rounded alike, the rest's too (JAX's rest takes no
precision argument). The sweep kernels launch a variant of their own under
it (launch counts ``gat_tile_fwd_bf16``, ``gat_tile_bwd_row_bf16``,
``gat_tile_bwd_col_bf16``; ``gat_scores`` has one variant). JAX's fused
forward rounds each e under the running tile max and rescales later; the
port rounds it under the row's final max: on the TPU the two differ in the
last bf16 bit of a term (XLA on the CPU ignores DEFAULT and computes
float32). Kernels and plain versions read only the listed edges, so where
z (or g) holds Inf or NaN in a column off a row's edges they give the
sparse answer (JAX's dense tiles spread 0·Inf = NaN there). The kernels
gather a row's whole 16-byte pieces and clear the neighbouring heads'
columns only in the operand they hold, so a non-finite value in another
head's columns of a row on the edges can reach a backward dot product as
0·Inf = NaN; the plain versions read each head alone.

The backward math (one autograd Function for the whole layer)::

    dα = g·zᵀ;  c_i = ⟨g_i, out_i⟩;  draw = α(κ·dα − c)·σ'(raw)
    ds_i = Σ_j draw;  dd_j = Σ_i draw;  dz_j = Σ_i κα_ij g_i + dd_j a_dst + ds_j a_src

needs only (m, den) beyond the inputs: the backward recomputes
``e = exp(raw − m)`` under the row's shift. Attention dropout κ is a
position-keyed hash of each entry (``ops/dropout.py :: entry_keep``),
recomputed in every sweep, so the dropped operator differentiates exactly.

The layer's Z = H W is the caller's (``ops/attention.py :: gat_layer``, on
the 3×TF32 dense kernel). Each forward and each backward run of the layer
adds the pattern's rest edges (those outside the dense tiles, which its
sweeps walk with the tiled ones) to
``profiling.counters["attn_rest_edges"]``. Memory at Twitter-World size
(1.4M rows, 4 heads of f = 225): each [n, H·f] float32 array (z, out, g,
dz) is 5.04 GB and each [N, H] vector 22 MB; the sweeps make no other wide
array. :class:`_TiledGatCore` saves z, out and the vectors (10.2 GB), under
remat only from a layer's recompute to the end of its backward (the
900-900 model's peak: PERF.md §5).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from graphconvgeo_torch.ops.dropout import entry_keep
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern
from graphconvgeo_torch.utils import cuda_build, profiling

_NEG = -1e30
_M32 = 0xFFFFFFFF
KERNEL_BLOCK = 128  # the CUDA kernels' tile edge
# the widest head the kernels take: they hold a head's span, at most
# ceil((f + 3) / 4) aligned float4s, in 4 passes of 32 lanes
EDGE_MAX_F = 509
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


def _heads_of(z: torch.Tensor, heads: int) -> tuple:
    """(H, f) of a [rows, H·f] array."""
    if z.dim() != 2 or z.shape[1] % heads:
        raise ValueError(f"expected [rows, {heads}·f], got {tuple(z.shape)}")
    return heads, z.shape[1] // heads


def _padded(att) -> tuple:
    """(Npad, Mpad): the tile grid's rows and columns."""
    return att.n_row_blocks * att.block, att.n_col_blocks * att.block


# ------------------------------------------------------- plain versions
def gat_scores_plain(att, z, a_src, a_dst):
    """(s [Npad,H], d [Mpad,H]): per head ``s = z·a_src`` over z's first
    ``att.n_rows`` rows and ``d = z·a_dst`` over all of them, 0 on the
    padding rows."""
    heads, f = a_src.shape
    n, rows = att.n_rows, z.shape[0]
    npad, mpad = _padded(att)
    zh = z.reshape(rows, heads, f)
    s = z.new_zeros((npad, heads))
    s[:n] = torch.einsum("nhf,hf->nh", zh[:n], a_src)
    d = z.new_zeros((mpad, heads))
    d[:rows] = torch.einsum("nhf,hf->nh", zh, a_dst)
    return s, d


def gat_tile_fwd_plain(att, s, d, z, *, slope, seed, rate, mxu_precision=None, edges=None):
    """(out [n_rows, H·f], den [Npad,H], m [Npad,H]) over ``edges`` (by row,
    default ``att.edges``): per row the max ``m`` of its edges' scores, then
    ``den = Σ exp(sc − m)`` and ``out = Σ κ·exp(sc − m)·z_j / den``; a row
    with no listed edge gives m = 0, den = 1, out = 0. κe and z rounded to
    bf16 under ``mxu_precision="default"``."""
    bf16 = _bf16_operands(mxu_precision)
    edges = _edges_of(att, edges, "edges")
    heads, f = _heads_of(z, s.shape[1])
    zh = z.reshape(z.shape[0], heads, f)
    m = s.new_full(s.shape, _NEG)
    for rows, cols in _edge_chunks(edges, heads * f):
        sc = _leaky(s[rows] + d[cols], slope)
        m.scatter_reduce_(0, rows[:, None].expand(-1, heads), sc, "amax")
    den = torch.zeros_like(s)
    o = z.new_zeros((att.n_rows, heads, f))
    for rows, cols in _edge_chunks(edges, heads * f):
        e = torch.exp(_leaky(s[rows] + d[cols], slope) - m[rows])
        den.index_add_(0, rows, e)
        if rate > 0.0:
            e = e * _edge_keep(rows, cols, heads=heads, n_cols=att.n_cols,
                               head_stride=att.n_rows * att.n_cols, seed=seed, rate=rate)
        o.index_add_(0, rows, _operand(e, bf16)[..., None] * _operand(zh[cols], bf16))
    m = torch.where(m > _NEG / 2, m, 0.0)
    den = torch.where(den > 0, den, 1.0)
    return o.div_(den[: att.n_rows, :, None]).view(att.n_rows, heads * f), den, m


def _edge_terms(att, rows, cols, s, d, m, den, c, zh, gh, *, slope, seed, rate, bf16):
    """Shared by both backward versions, for a chunk of edges (rows[k],
    cols[k]) of the [rows, H, f] views zh, gh: (κα [e,H], draw [e,H], g_i
    [e,H,f]) with α = exp(sc − m_i) / den_i, dα = g_i·z_j (of bf16 operands
    under ``bf16``, as g_i is returned) and draw = α(κ·dα − c_i)·σ'(raw)."""
    raw = s[rows] + d[cols]
    alpha = torch.exp(_leaky(raw, slope) - m[rows]) / den[rows]
    g_i = _operand(gh[rows], bf16)
    dalpha = (g_i * _operand(zh[cols], bf16)).sum(-1)
    kalpha = alpha
    if rate > 0.0:
        kf = _edge_keep(rows, cols, heads=s.shape[1], n_cols=att.n_cols,
                        head_stride=att.n_rows * att.n_cols, seed=seed, rate=rate)
        dalpha, kalpha = kf * dalpha, kf * alpha
    return kalpha, alpha * (dalpha - c[rows]) * _leaky_grad(raw, slope), g_i


def gat_tile_bwd_row_plain(att, s, d, m, den, z, g, out, *, slope, seed, rate,
                           mxu_precision=None, edges=None):
    """(ds [Npad,H], c [Npad,H]): ``c_i = ⟨g_i, out_i⟩`` per head (float32
    at every precision; 0 past n_rows), then ``ds_i = Σ_j α(κ·dα − c_i)·
    σ'(raw)`` over each row's entries of ``edges`` (by row, default
    ``att.edges``); ``mxu_precision`` as in :func:`gat_tile_fwd_plain`."""
    bf16 = _bf16_operands(mxu_precision)
    edges = _edges_of(att, edges, "edges")
    heads, f = _heads_of(z, s.shape[1])
    n = att.n_rows
    zh, gh = z.reshape(z.shape[0], heads, f), g.reshape(n, heads, f)
    c = torch.zeros_like(s)
    c[:n] = (gh * out.reshape(n, heads, f)).sum(-1)
    ds = torch.zeros_like(s)
    for rows, cols in _edge_chunks(edges, heads * f):
        _, draw, _ = _edge_terms(att, rows, cols, s, d, m, den, c, zh, gh, slope=slope,
                                 seed=seed, rate=rate, bf16=bf16)
        ds.index_add_(0, rows, draw)
    return ds, c


def gat_tile_bwd_col_plain(att, s, d, m, den, c, ds, z, g, a_src, a_dst, *, slope, seed, rate,
                           mxu_precision=None, edges=None):
    """(dz [M, H·f], dd [Mpad,H]) over ``edges`` (by column, default
    ``att.edges_t``): ``dd_j = Σ_i draw_ij`` and ``dz_j = Σ_i κα_ij g_i +
    dd_j·a_dst + ds_j·a_src`` (the ds term on z's first n_rows rows: the
    chain through s and d); κα and g rounded to bf16 under
    ``mxu_precision="default"``."""
    bf16 = _bf16_operands(mxu_precision)
    edges_t = _edges_of(att, edges, "edges_t")
    heads, f = _heads_of(z, s.shape[1])
    n, rows_z = att.n_rows, z.shape[0]
    zh, gh = z.reshape(rows_z, heads, f), g.reshape(n, heads, f)
    dz = z.new_zeros((rows_z, heads, f))
    dd = torch.zeros_like(d)
    for cols, rows in _edge_chunks(edges_t, heads * f):
        kalpha, draw, g_i = _edge_terms(att, rows, cols, s, d, m, den, c, zh, gh, slope=slope,
                                        seed=seed, rate=rate, bf16=bf16)
        dd.index_add_(0, cols, draw)
        dz.index_add_(0, cols, _operand(kalpha, bf16)[..., None] * g_i)
    dz += dd[:rows_z, :, None] * a_dst
    dz[:n] += ds[:n, :, None] * a_src
    return dz.view(rows_z, heads * f), dd


# ------------------------------------------------------- CUDA wrappers
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# trailing scalars of every sweep's entry: contract_bf16, slope, dropout,
# seed, keep_thr, keep_scale, n_cols, head_stride, stream; before them the
# entry's sizes
_TAIL = [_I, _F, _I, _U, _U, _F, _U, _U, _P]
_ENTRIES = {
    # n_rows (padded), n_out, heads, f
    "gat_tile_fwd": ("gat_tile_fwd_f32", [_P] * 8 + [_I] * 4 + _TAIL),
    # n_rows (padded), n_g, heads, f
    "gat_tile_bwd_row": ("gat_tile_bwd_row_f32", [_P] * 11 + [_I] * 4 + _TAIL),
    # n_cols (padded), n_z, n_s, heads, f
    "gat_tile_bwd_col": ("gat_tile_bwd_col_f32", [_P] * 14 + [_I] * 5 + _TAIL),
    # n_z, n_s, s_rows, d_rows, heads, f, stream
    "gat_scores": ("gat_scores_f32", [_P] * 5 + [_I] * 6 + [_P]),
}
# the launch count of each sweep kernel's bf16-operand variant
BF16_COUNTS = {k: f"{k}_bf16" for k in ("gat_tile_fwd", "gat_tile_bwd_row", "gat_tile_bwd_col")}


def _kernel_fn(kernel: str):
    symbol, argtypes = _ENTRIES[kernel]
    fn = getattr(cuda_build.load("gat_tiled"), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(att, heads, f, named):
    """Refuse what the kernels do not take: a block other than
    :data:`KERNEL_BLOCK`, a head outside (0, :data:`EDGE_MAX_F`] columns, and
    any of ``named`` — (name, tensor, dtype, shape or None) — on another
    device than the first, of another dtype or shape, or not contiguous.
    Any width and alignment of the [rows, H·f] arrays is taken: the kernels
    read 16-byte pieces where the shape and the pointers allow it."""
    if att.block != KERNEL_BLOCK:
        raise ValueError(f"gat_tiled kernels take block {KERNEL_BLOCK}, got {att.block}")
    if not (0 < f <= EDGE_MAX_F and 0 < heads <= 65535):
        raise ValueError(f"the edge kernels take heads of 0 < f <= {EDGE_MAX_F} columns, "
                         f"got f {f} ({heads} heads)")
    dev = named[0][1].device
    for name, t, dtype, shape in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {named[0][0]} on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _wide_rows(att, z) -> int:
    """z's rows M: it covers the pattern's rows and columns and lies within
    the padded column grid."""
    rows = z.shape[0]
    if not max(att.n_rows, att.n_cols) <= rows <= _padded(att)[1]:
        raise ValueError(f"z must have between {max(att.n_rows, att.n_cols)} and "
                         f"{_padded(att)[1]} rows, got {rows}")
    return rows


def _vectors(att, heads, **arrays):
    """Named [rows, H] float32 operands: d and dd over the padded columns,
    the others over the padded rows."""
    npad, mpad = _padded(att)
    return [(k, t, torch.float32, (mpad if k in ("d", "dd") else npad, heads))
            for k, t in arrays.items()]


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


def gat_scores(att, z, a_src, a_dst):
    """(s [Npad,H], d [Mpad,H]) of z [M, H·f] and a_src, a_dst [H, f]
    float32: ``s = z·a_src`` on z's first ``att.n_rows`` rows, ``d =
    z·a_dst`` on all of them, 0 on the padding rows."""
    if not _route(z):
        return gat_scores_plain(att, z, a_src, a_dst)
    heads, f = a_src.shape
    rows = _wide_rows(att, z)
    wide = [("z", z, torch.float32, (rows, heads * f))]
    wide += [(k, t, torch.float32, (heads, f)) for k, t in (("a_src", a_src), ("a_dst", a_dst))]
    _check_cuda_operands(att, heads, f, wide)
    npad, mpad = _padded(att)
    s = torch.empty((npad, heads), dtype=torch.float32, device=z.device)
    d = torch.empty((mpad, heads), dtype=torch.float32, device=z.device)
    fn = _kernel_fn("gat_scores")
    with torch.cuda.device(z.device):
        err = fn(*(t.data_ptr() for t in (z, a_src, a_dst, s, d)), rows, att.n_rows, npad, mpad,
                 heads, f, torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gat_scores kernel launch failed with CUDA error {err}")
    cuda_build.launch_counts["gat_scores"] += 1
    return s, d


def gat_tile_fwd(att, s, d, z, *, slope, seed, rate, mxu_precision=None, edges=None):
    """(out [n_rows, H·f], den [Npad,H], m [Npad,H]) of the forward sweep:
    the normalized aggregation, and rows with no listed edge as m = 0, den
    = 1, out = 0. s [Npad,H], d [Mpad,H], z [M, H·f] float32.
    ``mxu_precision`` as in the module docstring. ``edges`` (by row;
    default ``att.edges``, the tiled edges) are the lists the sweep walks:
    ``att.all_edges`` is the whole pattern."""
    if not _route(z):
        return gat_tile_fwd_plain(att, s, d, z, slope=slope, seed=seed, rate=rate,
                                  mxu_precision=mxu_precision, edges=edges)
    bf16 = _bf16_operands(mxu_precision)
    edges = _edges_of(att, edges, "edges")
    heads, f = _heads_of(z, s.shape[1])
    rows = _wide_rows(att, z)
    _check_cuda_operands(att, heads, f, [
        ("z", z, torch.float32, (rows, heads * f)),
        ("row_ptr", edges.ptr, torch.int32, None), ("col", edges.idx, torch.int32, None),
        *_vectors(att, heads, s=s, d=d)])
    npad, n = _padded(att)[0], att.n_rows
    out = torch.empty((n, heads * f), dtype=torch.float32, device=z.device)
    den = torch.empty((npad, heads), dtype=torch.float32, device=z.device)
    m = torch.empty((npad, heads), dtype=torch.float32, device=z.device)
    ptrs = [t.data_ptr() for t in (edges.ptr, edges.idx, s, d, z, out, den, m)]
    _launch("gat_tile_fwd", att, ptrs, (npad, n, heads, f),
            slope=slope, seed=seed, rate=rate, bf16=bf16, device=z.device)
    return out, den, m


def gat_tile_bwd_row(att, s, d, m, den, z, g, out, *, slope, seed, rate, mxu_precision=None,
                     edges=None):
    """(ds [Npad,H], c [Npad,H]) of the row sweep: c = ⟨g, out⟩ per row and
    head, then ds. m, den [Npad,H] as :func:`gat_tile_fwd` gives them; g,
    out [n_rows, H·f]; ``mxu_precision`` and ``edges`` (by row) as in
    :func:`gat_tile_fwd`."""
    if not _route(z):
        return gat_tile_bwd_row_plain(att, s, d, m, den, z, g, out, slope=slope, seed=seed,
                                      rate=rate, mxu_precision=mxu_precision, edges=edges)
    bf16 = _bf16_operands(mxu_precision)
    edges = _edges_of(att, edges, "edges")
    heads, f = _heads_of(z, s.shape[1])
    rows, n = _wide_rows(att, z), att.n_rows
    _check_cuda_operands(att, heads, f, [
        ("z", z, torch.float32, (rows, heads * f)), ("g", g, torch.float32, (n, heads * f)),
        ("out", out, torch.float32, (n, heads * f)),
        ("row_ptr", edges.ptr, torch.int32, None), ("col", edges.idx, torch.int32, None),
        *_vectors(att, heads, s=s, d=d, m=m, den=den)])
    ds, c = torch.empty_like(s), torch.empty_like(s)
    ptrs = [t.data_ptr() for t in (edges.ptr, edges.idx, s, d, m, den, z, g, out, ds, c)]
    _launch("gat_tile_bwd_row", att, ptrs, (_padded(att)[0], n, heads, f),
            slope=slope, seed=seed, rate=rate, bf16=bf16, device=z.device)
    return ds, c


def gat_tile_bwd_col(att, s, d, m, den, c, ds, z, g, a_src, a_dst, *, slope, seed, rate,
                     mxu_precision=None, edges=None):
    """(dz [M, H·f], dd [Mpad,H]) of the column sweep, dz with the chain
    through s and d (``dd_j·a_dst + ds_j·a_src``, the ds term on z's first
    n_rows rows). c, ds [Npad,H] as :func:`gat_tile_bwd_row` gives them;
    a_src, a_dst [H, f]; ``mxu_precision`` as in :func:`gat_tile_fwd`;
    ``edges`` by column, default ``att.edges_t`` (``att.all_edges_t`` is the
    whole pattern)."""
    if not _route(z):
        return gat_tile_bwd_col_plain(att, s, d, m, den, c, ds, z, g, a_src, a_dst, slope=slope,
                                      seed=seed, rate=rate, mxu_precision=mxu_precision,
                                      edges=edges)
    bf16 = _bf16_operands(mxu_precision)
    edges_t = _edges_of(att, edges, "edges_t")
    heads, f = _heads_of(z, s.shape[1])
    rows, n = _wide_rows(att, z), att.n_rows
    _check_cuda_operands(att, heads, f, [
        ("z", z, torch.float32, (rows, heads * f)), ("g", g, torch.float32, (n, heads * f)),
        ("a_src", a_src, torch.float32, (heads, f)), ("a_dst", a_dst, torch.float32, (heads, f)),
        ("col_ptr", edges_t.ptr, torch.int32, None), ("row", edges_t.idx, torch.int32, None),
        *_vectors(att, heads, s=s, d=d, m=m, den=den, c=c, ds=ds)])
    dz = torch.empty_like(z)
    dd = torch.empty_like(d)
    ptrs = [t.data_ptr() for t in (edges_t.ptr, edges_t.idx, s, d, m, den, c, ds, z, g, a_src,
                                   a_dst, dz, dd)]
    _launch("gat_tile_bwd_col", att, ptrs, (_padded(att)[1], rows, n, heads, f),
            slope=slope, seed=seed, rate=rate, bf16=bf16, device=z.device)
    return dz, dd


# ---------------------------------------------------------- the layer
class _TiledGatCore(torch.autograd.Function):
    """The whole tiled layer, differentiable in z, a_src and a_dst; its
    backward is the JAX package's ``_tiled_gat_bwd``: c and ds from the row
    sweep, dd and dz with the chain through s = z·a_src and d = z·a_dst from
    the column sweep (each over every edge of the pattern), then a's
    gradients. It saves z, out and the [N, H] vectors; ``mxu_precision``
    reaches every sweep."""

    @staticmethod
    def forward(ctx, z, a_src, a_dst, att, seed, slope, rate, mxu_precision):
        s, d = gat_scores(att, z, a_src, a_dst)
        out, den, m = gat_tile_fwd(att, s, d, z, slope=slope, seed=seed, rate=rate,
                                   mxu_precision=mxu_precision, edges=att.all_edges)
        profiling.counters["attn_rest_edges"] += att.rest_nnz
        ctx.att, ctx.seed, ctx.slope, ctx.rate = att, seed, slope, rate
        ctx.mxu_precision = mxu_precision
        ctx.save_for_backward(z, a_src, a_dst, out, s, d, m, den)
        return out

    @staticmethod
    def backward(ctx, g):
        att = ctx.att
        z, a_src, a_dst, out, s, d, m, den = ctx.saved_tensors
        heads, f = a_src.shape
        n, rows = att.n_rows, z.shape[0]
        g = g.contiguous()
        kw = dict(slope=ctx.slope, seed=ctx.seed, rate=ctx.rate, mxu_precision=ctx.mxu_precision)
        ds, c = gat_tile_bwd_row(att, s, d, m, den, z, g, out, edges=att.all_edges, **kw)
        dz, dd = gat_tile_bwd_col(att, s, d, m, den, c, ds, z, g, a_src, a_dst,
                                  edges=att.all_edges_t, **kw)
        profiling.counters["attn_rest_edges"] += att.rest_nnz
        z_heads = z.view(rows, heads, f)
        da_src = torch.einsum("nh,nhf->hf", ds[:n], z_heads[:n])
        da_dst = torch.einsum("nh,nhf->hf", dd[:rows], z_heads)
        return dz, da_src, da_dst, None, None, None, None, None


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
        hw.float().contiguous(), a_src.float().contiguous(), a_dst.float().contiguous(), att,
        int(seed) if rate > 0.0 else 0, float(negative_slope), rate, mxu_precision,
    )
