"""Tiled (flash-style) GAT attention: three hand-written CUDA kernels, their
plain twins, the bucketed rest path and the layer's autograd Function.

Port of ``graphconvgeo_tpu/ops/attention_tiled.py``. One layer is three
sweeps over a :class:`TiledAttentionPattern`:

- :func:`gat_tile_fwd` — per row: max ``m``, unnormalized aggregation ``o``
  and denominators ``den``;
- :func:`gat_tile_bwd_row` — ``ds`` (the per-edge ``g_i·z_j``);
- :func:`gat_tile_bwd_col` — ``dz`` and ``dd`` (the transpose sweep,
  ``(κα)ᵀ·g``).

Each wrapper takes its plain PyTorch version for CPU tensors and launches
``csrc/gat_tiled.cu`` for CUDA tensors (or raises); there is no fallback
from one to the other. The plain twins sweep the dense mask tiles; the
kernels walk compressed edge lists, by default the tiled edges
(``att.edges`` by row, ``att.edges_t`` by column), or the lists passed as
``edges``.

The layer (:class:`_TiledGatCore`) covers every edge of the pattern. On the
card with float32 contractions the kernels walk the whole pattern's lists
(``att.all_edges``, ``att.all_edges_t``: the tiled edges and the bucketed
rest's together), so the forward's (m, den, o) and the backward's ds, dz
and dd come straight from the sweeps. On the CPU, and under the
bf16-operand variant, the sweeps cover the tiles and the bucketed rest
(``_rest_fused``, ``_rest_bwd``) covers the edges outside them in plain
PyTorch; the two softmax states are merged by exp-rescale, so the softmax
over the union is exact.

``mxu_precision`` picks the tile contractions' arithmetic, as the JAX
package's argument of that name does: None or ``"highest"`` is float32;
``"default"`` (the TPU's ``Precision.DEFAULT``, one bf16 MXU pass) rounds
both operands of each contraction to bf16 (nearest-even) and sums the
products in float32 — the forward's ``bf16(κe) @ bf16(z)`` (``den`` stays
the sum of the unrounded e), the ds sweep's ``bf16(g) @ bf16(z)ᵀ``, the
column sweep's ``bf16(κα)ᵀ @ bf16(g)`` and ``bf16(g) @ bf16(z)ᵀ``. Nothing
else is rounded: the max, exp, den, keep hash and the rest path stay
float32 (on the card too: the variant walks the tiled edges and leaves the
rest to the plain path, as on the CPU). The kernels launch a variant of
their own under it (launch counts ``gat_tile_fwd_bf16``,
``gat_tile_bwd_row_bf16``, ``gat_tile_bwd_col_bf16``).
JAX's fused forward rounds each e under the running tile max and rescales
later; the port rounds it under the row's final max: on the TPU the two
differ in the last bf16 bit of a term (XLA on the CPU ignores DEFAULT and
computes float32). The plain versions are the JAX package's dense-tile
functions vectorized over tiles, two-pass instead of online (the same sums
in another order). On finite inputs the kernels compute the same functions;
where z (or g) holds Inf or NaN in a column off a row's edges, the dense
twins spread 0·Inf = NaN (``e @ z``, ``g·zᵀ``, ``αᵀ·g``) and the three
kernels, which read only the edges, give the sparse answer.

The backward math (one autograd Function for the whole layer)::

    dα = g·zᵀ;  c_i = ⟨g_i, out_i⟩;  draw = α(κ·dα − c)·σ'(raw)
    ds_i = Σ_j draw;  dd_j = Σ_i draw;  dz_j = Σ_i κα_ij g_i

needs only (m, den) beyond the inputs: the backward recomputes
``e = exp(raw − m)`` under the row's shift. Attention dropout κ is a
position-keyed hash of each entry (``ops/dropout.py :: entry_keep``),
recomputed in every sweep, so the dropped operator differentiates exactly.

The layer's Z = H W is the caller's (``ops/attention.py :: gat_layer``, on
the 3×TF32 dense kernel). Each forward and each backward run of the layer
adds the pattern's rest edges to ``profiling.counters["attn_rest_edges"]``,
whichever way it covers them, and each kernel launch on the whole-pattern
lists adds 1 to ``profiling.counters["attn_rest_in_sweeps"]`` (3 for a
forward and its backward; 0 on the CPU and under the bf16 variant). Memory
at Twitter-World size (1.4M rows, 4 heads of f = 225 padded to Fp = 256):
each [Npad, H, Fp] float32 array (zp, o, gp, dz) is 5.7 GB and each
[n, H·f] one 5.04 GB. The forward normalizes o in place (on the plain path
after rescaling it and adding the rest's rows a block at a time); the
backward frees gp after the sweeps and adds the chain through s and d into
dz's real columns in place (on the plain path after the rest's rows, a
block at a time). :class:`_TiledGatCore` saves z, out and zp (15.8 GB),
under remat only from a layer's recompute to the end of its backward
(the 900-900 model's peak: PERF.md §5).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from graphconvgeo_torch.ops.attention import _ell_matvec_heads, _ell_sddmm_heads
from graphconvgeo_torch.ops.dropout import entry_keep
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern, unpack_mask
from graphconvgeo_torch.sparse.formats import _round_up
from graphconvgeo_torch.utils import cuda_build, profiling

_NEG = -1e30
_M32 = 0xFFFFFFFF
KERNEL_BLOCK = 128  # the CUDA kernels' tile edge
F_ALIGN = 128  # the CUDA kernels' column chunk; _prep pads the head width to it
EDGE_MAX_FP = 512  # the kernels hold a head's Fp / 128 passes in registers
# a plain version's chunk of tiles materializes at most this many floats per
# temporary (256 MB)
_TILE_CHUNK_FLOATS = 1 << 26
_ROW_BLOCK = 1 << 16  # rows of the rest merged into the sweeps' arrays at once


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


def _tile_keep(rowblk, colblk, *, heads, block, n_cols, head_stride, seed, rate):
    """[T, H, B, B] keep/(1−rate) for tiles at (rowblk, colblk): entry
    ``(rb·B + i)·n_cols + (cb·B + j) + h·head_stride``, uint32-wrapped."""
    ar = torch.arange(block, device=rowblk.device, dtype=torch.int64)
    gi = rowblk.long()[:, None] * block + ar
    gj = colblk.long()[:, None] * block + ar
    hs = torch.arange(heads, device=rowblk.device, dtype=torch.int64) * (head_stride & _M32)
    eid = gi[:, None, :, None] * (n_cols & _M32) + gj[:, None, None, :] + hs[None, :, None, None]
    return entry_keep(eid, seed, rate).float() / (1.0 - rate)


def _chunks(att: TiledAttentionPattern, heads: int, fp: int):
    step = max(1, _TILE_CHUNK_FLOATS // (heads * att.block * max(att.block, fp)))
    return [(t0, min(t0 + step, att.n_tiles)) for t0 in range(0, att.n_tiles, step)]


class _Blocks:
    """Per-block views of the sweep operands: [n_blocks, H, B] and
    [n_blocks, H, B, Fp] (heads-major within a block)."""

    def __init__(self, att: TiledAttentionPattern, **arrays):
        b = att.block
        for name, a in arrays.items():
            nb = a.shape[0] // b
            setattr(self, name, a.view(nb, b, *a.shape[1:]).transpose(1, 2))


def _tile_scores(att, blk, t0, t1, *, slope, transposed=False):
    """(rowblk, colblk, mask [T,1,B,B], raw [T,H,B,B]) for tiles t0:t1 of
    the row-major (or, ``transposed``, the column-major) sweep."""
    if transposed:
        bits, rb, cb = att.mask_bits_t, att.rowblk_t, att.colblk_t
    else:
        bits, rb, cb = att.mask_bits, att.rowblk, att.colblk
    rb, cb = rb[t0:t1].long(), cb[t0:t1].long()
    mask = unpack_mask(bits[t0:t1], att.block)[:, None]
    raw = blk.s[rb][..., :, None] + blk.d[cb][..., None, :]
    return rb, cb, mask, raw


# ------------------------------------------------------------ plain twins
def gat_tile_fwd_plain(att, s, d, z, *, slope, seed, rate, mxu_precision=None):
    """(o [Npad,H,Fp], den [Npad,H], m [Npad,H]): per row block, the max
    ``m`` of its masked scores over all its tiles (``_NEG`` if none), then
    ``den = Σ exp(sc − m)`` and ``o = Σ κ·exp(sc − m)·z`` (its operands
    rounded to bf16 under ``mxu_precision="default"``)."""
    bf16 = _bf16_operands(mxu_precision)
    heads, fp = z.shape[1], z.shape[2]
    nrb, b = att.n_row_blocks, att.block
    blk = _Blocks(att, s=s, d=d, z=z)
    hs = att.n_rows * att.n_cols
    m = s.new_full((nrb, heads, b), _NEG)
    chunks = _chunks(att, heads, fp)
    for t0, t1 in chunks:
        rb, _, mask, raw = _tile_scores(att, blk, t0, t1, slope=slope)
        sc = torch.where(mask, _leaky(raw, slope), _NEG)
        m.scatter_reduce_(0, rb[:, None, None].expand(-1, heads, b), sc.amax(-1), "amax")
    den = s.new_zeros((nrb, heads, b))
    o = z.new_zeros((nrb, heads, b, fp))
    for t0, t1 in chunks:
        rb, cb, mask, raw = _tile_scores(att, blk, t0, t1, slope=slope)
        sc = torch.where(mask, _leaky(raw, slope), _NEG)
        e = torch.exp(sc - m[rb][..., None]) * mask
        den.index_add_(0, rb, e.sum(-1))
        if rate > 0.0:
            e = e * _tile_keep(rb, cb, heads=heads, block=b, n_cols=att.n_cols,
                               head_stride=hs, seed=seed, rate=rate)
        o.index_add_(0, rb, torch.matmul(_operand(e, bf16), _operand(blk.z[cb], bf16)))
    return (
        o.transpose(1, 2).reshape(-1, heads, fp),
        den.transpose(1, 2).reshape(-1, heads),
        m.transpose(1, 2).reshape(-1, heads),
    )


def _alpha_dalpha(att, blk, t0, t1, *, slope, seed, rate, transposed, bf16):
    """Shared by both backward twins: (rb, cb, α, κ or None, κ·dα, σ'(raw));
    dα = g·zᵀ of bf16-rounded operands under ``bf16``."""
    heads, b = blk.s.shape[1], att.block
    rb, cb, mask, raw = _tile_scores(att, blk, t0, t1, slope=slope, transposed=transposed)
    # mask BEFORE the exp: a masked slot whose raw score exceeds the row's
    # edge max by ~89 would overflow to inf, and inf·0 is NaN
    e = torch.exp(torch.where(mask, _leaky(raw, slope), _NEG) - blk.m[rb][..., None]) * mask
    alpha = e / blk.den[rb][..., None]
    dalpha = torch.matmul(_operand(blk.g[rb], bf16), _operand(blk.z[cb], bf16).transpose(-1, -2))
    kf = None
    if rate > 0.0:
        kf = _tile_keep(rb, cb, heads=heads, block=b, n_cols=att.n_cols,
                        head_stride=att.n_rows * att.n_cols, seed=seed, rate=rate)
        dalpha = dalpha * kf
    return rb, cb, alpha, kf, dalpha, _leaky_grad(raw, slope)


def gat_tile_bwd_row_plain(att, s, d, m, den, c, z, g, *, slope, seed, rate,
                           mxu_precision=None):
    """ds [Npad, H]: ``Σ_j α(κ·dα − c)·σ'(raw)`` over each row's tiles."""
    bf16 = _bf16_operands(mxu_precision)
    heads, fp = z.shape[1], z.shape[2]
    blk = _Blocks(att, s=s, d=d, m=m, den=den, c=c, z=z, g=g)
    ds = s.new_zeros((att.n_row_blocks, heads, att.block))
    for t0, t1 in _chunks(att, heads, fp):
        rb, _, alpha, _, dalpha, lg = _alpha_dalpha(
            att, blk, t0, t1, slope=slope, seed=seed, rate=rate, transposed=False, bf16=bf16
        )
        draw = alpha * (dalpha - blk.c[rb][..., None]) * lg
        ds.index_add_(0, rb, draw.sum(-1))
    return ds.transpose(1, 2).reshape(-1, heads)


def gat_tile_bwd_col_plain(att, s, d, m, den, c, z, g, *, slope, seed, rate,
                           mxu_precision=None):
    """(dz [Mpad,H,Fp], dd [Mpad,H]) over the column-major tile copies:
    ``dz_j = Σ_i κα_ij g_i`` and ``dd_j = Σ_i draw_ij``."""
    bf16 = _bf16_operands(mxu_precision)
    heads, fp = z.shape[1], z.shape[2]
    ncb, b = att.n_col_blocks, att.block
    blk = _Blocks(att, s=s, d=d, m=m, den=den, c=c, z=z, g=g)
    dz = z.new_zeros((ncb, heads, b, fp))
    dd = d.new_zeros((ncb, heads, b))
    for t0, t1 in _chunks(att, heads, fp):
        rb, cb, alpha, kf, dalpha, lg = _alpha_dalpha(
            att, blk, t0, t1, slope=slope, seed=seed, rate=rate, transposed=True, bf16=bf16
        )
        a_dz = alpha if kf is None else alpha * kf
        dz.index_add_(0, cb, torch.matmul(_operand(a_dz, bf16).transpose(-1, -2),
                                          _operand(blk.g[rb], bf16)))
        draw = alpha * (dalpha - blk.c[rb][..., None]) * lg
        dd.index_add_(0, cb, draw.sum(-2))
    return dz.transpose(1, 2).reshape(-1, heads, fp), dd.transpose(1, 2).reshape(-1, heads)


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
    """True for the kernel (CUDA tensors), False for the plain twin."""
    if z.device.type == "cpu":
        return False
    if z.device.type != "cuda":
        raise ValueError(f"gat_tiled runs on cpu or cuda, got {z.device}")
    return True


def _edges_of(att, z, edges, default: str):
    """The lists a kernel walks: ``edges``, else the pattern's attribute
    ``default``; None for CPU tensors, whose plain twin sweeps the mask
    tiles (so it refuses ``edges``)."""
    if not _route(z):
        if edges is not None:
            raise ValueError("edges= picks the lists a CUDA kernel walks; the plain twin sweeps "
                             "the mask tiles")
        return None
    return getattr(att, default) if edges is None else edges


def gat_tile_fwd(att, s, d, z, *, slope, seed, rate, f=None, mxu_precision=None, edges=None):
    """(o [Npad,H,Fp], den [Npad,H], m [Npad,H]) of the forward sweep.
    s [Npad,H], d [Mpad,H], z [Mpad,H,Fp] float32; ``f`` (default Fp) is the
    head's real width: the kernel gathers z's first f columns of each head
    and writes o's others as 0 (the twin multiplies z's zero padding).
    ``mxu_precision`` as in the module docstring. ``edges`` (by row; default
    ``att.edges``, the tiled edges) are the lists the kernel walks:
    ``att.all_edges`` sweeps the whole pattern."""
    bf16 = _bf16_operands(mxu_precision)
    edges = _edges_of(att, z, edges, "edges")
    if edges is None:
        return gat_tile_fwd_plain(att, s, d, z, slope=slope, seed=seed, rate=rate,
                                  mxu_precision=mxu_precision)
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
    :func:`gat_tile_fwd` (the kernel gathers the first f columns of each
    head of z and g)."""
    bf16 = _bf16_operands(mxu_precision)
    edges = _edges_of(att, z, edges, "edges")
    if edges is None:
        return gat_tile_bwd_row_plain(att, s, d, m, den, c, z, g, slope=slope, seed=seed,
                                      rate=rate, mxu_precision=mxu_precision)
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
    ``mxu_precision`` as in :func:`gat_tile_fwd` (the kernel writes dz's
    columns past f as 0); ``edges`` by column, default ``att.edges_t``
    (``att.all_edges_t`` sweeps the whole pattern)."""
    bf16 = _bf16_operands(mxu_precision)
    edges_t = _edges_of(att, z, edges, "edges_t")
    if edges_t is None:
        return gat_tile_bwd_col_plain(att, s, d, m, den, c, z, g, slope=slope, seed=seed,
                                      rate=rate, mxu_precision=mxu_precision)
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


# ------------------------------------------------------------- rest path
def _rest_keep(row_ids, idx, seed, *, heads, n_cols, head_stride, rate):
    """[H, n_b, K] keep/(1−rate) for one rest bucket — the tile sweeps'
    entry ids (rest edges never coincide with tiled edges)."""
    eid = row_ids[:, None].long() * (n_cols & _M32) + idx.long()
    offs = torch.arange(heads, device=idx.device, dtype=torch.int64) * (head_stride & _M32)
    return entry_keep(eid[None] + offs[:, None, None], seed, rate).float() / (1.0 - rate)


def _add_rows(dst: torch.Tensor, src_sorted: torch.Tensor, inv_perm: torch.Tensor,
              scale: Optional[torch.Tensor] = None) -> None:
    """``dst[r] += src_sorted[inv_perm[r]] (· scale[r])`` for every row r of
    ``dst``, :data:`_ROW_BLOCK` rows at a time: the bucketed rest's rows
    merged without a whole reordered copy of them."""
    for r0 in range(0, dst.shape[0], _ROW_BLOCK):
        rows = slice(r0, min(r0 + _ROW_BLOCK, dst.shape[0]))
        part = src_sorted[inv_perm[rows]]
        dst[rows] += part if scale is None else part.mul_(scale[rows])


def _rest_fused(rest, s, d, z_heads, *, slope, seed, rate, n_cols_g, head_stride):
    """(m_rest, den_rest, o_sorted) of the bucketed residual in one pass. The
    buckets partition rows, so each takes its own max; ``m_rest`` is
    ``_NEG`` on rows with no rest edge, and den/o are computed under the
    clamped shift (0 there). ``o_sorted`` [Σ n_b, H, f] is in the buckets'
    row order (``rest.inv_perm`` maps a row to its place)."""
    heads = s.shape[1]
    n, f = z_heads.shape[0], z_heads.shape[2]
    s_sorted = s.t()[:, rest.perm]
    d_t = d.t()
    z_flat = z_heads.reshape(n, heads * f)
    o_sorted = z_heads.new_empty((rest.perm.shape[0], heads, f))
    ms, dens = [], []
    start = 0
    for idx, valid, rid in zip(rest.indices, rest.valid, rest.row_ids):
        n_b = idx.shape[0]
        raw = s_sorted[:, start : start + n_b, None] + d_t[:, idx]  # [H, n_b, K]
        sc = torch.where(valid > 0, _leaky(raw, slope), _NEG)
        m_b = sc.amax(-1)
        m_used = torch.where(m_b > _NEG / 2, m_b, 0.0)
        e = torch.exp(sc - m_used[..., None]) * valid
        ms.append(m_b)
        dens.append(e.sum(-1))
        if rate > 0.0:
            e = e * _rest_keep(rid, idx, seed, heads=heads, n_cols=n_cols_g,
                               head_stride=head_stride, rate=rate)
        o_sorted[start : start + n_b] = _ell_matvec_heads(idx, e, z_flat).view(n_b, heads, f)
        start += n_b
    m_rest = torch.cat(ms, 1)[:, rest.inv_perm].t()
    den_rest = torch.cat(dens, 1)[:, rest.inv_perm].t()
    return m_rest, den_rest, o_sorted


def _rest_bwd(rest, s, d, m, den, c, z_heads, g_heads, *, slope, seed, rate, n_cols_g, head_stride):
    """The residual edges' (ds, dd, dz_sorted): ``dz_sorted`` [Σ n_tb, H·f]
    is in the transpose buckets' column order (``rest.inv_perm_c`` maps a
    column to its place)."""
    heads, f = s.shape[1], z_heads.shape[2]
    perm = rest.perm
    s_sorted, m_sorted = s.t()[:, perm], m.t()[:, perm]
    den_sorted, c_sorted = den.t()[:, perm], c.t()[:, perm]
    d_t = d.t()
    z_flat = z_heads.reshape(-1, heads * f)
    alphas, draws, ds_parts = [], [], []
    start = 0
    for idx, valid, rid in zip(rest.indices, rest.valid, rest.row_ids):
        n_b = idx.shape[0]
        sl = slice(start, start + n_b)
        raw = s_sorted[:, sl, None] + d_t[:, idx]
        # mask before the exp: padding slots index column 0, whose score may
        # tower over the row's max
        e = torch.exp(torch.where(valid > 0, _leaky(raw, slope), _NEG) - m_sorted[:, sl, None]) * valid
        alpha = e / den_sorted[:, sl, None]
        dalpha = _ell_sddmm_heads(idx, g_heads[rid].reshape(n_b, heads * f), z_flat, heads)
        alpha_dz = alpha
        if rate > 0.0:
            kf = _rest_keep(rid, idx, seed, heads=heads, n_cols=n_cols_g,
                            head_stride=head_stride, rate=rate)
            dalpha = dalpha * kf
            alpha_dz = alpha * kf  # dz reads the dropped α
        draw = alpha * (dalpha - c_sorted[:, sl, None]) * _leaky_grad(raw, slope) * valid
        alphas.append(alpha_dz)
        draws.append(draw)
        ds_parts.append(draw.sum(-1))
        start += n_b
    ds = torch.cat(ds_parts, 1)[:, rest.inv_perm].t()
    alpha_flat = torch.cat([a.reshape(heads, -1) for a in alphas], 1)
    draw_flat = torch.cat([w.reshape(heads, -1) for w in draws], 1)
    g_flat = g_heads.reshape(-1, heads * f)
    dz_sorted = g_flat.new_empty((sum(i.shape[0] for i in rest.indices_t), heads * f))
    dd_parts, start = [], 0
    for idx_t, valid_t, pt in zip(rest.indices_t, rest.valid_t, rest.perm_t):
        flat = pt.reshape(-1)
        a_t = alpha_flat[:, flat].view(heads, *pt.shape) * valid_t
        w_t = draw_flat[:, flat].view(heads, *pt.shape) * valid_t
        dz_sorted[start : start + pt.shape[0]] = _ell_matvec_heads(idx_t, a_t, g_flat)
        dd_parts.append(w_t.sum(-1))
        start += pt.shape[0]
    dd = torch.cat(dd_parts, 1)[:, rest.inv_perm_c].t()
    return ds, dd, dz_sorted.view(-1, heads, f)


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
    """Padded sweep operands: z_heads [M,H,f], zp [Mpad,H,Fp], s [Npad,H]
    (rows of z up to n_rows), d [Mpad,H]."""
    heads, f = a_src.shape
    fp = _round_up(f, F_ALIGN)
    n = att.n_rows
    npad = att.n_row_blocks * att.block
    mpad = att.n_col_blocks * att.block
    z_heads = z.reshape(z.shape[0], heads, f)
    zp = _pad_heads(z_heads, mpad, fp)
    s = _pad_rows(torch.einsum("nhf,hf->nh", z_heads[:n], a_src), npad).contiguous()
    d = _pad_rows(torch.einsum("nhf,hf->nh", z_heads, a_dst), mpad).contiguous()
    return z_heads, zp, s, d


def _bwd_operands(att: TiledAttentionPattern, a_src, g, out):
    """The backward sweeps' operands beyond the forward's: g_heads [n,H,f],
    gp [Npad,H,Fp] and c = ⟨g, out⟩ per row and head [Npad,H]."""
    heads, f = a_src.shape
    n = att.n_rows
    npad = att.n_row_blocks * att.block
    g_heads = g.contiguous().view(n, heads, f)
    gp = _pad_heads(g_heads, npad, _round_up(f, F_ALIGN))
    c = _pad_rows(torch.einsum("nhf,nhf->nh", g_heads, out.view(n, heads, f)), npad).contiguous()
    return g_heads, gp, c


def _whole_sweeps(z: torch.Tensor, mxu_precision) -> bool:
    """True where the kernels sweep the whole pattern (``att.all_edges``,
    ``att.all_edges_t``) in place of the tiles plus the plain rest: CUDA
    tensors with float32 contractions. The CPU twins and the bf16-operand
    variant keep the split."""
    return _route(z) and not _bf16_operands(mxu_precision)


def _count_sweep(att, launches: int) -> None:
    """A run of the layer's forward or backward: the rest's edges it
    covered, and its kernel launches on the whole-pattern lists."""
    profiling.counters["attn_rest_edges"] += att.rest_nnz
    profiling.counters["attn_rest_in_sweeps"] += launches


def _layer_fwd(att, z, a_src, a_dst, *, seed, slope, rate, mxu_precision=None):
    """(out [n, H·f], s, d, m, den, zp); rows with no edge get m = 0 and
    den = 1. On the card (:func:`_whole_sweeps`) kernel 3 walks every edge,
    so its (m, den, o) are the row's; otherwise the tile sweep's
    accumulators (under each row's running tile max) and the rest's (under
    its own max) are rescaled to the merged max."""
    heads, f = a_src.shape
    n = att.n_rows
    npad = att.n_row_blocks * att.block
    z_heads, zp, s, d = _prep(att, z, a_src, a_dst)
    if _whole_sweeps(zp, mxu_precision):
        o, den, m = gat_tile_fwd(att, s, d, zp, slope=slope, seed=seed, rate=rate, f=f,
                                 edges=att.all_edges)
        _count_sweep(att, 1)
        m = torch.where(m > _NEG / 2, m, 0.0)
        den = torch.where(den > 0, den, 1.0)
        out = o.div_(den[..., None])[:n, :, :f].reshape(n, heads * f)
        return out, s, d, m, den, zp
    hstride = att.n_rows * att.n_cols
    o_t, den_t, m_t = gat_tile_fwd(att, s, d, zp, slope=slope, seed=seed, rate=rate, f=f,
                                   mxu_precision=mxu_precision)
    valid_t = m_t > _NEG / 2
    if att.rest is not None:
        m_r, den_r, o_sorted = _rest_fused(
            att.rest, s[:n], d[: z.shape[0]], z_heads, slope=slope, seed=seed, rate=rate,
            n_cols_g=att.n_cols, head_stride=hstride,
        )
        _count_sweep(att, 0)
        # padding rows saw no rest edge: their rest max reads as empty
        m_rp = F.pad(m_r, (0, 0, 0, npad - n), value=_NEG)
        valid_r = m_rp > _NEG / 2
        m = torch.maximum(m_t, m_rp)
        m = torch.where(m > _NEG / 2, m, 0.0)
        a_t = torch.where(valid_t, torch.exp(m_t - m), 0.0)
        a_r = torch.where(valid_r, torch.exp(torch.where(valid_r, m_rp, 0.0) - m), 0.0)
        den = den_t * a_t
        o_un = o_t.mul_(a_t[..., None])
        den[:n] += den_r * a_r[:n]
        _add_rows(o_un[:n, :, :f], o_sorted, att.rest.inv_perm, a_r[:n, :, None])
        del o_sorted
    else:
        m = torch.where(valid_t, m_t, 0.0)
        a_t = torch.where(valid_t, torch.exp(m_t - m), 0.0)
        den = den_t * a_t
        o_un = o_t.mul_(a_t[..., None])
    den = torch.where(den > 0, den, 1.0)
    # in place: at World each [Npad, H, Fp] temporary is 5.7 GB
    out = o_un.div_(den[..., None])[:n, :, :f].reshape(n, heads * f)
    return out, s, d, m.contiguous(), den.contiguous(), zp


class _TiledGatCore(torch.autograd.Function):
    """The whole tiled layer, differentiable in z, a_src and a_dst; its
    backward is the JAX package's ``_tiled_gat_bwd``: c = ⟨g, out⟩, ds from
    the row sweep, dz and dd from the column sweep (on the card over every
    edge; otherwise over the tiles, plus the rest's share), then the chain
    through s = z·a_src and d = z·a_dst. The forward's padded zp is kept for
    the backward sweeps; ``mxu_precision`` reaches every sweep."""

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
        att, seed, slope, rate = ctx.att, ctx.seed, ctx.slope, ctx.rate
        z, a_src, a_dst, out, s, d, m, den, zp = ctx.saved_tensors
        heads, f = a_src.shape
        n, rows = att.n_rows, z.shape[0]
        z_heads = z.view(rows, heads, f)
        g_heads, gp, c = _bwd_operands(att, a_src, g, out)
        kw = dict(slope=slope, seed=seed, rate=rate)
        prec = ctx.mxu_precision
        whole = _whole_sweeps(zp, prec)
        by_row, by_col = (att.all_edges, att.all_edges_t) if whole else (None, None)
        ds = gat_tile_bwd_row(att, s, d, m, den, c, zp, gp, f=f, mxu_precision=prec,
                              edges=by_row, **kw)
        dzp, dd = gat_tile_bwd_col(att, s, d, m, den, c, zp, gp, f=f, mxu_precision=prec,
                                   edges=by_col, **kw)
        del gp
        if whole:
            _count_sweep(att, 2)
        elif att.rest is not None:
            ds_r, dd_r, dz_sorted = _rest_bwd(
                att.rest, s[:n], d[:rows], m[:n], den[:n], c[:n], z_heads, g_heads,
                n_cols_g=att.n_cols, head_stride=att.n_rows * att.n_cols, **kw,
            )
            _count_sweep(att, 0)
            ds[:n] += ds_r
            dd[: dd_r.shape[0]] += dd_r
            inv_c = att.rest.inv_perm_c
            _add_rows(dzp[: inv_c.shape[0], :, :f], dz_sorted, inv_c)
            del dz_sorted
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
