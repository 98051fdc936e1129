"""Sparse operand containers for the graph convolution and the input layer.

Host-side graphs live in scipy CSR/COO. Each operand class below is built on
the host in numpy, held as CPU tensors, and moved to the device in one step
with :func:`to_device`:

- :class:`EllMatrix` — row-padded (ELLPACK) format: every row padded to a
  common slot count (pad slots point at column 0 with value 0.0). Operand of
  the ``ell`` and ``oracle`` backends (``ops/spmm.py``).
- :class:`CappedEll` — an ``EllMatrix`` capped at a row-length quantile plus
  an overflow ``EllMatrix`` for the few longer rows: the sampled input
  layer's operand (``models/sampled.py``).
- :class:`BsrMatrix` — block-sparse rows with densified ``B × B`` tiles and
  per-row-block tile lists padded to ``k_max`` with the all-zero tile 0.
  Operand of the ``bsr`` backend's CUDA kernel and of the BSR SDDMM
  (``ops/spmm_bsr.py``, ``ops/sddmm_bsr.py``).
- :class:`BsrFlat` — flat-tile block-sparse rows: dense ``B × B`` tiles
  sorted by (row block, column block). Operand of the hybrid backend's
  CUDA kernel (``ops/spmm_bsr.py``).
- :class:`PackedRows` — the row-compressed nonzeros of a ``BsrMatrix`` or
  ``BsrFlat`` (their ``packed`` property, built once per instance on the
  tiles' device by :func:`pack_rows`): what the packed-row CUDA kernel
  reads.
- :class:`TileEntries` — the same nonzeros indexed by tile (a
  ``BsrMatrix``'s ``tile_entries`` property, built once per instance): what
  the nonzero-route SDDMM kernel reads.
- :class:`BucketedEll` — degree-bucketed row-padded format: per-bucket
  gathers of the dense operand, padded work ≈ 1.3–2× nnz under power-law
  degree skew.
- :class:`CachedBell` — bucketed-ELL with a hot-column split.
- :class:`SlabbedBell` — the BoW input as a dense slab over its Zipf-head
  columns plus a gather residual.
- :class:`BucketedAttention` — the degree-bucketed edge pattern of the GAT
  layers (and the rest of ``sparse/attention_tiles.py``'s tiled operand);
  under an :func:`attention_schedule` its bucket shapes are common to every
  rank's block.
- :class:`AttentionEll` — the fixed-K edge pattern of the distributed GAT's
  ``ell`` format (the correctness anchor).
- :class:`SparseGraph` — the host owner of one sparse operator, building the
  formats above lazily.

Index arrays that drive the bucketed gathers are int64 (PyTorch's native
index type); the arrays a CUDA kernel reads, and the ELL indices (equal to
the JAX package's), are int32.

Reference parity: the reference keeps its adjacency as scipy CSR and relies
on Theano's ``structured_dot`` (``gcnmodel.py :: SparseConvolutionDenseLayer``);
symmetric normalization Â = D^-1/2 (A+I) D^-1/2 happens in
``gcnmain.py :: preprocess_data``. :func:`normalize_adjacency` reproduces
that math exactly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _t(a: np.ndarray) -> torch.Tensor:
    """Host numpy array -> CPU tensor (copied, contiguous)."""
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def to_device(obj, device, _memo=None):
    """Move every tensor inside an operand (dataclass, tuple, or tensor) to
    ``device``; non-tensor fields are kept. An object met twice in one call
    (a symmetric operator passed as its own transpose) moves once and stays
    one object. A dataclass is rebuilt, so nothing cached on the old
    instance (such as :attr:`BsrFlat.packed`) comes along."""
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj.to(device)
    elif isinstance(obj, tuple):
        out = tuple(to_device(o, device, memo) for o in obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {
            f.name: to_device(getattr(obj, f.name), device, memo)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (torch.Tensor, tuple))
            or dataclasses.is_dataclass(getattr(obj, f.name))
        }
        out = dataclasses.replace(obj, **changes)
    else:
        return obj
    memo[id(obj)] = out
    return out


def bucket_widths(max_deg: int) -> list:
    """Descending degree-bucket width ladder: powers of two down to 1."""
    max_deg = max(int(max_deg), 1)
    widths = [1]
    while widths[-1] < max_deg:
        widths.append(widths[-1] * 2)
    return widths[::-1]


def attention_schedule(deg_lists, *, row_align: int = 8) -> list:
    """Common ``(width, padded_rows)`` bucket schedule over rank blocks.

    ``deg_lists``: one degree vector per rank block (row degrees for the
    forward layout, column in-degrees for the transpose). The width ladder
    comes from the global max degree and each bucket's row count is the max
    over the blocks (rounded up to ``row_align``), so
    ``BucketedAttention.from_scipy(block, schedule=...)`` gives every rank
    the same shapes (JAX: one SPMD program over the stacked blocks)."""
    deg_lists = [np.asarray(d) for d in deg_lists]
    gmax = max((int(d.max()) if d.size and d.max() else 1) for d in deg_lists)
    widths = bucket_widths(gmax)
    counts = np.zeros((len(deg_lists), len(widths)), np.int64)
    for di, deg in enumerate(deg_lists):
        ds = -np.sort(-deg)
        start = 0
        for bi, k in enumerate(widths):
            lower = widths[bi + 1] if bi + 1 < len(widths) else 0
            end = start + int(np.searchsorted(-ds[start:], -lower))
            if bi + 1 == len(widths):
                end = len(ds)
            counts[di, bi] = end - start
            start = end
    rows = [int(_round_up(int(c), row_align)) if c else 0 for c in counts.max(axis=0)]
    sched = [(k, r) for k, r in zip(widths, rows) if r > 0]
    return sched or [(1, row_align)]


def normalize_adjacency(adj: sp.spmatrix, *, add_self_loops: bool = True) -> sp.csr_matrix:
    """Symmetric GCN normalization Â = D^-1/2 (A + I) D^-1/2.

    Matches the reference preprocessing (``gcnmain.py :: preprocess_data``):
    self-loops added, degree computed on A+I, isolated nodes get degree from
    their self-loop (so no division by zero).
    """
    adj = sp.csr_matrix(adj, dtype=np.float64)
    if adj.nnz and adj.data.min() < 0.0:
        # D^-1/2 is undefined for negative degrees; mention graphs are
        # non-negative by construction — anything else is a caller bug
        raise ValueError(
            "normalize_adjacency needs a non-negative adjacency "
            f"(min weight {adj.data.min()!r})"
        )
    if add_self_loops:
        adj = adj + sp.identity(adj.shape[0], format="csr", dtype=np.float64)
    deg = np.asarray(adj.sum(axis=1)).ravel()
    with np.errstate(divide="ignore"):
        d_inv_sqrt = 1.0 / np.sqrt(deg)
    d_inv_sqrt[~np.isfinite(d_inv_sqrt)] = 0.0
    d_mat = sp.diags(d_inv_sqrt)
    out = (d_mat @ adj @ d_mat).tocsr()
    out.sort_indices()
    return out.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class PackedRows:
    """Row-compressed (CSR) form of a block-sparse operand's nonzeros: what
    the packed-row CUDA kernel reads (``csrc/bsr_flat.cu``).

    row_ptr: [n_rows_padded + 1] int32 — row i owns entries
             ``row_ptr[i] : row_ptr[i + 1]``; rows without one have equal
             bounds.
    col:     [nnz] int32 global column, ``column block · B + column in the
             tile``.
    val:     [nnz] float32.

    Within a row the entries are in slot order, then by column inside the
    tile: the order in which the dense-tile product adds them.
    """

    row_ptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor

    @property
    def nnz(self) -> int:
        return self.col.shape[0]


def pack_rows(
    tiles: torch.Tensor,
    slot_tile: torch.Tensor,
    slot_rowblk: torch.Tensor,
    slot_colblk: torch.Tensor,
    n_rows_padded: int,
) -> PackedRows:
    """The :class:`PackedRows` of ``Σ over slots s of tiles[slot_tile[s]]``
    placed at row block ``slot_rowblk[s]``, column block ``slot_colblk[s]``,
    built with torch ops on the tiles' device. Slots are given in the order
    the dense product adds them; a slot whose tile is all zero (padding,
    filler) gives no entry, and a tile named by two slots gives its entries
    twice, as the dense product adds it twice."""
    b = tiles.shape[1]
    dev = tiles.device
    flat = tiles.reshape(-1)
    nz = flat.nonzero().squeeze(1)  # row-major: by tile, row in the tile, column
    per_tile = torch.bincount(nz // (b * b), minlength=tiles.shape[0])
    tile_start = torch.cumsum(per_tile, 0) - per_tile
    slot_tile = slot_tile.long()
    per_slot = per_tile[slot_tile]
    slot_of = torch.repeat_interleave(torch.arange(slot_tile.shape[0], device=dev), per_slot)
    slot_start = torch.cumsum(per_slot, 0) - per_slot
    offset = torch.arange(slot_of.shape[0], device=dev) - slot_start[slot_of]
    src = nz[tile_start[slot_tile[slot_of]] + offset]
    in_tile = src % (b * b)
    row = slot_rowblk.long()[slot_of] * b + in_tile // b
    col = slot_colblk.long()[slot_of] * b + in_tile % b
    # a stable sort keeps each row's entries in slot order, then by column
    row, order = torch.sort(row, stable=True)
    if row.numel() and int(row[-1]) >= n_rows_padded:
        raise ValueError(f"a slot's row block lies past the {n_rows_padded} padded rows")
    counts = torch.bincount(row, minlength=n_rows_padded)
    row_ptr = torch.zeros(n_rows_padded + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    if int(row_ptr[-1]) >= 2**31:
        raise ValueError("the packed form holds 2^31 or more entries; int32 columns cannot index it")
    return PackedRows(
        row_ptr=row_ptr.int(), col=col[order].int().contiguous(), val=flat[src][order].contiguous()
    )


@dataclasses.dataclass(frozen=True)
class TileEntries:
    """The nonzeros of a :class:`BsrMatrix`'s tiles, indexed by tile: what
    the nonzero-route SDDMM kernel reads (``csrc/sddmm_bsr.cu``).

    tile_ptr: [n_tiles + 2] int32 — tile t owns entries
              ``tile_ptr[t] : tile_ptr[t + 1]``; tile 0 (all zero) owns none.
    pos:      [nnz] int32 — the entry's place ``i·B + j`` inside its tile.
    trow/tcol: [n_tiles + 1] int32 — each tile's row and column block
              (:func:`tile_blocks`; tile 0 at (0, 0)).

    Entries are in row-major order: by tile, then row, then column.
    """

    tile_ptr: torch.Tensor
    pos: torch.Tensor
    trow: torch.Tensor
    tcol: torch.Tensor

    @property
    def nnz(self) -> int:
        return self.pos.shape[0]


def tile_blocks(pattern: "BsrMatrix") -> tuple:
    """(trow, tcol): [n_tiles + 1] int32 row and column block of each tile,
    built with torch ops on the pattern's device, without a host sync;
    tile 0 (and every padding slot, which points at it) maps to (0, 0)."""
    flat = pattern.tile_idx.reshape(-1).long()
    dev = flat.device
    real = flat > 0
    rows = torch.arange(pattern.n_row_blocks, dtype=torch.int32, device=dev)
    rows = rows.repeat_interleave(pattern.k_max)
    cols = pattern.tile_col.reshape(-1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    n = pattern.tiles.shape[0]
    trow = torch.zeros(n, dtype=torch.int32, device=dev).scatter_(0, flat, torch.where(real, rows, zero))
    tcol = torch.zeros(n, dtype=torch.int32, device=dev).scatter_(0, flat, torch.where(real, cols, zero))
    return trow, tcol


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Row-padded sparse matrix.

    indices: [n_rows, K] int32 column ids (pad = 0)
    values:  [n_rows, K] float32 edge values (pad = 0.0)
    """

    indices: torch.Tensor
    values: torch.Tensor
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def k(self) -> int:
        return self.indices.shape[1]

    @staticmethod
    def from_scipy(mat: sp.spmatrix, *, pad_k_to: int = 8, pad_rows_to: int = 1) -> "EllMatrix":
        """Slot count padded to a multiple of ``pad_k_to``, row count to a
        multiple of ``pad_rows_to`` (extra rows are all padding)."""
        csr = sp.csr_matrix(mat)
        csr.sort_indices()
        n_rows, n_cols = csr.shape
        deg = np.diff(csr.indptr)
        k = _round_up(max(int(deg.max()) if n_rows else 0, 1), pad_k_to)
        n_rows_pad = _round_up(max(n_rows, 1), pad_rows_to)
        indices = np.zeros((n_rows_pad, k), dtype=np.int32)
        values = np.zeros((n_rows_pad, k), dtype=np.float32)
        if csr.nnz:
            rows = np.repeat(np.arange(n_rows), deg)
            slots = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], deg)
            indices[rows, slots] = csr.indices
            values[rows, slots] = csr.data
        return EllMatrix(indices=_t(indices), values=_t(values), n_cols=n_cols)


@dataclasses.dataclass(frozen=True)
class CappedEll:
    """Row-capped ELL + overflow bucket: the sampled input path's defense
    against single-document token outliers.

    ``x.ell()`` pads EVERY user row to the maximum token count; one
    million-token document inflates the whole [N, K] sampled operand. Here
    ``main`` keeps at most ``cap`` tokens per row, and the tail tokens of
    the few overflowing rows live in ``ov`` (row 0 reserved all-zero);
    ``ov_id[i]`` maps row i to its overflow row (0 = none). The embedding
    bag then adds ``ov``'s contribution via one small global bag per step +
    a [batch]-shaped take — loss semantics identical to the uncapped
    layout, operand shapes bounded by the cap and the ACTUAL overflow nnz.
    ``ov`` and ``ov_id`` are None when no row overflows.
    """

    main: EllMatrix
    ov: Optional[EllMatrix]
    ov_id: Optional[torch.Tensor]  # [n_rows] int32 into ov rows (0 = none)

    @property
    def n_cols(self) -> int:
        return self.main.n_cols


@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """Block-sparse rows with densified tiles and padded per-row-block tile
    lists, ``k_max`` slots a row block (the JAX package's layout; the SpMM
    kernel reads its :attr:`packed` nonzeros, the SDDMM kernel its
    :attr:`tile_entries`).

    tiles:    [n_tiles + 1, B, B] float32; tiles[0] is all zero (padding).
    tile_idx: [n_row_blocks, k_max] int32 index into ``tiles`` (pad = 0).
    tile_col: [n_row_blocks, k_max] int32 column-block id (pad = 0).
    n_rows/n_cols: logical (unpadded) shape.
    """

    tiles: torch.Tensor
    tile_idx: torch.Tensor
    tile_col: torch.Tensor
    n_rows: int
    n_cols: int
    block: int

    @property
    def n_tiles(self) -> int:
        """Materialized tiles, the zero tile 0 not counted."""
        return self.tiles.shape[0] - 1

    @property
    def n_row_blocks(self) -> int:
        return self.tile_idx.shape[0]

    @property
    def k_max(self) -> int:
        return self.tile_idx.shape[1]

    @property
    def n_rows_padded(self) -> int:
        return self.n_row_blocks * self.block

    @property
    def n_cols_padded(self) -> int:
        return _round_up(self.n_cols, self.block)

    @functools.cached_property
    def packed(self) -> PackedRows:
        """The tiles' nonzeros in rows (built once per instance, on the
        tiles' device): slot (r, k) is tile ``tile_idx[r, k]`` at column
        block ``tile_col[r, k]``; padding slots name the zero tile 0."""
        rb, k_max = self.tile_idx.shape
        slot_rowblk = torch.arange(rb, device=self.tiles.device).repeat_interleave(k_max)
        return pack_rows(self.tiles, self.tile_idx.reshape(-1), slot_rowblk,
                         self.tile_col.reshape(-1), self.n_rows_padded)

    @functools.cached_property
    def tile_rowcol(self) -> tuple:
        """(trow, tcol) of :func:`tile_blocks`, built once per instance:
        what the dense-tile SDDMM kernel reads."""
        return tile_blocks(self)

    @functools.cached_property
    def tile_entries(self) -> TileEntries:
        """The tiles' nonzeros by tile (built once per instance, on the
        tiles' device, from one ``nonzero`` over the tiles)."""
        b2 = self.block * self.block
        if self.tiles.numel() >= 2**31:
            raise ValueError("the tiles hold 2^31 or more entries; int32 offsets cannot index them")
        nz = self.tiles.reshape(-1).nonzero().squeeze(1)  # by tile, row in the tile, column
        per_tile = torch.bincount(nz // b2, minlength=self.tiles.shape[0])
        tile_ptr = torch.zeros(self.tiles.shape[0] + 1, dtype=torch.int64, device=nz.device)
        torch.cumsum(per_tile, 0, out=tile_ptr[1:])
        trow, tcol = self.tile_rowcol
        return TileEntries(tile_ptr=tile_ptr.int(), pos=(nz % b2).int(), trow=trow, tcol=tcol)

    @staticmethod
    def from_scipy(mat: sp.spmatrix, *, block: int = 128, max_tiles: int = 65536) -> "BsrMatrix":
        coo = sp.coo_matrix(mat)
        n_rows, n_cols = coo.shape
        rb = _round_up(max(n_rows, 1), block) // block
        cb = _round_up(max(n_cols, 1), block) // block
        key = (coo.row // block).astype(np.int64) * cb + (coo.col // block)
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        uniq = np.unique(key_s)
        n_tiles = len(uniq)
        if n_tiles > max_tiles:
            raise ValueError(
                f"BSR would materialize {n_tiles} dense {block}x{block} tiles "
                f"({n_tiles * block * block * 4 / 1e9:.1f} GB) — the sparsity "
                "pattern is too scattered for densified tiles; use the "
                "'hybrid' or 'bell' backend instead"
            )
        tiles = np.zeros((n_tiles + 1, block, block), dtype=np.float32)
        tile_of_edge = np.searchsorted(uniq, key_s) + 1
        np.add.at(
            tiles,
            (tile_of_edge, coo.row[order] % block, coo.col[order] % block),
            coo.data[order],
        )
        # per-row-block tile lists: uniq is sorted, so its row blocks are
        # non-decreasing and a tile's slot is its offset in its row block
        uniq_br = (uniq // cb).astype(np.int64)
        counts = np.bincount(uniq_br, minlength=rb)
        k_max = max(int(counts.max()) if n_tiles else 0, 1)
        tile_idx = np.zeros((rb, k_max), dtype=np.int32)
        tile_col = np.zeros((rb, k_max), dtype=np.int32)
        if n_tiles:
            slot = np.arange(n_tiles) - np.searchsorted(uniq_br, np.arange(rb))[uniq_br]
            tile_idx[uniq_br, slot] = np.arange(n_tiles) + 1
            tile_col[uniq_br, slot] = uniq % cb
        return BsrMatrix(
            tiles=_t(tiles),
            tile_idx=_t(tile_idx),
            tile_col=_t(tile_col),
            n_rows=n_rows,
            n_cols=n_cols,
            block=block,
        )

    def density_stats(self) -> dict:
        """Diagnostics: how well edges fill the materialized tiles."""
        n_tiles = self.n_tiles
        fill = float((self.tiles != 0).sum()) / max(n_tiles * self.block * self.block, 1)
        return {
            "n_tiles": n_tiles,
            "tile_fill": fill,
            "k_max": self.k_max,
            "padded_shape": (self.n_rows_padded, self.n_cols_padded),
        }


@dataclasses.dataclass(frozen=True)
class BsrFlat:
    """Flat-tile block-sparse matrix — one slot per MATERIALIZED tile (the
    JAX package's layout; the CUDA kernel reads its :attr:`packed` nonzeros).

    tiles:   [n_tiles, B, B] float32 dense tile data, sorted by (row block,
             col block); row blocks with no edges carry one all-zero tile so
             every output block is still written.
    rowblk:  [n_tiles] int32 — output row-block id per tile (non-decreasing).
    colblk:  [n_tiles] int32 — h column-block id per tile.
    row_ptr: [n_row_blocks + 1] int32 — row block r owns tiles
             ``row_ptr[r] : row_ptr[r + 1]`` (the CUDA kernel's run bounds;
             their starts are where the JAX kernel's ``first`` resets).
    """

    tiles: torch.Tensor
    rowblk: torch.Tensor
    colblk: torch.Tensor
    row_ptr: torch.Tensor
    n_rows: int
    n_cols: int
    block: int

    @property
    def n_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def n_row_blocks(self) -> int:
        return _round_up(max(self.n_rows, 1), self.block) // self.block

    @property
    def n_rows_padded(self) -> int:
        return self.n_row_blocks * self.block

    @property
    def n_cols_padded(self) -> int:
        return _round_up(self.n_cols, self.block)

    @functools.cached_property
    def packed(self) -> PackedRows:
        """The tiles' nonzeros in rows (built once per instance, on the
        tiles' device): slot t is tile t at row block ``rowblk[t]``, column
        block ``colblk[t]``; zero filler tiles give no entry."""
        return pack_rows(self.tiles, torch.arange(self.n_tiles, device=self.tiles.device),
                         self.rowblk, self.colblk, self.n_rows_padded)

    @staticmethod
    def from_scipy(mat: sp.spmatrix, *, block: int = 256, max_tiles: int = 65536) -> "BsrFlat":
        coo = sp.coo_matrix(mat)
        n_rows, n_cols = coo.shape
        rb = _round_up(max(n_rows, 1), block) // block
        cb = _round_up(max(n_cols, 1), block) // block
        key = (coo.row // block).astype(np.int64) * cb + (coo.col // block)
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        uniq = np.unique(key_s)
        # every row block owns >= 1 tile: the zero filler tile keeps the
        # tile list in step with the JAX operand (whose kernel zero-inits an
        # output block only when visiting its first tile)
        have = np.zeros(rb, dtype=bool)
        have[(uniq // cb).astype(np.int64)] = True
        filler = np.flatnonzero(~have).astype(np.int64) * cb  # zero tile at col 0
        all_keys = np.sort(np.concatenate([uniq, filler]))
        n_tiles = len(all_keys)
        if n_tiles > max_tiles:
            raise ValueError(
                f"BsrFlat would materialize {n_tiles} dense {block}x{block} "
                "tiles — pattern too scattered; use 'hybrid' with a higher "
                "min_tile_nnz or the 'bell' backend"
            )
        tiles = np.zeros((n_tiles, block, block), dtype=np.float32)
        tile_of_edge = np.searchsorted(all_keys, key_s)
        np.add.at(
            tiles,
            (tile_of_edge, coo.row[order] % block, coo.col[order] % block),
            coo.data[order],
        )
        rowblk = (all_keys // cb).astype(np.int32)
        colblk = (all_keys % cb).astype(np.int32)
        row_ptr = np.searchsorted(rowblk, np.arange(rb + 1)).astype(np.int32)
        return BsrFlat(
            tiles=_t(tiles),
            rowblk=_t(rowblk),
            colblk=_t(colblk),
            row_ptr=_t(row_ptr),
            n_rows=n_rows,
            n_cols=n_cols,
            block=block,
        )


@dataclasses.dataclass(frozen=True)
class BucketedEll:
    """Degree-bucketed ELL — the fix for power-law degree skew.

    Plain ELL pads every row to the max degree; on an @-mention graph that
    wastes 10–100× (hubs dominate). Here rows are sorted by degree and split
    into buckets whose slot widths grow geometrically; each bucket is its own
    dense [n_b, K_b] ELL block, so total padded slots ≈ 1.3–2× nnz.

    ``perm[j]`` = original row id at sorted position j; ``inv_perm`` restores
    original order after the per-bucket matvecs are concatenated.
    """

    indices: tuple  # tuple of [n_b, K_b] int64
    values: tuple  # tuple of [n_b, K_b] float32
    row_ids: tuple  # tuple of [n_b] int64 — original row id per bucket row
    perm: torch.Tensor  # [n_rows] int64
    inv_perm: torch.Tensor  # [n_rows] int64
    n_cols: int
    # True when the rows were ALREADY grouped by descending bucket width, so
    # perm is the identity and the restore gather is skipped
    natural: bool = False

    @property
    def padded_slots(self) -> int:
        return sum(int(i.shape[0] * i.shape[1]) for i in self.indices)

    @staticmethod
    def from_scipy(mat: sp.spmatrix) -> "BucketedEll":
        csr = sp.csr_matrix(mat)
        csr.sort_indices()
        n_rows, n_cols = csr.shape
        deg = np.diff(csr.indptr)
        widths = bucket_widths(int(deg.max()) if n_rows and deg.max() else 1)
        kneed = np.power(2.0, np.ceil(np.log2(np.maximum(deg, 1)))).astype(np.int64)
        natural = n_rows == 0 or bool(np.all(np.diff(kneed) <= 0))
        if natural:
            perm = np.arange(n_rows, dtype=np.int64)
            deg_sorted = deg
        else:
            perm = np.argsort(-deg, kind="stable").astype(np.int64)
            deg_sorted = deg[perm]
        indices, values, row_ids = [], [], []
        start = 0
        for b, k in enumerate(widths):
            lower = widths[b + 1] if b + 1 < len(widths) else 0
            # rows with lower < deg <= k  (bucket-grouped ⇒ contiguous)
            if natural:
                end = start + int(np.sum(kneed[start:] == k))
            else:
                end = start + int(np.searchsorted(-deg_sorted[start:], -lower))
            if b + 1 == len(widths):
                end = n_rows  # last bucket takes everything left (incl. deg 0)
            if end == start:
                continue
            rows = perm[start:end]
            block = csr[rows]
            bi = np.zeros((end - start, k), dtype=np.int64)
            bv = np.zeros((end - start, k), dtype=np.float32)
            bdeg = np.diff(block.indptr)
            if block.nnz:
                rr = np.repeat(np.arange(end - start), bdeg)
                ss = np.arange(block.nnz) - np.repeat(block.indptr[:-1], bdeg)
                bi[rr, ss] = block.indices
                bv[rr, ss] = block.data
            indices.append(_t(bi))
            values.append(_t(bv))
            row_ids.append(_t(rows))
            start = end
        if not indices:  # empty matrix
            indices = [torch.zeros((max(n_rows, 1), 1), dtype=torch.int64)]
            values = [torch.zeros((max(n_rows, 1), 1), dtype=torch.float32)]
            row_ids = [torch.zeros((max(n_rows, 1),), dtype=torch.int64)]
        inv_perm = np.empty(n_rows, dtype=np.int64)
        inv_perm[perm] = np.arange(n_rows, dtype=np.int64)
        return BucketedEll(
            indices=tuple(indices),
            values=tuple(values),
            row_ids=tuple(row_ids),
            perm=_t(perm),
            inv_perm=_t(inv_perm),
            n_cols=n_cols,
            natural=natural,
        )


@dataclasses.dataclass(frozen=True)
class CachedBell:
    """Residual SpMM operand split by column heat.

    Edges pointing at the ``hot_ids`` columns gather from the compact
    ``h_hot = h[hot_ids]`` table instead of the full feature matrix (the
    cache-first idea of arXiv:2104.10716); the JAX package measured the
    compact-table gather as the faster one on its hardware.

    ``hot``/``hot_t`` are the [n, C]/[C, n] parts (compact column ids);
    ``cold``/``cold_t`` the remainder with global ids. Self-contained for
    autodiff — the transposes ride along for the backward.
    """

    hot_ids: torch.Tensor  # [C] int64 global column ids
    hot: BucketedEll
    hot_t: BucketedEll
    cold: BucketedEll
    cold_t: BucketedEll

    @staticmethod
    def from_scipy(
        csr: sp.csr_matrix,
        *,
        max_hot: int = 16384,
        min_fraction: float = 0.25,
    ):
        """Returns a CachedBell, or None when the column skew doesn't justify
        the extra compact-table gather (uniform residuals)."""
        csr = sp.csr_matrix(csr)
        n_rows, n_cols = csr.shape
        if csr.nnz == 0 or n_cols <= max_hot:
            return None
        freq = np.bincount(csr.indices, minlength=n_cols)
        order = np.argsort(-freq, kind="stable")
        hot_ids = np.sort(order[:max_hot])
        covered = freq[hot_ids].sum() / csr.nnz
        if covered < min_fraction:
            return None
        hot_mask = np.zeros(n_cols, dtype=bool)
        hot_mask[hot_ids] = True
        coo = csr.tocoo()
        is_hot = hot_mask[coo.col]
        compact = np.full(n_cols, -1, dtype=np.int64)
        compact[hot_ids] = np.arange(len(hot_ids))
        hot_csr = sp.coo_matrix(
            (coo.data[is_hot], (coo.row[is_hot], compact[coo.col[is_hot]])),
            shape=(n_rows, len(hot_ids)),
        ).tocsr()
        cold_csr = sp.coo_matrix(
            (coo.data[~is_hot], (coo.row[~is_hot], coo.col[~is_hot])),
            shape=(n_rows, n_cols),
        ).tocsr()
        return CachedBell(
            hot_ids=_t(hot_ids.astype(np.int64)),
            hot=BucketedEll.from_scipy(hot_csr),
            hot_t=BucketedEll.from_scipy(hot_csr.T.tocsr()),
            cold=BucketedEll.from_scipy(cold_csr),
            cold_t=BucketedEll.from_scipy(cold_csr.T.tocsr()),
        )


def zipf_head_cols(
    csr: sp.csr_matrix,
    *,
    slab_cols: int = 4096,
    itemsize: int = 2,
    byte_budget: int = 2 << 30,
    min_coverage: float = 0.15,
    budget_rows: Optional[int] = None,
) -> Optional[np.ndarray]:
    """The top-nnz column ids worth densifying into a head slab, or None
    when the matrix is too small / head-light (the :class:`SlabbedBell`
    gate; shared with the row-partitioned distributed input, where
    ``budget_rows`` is a rank's row count, so the byte budget applies to
    each rank's slab block, not to the whole matrix)."""
    n_rows, n_cols = csr.shape
    if csr.nnz == 0 or n_cols < 1024 or n_rows < 1024:
        return None
    rows_for_budget = n_rows if budget_rows is None else budget_rows
    c = min(slab_cols, n_cols, max(byte_budget // max(rows_for_budget * itemsize, 1), 0))
    c = int(c) & ~127  # align the slab width to 128 columns
    if c < 128:
        return None
    freq = np.bincount(csr.indices, minlength=n_cols)
    order = np.argsort(-freq, kind="stable")
    cols = np.sort(order[:c])
    if freq[cols].sum() < min_coverage * csr.nnz:
        return None
    return cols.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SlabbedBell:
    """BoW input operand with a dense slab over the Zipf head columns.

    A TF-IDF matrix's column mass is Zipf-distributed: the most frequent few
    thousand tokens hold 30–60% of the nonzeros, and a column band that
    dense moves fewer bytes as a dense slab through one matrix product than
    as per-edge row gathers.

    Fields:
      cols:  [C] int64 — global column ids of the slab columns (top-nnz).
      slab:  [N, C] dense values of those columns, in ``slab_dtype``
             (bfloat16 by default, as in JAX; float32 for exact parity).
      rest:  the remaining entries — :class:`CachedBell` when their column
             skew justifies the hot-column split, else :class:`BucketedEll`.
      rest_t: transpose of ``rest`` when it is a BucketedEll (None for
             CachedBell, which is self-contained).

    The forward is ``slab @ W0[cols] + rest-SpMM``, its slab term summed in
    float32 whatever the slab's dtype; autograd scatters ``slabᵀ·G`` into
    the C slab rows of dW0 and runs the rest transpose.
    """

    cols: torch.Tensor
    slab: torch.Tensor
    rest: Optional[object]
    rest_t: Optional[BucketedEll]
    n_cols: int

    @property
    def c_head(self) -> int:
        """The slab's column count C."""
        return self.cols.shape[0]

    @staticmethod
    def from_scipy(
        csr: sp.csr_matrix,
        *,
        slab_cols: int = 4096,
        slab_dtype: torch.dtype = torch.bfloat16,
        byte_budget: int = 2 << 30,
        min_coverage: float = 0.15,
        hot_cache: bool = True,
    ):
        """Build the slabbed operand, or return None when the head band is
        not worth densifying (slab coverage below ``min_coverage``).

        ``byte_budget`` caps the slab's device bytes at ``slab_dtype``'s
        itemsize, so the column count shrinks to fit at large row counts.
        The slab is built in float32 and rounded to ``slab_dtype``."""
        csr = sp.csr_matrix(csr)
        n_rows, n_cols = csr.shape
        cols = zipf_head_cols(
            csr,
            slab_cols=slab_cols,
            itemsize=slab_dtype.itemsize,
            byte_budget=byte_budget,
            min_coverage=min_coverage,
        )
        if cols is None:
            return None
        c = len(cols)
        head_mask = np.zeros(n_cols, dtype=bool)
        head_mask[cols] = True
        coo = csr.tocoo()
        in_head = head_mask[coo.col]
        compact = np.zeros(n_cols, dtype=np.int64)
        compact[cols] = np.arange(c)
        slab = np.zeros((n_rows, c), dtype=np.float32)
        slab[coo.row[in_head], compact[coo.col[in_head]]] = coo.data[in_head]
        rest_csr = sp.coo_matrix(
            (coo.data[~in_head], (coo.row[~in_head], coo.col[~in_head])),
            shape=csr.shape,
        ).tocsr()
        rest = rest_t = None
        if rest_csr.nnz:
            if hot_cache:
                rest = CachedBell.from_scipy(rest_csr)
            if rest is None:
                rest = BucketedEll.from_scipy(rest_csr)
                rest_t = BucketedEll.from_scipy(rest_csr.T.tocsr())
        return SlabbedBell(
            cols=_t(cols.astype(np.int64)),
            slab=_t(slab).to(slab_dtype),
            rest=rest,
            rest_t=rest_t,
            n_cols=n_cols,
        )


@dataclasses.dataclass(frozen=True)
class AttentionEll:
    """Fixed-K edge-pattern operand of the attention layers: the edge values
    are computed each step (a softmax of learned scores), so the operand
    carries the pattern and what the backward needs.

    - ``indices``/``valid``: the forward ELL layout, [N, K] int64 column ids
      (pad 0) and a float32 {0,1} mask (the attention values are dense over
      the layout, so a zero value cannot mark padding);
    - ``indices_t``/``valid_t``: the transpose pattern's ELL layout
      [n_cols, K_t], which gathers the input cotangent Aᵀ·G;
    - ``perm_t``: [n_cols·K_t] int64, each transpose slot's flat position
      in the forward layout, so the transposed values are one gather.
    """

    indices: torch.Tensor
    valid: torch.Tensor
    indices_t: torch.Tensor
    valid_t: torch.Tensor
    perm_t: torch.Tensor
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def k(self) -> int:
        return self.indices.shape[1]

    @staticmethod
    def _pattern_ell(csr: sp.csr_matrix, *, pad_k_to: int = 8, fixed_k: int = 0):
        deg = np.diff(csr.indptr)
        n_rows = csr.shape[0]
        k = fixed_k or _round_up(max(int(deg.max()) if n_rows and csr.nnz else 0, 1), pad_k_to)
        indices = np.zeros((n_rows, k), dtype=np.int64)
        valid = np.zeros((n_rows, k), dtype=np.float32)
        rows = np.repeat(np.arange(n_rows), deg)
        slots = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], deg)
        indices[rows, slots] = csr.indices
        valid[rows, slots] = 1.0
        return indices, valid, rows, slots, k

    @staticmethod
    def from_scipy(
        mat: sp.spmatrix, *, pad_k_to: int = 8, fixed_k: int = 0, fixed_k_t: int = 0
    ) -> "AttentionEll":
        """``fixed_k``/``fixed_k_t`` force the slot counts (the distributed
        path's common shape over the ranks' blocks)."""
        csr = sp.csr_matrix(mat)
        csr.sort_indices()
        indices, valid, rows, slots, k = AttentionEll._pattern_ell(
            csr, pad_k_to=pad_k_to, fixed_k=fixed_k
        )
        # each edge's forward flat position (+1, so explicit zeros survive
        # the sparse transpose) rides through the transpose
        ell_pos = rows.astype(np.int64) * k + slots
        csr_t = sp.csr_matrix((ell_pos + 1, csr.indices, csr.indptr), shape=csr.shape).T.tocsr()
        csr_t.sort_indices()
        indices_t, valid_t, rows_t, slots_t, _ = AttentionEll._pattern_ell(
            csr_t, pad_k_to=pad_k_to, fixed_k=fixed_k_t
        )
        perm_t = np.zeros(indices_t.shape, dtype=np.int64)
        perm_t[rows_t, slots_t] = csr_t.data.astype(np.int64) - 1
        return AttentionEll(
            indices=_t(indices),
            valid=_t(valid),
            indices_t=_t(indices_t),
            valid_t=_t(valid_t),
            perm_t=_t(perm_t.reshape(-1)),
            n_cols=csr.shape[1],
        )


@dataclasses.dataclass(frozen=True)
class BucketedAttention:
    """Degree-bucketed edge-pattern operand for attention layers.

    Rows are degree-sorted and split into geometric-width buckets as in
    :class:`BucketedEll`; the edge softmax is row-local, so it runs per
    bucket and a hub row costs its true degree.

    Forward layout (rows bucketed by out-degree, descending):
      ``indices``/``valid``: per-bucket [n_b, K_b] int64 column ids and
      float32 {0,1} mask; ``row_ids``: per-bucket [n_b] global row ids;
      ``perm``/``inv_perm``: the sort permutation [Σ n_b] and its inverse
      [n_rows].
    Transpose layout (the input cotangent Aᵀ·G without a scatter-add; its
    rows are the forward COLUMNS, bucketed by in-degree):
      ``indices_t``/``valid_t``: per-bucket [n_tb, K_tb] forward-row ids;
      ``perm_t``: per-bucket [n_tb, K_tb] int64 — each transpose slot's flat
      position in the concatenated forward values (bucket offsets
      included), so the transposed values are one gather;
      ``inv_perm_c``: [n_cols] restore order for the cotangent rows.

    Under a schedule (:func:`attention_schedule`) the buckets are padded with
    all-invalid rows (row id 0) to the schedule's row counts, so ``perm``
    is longer than ``n_rows``; ``inv_perm`` never points at a padding row,
    whose softmax row is zero.
    """

    indices: tuple
    valid: tuple
    row_ids: tuple
    perm: torch.Tensor
    inv_perm: torch.Tensor
    indices_t: tuple
    valid_t: tuple
    perm_t: tuple
    inv_perm_c: torch.Tensor
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.inv_perm.shape[0]

    @staticmethod
    def _bucketize(csr: sp.csr_matrix, carry_data: bool = False, schedule=None):
        """Degree-bucketed ELL arrays of a pattern. Returns (per-bucket
        (idx, mask, rows, dat), perm, inv_perm, pos): ``pos`` maps each csr
        edge (in csr data order) to its flat slot in the concatenated
        buckets; with ``carry_data`` the csr's data (an integer payload
        shifted by +1, so explicit zeros survive a sparse transpose) lands
        in ``dat`` at each edge's slot, minus the shift. ``schedule`` (a list
        of ``(width, padded_rows)``) forces the bucket shapes."""
        n_rows = csr.shape[0]
        deg = np.diff(csr.indptr)
        order = np.argsort(-deg, kind="stable").astype(np.int64)
        deg_sorted = deg[order]
        if schedule is None:
            widths = bucket_widths(int(deg.max()) if n_rows and deg.max() else 1)
            pad_rows = [None] * len(widths)
        else:
            widths = [k for k, _ in schedule]
            pad_rows = [r for _, r in schedule]
        buckets, perm_parts = [], []
        pos = np.zeros(csr.nnz, dtype=np.int64)
        inv_perm = np.zeros(n_rows, dtype=np.int64)
        start, off, row_off = 0, 0, 0
        for b, k in enumerate(widths):
            lower = widths[b + 1] if b + 1 < len(widths) else 0
            end = start + int(np.searchsorted(-deg_sorted[start:], -lower))
            if b + 1 == len(widths):
                end = n_rows
            count = end - start
            n_slot = count if pad_rows[b] is None else pad_rows[b]
            if count > n_slot:
                raise ValueError(
                    f"schedule bucket {b} (width {k}) holds {n_slot} rows but this block has "
                    f"{count}: build the schedule over every rank's block (attention_schedule)"
                )
            if n_slot == 0:
                continue
            rows = order[start:end]
            block = csr[rows]
            bi = np.zeros((n_slot, k), dtype=np.int64)
            bm = np.zeros((n_slot, k), dtype=np.float32)
            bd = np.zeros((n_slot, k), dtype=np.int64)
            bdeg = np.diff(block.indptr)
            if block.nnz:
                rr = np.repeat(np.arange(count), bdeg)
                ss = np.arange(block.nnz) - np.repeat(block.indptr[:-1], bdeg)
                bi[rr, ss] = block.indices
                bm[rr, ss] = 1.0
                if carry_data:
                    bd[rr, ss] = block.data.astype(np.int64) - 1
                edge_ids = np.repeat(csr.indptr[rows].astype(np.int64), bdeg) + ss
                pos[edge_ids] = off + rr.astype(np.int64) * k + ss
            row_ids = np.zeros(n_slot, dtype=np.int64)
            row_ids[:count] = rows
            buckets.append((bi, bm, row_ids, bd))
            perm_parts.append(row_ids)
            inv_perm[rows] = row_off + np.arange(count)
            start = end
            off += n_slot * k
            row_off += n_slot
        if not buckets:
            n1 = max(n_rows, 1)
            buckets = [(np.zeros((n1, 1), np.int64), np.zeros((n1, 1), np.float32),
                        np.arange(n1, dtype=np.int64), np.zeros((n1, 1), np.int64))]
            perm_parts = [buckets[0][2]]
            inv_perm = np.arange(n_rows, dtype=np.int64)
        return buckets, np.concatenate(perm_parts), inv_perm, pos

    @staticmethod
    def from_scipy(mat: sp.spmatrix, *, schedule=None, schedule_t=None) -> "BucketedAttention":
        """``schedule``/``schedule_t``: optional bucket shapes for the
        forward / transpose layouts, common to every rank's block
        (:func:`attention_schedule`; see
        ``parallel.partition.build_attention_operands``)."""
        csr = sp.csr_matrix(mat)
        csr.sort_indices()
        fwd, perm, inv_perm, pos = BucketedAttention._bucketize(csr, schedule=schedule)
        # the transpose carries each edge's forward flat position (+1)
        csr_t = sp.csr_matrix(
            (pos.astype(np.float64) + 1.0, csr.indices, csr.indptr), shape=csr.shape
        ).T.tocsr()
        csr_t.sort_indices()
        tr, _, inv_perm_c, _ = BucketedAttention._bucketize(csr_t, carry_data=True,
                                                            schedule=schedule_t)
        return BucketedAttention(
            indices=tuple(_t(b[0]) for b in fwd),
            valid=tuple(_t(b[1]) for b in fwd),
            row_ids=tuple(_t(b[2]) for b in fwd),
            perm=_t(perm),
            inv_perm=_t(inv_perm),
            indices_t=tuple(_t(b[0]) for b in tr),
            valid_t=tuple(_t(b[1]) for b in tr),
            perm_t=tuple(_t(b[3]) for b in tr),
            inv_perm_c=_t(inv_perm_c),
            n_cols=csr.shape[1],
        )


def split_dense_tiles(
    csr: sp.csr_matrix, *, block: int = 128, min_tile_nnz: int = 96
) -> tuple:
    """Split a sparse matrix into (dense-tile part, residual part).

    Tiles with ≥ ``min_tile_nnz`` edges are densified for the tile kernel;
    everything else stays in gather-friendly form (the HC-SpMM-style hybrid
    split)."""
    coo = sp.coo_matrix(csr)
    cb = _round_up(max(csr.shape[1], 1), block) // block
    key = (coo.row // block).astype(np.int64) * cb + (coo.col // block)
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    dense_mask = counts[inv] >= min_tile_nnz

    def sub(mask):
        return sp.coo_matrix(
            (coo.data[mask], (coo.row[mask], coo.col[mask])), shape=coo.shape
        ).tocsr()

    return sub(dense_mask), sub(~dense_mask)


def _hybrid_parts(csr: sp.csr_matrix, block: int, min_tile_nnz: int) -> tuple:
    dense, resid = split_dense_tiles(csr, block=block, min_tile_nnz=min_tile_nnz)
    bsr = BsrFlat.from_scipy(dense, block=block) if dense.nnz else None
    r = None
    if resid.nnz:
        r = CachedBell.from_scipy(resid)
        if r is None:
            r = BucketedEll.from_scipy(resid)
    return bsr, r


@dataclasses.dataclass
class SparseGraph:
    """Host-side owner of one sparse operator, with lazily-built operand
    formats (CPU tensors) for both the forward matrix and its transpose
    (needed for the SpMM backward pass; for the symmetric normalized
    adjacency the transpose is the matrix itself)."""

    csr: sp.csr_matrix
    symmetric: bool = False
    _ell: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    _ell_t: Optional[EllMatrix] = dataclasses.field(default=None, repr=False)
    _bsr: Optional[BsrMatrix] = dataclasses.field(default=None, repr=False)
    _bsr_t: Optional[BsrMatrix] = dataclasses.field(default=None, repr=False)
    _bell: Optional[BucketedEll] = dataclasses.field(default=None, repr=False)
    _bell_t: Optional[BucketedEll] = dataclasses.field(default=None, repr=False)
    _hybrid: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _hybrid_t: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _tile_cov: Optional[float] = dataclasses.field(default=None, repr=False)

    @property
    def shape(self):
        return self.csr.shape

    @property
    def nnz(self) -> int:
        return int(self.csr.nnz)

    def tile_coverage(self, *, block: int = 256, min_tile_nnz: int = 96) -> float:
        """Fraction of edges in dense tiles (cached; drives backend='auto')."""
        if self._tile_cov is None:
            from graphconvgeo_torch.sparse.reorder import tile_coverage

            self._tile_cov = tile_coverage(
                self.csr, block=block, min_tile_nnz=min_tile_nnz
            ) if self.nnz else 0.0
        return self._tile_cov

    def ell(self) -> EllMatrix:
        if self._ell is None:
            self._ell = EllMatrix.from_scipy(self.csr)
        return self._ell

    def ell_t(self) -> EllMatrix:
        if self.symmetric:
            return self.ell()
        if self._ell_t is None:
            self._ell_t = EllMatrix.from_scipy(self.csr.T.tocsr())
        return self._ell_t

    def ell_capped(
        self, *, cap: Optional[int] = None, quantile: float = 0.999, slack: float = 2.0
    ) -> CappedEll:
        """Row-capped ELL with an overflow bucket (see :class:`CappedEll`).

        Default cap = ``slack × the `quantile` row nnz`` (min 8): typical
        rows keep their one padded layout; only genuine outliers overflow.
        Returns a plain capped view with ``ov=None`` when nothing exceeds
        the cap."""
        csr = sp.csr_matrix(self.csr)
        csr.sort_indices()
        deg = np.diff(csr.indptr)
        k_max = int(deg.max()) if len(deg) else 0
        if cap is None:
            q = float(np.quantile(deg, quantile)) if len(deg) else 0.0
            cap = max(8, int(np.ceil(slack * q)))
        if k_max <= cap:
            return CappedEll(main=self.ell(), ov=None, ov_id=None)
        # split each overflowing row at `cap`: head stays in main, tail
        # moves to its own overflow row
        pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], deg)
        head = pos < cap
        rows_all = np.repeat(np.arange(csr.shape[0]), deg)
        main = sp.coo_matrix(
            (csr.data[head], (rows_all[head], csr.indices[head])), shape=csr.shape
        ).tocsr()
        ov_rows_global = np.flatnonzero(deg > cap)
        remap = np.zeros(csr.shape[0], dtype=np.int64)
        remap[ov_rows_global] = 1 + np.arange(len(ov_rows_global))
        tail = ~head
        ov = sp.coo_matrix(
            (csr.data[tail], (remap[rows_all[tail]], csr.indices[tail])),
            shape=(len(ov_rows_global) + 1, csr.shape[1]),  # row 0 = all-zero
        ).tocsr()
        return CappedEll(
            main=EllMatrix.from_scipy(main),
            ov=EllMatrix.from_scipy(ov),
            ov_id=_t(remap.astype(np.int32)),
        )

    def bsr(self, block: int = 128) -> BsrMatrix:
        if self._bsr is None or self._bsr.block != block:
            self._bsr = BsrMatrix.from_scipy(self.csr, block=block)
        return self._bsr

    def bsr_t(self, block: int = 128) -> BsrMatrix:
        if self.symmetric:
            return self.bsr(block)
        if self._bsr_t is None or self._bsr_t.block != block:
            self._bsr_t = BsrMatrix.from_scipy(self.csr.T.tocsr(), block=block)
        return self._bsr_t

    def bell(self) -> BucketedEll:
        if self._bell is None:
            self._bell = BucketedEll.from_scipy(self.csr)
        return self._bell

    def bell_t(self) -> BucketedEll:
        if self.symmetric:
            return self.bell()
        if self._bell_t is None:
            self._bell_t = BucketedEll.from_scipy(self.csr.T.tocsr())
        return self._bell_t

    def hybrid(self, *, block: int = 256, min_tile_nnz: int = 96) -> tuple:
        """(BsrFlat dense-tile part | None, residual | None) where the
        residual is a :class:`CachedBell` when its column skew justifies the
        hot-column split, else a plain :class:`BucketedEll`."""
        if self._hybrid is None:
            self._hybrid = _hybrid_parts(self.csr, block, min_tile_nnz)
        return self._hybrid

    def hybrid_t(self, *, block: int = 256, min_tile_nnz: int = 96) -> tuple:
        if self.symmetric:
            return self.hybrid(block=block, min_tile_nnz=min_tile_nnz)
        if self._hybrid_t is None:
            self._hybrid_t = _hybrid_parts(self.csr.T.tocsr(), block, min_tile_nnz)
        return self._hybrid_t

    @staticmethod
    def normalized_adjacency(adj: sp.spmatrix) -> "SparseGraph":
        """The symmetric Â = D^-1/2 (A + I) D^-1/2 of ``adj`` as a graph."""
        return SparseGraph(csr=normalize_adjacency(adj), symmetric=True)
