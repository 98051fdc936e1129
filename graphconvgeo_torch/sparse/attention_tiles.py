"""Tiled attention pattern — the flash-style operand of the GAT layer.

On a community-reordered mention graph many edges live in dense B×B tiles.
The JAX package runs the whole attention layer there as dense tile work
with the scores recomputed on the fly (the GATv1 score is
``LeakyReLU(s_i + d_j)`` over narrow [N, H] vectors, so a tile's score block
is a broadcast add, never a per-edge array):

- forward: one sweep over each row block's tiles with an online softmax
  (running max, rescaled aggregation and denominators);
- backward: one sweep in row order (ds) and one in column order (dz, dd).

Edges outside dense tiles go to the bucketed layout (``rest``), which the
JAX package runs apart and merges with the tiles' softmax state under one
shift.

The pattern also keeps, each built once per instance on the masks' device,
compressed edge lists for the sweeps of ``ops/attention_tiled.py`` (the
CUDA kernels of ``csrc/gat_tiled.cu`` and their plain versions), which walk
edges instead of multiplying dense tiles that are 1–3% full: the tiled
edges (:attr:`TiledAttentionPattern.edges` by row,
:attr:`TiledAttentionPattern.edges_t` by column) and every edge of the
pattern, the tiled edges and the rest's together
(:attr:`TiledAttentionPattern.all_edges`,
:attr:`TiledAttentionPattern.all_edges_t`). The layer walks the latter on
every device, so one sweep covers the whole pattern; the tiles and the
rest's buckets are what the lists are built from.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from graphconvgeo_torch.sparse.formats import BucketedAttention, _round_up, _t, split_dense_tiles

# mask entries unpacked at once while the edge lists are built (16 MB of bool)
_EDGE_CHUNK = 1 << 24


def unpack_mask(bits: torch.Tensor, block: int) -> torch.Tensor:
    """[T, W, B] packed words → [T, B, B] bool: ``mask[t, i, j]`` is bit
    ``i // W`` of ``bits[t, i % W, j]``."""
    w = block // 32
    words = bits.repeat(1, block // w, 1)  # row i = bits[:, i % w]
    shifts = (torch.arange(block, device=bits.device, dtype=torch.int32) // w).view(1, block, 1)
    return ((words >> shifts) & 1).bool()


@dataclasses.dataclass(frozen=True)
class TileEdges:
    """Edges of a :class:`TiledAttentionPattern` compressed by row
    (``edges``, ``all_edges``) or by column (``edges_t``, ``all_edges_t``),
    without values: what the edge kernels of ``csrc/gat_tiled.cu`` walk.

    ptr: [n_padded + 1] int32 — row (by row) or column (by column) r owns
         entries ``ptr[r] : ptr[r + 1]``.
    idx: [nnz] int32 — the other end of each edge: its global column by
         row, its global row by column.

    Within a row (column) the entries are ascending. Filler tiles and the
    rest's padding slots give no entry.
    """

    ptr: torch.Tensor
    idx: torch.Tensor

    @property
    def nnz(self) -> int:
        return self.idx.shape[0]


def _compress(major: torch.Tensor, minor: torch.Tensor, n_padded: int, n_minor: int) -> TileEdges:
    """The :class:`TileEdges` of distinct pairs (``major``, ``minor``), int64
    on one device, ``minor`` < ``n_minor``: entries sorted by major index,
    then ascending minor index."""
    if major.numel() >= 2**31:
        raise ValueError("the pattern holds 2^31 or more edges; int32 offsets cannot index them")
    key = torch.sort(major * n_minor + minor).values
    ptr = torch.zeros(n_padded + 1, dtype=torch.int64, device=key.device)
    torch.cumsum(torch.bincount(key // n_minor, minlength=n_padded), 0, out=ptr[1:])
    return TileEdges(ptr=ptr.int(), idx=(key % n_minor).int())


def _tile_pairs(bits, rowblk, colblk, *, block: int) -> tuple:
    """(rows, cols) int64 of the set bits of packed mask tiles ``bits``
    [T, W, B], tile t at row block ``rowblk[t]`` and column block
    ``colblk[t]``, unpacking at most ``_EDGE_CHUNK`` mask entries at a
    time."""
    step = max(1, _EDGE_CHUNK // (block * block))
    rows, cols = [], []
    for t0 in range(0, bits.shape[0], step):
        t, i, j = unpack_mask(bits[t0 : t0 + step], block).nonzero().unbind(1)
        t = t + t0
        rows.append(rowblk.long()[t] * block + i)
        cols.append(colblk.long()[t] * block + j)
    return torch.cat(rows), torch.cat(cols)


@dataclasses.dataclass(frozen=True)
class TiledAttentionPattern:
    """Pattern-only block tiles plus a bucketed rest, in both sweep orders.

    mask_bits:   [T, B//32, B] int32 holding uint32 bit patterns — the packed
                 mask: ``mask[i, j]`` is bit ``i // W`` of
                 ``mask_bits[t, i % W, j]`` with ``W = B//32``.
    rowblk/colblk: [T] int32, tiles sorted by (row block, column block).
    row_ptr:     [n_row_blocks + 1] int32 — row block r owns tiles
                 ``row_ptr[r] : row_ptr[r + 1]`` (the row order's run
                 bounds, as JAX's).
    mask_bits_t/rowblk_t/colblk_t: the same tiles sorted by (column block,
                 row block), stored as copies for JAX's dz/dd sweep.
    col_ptr_t:   [n_col_blocks + 1] int32 — run bounds over ``colblk_t``.
    rest:        the residual edges in the degree-bucketed layout (None when
                 every edge is tiled).
    edges/edges_t: the tiled edges as :class:`TileEdges` by row and by
                 column (cached properties, built once per instance).
    all_edges/all_edges_t: every edge of the pattern, tiled and rest, as
                 :class:`TileEdges` by row and by column (the same).

    Every row block and every column block owns at least one tile (all-zero
    filler tiles where the pattern has none), as in the JAX operand.
    """

    mask_bits: torch.Tensor
    rowblk: torch.Tensor
    colblk: torch.Tensor
    row_ptr: torch.Tensor
    mask_bits_t: torch.Tensor
    rowblk_t: torch.Tensor
    colblk_t: torch.Tensor
    col_ptr_t: torch.Tensor
    rest: Optional[BucketedAttention]
    n_rows: int
    n_cols: int
    block: int

    @property
    def n_tiles(self) -> int:
        return self.mask_bits.shape[0]

    @property
    def n_row_blocks(self) -> int:
        return _round_up(max(self.n_rows, 1), self.block) // self.block

    @property
    def n_col_blocks(self) -> int:
        return _round_up(max(self.n_cols, 1), self.block) // self.block

    def _edge_lists(self, *, rest: bool, by_column: bool) -> TileEdges:
        """The set bits of the tiles and, with ``rest``, the rest's valid
        slots (its padding slots and all-invalid rows give none), compressed
        by row over the padded rows or by column over the padded columns,
        with torch ops on the masks' device."""
        rows, cols = _tile_pairs(self.mask_bits, self.rowblk, self.colblk, block=self.block)
        if rest and self.rest is not None:
            rows, cols = [rows], [cols]
            for idx, valid, rid in zip(self.rest.indices, self.rest.valid, self.rest.row_ids):
                keep = valid > 0
                rows.append(rid.long()[:, None].expand(idx.shape)[keep])
                cols.append(idx.long()[keep])
            rows, cols = torch.cat(rows), torch.cat(cols)
        npad, mpad = self.n_row_blocks * self.block, self.n_col_blocks * self.block
        if by_column:
            return _compress(cols, rows, mpad, npad)
        return _compress(rows, cols, npad, mpad)

    @functools.cached_property
    def edges(self) -> TileEdges:
        """The tiled edges by row over the padded rows (built once per
        instance, on the masks' device): what the kernels walk by default."""
        return self._edge_lists(rest=False, by_column=False)

    @functools.cached_property
    def edges_t(self) -> TileEdges:
        """The tiled edges by column over the padded columns."""
        return self._edge_lists(rest=False, by_column=True)

    @functools.cached_property
    def all_edges(self) -> TileEdges:
        """Every edge of the pattern, tiled and rest, by row over the padded
        rows (built once per instance, on the masks' device; :attr:`edges`
        without a rest): what the float32 layer's forward and ds kernels
        walk on the card."""
        if self.rest is None:
            return self.edges
        return self._edge_lists(rest=True, by_column=False)

    @functools.cached_property
    def all_edges_t(self) -> TileEdges:
        """Every edge of the pattern by column over the padded columns
        (:attr:`edges_t` without a rest): what the float32 layer's dz/dd
        kernel walks on the card."""
        if self.rest is None:
            return self.edges_t
        return self._edge_lists(rest=True, by_column=True)

    @functools.cached_property
    def rest_nnz(self) -> int:
        """The rest's edges (its valid slots; 0 without a rest), counted
        once per instance: what each forward and each backward run of the
        layer adds to ``profiling.counters["attn_rest_edges"]``."""
        if self.rest is None:
            return 0
        return int(sum(int(torch.count_nonzero(v)) for v in self.rest.valid))

    @staticmethod
    def from_scipy(
        mat: sp.spmatrix,
        *,
        block: int = 128,
        min_tile_nnz: int = 64,
        max_tiles: int = 65536,
        rest_schedule=None,
        rest_schedule_t=None,
    ) -> "TiledAttentionPattern":
        """Tiles of ≥ ``min_tile_nnz`` edges go to the tile sweeps; the rest
        to the bucketed layout. ``rest_schedule``/``rest_schedule_t`` force
        the rest's bucket shapes (common to every rank's block in the
        distributed GAT: ``parallel.partition.build_attention_operands``);
        the rest then exists even when this block has no rest edge (all
        rows invalid)."""
        if block % 32:
            raise ValueError("block must be a multiple of 32 (bit-packed mask)")
        csr = sp.csr_matrix(mat)
        csr.sort_indices()
        n_rows, n_cols = csr.shape
        dense, resid = split_dense_tiles(csr, block=block, min_tile_nnz=min_tile_nnz)
        rb = _round_up(max(n_rows, 1), block) // block
        cb = _round_up(max(n_cols, 1), block) // block

        coo = dense.tocoo()
        key = (coo.row // block).astype(np.int64) * cb + (coo.col // block)
        uniq = np.unique(key)
        # fillers: every row block owns a tile in the row sweep, every column
        # block one in the column sweep
        have_r = np.zeros(rb, dtype=bool)
        have_r[(uniq // cb).astype(np.int64)] = True
        have_c = np.zeros(cb, dtype=bool)
        have_c[(uniq % cb).astype(np.int64)] = True
        fill_r = np.flatnonzero(~have_r).astype(np.int64) * cb  # (r, 0)
        fill_c = np.flatnonzero(~have_c).astype(np.int64)  # (0, c)
        all_keys = np.unique(np.concatenate([uniq, fill_r, fill_c]))
        n_tiles = len(all_keys)
        if n_tiles > max_tiles:
            raise ValueError(
                f"TiledAttentionPattern would materialize {n_tiles} mask tiles"
                " — pattern too scattered; raise min_tile_nnz or use the"
                " bucketed attention operand"
            )
        # pack straight into bits, never through a dense [T, B, B] mask
        w = block // 32
        bits = np.zeros((n_tiles, w, block), dtype=np.uint32)
        t_of_edge = np.searchsorted(all_keys, key)
        r, c = coo.row % block, coo.col % block
        np.bitwise_or.at(
            bits, (t_of_edge, r % w, c), np.uint32(1) << (r // w).astype(np.uint32)
        )
        rowblk = (all_keys // cb).astype(np.int32)
        colblk = (all_keys % cb).astype(np.int32)
        perm_t = np.lexsort((rowblk, colblk))
        colblk_t = colblk[perm_t]
        return TiledAttentionPattern(
            mask_bits=_t(bits.view(np.int32)),
            rowblk=_t(rowblk),
            colblk=_t(colblk),
            row_ptr=_t(np.searchsorted(rowblk, np.arange(rb + 1)).astype(np.int32)),
            mask_bits_t=_t(bits[perm_t].view(np.int32)),
            rowblk_t=_t(rowblk[perm_t]),
            colblk_t=_t(colblk_t),
            col_ptr_t=_t(np.searchsorted(colblk_t, np.arange(cb + 1)).astype(np.int32)),
            rest=(
                BucketedAttention.from_scipy(resid, schedule=rest_schedule,
                                             schedule_t=rest_schedule_t)
                if resid.nnz or rest_schedule is not None
                else None
            ),
            n_rows=n_rows,
            n_cols=n_cols,
            block=block,
        )

    def pad_to(self, n_tiles: int) -> "TiledAttentionPattern":
        """The pattern with all-zero tiles appended up to ``n_tiles`` (JAX's
        ``pad_to``: the ranks' patterns then share one tile count). Each
        padding tile sits at the row and column block of the last real tile
        in either order, so both orders stay sorted; ``row_ptr`` and
        ``col_ptr_t`` stretch their last run over it. A zero-mask tile adds
        no entry to any edge list, so padding changes no kernel's work."""
        extra = n_tiles - self.n_tiles
        if extra <= 0:
            return self
        zero = self.mask_bits.new_zeros((extra, *self.mask_bits.shape[1:]))

        def pad(a):
            return torch.cat([a, a[-1:].expand(extra)])

        rowblk, colblk_t = pad(self.rowblk), pad(self.colblk_t)
        ar = lambda nb: torch.arange(nb + 1, dtype=rowblk.dtype, device=rowblk.device)
        return dataclasses.replace(
            self,
            mask_bits=torch.cat([self.mask_bits, zero]),
            rowblk=rowblk,
            colblk=pad(self.colblk),
            row_ptr=torch.searchsorted(rowblk, ar(self.n_row_blocks)).int(),
            mask_bits_t=torch.cat([self.mask_bits_t, zero]),
            rowblk_t=pad(self.rowblk_t),
            colblk_t=colblk_t,
            col_ptr_t=torch.searchsorted(colblk_t, ar(self.n_col_blocks)).int(),
        )

    def stats(self) -> dict:
        bits = self.mask_bits.cpu().numpy()
        tiled_edges = int(np.unpackbits(bits.view(np.uint8)).sum())
        rest_edges = 0
        if self.rest is not None:
            rest_edges = int(sum(float(v.sum()) for v in self.rest.valid))
        return {
            "n_tiles": self.n_tiles,
            "tiled_edges": tiled_edges,
            "rest_edges": rest_edges,
            "tile_fill": tiled_edges / max(self.n_tiles * self.block**2, 1),
        }
