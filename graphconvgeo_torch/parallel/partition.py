"""Edge partitioner: contiguous node-row blocks per rank, planned on the host.

Rank r owns rows ``[r·rpd, (r+1)·rpd)`` of the (padded) adjacency and
feature matrices: the edges incident to those rows as destination. Every
rank builds the same plan in numpy (array for array the JAX package's) and
moves only its own block to its device (``spmm_dist.device_slice``).

Stacked formats (leading rank axis; one shape for every rank, as the JAX
package's SPMD program needs and its parity tests compare):

- :class:`StackedEll` — plain ELL blocks padded to one common slot count.
- :class:`StackedBell` — degree-bucketed ELL: per rank, rows are sorted by
  degree and split into geometric-width buckets whose shapes (row count,
  slot count) are the same on every rank. Padded slots ≈ 1.3–2× nnz instead
  of max-degree×, and the mostly-empty transpose blocks collapse.

Feature blocks (``x_*`` / ``xt_*``) stay plain ELL: the sparse-input
dropout hashes global (row, col) entry positions on that layout.

The one per-rank shape: with ``local_backend="bsr"`` each rank's dense
256² tiles of its local square block are its own :class:`BsrFlat`
(:attr:`HaloExchange.bsr`), which carries kernel 1 through ``.packed``.
The JAX package pads every device's tiles to the largest count with
all-zero tiles (``first=0``, the last row block); :attr:`HaloExchange.bsr_tiles`
and its siblings give that stacked layout for comparison, but a rank never
runs it: the packed rows hold only nonzeros, so padding tiles would cost
nothing anyway.

The distributed GAT's attention operands (:func:`build_attention_operands`)
come as a list of per-rank operands of equal shapes (the JAX package stacks
the same arrays): bucketed patterns on a shared schedule, fixed-K patterns,
or tiled patterns padded to one tile count.

Padding rows are appended at the end of the global numbering, so real node
ids are unchanged and blocks are contiguous ranges: no column remapping.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from graphconvgeo_torch.sparse.formats import (
    AttentionEll,
    BsrFlat,
    BucketedAttention,
    _round_up,
    attention_schedule,
    bucket_widths,
    split_dense_tiles,
    zipf_head_cols,
)


def _ell_np(csr: sp.csr_matrix, k: int):
    """ELL arrays for one block with a fixed slot count k."""
    csr = csr.tocsr()
    csr.sort_indices()
    n = csr.shape[0]
    indices = np.zeros((n, k), dtype=np.int32)
    values = np.zeros((n, k), dtype=np.float32)
    deg = np.diff(csr.indptr)
    if csr.nnz:
        rows = np.repeat(np.arange(n), deg)
        slots = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], deg)
        indices[rows, slots] = csr.indices
        values[rows, slots] = csr.data
    return indices, values


def _stack_blocks(blocks, pad_k_to=8):
    """blocks: list of csr → stacked ELL arrays with a common K."""
    k = max(max((int(np.diff(b.indptr).max()) if b.nnz else 0) for b in blocks), 1)
    k = _round_up(k, pad_k_to)
    pairs = [_ell_np(b, k) for b in blocks]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@dataclasses.dataclass(frozen=True)
class StackedEll:
    """Plain ELL rank blocks: indices/values [D, rows, K] (pad = 0)."""

    indices: np.ndarray
    values: np.ndarray

    @staticmethod
    def from_blocks(blocks, pad_k_to: int = 8) -> "StackedEll":
        idx, val = _stack_blocks(blocks, pad_k_to)
        return StackedEll(indices=idx, values=val)

    @property
    def padded_slots(self) -> int:
        return int(np.prod(self.indices.shape))


@dataclasses.dataclass(frozen=True)
class StackedBell:
    """Degree-bucketed ELL rank blocks with one bucket shape for every rank.

    indices/values: tuple of [D, rows_b, K_b]; per rank, bucket b holds its
    rows_b highest-remaining-degree rows (padded with empty rows: bucket row
    counts are the max over ranks). ``inv_perm`` [D, n_rows]: original row →
    position in the concatenated per-bucket output (restores row order after
    the bucket matvecs).
    """

    indices: tuple
    values: tuple
    inv_perm: np.ndarray

    @property
    def padded_slots(self) -> int:
        return sum(int(np.prod(i.shape[1:])) for i in self.indices) * self.indices[0].shape[0]

    @staticmethod
    def from_blocks(blocks, *, row_align: int = 8) -> "StackedBell":
        blocks = [b.tocsr() for b in blocks]
        for b in blocks:
            b.sort_indices()
        n_rows = blocks[0].shape[0]
        degs = [np.diff(b.indptr) for b in blocks]
        gmax = max((int(d.max()) if d.size and d.max() else 1) for d in degs)
        widths = bucket_widths(gmax)  # one descending ladder for every rank
        n_b = len(widths)
        d_n = len(blocks)
        orders, cuts = [], []
        counts = np.zeros((d_n, n_b), np.int64)
        for di, deg in enumerate(degs):
            order = np.argsort(-deg, kind="stable")
            ds = deg[order]
            start, dev_cuts = 0, []
            for bi, k in enumerate(widths):
                lower = widths[bi + 1] if bi + 1 < n_b else 0
                end = start + int(np.searchsorted(-ds[start:], -lower))
                if bi + 1 == n_b:
                    end = n_rows  # last bucket: everything left (incl. deg 0)
                dev_cuts.append((start, end))
                counts[di, bi] = end - start
                start = end
            orders.append(order)
            cuts.append(dev_cuts)
        rows_b = [
            int(_round_up(int(counts[:, bi].max()), row_align)) if counts[:, bi].max() else 0
            for bi in range(n_b)
        ]
        keep = [bi for bi in range(n_b) if rows_b[bi] > 0]
        if not keep:  # all blocks empty
            keep, rows_b = [n_b - 1], [0] * (n_b - 1) + [row_align]
        idx_arrays = [np.zeros((d_n, rows_b[bi], widths[bi]), np.int32) for bi in keep]
        val_arrays = [np.zeros((d_n, rows_b[bi], widths[bi]), np.float32) for bi in keep]
        inv_perm = np.zeros((d_n, n_rows), dtype=np.int32)
        for di, b in enumerate(blocks):
            off = 0
            for j, bi in enumerate(keep):
                start, end = cuts[di][bi]
                rows = orders[di][start:end]
                if len(rows):
                    blk = b[rows]
                    bdeg = np.diff(blk.indptr)
                    if blk.nnz:
                        rr = np.repeat(np.arange(end - start), bdeg)
                        ss = np.arange(blk.nnz) - np.repeat(blk.indptr[:-1], bdeg)
                        idx_arrays[j][di, rr, ss] = blk.indices
                        val_arrays[j][di, rr, ss] = blk.data
                    inv_perm[di, rows] = off + np.arange(len(rows), dtype=np.int32)
                off += rows_b[bi]
        return StackedBell(
            indices=tuple(idx_arrays), values=tuple(val_arrays), inv_perm=inv_perm
        )


def stack_operand(blocks, fmt: str = "bell", **kw):
    """Stacked operand for a list of per-rank csr blocks."""
    if fmt == "bell":
        return StackedBell.from_blocks(blocks, **kw)
    if fmt == "ell":
        return StackedEll.from_blocks(blocks, **kw)
    raise ValueError(f"unknown dist format {fmt!r}")


@dataclasses.dataclass
class RowPartition:
    n_devices: int
    n_nodes: int  # logical
    n_pad: int  # padded global rows = n_devices * rows_per_device
    rows_per_device: int
    n_features: int
    a_blocks: list  # per-rank csr [rpd, n_pad] (host planning + lazy operands)
    x_idx: np.ndarray
    x_val: np.ndarray
    xt_idx: np.ndarray
    xt_val: np.ndarray
    y: np.ndarray  # [n_pad] labels (pad = 0)
    mask: np.ndarray  # [n_pad] train mask (pad = 0)
    # Optional Zipf-head input slab: the dense [D, rpd, C] row blocks of the
    # head columns (float32 on the host); the x_* ELL blocks then hold only
    # the rest entries. None when slab_cols=0 or zipf_head_cols rejects X.
    slab: Optional[np.ndarray] = None
    slab_col_ids: Optional[np.ndarray] = None  # [C] int32 global column ids
    _a_ops: dict = dataclasses.field(default_factory=dict, repr=False)

    def a_operands(self, fmt: str = "bell") -> tuple:
        """(a, at) stacked operands for the all-gather path, built on first
        use: the transpose blocks are [n_pad, rpd] per rank (bucketed, the
        mostly-empty rows collapse)."""
        if fmt not in self._a_ops:
            a = stack_operand(self.a_blocks, fmt)
            at = stack_operand([b.T.tocsr() for b in self.a_blocks], fmt)
            self._a_ops[fmt] = (a, at)
        return self._a_ops[fmt]

    @property
    def boundary_stats(self) -> dict:
        """Fraction of referenced columns that are remote per rank: what
        drives the halo exchange's volume."""
        out = []
        for d, blk in enumerate(self.a_blocks):
            lo, hi = d * self.rows_per_device, (d + 1) * self.rows_per_device
            cols = blk.indices
            if cols.size == 0:
                out.append(0.0)
                continue
            out.append(float(np.mean((cols < lo) | (cols >= hi))))
        return {"remote_col_fraction": out}


def partition_rows(
    adj: sp.csr_matrix,
    x: sp.csr_matrix,
    y: np.ndarray,
    train_mask: np.ndarray,
    n_devices: int,
    *,
    row_align: int = 8,
    slab_cols: int = 0,
    slab_byte_budget: int = 2 << 30,
) -> RowPartition:
    """``slab_cols > 0`` splits the Zipf-head columns of X into a dense
    per-rank slab (the distributed form of SlabbedBell: the byte budget
    applies per rank, at 2 bytes an entry as in the JAX package); the ELL x
    blocks then carry only the rest entries."""
    n = adj.shape[0]
    v = x.shape[1]
    rpd = _round_up(-(-n // n_devices), row_align)
    n_pad = rpd * n_devices

    slab_ids = None
    if slab_cols:
        slab_ids = zipf_head_cols(
            sp.csr_matrix(x),
            slab_cols=slab_cols,
            itemsize=2,
            byte_budget=slab_byte_budget,
            budget_rows=rpd,
        )

    def pad_rows(m: sp.csr_matrix, rows: int) -> sp.csr_matrix:
        if m.shape[0] == rows:
            return m.tocsr()
        return sp.vstack([m, sp.csr_matrix((rows - m.shape[0], m.shape[1]), dtype=m.dtype)]).tocsr()

    # the adjacency also needs padded columns, so h_full's row count matches
    adj_p = pad_rows(adj, n_pad)
    adj_p = sp.csr_matrix((adj_p.data, adj_p.indices, adj_p.indptr), shape=(n_pad, n_pad))
    x_p = pad_rows(x, n_pad)

    a_blocks = [adj_p[d * rpd : (d + 1) * rpd].tocsr() for d in range(n_devices)]

    slab = None
    if slab_ids is not None:
        c = len(slab_ids)
        head_mask = np.zeros(v, dtype=bool)
        head_mask[slab_ids] = True
        coo = x_p.tocoo()
        in_head = head_mask[coo.col]
        compact = np.zeros(v, dtype=np.int64)
        compact[slab_ids] = np.arange(c)
        slab = np.zeros((n_devices, rpd, c), dtype=np.float32)
        slab[
            coo.row[in_head] // rpd, coo.row[in_head] % rpd, compact[coo.col[in_head]]
        ] = coo.data[in_head]
        x_p = sp.coo_matrix(
            (coo.data[~in_head], (coo.row[~in_head], coo.col[~in_head])), shape=x_p.shape
        ).tocsr()

    x_blocks = [x_p[d * rpd : (d + 1) * rpd] for d in range(n_devices)]
    xt_blocks = [b.T.tocsr() for b in x_blocks]  # [v, rpd] each

    x_idx, x_val = _stack_blocks(x_blocks)
    xt_idx, xt_val = _stack_blocks(xt_blocks)

    y_p = np.zeros(n_pad, dtype=np.int32)
    y_p[:n] = y
    m_p = np.zeros(n_pad, dtype=np.float32)
    m_p[:n] = train_mask
    return RowPartition(
        n_devices=n_devices,
        n_nodes=n,
        n_pad=n_pad,
        rows_per_device=rpd,
        n_features=v,
        a_blocks=a_blocks,
        x_idx=x_idx,
        x_val=x_val,
        xt_idx=xt_idx,
        xt_val=xt_val,
        y=y_p,
        mask=m_p,
        slab=slab,
        slab_col_ids=slab_ids,
    )


@dataclasses.dataclass
class HaloExchange:
    """Boundary-exchange plan: instead of all-gathering every node feature,
    each rank sends only the rows its peers reference (the halo), in one
    all-to-all.

    The local block is split by column ownership:

    - ``local_blocks``  — edges whose source is local: csr [rpd, rpd].
    - ``remote_blocks`` — edges whose source is remote: csr [rpd, D·h_max] in
      halo space, where slot s·h_max + j holds rank s's row
      ``send_idx[s, d, j]``.

    Stacked operands (forward + transpose of each part) come from
    :meth:`operands` in either format. With ``local_backend="bsr"``,
    ``bsr`` holds each rank's dense local tiles as its own :class:`BsrFlat`
    and ``local_blocks`` only the residual.
    """

    h_max: int
    send_idx: np.ndarray  # [D(src), D(dst), h_max] local row ids (pad 0)
    local_blocks: list  # csr [rpd, rpd] (the residual when bsr is set)
    remote_blocks: list  # csr [rpd, n_halo]
    rpd: int
    bsr: Optional[list] = None  # per-rank BsrFlat [rpd, rpd] of the dense local tiles
    block: int = 0
    _ops: dict = dataclasses.field(default_factory=dict, repr=False)

    def operands(self, fmt: str = "bell", keys=("al", "alt", "ar", "art")) -> dict:
        """Stacked operands, built lazily per key (the ring never needs the
        monolithic remote pair 'ar'/'art': see :meth:`ring_operands`)."""
        blocks = {
            "al": lambda: self.local_blocks,
            "alt": lambda: [b.T.tocsr() for b in self.local_blocks],
            "ar": lambda: self.remote_blocks,
            "art": lambda: [b.T.tocsr() for b in self.remote_blocks],
        }
        built = self._ops.setdefault(fmt, {})
        for k in keys:
            if k not in built:
                built[k] = stack_operand(blocks[k](), fmt)
        return {k: built[k] for k in keys}

    def ring_operands(self, fmt: str = "bell") -> dict:
        """{'arp', 'artp'}: per-source-peer remote operands for the ring halo
        (leaves [D, D_src, …]). Rank d's remote block is split by which
        peer owns the columns, so each ring step multiplies only the block
        of the peer whose rows just arrived. Column segment s of the
        all-to-all layout ([s·h_max, (s+1)·h_max)) is peer s's rows, so the
        split is a column slice."""
        key = ("ring", fmt)
        if key not in self._ops:
            d_n = self.send_idx.shape[0]
            per, per_t = [], []
            for d in range(d_n):
                rb = self.remote_blocks[d].tocsc()
                for s in range(d_n):
                    blk = rb[:, s * self.h_max : (s + 1) * self.h_max].tocsr()
                    per.append(blk)
                    per_t.append(blk.T.tocsr())

            def stack2(blocks):
                op = stack_operand(blocks, fmt)
                return map_arrays(op, lambda a: a.reshape(d_n, d_n, *a.shape[1:]))

            self._ops[key] = {"arp": stack2(per), "artp": stack2(per_t)}
        return self._ops[key]

    @property
    def halo_fraction(self) -> float:
        """Halo rows exchanged / rows an all-gather would move."""
        d = self.send_idx.shape[0]
        return (d * self.h_max) / max(d * self.rpd, 1)

    def _stacked_bsr(self, field: str, pad) -> Optional[np.ndarray]:
        """The JAX package's stacked tile layout: every rank's ``field``
        padded to the largest tile count with ``pad``."""
        if self.bsr is None:
            return None
        arrays = [getattr(b, field).numpy() for b in self.bsr]
        t_max = max(a.shape[0] for a in arrays)
        out = np.full((len(arrays), t_max, *arrays[0].shape[1:]), pad, arrays[0].dtype)
        for d, a in enumerate(arrays):
            out[d, : a.shape[0]] = a
        return out

    @property
    def bsr_tiles(self) -> Optional[np.ndarray]:
        """[D, Tmax, B, B]; padding tiles all zero."""
        return self._stacked_bsr("tiles", 0.0)

    @property
    def bsr_rowblk(self) -> Optional[np.ndarray]:
        """[D, Tmax]; padding tiles at the last row block."""
        return None if self.bsr is None else self._stacked_bsr("rowblk", self.rpd // self.block - 1)

    @property
    def bsr_colblk(self) -> Optional[np.ndarray]:
        return self._stacked_bsr("colblk", 0)

    @property
    def bsr_first(self) -> Optional[np.ndarray]:
        """[D, Tmax]: 1 where a tile opens its row block (the JAX kernel's
        accumulator reset; the port's BsrFlat keeps ``row_ptr`` instead),
        0 on padding tiles."""
        rowblk = self._stacked_bsr("rowblk", -1)
        if rowblk is None:
            return None
        first = np.zeros(rowblk.shape, np.int32)
        first[:, 0] = 1
        first[:, 1:] = rowblk[:, 1:] != rowblk[:, :-1]
        first[rowblk < 0] = 0
        return first


def build_halo(
    part: RowPartition,
    *,
    pad_align: int = 8,
    local_backend: str = "bell",
    bsr_block: int = 256,
    min_tile_nnz: int = 96,
) -> HaloExchange:
    """local_backend='bsr' also densifies each rank's local square block
    into tiles for kernel 1 (needs rows_per_device % bsr_block == 0: pass
    row_align=bsr_block to partition_rows); 'bell' keeps everything sparse."""
    d_n, rpd = part.n_devices, part.rows_per_device

    # which remote rows does each rank need from each peer?
    need = [[None] * d_n for _ in range(d_n)]  # need[dst][src]
    block_coo = [b.tocoo() for b in part.a_blocks]
    for d in range(d_n):
        cols = block_coo[d].col
        owner = cols // rpd
        for s in range(d_n):
            if s == d:
                need[d][s] = np.empty(0, np.int64)
                continue
            need[d][s] = np.unique(cols[owner == s]) - s * rpd
    h_max = max((len(need[d][s]) for d in range(d_n) for s in range(d_n)), default=0)
    h_max = max(_round_up(max(h_max, 1), pad_align), pad_align)

    send_idx = np.zeros((d_n, d_n, h_max), dtype=np.int32)
    local_blocks, remote_blocks = [], []
    n_halo = d_n * h_max
    for d in range(d_n):
        for s in range(d_n):
            rows = need[d][s]
            send_idx[s, d, : len(rows)] = rows
        lo = d * rpd
        coo = block_coo[d]
        rows_flat, cols, vals = coo.row, coo.col, coo.data
        owner = cols // rpd
        lm = owner == d
        local_blocks.append(
            sp.coo_matrix((vals[lm], (rows_flat[lm], cols[lm] - lo)), shape=(rpd, rpd)).tocsr()
        )
        # remote part: remap col -> s*h_max + pos_in_need
        rm = ~lm
        rcols = np.zeros(int(rm.sum()), dtype=np.int64)
        if rm.any():
            c = cols[rm]
            s_of = owner[rm]
            for s in range(d_n):
                m = s_of == s
                if not m.any():
                    continue
                rcols[m] = s * h_max + np.searchsorted(need[d][s], c[m] - s * rpd)
        remote_blocks.append(
            sp.coo_matrix((vals[rm], (rows_flat[rm], rcols)), shape=(rpd, n_halo)).tocsr()
        )

    bsr = None
    block = 0
    if local_backend == "bsr" and rpd % bsr_block == 0:
        # split each local square block into dense tiles + a sparse residual;
        # the local block of a symmetric Â is symmetric, so one BsrFlat
        # serves forward and backward
        dense_parts, resid_parts = [], []
        for b in local_blocks:
            dense, resid = split_dense_tiles(b, block=bsr_block, min_tile_nnz=min_tile_nnz)
            dense_parts.append(dense)
            resid_parts.append(resid)
        if any(d.nnz for d in dense_parts):
            block = bsr_block
            bsr = [BsrFlat.from_scipy(d, block=bsr_block) for d in dense_parts]
            local_blocks = resid_parts  # the local operands hold only the residual

    return HaloExchange(
        h_max=h_max,
        send_idx=send_idx,
        local_blocks=local_blocks,
        remote_blocks=remote_blocks,
        rpd=rpd,
        bsr=bsr,
        block=block,
    )


def build_attention_operands(hx: HaloExchange, fmt: str = "bell", *, block: int = 128,
                             min_tile_nnz: int = 64) -> list:
    """The distributed GAT's attention operands, one per rank (JAX
    ``partition.py :: build_attention_operands``), in the EXTENDED column
    space of ``hstack([local_block, remote_block])``: columns [0, rpd) are
    the rank's own rows, [rpd, rpd + D·h_max) the halo slots of the GCN
    path's all-to-all. Every rank's operand has the same shapes: JAX stacks
    them into one SPMD program, and rank r's operand here is block r of
    that stack.

    fmt="bell": :class:`BucketedAttention` under a shared
    :func:`attention_schedule` (a hub row costs its true degree);
    fmt="ell": :class:`AttentionEll` at the ranks' common slot counts (the
    correctness anchor); fmt="tiled": :class:`TiledAttentionPattern`, its
    rest on a schedule shared by every rank's residual and its tiles padded
    to the largest count with all-zero tiles (``pad_to``), which add no edge
    to the kernels' lists."""
    ext_blocks = [sp.hstack([l, r]).tocsr() for l, r in zip(hx.local_blocks, hx.remote_blocks)]
    n_ext = ext_blocks[0].shape[1]
    in_degrees = lambda blocks: [np.bincount(b.indices, minlength=n_ext) for b in blocks]
    if fmt == "bell":
        sched = attention_schedule([np.diff(b.indptr) for b in ext_blocks])
        sched_t = attention_schedule(in_degrees(ext_blocks))
        return [BucketedAttention.from_scipy(b, schedule=sched, schedule_t=sched_t)
                for b in ext_blocks]
    if fmt == "ell":
        k = _round_up(max(max(int(np.diff(b.indptr).max()) if b.nnz else 0
                              for b in ext_blocks), 1), 8)
        k_t = _round_up(max(max(int(d.max()) if d.any() else 0
                                for d in in_degrees(ext_blocks)), 1), 8)
        return [AttentionEll.from_scipy(b, fixed_k=k, fixed_k_t=k_t) for b in ext_blocks]
    if fmt == "tiled":
        from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern

        # the rests' shapes are common to every rank: schedule over every
        # rank's residual (the split from_scipy makes)
        resids = [split_dense_tiles(b, block=block, min_tile_nnz=min_tile_nnz)[1]
                  for b in ext_blocks]
        sched = attention_schedule([np.diff(r.indptr) for r in resids])
        sched_t = attention_schedule(in_degrees(resids))
        ops = [TiledAttentionPattern.from_scipy(b, block=block, min_tile_nnz=min_tile_nnz,
                                                rest_schedule=sched, rest_schedule_t=sched_t)
               for b in ext_blocks]
        t_max = max(o.n_tiles for o in ops)
        return [o.pad_to(t_max) for o in ops]
    raise ValueError(f"unknown attention operand format {fmt!r}")


def map_arrays(op, fn):
    """``op`` (a stacked operand) with ``fn`` applied to every array: its
    array fields and the arrays inside its tuple fields."""
    changes = {}
    for f in dataclasses.fields(op):
        val = getattr(op, f.name)
        changes[f.name] = tuple(fn(a) for a in val) if isinstance(val, tuple) else fn(val)
    return dataclasses.replace(op, **changes)


def partition_dataset(ds, n_devices: int, **kw) -> RowPartition:
    """:func:`partition_rows` of a preprocessed Dataset with its train rows
    as the mask."""
    mask = np.zeros(ds.n_nodes, dtype=np.float32)
    mask[ds.train_idx] = 1.0
    return partition_rows(ds.adj, ds.x, ds.y, mask, n_devices, **kw)
