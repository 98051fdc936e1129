"""Plain reference of the Highway-GCN's full-graph training steps, written
from the model's equations (SURVEY.md §3.2, ``gcnmodel.py :: GCN``) in plain
PyTorch: sparse-times-dense products and dense GEMMs, a backward written
out by hand (so that it fits at 1.4M users and width 900 after the program's
state is freed), and Adam as ``torch.optim.Adam`` defines it.

    H₀ = tanh(Xd · W₀ + b₀)                       Xd: X with the input dropout
    Hᵢ = Tᵢ ⊙ tanh(Â · (Dᵢ Wᵢ) + bᵢ) + (1 − Tᵢ) ⊙ Hᵢ₋₁,
         Tᵢ = σ(Dᵢ W_Tᵢ + b_Tᵢ),  Dᵢ = dropout(Hᵢ₋₁)
    loss = mean over the training rows of CE(dropout(H_L) W_out + b_out, y)

Â = D^-1/2 (A + I) D^-1/2 with A = binarize(offdiag(B Bᵀ) + Dir + Dirᵀ),
built here from the mention groups and direct edges (B the user × group
incidence); the reference never sees the port's operands.

The dropout masks are drawn as the configuration defines its randomness:
the sparse input's by the position-keyed Wang hash of each entry's id
``row · n_cols + col`` (low 32 bits) under an integer seed, one seed a step
from ``numpy.random.default_rng(seed).integers(0, 2**31 - 1)``; the dense
ones by ``torch.rand`` over each [N, H] activation from one generator on
the device seeded with ``seed``, three a step (the two conv inputs, then the
head's input). One thing of the program's own state is followed: the node
order (the port's community reordering, a relabeling).

The configuration's stated precisions are worked out again from its
``layout`` rules and the inputs, never read from the port (see
:func:`input_split` and :class:`FactoredAdjacency`): X's dense slab columns
(their values and W₀'s rows rounded to the slab's dtype), the hot-column
cache's columns (whose entries the dropout keys by the cache's compact
column id on the seed ``seed ^ 0x3779B97``), and, with a bf16 contraction
on a factorized Â, the factors' 128² tiles, whose values are rounded. With
``gather_bf16`` the input layer's W₀, its slab product, its cotangent and
dW₀ are rounded to bf16, as the conv layers' inputs and cotangents before
Â's gathers and the group sums y = B'ᵀh.

Imports nothing of the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
from typing import Optional

import numpy as np
import torch

M32 = 0xFFFFFFFF
HOT_SEED_XOR = 0x3779B97
BETAS = (0.9, 0.999)
EPS = 1e-8
HEAD_ROWS = 65536  # the head's row block
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def wang_hash(x: torch.Tensor) -> torch.Tensor:
    """Wang's integer hash of uint32 values held in an int64 tensor."""
    x = x & M32
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & M32
    return x ^ (x >> 15)


def hashed_keep(ids: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Keep mask of the entries with ids ``ids``: the hash of the id's low
    32 bits xor the seed's hash, as a float32 uniform in [0, 1), at least
    ``rate``."""
    s = wang_hash(torch.tensor(int(seed) & M32, dtype=torch.int64, device=ids.device))
    h = wang_hash((ids & M32) ^ s)
    return (h.to(torch.float32) / float(2**32)) >= rate


def round_to(t: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    """``t`` rounded to ``kind`` ("bf16", or "fp8": e4m3 under one scale
    that maps the largest magnitude to its largest value) and widened back."""
    if kind is None:
        return t
    if kind == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    scale = FP8_MAX / t.abs().max().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


@dataclasses.dataclass
class Problem:
    """One training problem in the program's node order."""

    x: "scipy.sparse.csr_matrix"  # [n, vocab] float32
    groups: list  # member arrays
    direct: tuple  # (src, dst)
    y: np.ndarray
    train_rows: np.ndarray
    hidden: tuple
    dropout: float
    lr: float
    seed: int
    # the configuration's stated roundings: W0 and the conv inputs before
    # the Â gathers ("gather"), the slab's X values ("slab")
    gather_bf16: bool = False
    slab_bf16: bool = False
    factorized: bool = False  # Â applied in factored form (FactoredAdjacency)
    # the configuration's "model" fields and "layout" rules, from which the
    # slab, the hot columns and the tiles are worked out
    model: dict = dataclasses.field(default_factory=dict)
    layout: dict = dataclasses.field(default_factory=dict)


def _by_frequency(counts: np.ndarray, k: int) -> np.ndarray:
    """The ``k`` most frequent column ids, ties to the lower id, sorted."""
    return np.sort(np.argsort(-counts, kind="stable")[:k])


def input_split(x, model: dict, layout: dict) -> tuple:
    """(slab_cols, hot_ids) of X's input operand by the rule the
    configuration states (None where it has none):

    - the slab, where ``input_backend`` is "slab" or "auto": width
      min(``slab_cols``, vocabulary, ``slab_byte_budget`` // (rows · the
      slab dtype's bytes)) rounded down to ``slab_align``; none under
      ``slab_align`` columns, where X has under ``slab_min_dims`` rows or
      columns, or where its columns hold under ``slab_min_coverage`` of the
      nonzeros; the most frequent columns, ties to the lower id;
    - the hot columns, where there is a slab (its rest) or
      ``input_hot_cache``: the ``hot_max`` most frequent columns of the
      entries outside the slab, ties to the lower id; none where the
      vocabulary has at most ``hot_max`` columns, there are no such entries,
      or they cover under ``hot_min_fraction`` of them."""
    n, v = x.shape
    freq = np.bincount(x.indices, minlength=v)
    nnz = int(freq.sum())
    slab = None
    if model.get("input_backend", "auto") in ("auto", "slab") and nnz and \
            min(n, v) >= layout["slab_min_dims"]:
        item = 2 if model.get("slab_dtype") == "bfloat16" else 4
        c = min(int(model["slab_cols"]), v, int(model["slab_byte_budget"]) // (n * item))
        c -= c % layout["slab_align"]
        if c >= layout["slab_align"]:
            cols = _by_frequency(freq, c)
            if freq[cols].sum() >= layout["slab_min_coverage"] * nnz:
                slab = cols
    hot = None
    if slab is not None or model.get("input_hot_cache", False):
        rest = freq.copy()
        if slab is not None:
            rest[slab] = 0
        total = int(rest.sum())
        if total and v > layout["hot_max"]:
            ids = _by_frequency(rest, layout["hot_max"])
            if rest[ids].sum() >= layout["hot_min_fraction"] * total:
                hot = ids
    return slab, hot


class Adjacency:
    """Â of a problem on a device: A as a binary CSR tensor and the
    normalization D^-1/2, applied as D^-1/2 (A (D^-1/2 h) + D^-1/2 h)."""

    def __init__(self, n: int, groups: list, direct: tuple, device):
        dev = torch.device(device)
        keys = []
        if groups:
            members = torch.as_tensor(np.concatenate(groups), dtype=torch.int64, device=dev)
            sizes = torch.as_tensor([len(g) for g in groups], dtype=torch.int64, device=dev)
            offs = torch.cumsum(sizes, 0) - sizes
            # one chunk of groups at a time keeps the pair lists small
            pair_n = sizes * sizes
            bounds = torch.cumsum(pair_n, 0)
            chunk = 1 << 27
            g0 = 0
            n_groups = sizes.shape[0]
            while g0 < n_groups:
                base = bounds[g0] - pair_n[g0]
                g1 = int(torch.searchsorted(bounds, base + chunk, right=True))
                g1 = max(g1, g0 + 1)
                gi = torch.repeat_interleave(torch.arange(g0, g1, device=dev), pair_n[g0:g1])
                local = torch.arange(gi.shape[0], device=dev) - (bounds[gi] - pair_n[gi] - base)
                a = members[offs[gi] + local // sizes[gi]]
                b = members[offs[gi] + local % sizes[gi]]
                off = a != b
                keys.append(torch.unique(a[off] * n + b[off]))
                g0 = g1
        if len(direct[0]):
            s = torch.as_tensor(direct[0], dtype=torch.int64, device=dev)
            d = torch.as_tensor(direct[1], dtype=torch.int64, device=dev)
            off = s != d
            keys += [s[off] * n + d[off], d[off] * n + s[off]]
        keys = torch.unique(torch.cat(keys)) if keys else torch.zeros(0, dtype=torch.int64,
                                                                       device=dev)
        rows, cols = keys // n, keys % n
        counts = torch.bincount(rows, minlength=n)
        crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(counts, 0)
        self.nnz = int(keys.shape[0])  # off-diagonal entries of A
        self.a = torch.sparse_csr_tensor(crow, cols, torch.ones(self.nnz, device=dev),
                                         size=(n, n))
        deg = counts.to(torch.float64) + 1.0
        self.s = deg.rsqrt().to(torch.float32)[:, None]

    def to_scipy(self):
        """Â as a scipy CSR matrix (float64), self-loops included."""
        import scipy.sparse as sp

        n = self.s.shape[0]
        a = sp.csr_matrix((np.ones(self.nnz), self.a.col_indices().cpu().numpy(),
                           self.a.crow_indices().cpu().numpy()), shape=(n, n))
        s = sp.diags(self.s[:, 0].double().cpu().numpy())
        return (s @ (a + sp.identity(n, format="csr")) @ s).tocsr()

    def apply(self, h: torch.Tensor) -> torch.Tensor:
        hs = self.s * h
        out = torch.sparse.mm(self.a, hs)
        out += hs
        out *= self.s
        return out


def _csr(rows, cols, vals, shape) -> torch.Tensor:
    """A CSR tensor from COO arrays on one device (sorted by row, then
    column)."""
    key = rows * shape[1] + cols
    order = torch.argsort(key)
    rows, cols, vals = rows[order], cols[order], vals[order]
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=shape[0]), 0)
    return torch.sparse_csr_tensor(crow, cols, vals, size=shape)


def _block_key(rows, cols, block: int) -> torch.Tensor:
    """Each entry's ``block``² block, as one integer."""
    width = int(cols.max()) // block + 1 if cols.numel() else 1
    return (rows // block) * width + cols // block


def _in_tiles(rows, cols, block: int, min_nnz: int) -> torch.Tensor:
    """Which entries lie in ``block``² blocks holding at least ``min_nnz``
    entries."""
    _, inv, counts = torch.unique(_block_key(rows, cols, block), return_inverse=True,
                                  return_counts=True)
    return counts[inv] >= min_nnz


class FactoredAdjacency:
    """Â of a problem in the factored form that a factorized operator with
    a rounded contraction computes, worked out from the mention groups:

        Â = B'·B'ᵀ + R' + diag((1 − mᵢ)/dᵢ),   B' = D^-1/2 B,
        R' = D^-1/2 (A − M) D^-1/2

    (B the user × group incidence over the groups of two or more distinct
    users, M = offdiag(B Bᵀ) the pair multiplicities, mᵢ the groups of user
    i, dᵢ = deg_A(i) + 1; values in float64, then float32). The groups are
    ordered by their members' median and the entries that fall in
    ``tile_block``² blocks of at least ``tile_min_nnz`` entries, of B' over
    [users × groups] and of R' + diag over [users × users], are the tiles:
    their values are rounded to ``kind``. An apply rounds h to ``kind``,
    sums y = B'ᵀh in float32, rounds y, and sums B'y + (R' + diag)h in
    float32."""

    def __init__(self, n: int, groups: list, direct: tuple, device, layout: dict,
                 kind: Optional[str]):
        dev = torch.device(device)
        self.kind = kind
        members = [np.unique(np.asarray(g, np.int64)) for g in groups]
        members = [m for m in members if len(m) >= 2]
        sizes_np = np.asarray([len(m) for m in members], np.int64)
        flat = np.concatenate(members) if members else np.zeros(0, np.int64)
        starts = np.concatenate([[0], np.cumsum(sizes_np)[:-1]]).astype(np.int64)
        mid = starts + sizes_np // 2
        median = np.where(sizes_np % 2 == 1, flat[np.minimum(mid, len(flat) - 1)],
                          (flat[mid - 1] + flat[np.minimum(mid, len(flat) - 1)]) / 2.0) \
            if members else np.zeros(0)
        if layout.get("hub_order", "median") != "median":
            raise ValueError(f"unknown hub order {layout['hub_order']!r}")
        rank = np.empty(len(members), np.int64)
        rank[np.argsort(median, kind="stable")] = np.arange(len(members))
        g_count = max(len(members), 1)
        b_rows = torch.as_tensor(flat, device=dev)
        b_cols = torch.as_tensor(np.repeat(rank, sizes_np), device=dev)
        # pair multiplicities M over the upper triangle, group by group
        sizes = torch.as_tensor(sizes_np, device=dev)
        offs = torch.as_tensor(starts, device=dev)
        keys, counts = [], []
        pair_n = sizes * sizes
        bounds = torch.cumsum(pair_n, 0)
        g0, chunk = 0, 1 << 27
        while g0 < len(members):
            base = bounds[g0] - pair_n[g0]
            g1 = max(int(torch.searchsorted(bounds, base + chunk, right=True)), g0 + 1)
            gi = torch.repeat_interleave(torch.arange(g0, g1, device=dev), pair_n[g0:g1])
            local = torch.arange(gi.shape[0], device=dev) - (bounds[gi] - pair_n[gi] - base)
            a = b_rows[offs[gi] + local // sizes[gi]]
            b = b_rows[offs[gi] + local % sizes[gi]]
            up = a < b
            k, c = torch.unique(a[up] * n + b[up], return_counts=True)
            keys.append(k)
            counts.append(c)
            g0 = g1
        keys = torch.cat(keys) if keys else torch.zeros(0, dtype=torch.int64, device=dev)
        counts = torch.cat(counts) if counts else torch.zeros(0, dtype=torch.int64, device=dev)
        keys, inv = torch.unique(keys, return_inverse=True)
        mult = torch.zeros(keys.shape[0], dtype=torch.int64, device=dev).index_add_(0, inv, counts)
        if len(direct[0]):
            s_ = torch.as_tensor(np.asarray(direct[0], np.int64), device=dev)
            d_ = torch.as_tensor(np.asarray(direct[1], np.int64), device=dev)
            off = s_ != d_
            lo, hi = torch.minimum(s_[off], d_[off]), torch.maximum(s_[off], d_[off])
            dkeys = torch.unique(lo * n + hi)
            keys, inv = torch.unique(torch.cat([keys, dkeys]), return_inverse=True)
            mult = torch.zeros(keys.shape[0], dtype=torch.int64, device=dev).index_add_(
                0, inv[: mult.shape[0]], mult)
        lo, hi = keys // n, keys % n
        deg = torch.bincount(lo, minlength=n) + torch.bincount(hi, minlength=n)
        d = deg.to(torch.float64) + 1.0
        s = 1.0 / torch.sqrt(d)
        r = 1.0 - mult.to(torch.float64)  # A − M over the upper triangle
        keep = r != 0
        lo, hi, r = lo[keep], hi[keep], r[keep]
        m_count = torch.bincount(b_rows, minlength=n).to(torch.float64)
        diag = ((1.0 - m_count) / d).to(torch.float32)
        di = torch.nonzero(diag).ravel()
        rd_rows = torch.cat([lo, hi, di])
        rd_cols = torch.cat([hi, lo, di])
        r32 = ((s[lo] * r) * s[hi]).to(torch.float32)
        rd_vals = torch.cat([r32, r32, diag[di]])
        b_vals = s[b_rows].to(torch.float32)
        block, min_nnz = layout["tile_block"], layout["tile_min_nnz"]
        b_tile = _in_tiles(b_rows, b_cols, block, min_nnz)
        rd_tile = _in_tiles(rd_rows, rd_cols, block, min_nnz)
        self.tiles = {"bt": _n_blocks(b_rows[b_tile], b_cols[b_tile], block),
                      "zr": _n_blocks(b_rows[b_tile], b_cols[b_tile], block)
                      + _n_blocks(rd_rows[rd_tile], rd_cols[rd_tile], block)}
        if kind is not None:
            b_vals = torch.where(b_tile, round_to(b_vals, kind), b_vals)
            rd_vals = torch.where(rd_tile, round_to(rd_vals, kind), rd_vals)
        self.b = _csr(b_rows, b_cols, b_vals, (n, g_count))
        self.bt = _csr(b_cols, b_rows, b_vals, (g_count, n))
        self.rd = _csr(rd_rows, rd_cols, rd_vals, (n, n))

    def apply(self, h: torch.Tensor) -> torch.Tensor:
        hb = round_to(h, self.kind)
        y = round_to(torch.sparse.mm(self.bt, hb), self.kind)
        out = torch.sparse.mm(self.b, y)
        out += torch.sparse.mm(self.rd, hb)
        return out


def _n_blocks(rows, cols, block: int) -> int:
    """Distinct ``block``² blocks that the entries touch."""
    return int(torch.unique(_block_key(rows, cols, block)).numel()) if rows.numel() else 0


class InputMatrix:
    """X on a device with its dropout: the values (the slab's rounded to
    ``slab_round``), which entries are the slab's, each entry's hash id and
    seed stream, and the transpose's order. ``slab_cols`` and ``hot_ids``:
    :func:`input_split`."""

    def __init__(self, p: Problem, device, slab_round: Optional[str], slab_cols, hot_ids):
        dev = torch.device(device)
        x = p.x.tocsr()
        x.sort_indices()
        n, v = x.shape
        self.shape = (n, v)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(x.indptr))
        cols = x.indices.astype(np.int64)
        vals = torch.as_tensor(x.data.astype(np.float32), device=dev)
        self.crow = torch.as_tensor(x.indptr.astype(np.int64), device=dev)
        self.col = torch.as_tensor(cols, device=dev)
        row_t = torch.as_tensor(rows, device=dev)
        ids = row_t * v + self.col
        hot = torch.zeros(len(cols), dtype=torch.bool, device=dev)
        self.in_slab = torch.zeros(v, dtype=torch.bool, device=dev)
        if slab_cols is not None:
            self.in_slab[torch.as_tensor(np.asarray(slab_cols, np.int64), device=dev)] = True
            if slab_round is not None:
                vals = torch.where(self.in_slab[self.col], round_to(vals, slab_round), vals)
        self.slab_entry = self.in_slab[self.col]
        if hot_ids is not None:
            # the cache holds X's residual columns: a slab column's entries
            # are the slab's, keyed by their global id, whatever the cache
            hot_ids = np.sort(np.asarray(hot_ids, np.int64))
            compact = torch.full((v,), -1, dtype=torch.int64, device=dev)
            compact[torch.as_tensor(hot_ids, device=dev)] = torch.arange(len(hot_ids), device=dev)
            hot = (compact[self.col] >= 0) & ~self.slab_entry
            ids = torch.where(hot, row_t * len(hot_ids) + compact[self.col], ids)
        self.vals, self.ids, self.hot = vals, ids, hot
        order = np.lexsort((rows, cols))  # the transpose: by column, then row
        self.t_order = torch.as_tensor(order, device=dev)
        self.t_crow = torch.zeros(v + 1, dtype=torch.int64, device=dev)
        self.t_crow[1:] = torch.cumsum(torch.bincount(self.col, minlength=v), 0)
        self.t_col = row_t[self.t_order]

    def dropped(self, seed: int, rate: float) -> tuple:
        """(Xd's slab entries, Xd's other entries, Xdᵀ) as CSR tensors under
        the input dropout of ``seed`` (the first two on X's pattern)."""
        keep = torch.where(self.hot, hashed_keep(self.ids, seed ^ HOT_SEED_XOR, rate),
                           hashed_keep(self.ids, seed, rate))
        vals = self.vals * keep.to(self.vals.dtype) / (1.0 - rate)
        n, v = self.shape
        zero = torch.zeros((), device=vals.device)
        slab = torch.sparse_csr_tensor(self.crow, self.col,
                                       torch.where(self.slab_entry, vals, zero), size=(n, v))
        rest = torch.sparse_csr_tensor(self.crow, self.col,
                                       torch.where(self.slab_entry, zero, vals), size=(n, v))
        xdt = torch.sparse_csr_tensor(self.t_crow, self.t_col, vals[self.t_order], size=(v, n))
        return slab, rest, xdt


class Reference:
    """The training steps of one problem on a device. ``mode``: "config"
    (the configuration's precisions: float32 GEMMs with TF32 off, and its
    stated bf16 roundings), "tf32" (the GEMMs in TF32) or "fp8" (the stated
    bf16 roundings in e4m3 instead)."""

    def __init__(self, p: Problem, device, *, mode: str = "config"):
        if mode not in ("config", "tf32", "fp8"):
            raise ValueError(f"unknown mode {mode!r}")
        self.p, self.mode, self.device = p, mode, torch.device(device)
        low = "fp8" if mode == "fp8" else "bf16"
        self.gather = low if p.gather_bf16 else None
        self.slab = low if p.slab_bf16 else None
        n = p.x.shape[0]
        if p.factorized and self.gather is not None:
            # the bf16 contraction rounds h, y and the tiles' values itself
            self.adj = FactoredAdjacency(n, p.groups, p.direct, self.device, p.layout,
                                         self.gather)
            self.adj_round = None
        else:
            self.adj = Adjacency(n, p.groups, p.direct, self.device)
            self.adj_round = self.gather
        self.slab_cols, self.hot_ids = input_split(p.x, p.model, p.layout)
        self.x = InputMatrix(p, self.device, self.slab, self.slab_cols, self.hot_ids)
        mask = torch.zeros(n, dtype=torch.float32, device=self.device)
        mask[torch.as_tensor(np.asarray(p.train_rows, np.int64), device=self.device)] = 1.0
        self.mask = mask
        self.y = torch.as_tensor(np.asarray(p.y, np.int64), device=self.device)

    def layout(self) -> dict:
        """What the reference worked out of the operands' layout, for a
        comparison with the program's: the slab's and the hot cache's
        columns, and the factored operator's tile counts."""
        tiles = getattr(self.adj, "tiles", {})
        return {"slab_cols": self.slab_cols, "hot_ids": self.hot_ids,
                "bt_tiles": tiles.get("bt"), "zr_tiles": tiles.get("zr")}

    def _dense_drop(self, h, keep):
        return torch.where(keep, h / (1.0 - self.p.dropout), torch.zeros((), device=h.device))

    def _layer(self, w: dict, i: int, h_in: torch.Tensor):
        a = h_in @ w[f"layers.{i}.w"]
        conv = self.adj.apply(round_to(a, self.adj_round))
        del a
        conv = torch.tanh(conv + w[f"layers.{i}.b"])
        t = torch.sigmoid(h_in @ w[f"layers.{i}.w_t"] + w[f"layers.{i}.b_t"])
        return conv, t

    def loss_and_grads(self, w: dict, x_seed: int, gen: torch.Generator) -> tuple:
        """One step's loss (float) and gradients (a dict like ``w``)."""
        p = self.p
        rate = p.dropout
        n_layers = len(p.hidden)
        n = p.x.shape[0]
        xd_slab, xd_rest, xdt = self.x.dropped(x_seed, rate)
        # X·W₀ in W₀'s gather dtype: the slab's product (W₀'s rows in the
        # slab's dtype) summed in float32 and cast to it, the rest's in float32
        w0 = round_to(w["input.w"], self.gather)
        h = round_to(torch.sparse.mm(xd_slab, round_to(w0, self.slab)), self.gather)
        h += torch.sparse.mm(xd_rest, w0)
        h = torch.tanh(h + w["input.b"])
        del xd_slab, xd_rest
        hs, keeps = [h], []
        for i in range(n_layers):
            keep = torch.rand(h.shape, generator=gen, device=h.device) < (1.0 - rate)
            h_in = self._dense_drop(h, keep)
            conv, t = self._layer(w, i, h_in)
            del h_in
            h = t * conv + (1.0 - t) * h
            del conv, t
            hs.append(h)
            keeps.append(keep)
        keep_o = torch.rand(h.shape, generator=gen, device=h.device) < (1.0 - rate)
        count = self.mask.sum().clamp(min=1.0)
        grads = {k: torch.zeros_like(v) for k, v in w.items()}
        g = torch.empty_like(h)
        num = torch.zeros((), dtype=torch.float64, device=h.device)
        for r0 in range(0, n, HEAD_ROWS):
            sl = slice(r0, min(r0 + HEAD_ROWS, n))
            hd = self._dense_drop(h[sl], keep_o[sl])
            logits = hd @ w["out.w"] + w["out.b"]
            m = self.mask[sl]
            lse = torch.logsumexp(logits, dim=-1)
            ce = lse - logits.gather(1, self.y[sl, None])[:, 0]
            num += (ce * m).sum(dtype=torch.float64)
            d = torch.softmax(logits, dim=-1)
            d[torch.arange(d.shape[0], device=d.device), self.y[sl]] -= 1.0
            d *= (m / count)[:, None]
            grads["out.w"] += hd.T @ d
            grads["out.b"] += d.sum(0)
            g[sl] = self._dense_drop(d @ w["out.w"].T, keep_o[sl])
            del hd, logits, d
        loss = float(num / count.double())
        del keep_o
        for i in reversed(range(n_layers)):
            h_prev, keep = hs[i], keeps[i]
            h_in = self._dense_drop(h_prev, keep)
            conv, t = self._layer(w, i, h_in)
            dt = g * (conv - h_prev)
            ds = g * t * (1.0 - conv * conv)
            del conv
            g.mul_(1.0 - t)
            dt.mul_(t * (1.0 - t))
            del t
            grads[f"layers.{i}.b"] += ds.sum(0)
            grads[f"layers.{i}.b_t"] += dt.sum(0)
            da = self.adj.apply(round_to(ds, self.adj_round))
            del ds
            grads[f"layers.{i}.w"] += h_in.T @ da
            grads[f"layers.{i}.w_t"] += h_in.T @ dt
            del h_in
            d_in = da @ w[f"layers.{i}.w"].T
            del da
            d_in += dt @ w[f"layers.{i}.w_t"].T
            del dt
            g += self._dense_drop(d_in, keep)
            del d_in
            hs[i + 1] = None
        d0 = g * (1.0 - hs[0] * hs[0])
        grads["input.b"] += d0.sum(0)
        # dW₀ in W₀'s gather dtype from the cotangent in it; the slab's rows
        # also in the slab's dtype
        dw0 = torch.sparse.mm(xdt, round_to(d0, self.gather))
        if self.slab is not None and self.slab != self.gather:
            dw0 = torch.where(self.x.in_slab[:, None], round_to(dw0, self.slab), dw0)
        grads["input.w"] += round_to(dw0, self.gather)
        return loss, grads

    def run(self, w0: dict, steps: int = 3) -> dict:
        """``steps`` Adam steps from the weights ``w0`` (not modified).
        Returns the losses, each leaf's first-gradient norm and each leaf's
        change after the steps (norms in float64)."""
        p = self.p
        seeds = np.random.default_rng(p.seed)
        gen = torch.Generator(device=self.device).manual_seed(p.seed)

        def step(w):
            return self.loss_and_grads(w, int(seeds.integers(0, 2**31 - 1)), gen)

        with tf32_matmul(self.mode == "tf32"):
            return adam_steps(w0, p.lr, steps, step)


@contextlib.contextmanager
def tf32_matmul(on: bool):
    """float32 GEMMs in TF32 (``on``) or in float32 inside the block."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def adam_steps(w0: dict, lr: float, steps: int, loss_and_grads) -> dict:
    """``steps`` steps of Adam as ``torch.optim.Adam`` defines it (betas
    0.9, 0.999, eps 1e-8, bias-corrected) from ``w0`` (not modified);
    ``loss_and_grads(w)`` gives one step's loss and gradients. Returns the
    losses, each leaf's first-gradient norm and each leaf's change after the
    steps (norms in float64), and the first gradients (on the host)."""
    w = {k: v.detach().clone().float() for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, g1, g1_tensors = [], {}, {}
    for step in range(1, steps + 1):
        loss, grads = loss_and_grads(w)
        losses.append(loss)
        if step == 1:
            g1 = {k: float(torch.linalg.vector_norm(g, dtype=torch.float64))
                  for k, g in grads.items()}
            g1_tensors = {k: g.float().cpu() for k, g in grads.items()}
        bc1, bc2 = 1.0 - BETAS[0] ** step, 1.0 - BETAS[1] ** step
        for k, g in grads.items():
            m[k].lerp_(g, 1.0 - BETAS[0])
            v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
            denom = (v2[k].sqrt() / bc2 ** 0.5).add_(EPS)
            w[k].addcdiv_(m[k], denom, value=-lr / bc1)
        del grads
    delta = {k: float(torch.linalg.vector_norm(w[k] - w0[k].float(), dtype=torch.float64))
             for k in w}
    return {"losses": losses, "g1": g1, "delta": delta, "g1_tensors": g1_tensors}


def readings(prog: dict, ref: dict) -> dict:
    """The numbers compared, from the program's and the reference's
    ``{"losses", "g1", "delta"}``:

    - ``loss_gap``: the largest relative gap of a step's loss;
    - ``grad_gap``: the worst leaf's gap between the two first-gradient
      norms, over the larger of the reference's norm of that leaf and of the
      median leaf;
    - ``delta_gap``: the same for the parameters' change over the steps,
      over the leaves whose reference gradient is at least a thousandth of
      the median leaf's (a leaf whose gradient is nought to rounding moves by
      round-off alone under Adam);
    - ``grad_diff`` (where both hold their first gradients): the worst
      leaf's norm of the difference of the two first gradients, over the
      same denominator as ``grad_gap``. A gap of norms is blind to rounding
      to first order (unbiased errors cancel in a norm); this number is not;
    - ``grad_diff_med``: the median leaf's of the same ratios. The worst
      leaf is as a rule dW₀, the end of the backward's chain of bf16
      roundings, where a float32 summation order's last bits grow into
      whole bf16 steps; the median leaf stays below that chain and tells
      TF32 GEMMs from float32 ones."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["g1"].values())
    grad_gap = max(abs(prog["g1"][k] - r) / max(r, med_g) for k, r in ref["g1"].items())
    med_d = statistics.median(ref["delta"].values())
    moving = [k for k, r in ref["g1"].items() if r >= 1e-3 * med_g]
    delta_gap = max(abs(prog["delta"][k] - ref["delta"][k]) / max(ref["delta"][k], med_d)
                    for k in moving)
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap, "delta_gap": delta_gap}
    if prog.get("g1_tensors") and ref.get("g1_tensors"):
        diffs = [float(torch.linalg.vector_norm(prog["g1_tensors"][k].double() - t.double()))
                 / max(ref["g1"][k], med_g) for k, t in ref["g1_tensors"].items()]
        out["grad_diff"] = max(diffs)
        out["grad_diff_med"] = statistics.median(diffs)
    return out
