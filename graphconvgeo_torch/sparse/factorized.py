"""Factorized projection adjacency: the GCN propagation without materializing
the cliques.

Port of ``graphconvgeo_tpu/sparse/factorized.py``. The reference builds its
graph by projection (``data.py :: efficient_collaboration_weighted_
projected_graph2``): every pair of users sharing a mentioned account (a
"hub") is connected, so the adjacency is a union of cliques plus the direct
mentions. For the user × hub incidence ``B`` the projection is
``A = binarize(offdiag(B·Bᵀ) + Dir)``, and the normalized operator factors
exactly, with no approximation:

    Â = D^-1/2 (A + I) D^-1/2                      (reference normalization)
      = B'·B'ᵀ + R' + diag((1 − mᵢ)/dᵢ)

with  B' = D^-1/2 B            (scaled incidence)
      mᵢ = Σ_g B[i,g]          (groups containing i — removes B·Bᵀ's diagonal)
      C  = (offdiag(B·Bᵀ) + Dir) − A ≥ 0           (multiplicity overcounts)
      R' = D^-1/2 (Dir − C) D^-1/2                 (small symmetric residual)

so an apply costs about nnz(B) gathers instead of nnz(A). After community
reordering the hub audiences are near block-diagonal: each factor is split
into dense 128² tiles (``min_tile_nnz`` 48), which run on the packed-row
CUDA kernel (kernel 1, :func:`~graphconvgeo_torch.ops.spmm_bsr.spmm_bsr_flat`),
and a row-trimmed bucketed rest (:class:`TrimmedBell`) that runs in plain
PyTorch gathers and one ``index_add_`` into its rows.

The default (merged) layout runs kernel 1 twice per apply: once on B'ᵀ's
tiles (``y = B'ᵀ·h``), once on the merged operand ``[R' + diag | 0 | B']``
over the stacked source ``z = [h; zeros(z_pad); y]``; one combined rest
adds the entries of both that did not tile.

``gather_dtype=torch.bfloat16`` casts h (and y, into z) before the gathers;
``mxu_dtype=torch.bfloat16`` rounds the tiles' values and the gathered rows
to bf16 before the float32 sums (the JAX package's 1-pass MXU contraction).
:func:`~graphconvgeo_torch.ops.spmm.spmm_operands` pairs the two. In the
merged layout the diag cells ride the tiles, so under bf16 they are rounded
too, while the separate layout keeps ``diag⊙h`` in float32.

:func:`spmm_factorized` is one autograd Function over the whole apply: Â is
symmetric, so its backward is the same apply on the cotangent. The merged
operand on its own is not symmetric ([N × (N + z_pad + G)]), so no factor
is ever differentiated on its own.

Non-finite inputs: on the card the tiles run on the packed-row kernel, which
multiplies nonzeros only; where h holds Inf or NaN it gives the sparse
answer, where the JAX Pallas kernels and the dense plain twin (the CPU
path) spread 0·Inf = NaN over the tile's row block. Training inputs are
finite.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from graphconvgeo_torch.sparse.formats import BsrFlat, BucketedEll, _round_up, _t, split_dense_tiles
from graphconvgeo_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class TrimmedBell:
    """A sparse operand restricted to its nonzero rows.

    ``bell`` is the [kr, n_cols] pattern over only the rows that have
    entries; ``rows`` maps its output rows back to the full row space
    (sorted, unique: one ``index_add_`` scatters them). Columns stay
    global."""

    rows: torch.Tensor  # [kr] int64 global output row ids (sorted, unique)
    bell: BucketedEll  # [kr, n_cols]

    @staticmethod
    def from_scipy(csr: sp.spmatrix) -> "TrimmedBell | None":
        csr = sp.csr_matrix(csr)
        csr.eliminate_zeros()
        if csr.nnz == 0:
            return None
        rows = np.flatnonzero(np.diff(csr.indptr)).astype(np.int64)
        return TrimmedBell(rows=_t(rows), bell=BucketedEll.from_scipy(csr[rows].tocsr()))


def _bell_raw(bell: BucketedEll, h: torch.Tensor, gather_dtype) -> torch.Tensor:
    """The bucketed product with the gather-dtype cast (not differentiated
    on its own: the operator is, as a whole)."""
    from graphconvgeo_torch.ops.spmm import _bell_matvec

    if gather_dtype is not None and gather_dtype != h.dtype:
        return _bell_matvec(bell, h.to(gather_dtype)).to(h.dtype)
    return _bell_matvec(bell, h)


def _apply_factor(
    tiles: Optional[BsrFlat],
    rest: Optional[TrimmedBell],
    h: torch.Tensor,
    *,
    n_out: int,
    gather_dtype=None,
    rest_src: Optional[torch.Tensor] = None,
    mxu_dtype=None,
) -> torch.Tensor:
    """(tiles + rest)·h for one factor. ``rest_src`` hands the rest a copy
    of ``h`` already cast to the gather dtype, so one cast serves every
    bucketed product of an apply."""
    from graphconvgeo_torch.ops.spmm_bsr import spmm_bsr_flat

    out = None
    if tiles is not None:
        out = spmm_bsr_flat(tiles, tiles, h, mxu_dtype=mxu_dtype or torch.float32)[:n_out]
    if rest is not None:
        kr = rest.rows.shape[0]
        sub = _bell_raw(rest.bell, h if rest_src is None else rest_src, gather_dtype)[:kr]
        if out is None:
            out = h.new_zeros((n_out, h.shape[1]))
        out.index_add_(0, rest.rows, sub.to(out.dtype))
    if out is None:
        out = h.new_zeros((n_out, h.shape[1]))
    return out


@dataclasses.dataclass(frozen=True)
class FactorizedAdjacency:
    """Operand for Â over a projection-built graph, in factored form. Each
    factor is dense 128² tiles (a :class:`BsrFlat`, run by kernel 1) plus a
    row-trimmed bucketed rest; either may be absent (None)."""

    bt_tiles: Optional[BsrFlat]  # tiles of B'ᵀ [G, N]
    bt_rest: Optional[TrimmedBell]
    b_tiles: Optional[BsrFlat]  # tiles of B'  [N, G] (separate layout)
    b_rest: Optional[TrimmedBell]
    r_tiles: Optional[BsrFlat]  # tiles of R'  [N, N] (separate layout)
    r_rest: Optional[TrimmedBell]
    # the merged tile operand [R' + diag | 0 | B'] over z = [h; pad; y]: one
    # kernel launch and one output for both factors (b_tiles, r_tiles None)
    zr_tiles: Optional[BsrFlat]
    # the combined rest of B' and R' over the same z: one bucketed product
    # and one scatter (b_rest, r_rest None)
    br_rest: Optional[TrimmedBell]
    diag: torch.Tensor  # [N] float32, (1 − mᵢ)/dᵢ
    n_rows: int
    n_groups: int
    # zero rows between h and y in z, so B''s column blocks in the merged
    # operand start on a block boundary; 0 in the separate-rest layout
    z_pad: int
    # the diag term rides the merged operand's diagonal cells (in tiles where
    # the diagonal block is dense enough, in br_rest otherwise): no diag⊙h pass
    diag_in_tiles: bool

    @staticmethod
    def from_groups(
        groups: dict,
        n: int,
        *,
        direct: tuple | None = None,
        block: int = 128,
        min_tile_nnz: int = 48,
        combined_rest: bool = True,
        merged_tiles: bool | None = None,
        hub_order: str = "median",
    ) -> "FactorizedAdjacency":
        """Build from the mention structure (``data/graph.py ::
        mention_structure``'s ``groups``, hub → member ids, and optional
        (src, dst) direct-mention edge arrays); equal to
        ``normalize_adjacency(materialize_projection(...))`` up to float32
        rounding.

        ``combined_rest`` merges the B' and R' rests into one over z
        (``False`` keeps them separate); ``merged_tiles`` (default: as
        ``combined_rest``; ``True`` without ``combined_rest`` raises) also
        merges their tiles; ``hub_order`` picks the hub axis's order (see
        :func:`host_factors`). Tiles are ``block``² with at least
        ``min_tile_nnz`` entries, as in the JAX package. The build is the
        span ``operands.adjacency``."""
        with span("operands.adjacency"):
            b_scaled, r_csr, diag, g_count = host_factors(
                groups, n, direct=direct, hub_order=hub_order
            )

            def hybrid_split(csr):
                dense, resid = split_dense_tiles(csr, block=block, min_tile_nnz=min_tile_nnz)
                tiles = BsrFlat.from_scipy(dense, block=block) if dense.nnz else None
                return tiles, resid

            bt_tiles, bt_resid = hybrid_split(b_scaled.T.tocsr())

            b_tiles = r_tiles = zr_tiles = None
            b_rest = r_rest = br_rest = None
            z_pad = 0
            if merged_tiles is None:
                merged_tiles = combined_rest
            elif merged_tiles and not combined_rest:
                raise ValueError("merged_tiles=True requires combined_rest=True")
            if combined_rest:
                # z's columns: R' entries keep their column (h's rows), B'
                # entries shift past the block-aligned n_pad
                z_pad = _round_up(n, block) - n
                spacer = sp.csr_matrix((n, z_pad), dtype=np.float32)
                if merged_tiles:
                    # diag folded in as diagonal cells; explicit zeros kept out
                    # so the split counts true entries
                    dmat = sp.diags(diag.astype(np.float32), format="csr")
                    dmat.eliminate_zeros()
                    zmat = sp.hstack([r_csr + dmat, spacer, b_scaled], format="csr")
                    zr_tiles, z_resid = hybrid_split(zmat)
                    br_rest = TrimmedBell.from_scipy(z_resid)
                else:
                    b_tiles, b_resid = hybrid_split(b_scaled)
                    r_tiles, r_resid = hybrid_split(r_csr)
                    combined = sp.hstack([r_resid.tocsr(), spacer, b_resid.tocsr()], format="csr")
                    br_rest = TrimmedBell.from_scipy(combined)
            else:
                b_tiles, b_resid = hybrid_split(b_scaled)
                r_tiles, r_resid = hybrid_split(r_csr)
                b_rest = TrimmedBell.from_scipy(b_resid)
                r_rest = TrimmedBell.from_scipy(r_resid)

            return FactorizedAdjacency(
                bt_tiles=bt_tiles,
                bt_rest=TrimmedBell.from_scipy(bt_resid),
                b_tiles=b_tiles,
                b_rest=b_rest,
                r_tiles=r_tiles,
                r_rest=r_rest,
                zr_tiles=zr_tiles,
                br_rest=br_rest,
                diag=_t(diag),
                n_rows=n,
                n_groups=max(g_count, 1),
                z_pad=z_pad,
                # folded when the merged operand exists to carry it; with an
                # empty merged operand every diag entry was zero
                diag_in_tiles=bool(
                    combined_rest and merged_tiles and (zr_tiles is not None or br_rest is not None)
                ),
            )

    @property
    def nnz_factored(self) -> int:
        """Padded bucket slots + dense-tile cells (the JAX package's count
        of its device work)."""
        total = 0
        for rest in (self.bt_rest, self.b_rest, self.r_rest, self.br_rest):
            if rest is not None:
                total += rest.bell.padded_slots
        for tiles in (self.bt_tiles, self.b_tiles, self.r_tiles, self.zr_tiles):
            if tiles is not None:
                total += tiles.n_tiles * tiles.block**2
        return total

    def stats(self) -> dict:
        """Each tile operand's tile count and nonzeros, and each rest's rows
        (0 where the operand is absent)."""
        out = {}
        for name in ("bt", "b", "r", "zr"):
            tiles = getattr(self, f"{name}_tiles")
            out[f"{name}_tiles"] = 0 if tiles is None else tiles.n_tiles
            out[f"{name}_tile_nnz"] = 0 if tiles is None else int((tiles.tiles != 0).sum())
        for name in ("bt", "b", "r", "br"):
            rest = getattr(self, f"{name}_rest")
            out[f"{name}_rest_rows"] = 0 if rest is None else int(rest.rows.shape[0])
        return out


def host_factors(
    groups: dict, n: int, *, direct: tuple | None = None, hub_order: str = "median"
):
    """The exact host-side factors of Â over a mention structure.

    Returns ``(b_scaled, r_csr, diag, g_count)``: the scaled incidence
    B' = D^-1/2·B as [n, g_count] csr, the symmetric correction
    R' = D^-1/2(Dir − C)D^-1/2, the elementwise term (1 − mᵢ)/dᵢ, and the
    surviving group count (groups of fewer than 2 members create no edge
    and are dropped).

    ``hub_order`` — the hub axis's order (a relabeling, exact either way):
    - ``"median"``: by the audience's median position, which aligns the hub
      axis with a community-contiguous user order.
    - ``"core"``: by the first user whose primary hub (largest audience,
      ties to the smaller hub id) it is; hubs that are nobody's primary fall
      back to the audience median.
    """
    member_lists = [np.unique(np.asarray(list(m), dtype=np.int64)) for m in groups.values()]
    member_lists = [m for m in member_lists if len(m) >= 2]
    g_count = len(member_lists)

    if g_count:
        med = np.asarray([float(np.median(m)) for m in member_lists])
        if hub_order == "core":
            aud = np.asarray([len(m) for m in member_lists], dtype=np.int64)
            users = np.concatenate(member_lists)
            hubs = np.repeat(np.arange(g_count, dtype=np.int64), [len(m) for m in member_lists])
            order = np.lexsort((hubs, -aud[hubs], users))
            u_sorted = users[order]
            first = np.ones(len(u_sorted), dtype=bool)
            first[1:] = u_sorted[1:] != u_sorted[:-1]
            core_user, core_hub = u_sorted[first], hubs[order][first]
            key = med.copy()
            has_core = np.zeros(g_count, dtype=bool)
            core_min = np.full(g_count, np.iinfo(np.int64).max, dtype=np.int64)
            np.minimum.at(core_min, core_hub, core_user)
            has_core[core_hub] = True
            key[has_core] = core_min[has_core].astype(np.float64)
            order_idx = np.argsort(key, kind="stable")
        else:
            order_idx = np.argsort(med, kind="stable")
        member_lists = [member_lists[g] for g in order_idx]
        b_rows = np.concatenate(member_lists)
        b_cols = np.repeat(np.arange(g_count, dtype=np.int64), [len(m) for m in member_lists])
    else:
        b_rows = np.zeros(0, dtype=np.int64)
        b_cols = np.zeros(0, dtype=np.int64)
    m_count = np.bincount(b_rows, minlength=n).astype(np.int64)

    # pair multiplicities: one entry per unordered pair per group
    p_src, p_dst = _group_pairs(member_lists, n)
    if direct is not None and len(direct[0]):
        d_src = np.asarray(direct[0], dtype=np.int64)
        d_dst = np.asarray(direct[1], dtype=np.int64)
        keep = d_src != d_dst
        d_src, d_dst = d_src[keep], d_dst[keep]
        # dedup + canonical orientation; Dir is binary
        lo, hi = np.minimum(d_src, d_dst), np.maximum(d_src, d_dst)
        pairs = np.unique(lo.astype(np.int64) * n + hi)
        dir_lo, dir_hi = pairs // n, pairs % n
    else:
        dir_lo = dir_hi = np.zeros(0, dtype=np.int64)

    e_src = np.concatenate([p_src, dir_lo])
    e_dst = np.concatenate([p_dst, dir_hi])
    # E = M_off + Dir with counts (upper triangle); A = binarize(E)
    e_upper = sp.coo_matrix(
        (np.ones(len(e_src), np.float64), (np.minimum(e_src, e_dst), np.maximum(e_src, e_dst))),
        shape=(n, n),
    ).tocsr()
    e_upper.sum_duplicates()
    a_upper = e_upper.copy()
    a_upper.data[:] = 1.0
    deg = np.asarray(a_upper.sum(axis=0)).ravel() + np.asarray(a_upper.sum(axis=1)).ravel()
    d = deg + 1.0  # rowsum of A + I
    s = 1.0 / np.sqrt(d)

    # R = Dir − C = Dir − (E − A): upper-triangle values, then mirrored
    r_upper = a_upper - e_upper  # = −C  (≤ 0 entries)
    if len(dir_lo):
        r_upper = r_upper + sp.coo_matrix(
            (np.ones(len(dir_lo), np.float64), (dir_lo, dir_hi)), shape=(n, n)
        ).tocsr()
    r_upper.eliminate_zeros()
    r_sym = r_upper + r_upper.T
    r_sym = sp.diags(s) @ r_sym @ sp.diags(s)  # R' = S R S
    r_csr = sp.csr_matrix(r_sym, dtype=np.float32)
    r_csr.sort_indices()

    b_scaled = sp.coo_matrix(
        (s[b_rows].astype(np.float32), (b_rows, b_cols)), shape=(n, max(g_count, 1))
    ).tocsr()
    b_scaled.sort_indices()

    diag = ((1.0 - m_count) / d).astype(np.float32)
    return b_scaled, r_csr, diag, g_count


def _group_pairs(member_lists: list, n: int):
    """All unordered pairs per group, duplicates across groups preserved
    (they ARE the multiplicities). Native clique expansion when available."""
    if not member_lists:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    try:
        from graphconvgeo_torch.native import project_cliques

        return project_cliques(dict(enumerate(member_lists)), n)
    except Exception:
        srcs, dsts = [], []
        for m in member_lists:
            iu = np.triu_indices(len(m), 1)
            srcs.append(m[iu[0]])
            dsts.append(m[iu[1]])
        return np.concatenate(srcs), np.concatenate(dsts)


def materialize_projection(
    groups: dict, n: int, *, direct: tuple | None = None
) -> sp.csr_matrix:
    """The unfactored adjacency A (binary, symmetric, no self-loops) — the
    exact matrix ``data/graph.py :: build_mention_adjacency`` produces from
    the same structure."""
    member_lists = [np.unique(np.asarray(list(m), dtype=np.int64)) for m in groups.values()]
    member_lists = [m for m in member_lists if len(m) >= 2]
    src, dst = _group_pairs(member_lists, n)
    if direct is not None and len(direct[0]):
        src = np.concatenate([src, np.asarray(direct[0], dtype=np.int64)])
        dst = np.concatenate([dst, np.asarray(direct[1], dtype=np.int64)])
    a = sp.coo_matrix((np.ones(len(src), np.float32), (src, dst)), shape=(n, n)).tocsr()
    a = a + a.T
    a.data[:] = 1.0
    a.setdiag(0)
    a.eliminate_zeros()
    a.sort_indices()
    return a.astype(np.float32)


def _raw_apply(fa: FactorizedAdjacency, h: torch.Tensor, gather_dtype, mxu_dtype=None) -> torch.Tensor:
    """Â·h in factored form, B'(B'ᵀh) + R'h + diag⊙h (not differentiated on
    its own)."""
    from graphconvgeo_torch.ops.spmm_bsr import F_ALIGN, spmm_bsr_flat

    if fa.br_rest is not None or fa.zr_tiles is not None:
        # combined layout: one cast of h shared by every bucketed product,
        # one stacked source z = [h; zeros(z_pad); y], one rest scatter and
        # (merged tiles) one tile launch over z
        gd = gather_dtype
        h_cast = h.to(gd) if gd is not None and h.dtype != gd else h
        y = _apply_factor(
            fa.bt_tiles, fa.bt_rest, h, n_out=fa.n_groups,
            gather_dtype=gd, rest_src=h_cast, mxu_dtype=mxu_dtype,
        )
        # z's dtype: the gather dtype when set, else the wider of h and y
        # (y's float32 partials are not rounded to a narrower h)
        z_dtype = h_cast.dtype if gd is not None else torch.promote_types(h.dtype, y.dtype)
        feat = h.shape[1]
        parts = [h_cast[: fa.n_rows].to(z_dtype)]
        if fa.z_pad:
            parts.append(h.new_zeros((fa.z_pad, feat), dtype=z_dtype))
        parts.append(y.to(z_dtype))
        if fa.zr_tiles is not None:
            # pad z to the merged operand's column grid in this one cat, so
            # spmm_bsr_flat takes it without another copy
            tail = fa.zr_tiles.n_cols_padded - (fa.n_rows + fa.z_pad + y.shape[0])
            if tail > 0 and feat % F_ALIGN == 0:
                parts.append(h.new_zeros((tail, feat), dtype=z_dtype))
        z = torch.cat(parts, dim=0)
        if fa.zr_tiles is not None:
            # z reaches the kernel in its own dtype; the output stays float32
            out = spmm_bsr_flat(
                fa.zr_tiles, fa.zr_tiles, z,
                mxu_dtype=mxu_dtype or torch.float32, h_dtype=z.dtype,
            )[: fa.n_rows]
        else:
            out = _apply_factor(fa.b_tiles, None, y, n_out=fa.n_rows, mxu_dtype=mxu_dtype)
            if fa.r_tiles is not None:
                out = out + _apply_factor(fa.r_tiles, None, h, n_out=fa.n_rows, mxu_dtype=mxu_dtype)
        if fa.br_rest is not None:
            kr = fa.br_rest.rows.shape[0]
            sub = _bell_raw(fa.br_rest.bell, z, gd)[:kr]
            out.index_add_(0, fa.br_rest.rows, sub.to(out.dtype))
        if fa.diag_in_tiles:
            return out
        return out + fa.diag[:, None] * h[: fa.n_rows]
    y = _apply_factor(
        fa.bt_tiles, fa.bt_rest, h, n_out=fa.n_groups, gather_dtype=gather_dtype,
        mxu_dtype=mxu_dtype,
    )
    out = _apply_factor(
        fa.b_tiles, fa.b_rest, y, n_out=fa.n_rows, gather_dtype=gather_dtype,
        mxu_dtype=mxu_dtype,
    )
    if fa.r_tiles is not None or fa.r_rest is not None:
        out = out + _apply_factor(
            fa.r_tiles, fa.r_rest, h, n_out=fa.n_rows, gather_dtype=gather_dtype,
            mxu_dtype=mxu_dtype,
        )
    return out + fa.diag[:, None] * h[: fa.n_rows]


class _FactorizedCore(torch.autograd.Function):
    """out = Â·h; dh = Â·g. Â is symmetric, so the backward is the same
    factored apply on the cotangent (cast to h's dtype, and dh back to it,
    as the JAX package's ``_factorized_bwd``). Rows of dh past ``n_rows``
    (padding rows of h) are zero."""

    @staticmethod
    def forward(ctx, h, fa, gather_dtype, mxu_dtype):
        ctx.fa, ctx.gather_dtype, ctx.mxu_dtype = fa, gather_dtype, mxu_dtype
        ctx.h_dtype, ctx.n_in = h.dtype, h.shape[0]
        return _raw_apply(fa, h, gather_dtype, mxu_dtype)

    @staticmethod
    def backward(ctx, g):
        dh = _raw_apply(ctx.fa, g.to(ctx.h_dtype), ctx.gather_dtype, ctx.mxu_dtype).to(ctx.h_dtype)
        if ctx.n_in != dh.shape[0]:
            dh = torch.cat([dh, dh.new_zeros((ctx.n_in - dh.shape[0], dh.shape[1]))])
        return dh, None, None, None


def spmm_factorized(
    fa: FactorizedAdjacency, h: torch.Tensor, *, gather_dtype=None, mxu_dtype=None
) -> torch.Tensor:
    """Â·h in factored form, differentiable in ``h``. ``gather_dtype``
    (e.g. ``torch.bfloat16``) casts h before the gathers; ``mxu_dtype`` is
    the tiles' contraction (float32 when None, or bfloat16). Pair them, or
    leave both None for float32."""
    return _FactorizedCore.apply(h, fa, gather_dtype, mxu_dtype)
