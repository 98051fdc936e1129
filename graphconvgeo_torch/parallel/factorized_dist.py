"""Edge-partitioned training over the FACTORIZED projection adjacency.

Port of ``graphconvgeo_tpu/parallel/factorized_dist.py``. The materialized
distributed path (``model_dist.py``) halo-exchanges every boundary
neighbour's features, because Â's edges are the projected cliques. Factored
(``sparse/factorized.py``: Â = B'·B'ᵀ + R' + diag), the clique mass needs no
per-edge exchange::

    y = B'ᵀ h = Σ_d (B'_d)ᵀ h_d     per-rank partial hub sums, from local rows
    y = all_reduce(partials)       one [G, F] all-reduce
    z = B'_d y                     local again (y is the same on every rank)

so the only per-edge exchange left is the halo of the small correction R',
which the parent's machinery (``build_halo`` over R') carries unchanged.
The all-reduce is an autograd Function whose backward all-reduces the
cotangents (``spmm_dist._AllReduce``): rank d's partial feeds every rank's
y, so under the per-rank-loss rule it needs every rank's ∂L/∂y.

For a very large G (every rank holding [G, F] stops fitting),
``hub_sharded=True`` shards the hub axis: rank e owns hub block e of
G/D rows; the partial sums ride a ring reduce-scatter (D−1 shifts of a
[G/D, F] accumulator, each hop adding the receiving rank's partial for
that block) and a second ring circulates the reduced blocks, each consumed
against the rank's matching column block of B'. Peak hub memory is
[G/D, F]; the link traffic is the all-reduce's. The shifts are
``spmm_dist._RingShift`` (backward: the opposite shift).

The local products are the ``bell`` / ``ell`` gathers (``dist_format``), as
in the JAX package: the factorized model launches no CUDA kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from graphconvgeo_torch.models.gcn import GCNConfig
from graphconvgeo_torch.parallel.mesh import GraphMesh
from graphconvgeo_torch.parallel.model_dist import DistHighwayGCN
from graphconvgeo_torch.parallel.partition import (
    RowPartition,
    map_arrays,
    partition_rows,
    stack_operand,
)
from graphconvgeo_torch.parallel.spmm_dist import (
    _AllReduce,
    _RingShift,
    _spmm_op_core,
    device_slice,
)
from graphconvgeo_torch.sparse.factorized import host_factors
from graphconvgeo_torch.sparse.formats import _round_up


@dataclasses.dataclass
class FactorizedPartition:
    """Host plan: R' row-partitioned like an adjacency, plus each rank's
    incidence block and the elementwise diagonal."""

    part: RowPartition  # the row partition of R' (+ features, labels, masks)
    b_blocks: list  # per-rank csr [rpd, G] (B' row slices)
    bt_blocks: list  # per-rank csr [G, rpd] (their transposes)
    diag: np.ndarray  # [n_pad] (1 − mᵢ)/dᵢ, padding rows 0
    n_groups: int


def partition_factorized(ds, n_devices: int, *, row_align: int = 8,
                         **part_kw) -> FactorizedPartition:
    """The distributed factorized plan of a preprocessed Dataset (it needs
    the mention structure, ``Dataset.groups_offsets`` and the rest), with
    its train rows as the mask."""
    if ds.groups_offsets is None or len(ds.groups_offsets) == 0:
        raise ValueError("dataset lacks the mention structure; re-preprocess")
    off, mem = ds.groups_offsets, ds.groups_members
    groups = {g: mem[off[g] : off[g + 1]] for g in range(len(off) - 1)}
    mask = np.zeros(ds.n_nodes, dtype=np.float32)
    mask[ds.train_idx] = 1.0
    return partition_factorized_raw(groups, ds.x, ds.y, mask, n_devices,
                                    direct=(ds.direct_src, ds.direct_dst),
                                    row_align=row_align, **part_kw)


def partition_factorized_raw(
    groups: dict,
    x: sp.csr_matrix,
    y: np.ndarray,
    train_mask: np.ndarray,
    n_devices: int,
    *,
    direct: tuple | None = None,
    row_align: int = 8,
    **part_kw,
) -> FactorizedPartition:
    n = x.shape[0]
    b_scaled, r_csr, diag, g_count = host_factors(groups, n, direct=direct)
    part = partition_rows(r_csr, x, y, train_mask, n_devices, row_align=row_align, **part_kw)
    rpd, n_pad = part.rows_per_device, part.n_pad
    if b_scaled.shape[0] != n_pad:
        b_scaled = sp.vstack(
            [b_scaled, sp.csr_matrix((n_pad - n, b_scaled.shape[1]), dtype=b_scaled.dtype)]
        ).tocsr()
    b_blocks = [b_scaled[d * rpd : (d + 1) * rpd].tocsr() for d in range(n_devices)]
    diag_pad = np.zeros(n_pad, dtype=np.float32)
    diag_pad[:n] = diag
    return FactorizedPartition(
        part=part,
        b_blocks=b_blocks,
        bt_blocks=[b.T.tocsr() for b in b_blocks],
        diag=diag_pad,
        n_groups=max(g_count, 1),
    )


def hub_sharded_operands(fpart: FactorizedPartition, dist_format: str = "bell"):
    """The hub-sharded incidence: every rank's B' rows split by hub block
    (operand (d, e) is B'_d[:, block_e]), stacked flat so all D² blocks share
    bucket shapes, then viewed [D_rank, D_block, …]. Returns (b_pe, bt_pe,
    groups_per_device)."""
    d_n = fpart.part.n_devices
    gpd = _round_up(-(-max(fpart.n_groups, 1) // d_n), 8)
    g_pad = gpd * d_n
    blocks = []
    for blk in fpart.b_blocks:
        if blk.shape[1] != g_pad:
            blk = sp.hstack(
                [blk, sp.csr_matrix((blk.shape[0], g_pad - blk.shape[1]), dtype=blk.dtype)]
            ).tocsr()
        blocks.append(blk)
    flat = [blocks[d][:, e * gpd : (e + 1) * gpd].tocsr() for d in range(d_n) for e in range(d_n)]
    per_rank = lambda op: map_arrays(op, lambda a: a.reshape(d_n, d_n, *a.shape[1:]))
    b_pe = per_rank(stack_operand(flat, dist_format))
    bt_pe = per_rank(stack_operand([m.T.tocsr() for m in flat], dist_format))
    return b_pe, bt_pe, gpd


class DistFactorizedGCN(DistHighwayGCN):
    """The distributed Highway-GCN whose convolution applies the factored Â.

    The parent is built over R' (its halo or all-gather carries the
    correction term); this class adds the incidence factor, with its one
    [G, F] all-reduce (or, hub-sharded, its two rings), and the diagonal.
    """

    def __init__(
        self,
        cfg: GCNConfig,
        fpart: FactorizedPartition,
        mesh: GraphMesh,
        *,
        halo: str = "auto",
        dist_format: str = "bell",
        halo_mode: str = "alltoall",
        hub_sharded: bool = False,
        seed: int = 0,
    ):
        super().__init__(cfg, fpart.part, mesh, halo=halo, local_backend="bell",
                         dist_format=dist_format, halo_mode=halo_mode, seed=seed)
        self.n_groups = fpart.n_groups
        self.hub_sharded = hub_sharded
        r, dev = mesh.rank, mesh.device
        if hub_sharded:
            b_pe, bt_pe, self.groups_per_device = hub_sharded_operands(fpart, dist_format)
            for key, op in (("b_pe", b_pe), ("bt_pe", bt_pe)):
                mine = device_slice(op, r, dev)  # [D_block, …]: one operand per hub block
                self.data[key] = [device_slice(mine, e) for e in range(mesh.world_size)]
        else:
            self.data["b"] = device_slice(stack_operand(fpart.b_blocks, dist_format), r, dev)
            self.data["bt"] = device_slice(stack_operand(fpart.bt_blocks, dist_format), r, dev)
        rpd = fpart.part.rows_per_device
        self.data["diag"] = torch.as_tensor(fpart.diag[r * rpd : (r + 1) * rpd], device=dev)

    def _conv(self, hw: torch.Tensor) -> torch.Tensor:
        # the correction R'·hw through the parent's halo / all-gather path
        out = super()._conv(hw)
        d = self.data
        if self.hub_sharded:
            z = self._hub_sharded_term(hw)
        else:
            # the rank's partial hub sums, one all-reduce, the local expansion
            y = _AllReduce.apply(_spmm_op_core(d["bt"], d["b"], hw), self.mesh)  # [G, F]
            z = _spmm_op_core(d["b"], d["bt"], y)
        return out + z + d["diag"][:, None] * hw

    def _hub_sharded_term(self, hw: torch.Tensor) -> torch.Tensor:
        """B'(B'ᵀ·hw) with the hub axis sharded: the ring reduce-scatter of
        the hub partials (the accumulator of block r+1+s visits rank r at
        step s, so after D−1 hops rank r holds its own block's sum), then
        the ring that circulates the reduced blocks, each arrival multiplied
        against the rank's matching column block of B'."""
        b_pe, bt_pe = self.data["b_pe"], self.data["bt_pe"]
        d_n, r = self.mesh.world_size, self.mesh.rank
        if d_n == 1:
            y = _spmm_op_core(bt_pe[0], b_pe[0], hw)
            return _spmm_op_core(b_pe[0], bt_pe[0], y)
        e0 = (r + 1) % d_n
        acc = _spmm_op_core(bt_pe[e0], b_pe[e0], hw)
        for s in range(1, d_n):
            acc = _RingShift.apply(acc, -1, self.mesh)  # from rank r+1
            e = (r + 1 + s) % d_n
            acc = acc + _spmm_op_core(bt_pe[e], b_pe[e], hw)
        z = _spmm_op_core(b_pe[r], bt_pe[r], acc)  # acc: block r, fully reduced
        buf = acc
        for s in range(1, d_n):
            buf = _RingShift.apply(buf, 1, self.mesh)  # from rank r−1: block r−s
            e = (r - s) % d_n
            z = z + _spmm_op_core(b_pe[e], bt_pe[e], buf)
        return z
