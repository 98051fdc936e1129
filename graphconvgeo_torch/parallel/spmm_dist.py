"""Edge-partitioned SpMM across the ranks of a :class:`GraphMesh`.

Each function below is the body one rank runs on its own rows (JAX: the
``shard_map`` body), with the collectives spelled out:

- all-gather (``local_spmm_allgather``): every rank all-gathers the node
  features and runs its row block's product; the backward runs the block's
  transpose and reduce-scatters.
- halo exchange (``local_spmm_halo``): only boundary rows move, in one
  all-to-all issued before the local product (as JAX orders them); the
  block is split by source ownership (``partition.build_halo``).
- ring (``local_spmm_halo_ring``): the all-to-all unrolled into D−1
  point-to-point shifts, each followed by the product of the block whose
  rows just arrived.
- halo + kernel 1 (``local_spmm_halo_bsr``): the rank's dense local 256²
  tiles through the flat-tile BSR kernel (one :class:`BsrFlat`, forward and
  backward: the local block of a symmetric Â is symmetric), the residual and
  the remote part gathered.

The collectives are autograd Functions of this module: the tiled all-gather
(backward: reduce-scatter), the all-to-all (backward: the same all-to-all of
the cotangents), the ring shift (backward: the opposite shift) and the
all-reduce (backward: the all-reduce of the cotangents; the factorized
model's hub sums). Every rank issues the same collectives in the same
order, forward and backward.
At world size 1 they still run through the process group.

Gradient rule (see ``model_dist.py``): each rank backpropagates its own
share of the loss; the collectives' backwards carry the cotangents of rows
other ranks read; the parameter gradients are summed afterwards by one
all-reduce. So :func:`local_input_spmm`'s backward returns the rank's
partial dW₀ = X_blockᵀ·G and does not all-reduce it (JAX psums it there,
because ``shard_map`` cannot see through its custom VJP).

Sparse operands are one rank's slice of a stacked format
(:func:`device_slice`): :class:`StackedEll` or :class:`StackedBell` with the
rank axis removed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from graphconvgeo_torch.ops.spmm import _ell_matvec, _GatherCore
from graphconvgeo_torch.ops.spmm_bsr import spmm_bsr_flat
from graphconvgeo_torch.parallel.mesh import GraphMesh
from graphconvgeo_torch.parallel.partition import StackedBell, map_arrays
from graphconvgeo_torch.sparse.formats import BsrFlat


def device_slice(op, index, device=None):
    """Slice ``index`` of every array of a stacked operand (numpy or
    torch), as tensors on ``device``; integer arrays become int64 (the
    gathers' index type)."""

    def take(a):
        t = torch.as_tensor(np.ascontiguousarray(a[index]) if isinstance(a, np.ndarray) else a[index])
        if not t.is_floating_point():
            t = t.long()
        return t if device is None else t.to(device)

    return map_arrays(op, take)


def _op_matvec(op, h: torch.Tensor) -> torch.Tensor:
    """One rank's SpMM for either stacked format (rank axis removed)."""
    if isinstance(op, StackedBell):
        outs = [_ell_matvec(i, v, h) for i, v in zip(op.indices, op.values)]
        return torch.cat(outs, dim=0).index_select(0, op.inv_perm)
    return _ell_matvec(op.indices, op.values, h)


def _spmm_op_core(fwd, bwd, h: torch.Tensor) -> torch.Tensor:
    """``fwd`` · h, differentiable in h: the backward is ``bwd`` · g (the
    operand's transpose), cast to h's dtype (JAX's ``_spmm_op_core``)."""
    return _GatherCore.apply(h, _op_matvec, fwd, bwd)


# the tiled all-gather and reduce-scatter under their current names
# (``all_gather_into_tensor`` and ``reduce_scatter_tensor`` before torch 2.13)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class _AllGather(torch.autograd.Function):
    """Tiled all-gather of [rows, F] blocks along rows; the backward
    reduce-scatters the cotangent (sums each rank's share of it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.new_empty((mesh.world_size * x.shape[0], *x.shape[1:]))
        _all_gather(out, x.contiguous(), group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        out = g.new_empty((g.shape[0] // mesh.world_size, *g.shape[1:]))
        _reduce_scatter(out, g.contiguous(), op=dist.ReduceOp.SUM, group=mesh.group)
        return out, None


class _AllReduce(torch.autograd.Function):
    """Sum of x over the ranks, the same on every rank. The backward is the
    all-reduce of the cotangents, not the identity: under the per-rank-loss
    rule rank d's cotangent is ∂L_d/∂y alone, and its partial feeds every
    rank's y, so it needs Σ_e ∂L_e/∂y (JAX: ``psum`` then ``pcast`` to
    varying, whose transpose is a psum). At world size 1 the two agree."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.contiguous().clone()
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.mesh.group)
        return out, None


class _AllToAll(torch.autograd.Function):
    """All-to-all of D equal row chunks: chunk s goes to rank s, and chunk s
    of the result came from rank s. The backward sends every cotangent
    chunk back where its rows came from: the same all-to-all."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_to_all(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh), None


def _all_to_all(x: torch.Tensor, mesh: GraphMesh) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.group)
    return out


class _RingShift(torch.autograd.Function):
    """Rank r sends x to rank r+s and receives from rank r−s (mod D); the
    backward shifts the cotangent by −s."""

    @staticmethod
    def forward(ctx, x, shift, mesh):
        ctx.shift, ctx.mesh = shift, mesh
        return _shift(x, shift, mesh)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.shift, ctx.mesh), None, None


def _shift(x: torch.Tensor, shift: int, mesh: GraphMesh) -> torch.Tensor:
    d_n, r = mesh.world_size, mesh.rank
    out = torch.empty_like(x)
    ops = [
        dist.P2POp(dist.isend, x.contiguous(), mesh.global_rank((r + shift) % d_n), mesh.group),
        dist.P2POp(dist.irecv, out, mesh.global_rank((r - shift) % d_n), mesh.group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _halo_send(h_local: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
    """The rows this rank ships, [D·h_max, F]: chunk s for peer s."""
    return h_local.index_select(0, send_idx.reshape(-1))


def local_spmm_allgather(h_local, a_op, at_op, mesh: GraphMesh) -> torch.Tensor:
    """h_local [rpd, F] → the rank's rows of Â·h [rpd, F].

    a_op: the rank's rows with global column ids; at_op: the transpose of
    its block (local column ids, n_pad rows)."""
    h_full = _AllGather.apply(h_local, mesh)  # [n_pad, F]
    return _spmm_op_core(a_op, at_op, h_full)


def local_spmm_halo(h_local, al_op, alt_op, ar_op, art_op, send_idx, mesh: GraphMesh):
    """The rank's rows of Â·h with a boundary exchange: the all-to-all of
    the rows its peers read (``send_idx`` [D, h_max]) is issued first, then
    the local-column product, then the remote-column product on the
    received halo. One all-to-all of D·h_max rows replaces the n_pad-row
    all-gather. The backward is the transpose program: both transpose
    products, the all-to-all of the halo cotangent, a scatter-add onto
    h_local (the autograd of ``index_select``)."""
    recv = _AllToAll.apply(_halo_send(h_local, send_idx), mesh)  # [D·h_max, F]
    out_local = _spmm_op_core(al_op, alt_op, h_local)
    return out_local + _spmm_op_core(ar_op, art_op, recv)


def local_spmm_halo_ring(h_local, al_op, alt_op, arp_ops, artp_ops, send_idx,
                         mesh: GraphMesh):
    """The rank's rows of Â·h with a ring exchange: D−1 shifts, step s
    shipping each rank's rows for peer r+s, each followed by the partial
    product against the operand block of the peer whose rows just arrived.
    The link traffic is the all-to-all's; the schedule is D−1 small
    transfers, each with a product behind it.

    arp_ops / artp_ops: the rank's per-source-peer remote operands, one per
    peer (``HaloExchange.ring_operands``, sliced). The backward is the
    transpose program: the opposite shifts, the transpose partial products,
    a scatter-add onto h_local."""
    out = _spmm_op_core(al_op, alt_op, h_local)
    d_n, r = mesh.world_size, mesh.rank
    if d_n == 1:
        return out
    for s in range(1, d_n):
        x = h_local.index_select(0, send_idx[(r + s) % d_n])  # [h_max, F] for peer r+s
        recv = _RingShift.apply(x, s, mesh)  # from peer r−s
        src = (r - s) % d_n
        out = out + _spmm_op_core(arp_ops[src], artp_ops[src], recv)
    return out


def local_spmm_halo_bsr(h_local, al_op, alt_op, ar_op, art_op, send_idx, bsr: BsrFlat,
                        mesh: GraphMesh):
    """The halo body with kernel 1: the dense tiles of the rank's local
    square block through the flat-tile BSR product (``bsr`` serves forward
    and backward: the local block of a symmetric Â is symmetric); al_op
    carries only the residual local edges. Still one all-to-all, issued
    first."""
    recv = _AllToAll.apply(_halo_send(h_local, send_idx), mesh)
    out_local = spmm_bsr_flat(bsr, bsr, h_local)
    out_local = out_local + _spmm_op_core(al_op, alt_op, h_local)
    return out_local + _spmm_op_core(ar_op, art_op, recv)


def local_input_spmm(w0, x_op, xt_op) -> torch.Tensor:
    """The rank's sparse input layer X_block · W₀: no communication in the
    forward; the backward returns the rank's partial dW₀ = X_blockᵀ·G,
    which the one all-reduce of the parameter gradients sums."""
    return _spmm_op_core(x_op, xt_op, w0)
