"""Distributed graph-attention model: edge-partitioned GAT training across ranks.

Port of ``graphconvgeo_tpu/parallel/gat_dist.py``. The partition and the
halo of :class:`~graphconvgeo_torch.parallel.model_dist.DistHighwayGCN`
(rank r owns rows ``[r·rpd, (r+1)·rpd)``; one all-to-all a layer ships the
rows its peers read), with attention as the propagation:

- the edge softmax runs over each destination row's neighbours, and every
  edge of a destination lives on its owner rank, so the softmax needs no
  communication;
- a layer computes Z = H·W, ships ``Z[send_idx]`` through the all-to-all and
  concatenates the local and the received rows into ``Z_ext``; the
  neighbour scores ``d_j = (Z_ext a_dst)_j`` are computed from the received
  rows, so Z is the only tensor exchanged, as on the GCN's halo path;
- the pattern lives in the extended column space (local rows, then the halo
  slots), built once by ``partition.build_attention_operands`` in one of
  three formats: ``bell`` (degree-bucketed), ``ell`` (fixed-K) or
  ``tiled`` (mask tiles and a bucketed rest, whose edges kernels 3–5 of
  ``csrc/gat_tiled.cu`` walk together). The tiled pattern is rectangular,
  rpd rows × (rpd + D·h_max) columns, and its padding rows have no edge:
  their outputs are 0 and their gradients finite (the layer divides by a
  guarded denominator).

The input layer, the loss, the streamed head, ``predict_classes`` and the
train step are the parent's (the same gradient rule: each rank
backpropagates its share, the all-to-all's backward carries the halo
cotangents home, one all-reduce sums the gradients).

**Attention dropout.** Each rank keys its masks with the layer's integer
seed (``models.gat.attn_layer_seed``, the single-device GAT's) mixed with
its rank, so the ranks draw different masks; rank 0's seed is the
single-device model's. On the tiled operand the mask hashes the entry's
position in the rank's extended pattern (``n_rows × n_cols`` of that
pattern), on the others it comes from a ``torch.Generator``. Either way the
masks depend on the world size, where JAX folds the rank into a
``jax.random`` key; parity with JAX is held at attention dropout 0.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from graphconvgeo_torch.models.gat import (
    _ACTIVATIONS,
    GATConfig,
    attn_layer_seed,
    init_gat_params,
)
from graphconvgeo_torch.models.gcn import matmul, torch_dtype
from graphconvgeo_torch.ops.attention import gat_attention
from graphconvgeo_torch.ops.dropout import dropout
from graphconvgeo_torch.parallel.mesh import GraphMesh
from graphconvgeo_torch.parallel.model_dist import DistHighwayGCN
from graphconvgeo_torch.parallel.partition import (
    RowPartition,
    build_attention_operands,
    build_halo,
)
from graphconvgeo_torch.parallel.spmm_dist import _AllToAll, _halo_send
from graphconvgeo_torch.sparse.formats import to_device

ATT_FORMATS = ("bell", "ell", "tiled")
# mixes the rank into the attention-dropout seed (an odd 31-bit constant)
_RANK_SEED_MIX = 0x632BE5AB


class DistGAT(DistHighwayGCN):
    """The GAT's parameters and layers (``models/gat.py``) on the
    distributed GCN's partition, halo and training plumbing."""

    def __init__(
        self,
        cfg: GATConfig,
        part: RowPartition,
        mesh: GraphMesh,
        att_format: str = "bell",
        *,
        min_tile_nnz: int = 64,
        seed: int = 0,
    ):
        """att_format: 'bell' (degree-bucketed gathers, any graph) | 'ell'
        (fixed-K, the correctness anchor) | 'tiled' (kernels 3–5 on the
        rank's mask tiles of ≥ ``min_tile_nnz`` edges, a shared-schedule
        bucketed rest beside them). ``seed`` draws the initial parameters
        (the same on every rank)."""
        nn.Module.__init__(self)
        if att_format not in ATT_FORMATS:
            raise ValueError(f"unknown att_format {att_format!r}")
        data = self._rank_rows(cfg, part, mesh)
        self.att_format = att_format
        # the whole pattern in the local blocks (no dense-tile split: the
        # attention reads every edge)
        self.halo = build_halo(part, local_backend="bell")
        ops = build_attention_operands(self.halo, att_format, min_tile_nnz=min_tile_nnz)
        data["att"] = to_device(ops[mesh.rank], mesh.device)
        data["send_idx"] = torch.as_tensor(self.halo.send_idx[mesh.rank], dtype=torch.int64,
                                           device=mesh.device)
        self.data = data
        # what the run record reads: one all-to-all, the pattern's format
        self.halo_mode, self.dist_format, self.local_backend = "alltoall", att_format, "bell"
        init_gat_params(self, cfg, torch.Generator().manual_seed(seed))
        self.to(device=mesh.device, dtype=torch_dtype(cfg.dtype))

    def attn_seed(self, x_seed: int, layer: int) -> int:
        """The rank's attention-dropout seed of hidden layer ``layer``."""
        return (attn_layer_seed(x_seed, layer) + _RANK_SEED_MIX * self.mesh.rank) & 0x7FFFFFFF

    def _attn_conv(self, h_in: torch.Tensor, layer, *, attn_dropout: float, seed: int):
        """The rank's rows of one attention layer (pre-bias): Z = h_in·W,
        the halo rows of Z by all-to-all, attention over [Z; halo]."""
        d = self.data
        dt = torch.promote_types(h_in.dtype, layer.w.dtype)
        hw = h_in.to(dt) @ layer.w.to(dt)  # [rpd, heads·f]
        recv = _AllToAll.apply(_halo_send(hw, d["send_idx"]), self.mesh)  # [D·h_max, heads·f]
        hw_ext = torch.cat([hw, recv])
        return gat_attention(
            d["att"], hw_ext, layer.a_src.to(dt), layer.a_dst.to(dt),
            negative_slope=self.cfg.negative_slope, attn_dropout=attn_dropout, seed=seed,
        )

    def _forward(self, *, train: bool, x_seed: int, generator, with_logits: bool) -> torch.Tensor:
        """The rank's logits [rpd, C], or (``with_logits=False``) its final
        hidden state after the output dropout. ``cfg.remat`` recomputes each
        attention layer in the backward (its all-to-all included), as the
        single-device GAT does."""
        cfg = self.cfg
        act = _ACTIVATIONS[cfg.activation]
        drop = train and cfg.dropout > 0.0
        if drop and generator is None:
            raise ValueError("generator required when train=True and dropout > 0")
        attn_rate = cfg.attn_dropout if train else 0.0

        def attn_layer(layer, a_seed, h, h_in):
            out = act(self._attn_conv(h_in, layer, attn_dropout=attn_rate, seed=a_seed) + layer.b)
            if cfg.residual and out.shape == h.shape:
                out = out + h
            return out

        with record_function("input_layer"):
            h = self._input_layer(drop=drop, x_seed=x_seed)
            h = act(h.to(torch_dtype(cfg.dtype)) + self.input.b)
        for i, layer in enumerate(self.layers):
            with record_function(f"attn_{i}"):
                h_in = dropout(h, rate=cfg.dropout, generator=generator) if drop else h
                a_seed = self.attn_seed(x_seed, i)
                if cfg.remat:
                    h = checkpoint(functools.partial(attn_layer, layer, a_seed), h, h_in,
                                   use_reentrant=False)
                else:
                    h = attn_layer(layer, a_seed, h, h_in)
        with record_function("output_layer"):
            if drop:
                h = dropout(h, rate=cfg.dropout, generator=generator)
            if not with_logits:
                return h
            return matmul(h, self.out.w) + self.out.b
