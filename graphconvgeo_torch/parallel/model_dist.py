"""Distributed Highway-GCN: edge-partitioned full-graph training across ranks.

The same parameters and layer semantics as the single-device model
(``models/gcn.py``; its ``init_gcn_params``, so ``params_from_jax`` loads
JAX parameters unchanged), but every node-indexed tensor is split over the
ranks of a :class:`~graphconvgeo_torch.parallel.mesh.GraphMesh`:

- parameters: replicated (the same init on every rank, the same update);
- H, logits, labels, masks: rank r holds rows ``[r·rpd, (r+1)·rpd)``;
- adjacency and features: the rank's block of the host plan
  (``partition.py``), sliced onto its device;
- the conv's SpMM: all-gather, halo all-to-all, ring, or halo + kernel 1 on
  the rank's dense local tiles (``spmm_dist.py``).

**Gradient rule.** Each rank backpropagates only its share of the loss,
``Σ_local ce·mask / max(Σ_global mask, 1)`` (the denominator all-reduced,
with no gradient), and the L2 term is added on rank 0 alone; the
collectives' backwards carry the cotangents of the rows other ranks read.
After ``backward`` one all-reduce sums the parameter gradients (and the
shares, which give the loss) across ranks (:meth:`loss_and_backward`). So
no step of the backward all-reduces on its own: the input layer's partial
dW₀ is summed by that one all-reduce. A loss replicated on every rank and
differentiated through a collective's backward would count each cotangent
D times.

**Dropout.** The sparse-input dropout is hashed by global entry position
(``ell_dropout_values`` / ``slab_dropout`` with the rank's row offset), so
it is bit-equal to the JAX package's and does not depend on the world size.
The dense dropouts draw from the rank's ``torch.Generator`` (the trainer
seeds one per rank from ``(seed, rank)``), so their masks depend on the
world size, where JAX draws one global mask; parity is held at rate 0.

:class:`~graphconvgeo_torch.parallel.gat_dist.DistGAT` and
:class:`~graphconvgeo_torch.parallel.factorized_dist.DistFactorizedGCN`
inherit the rank's rows (:meth:`DistHighwayGCN._rank_rows`), the input
layer, the loss, the streamed head, the predictions and the train step;
each brings its own propagation.

``cfg.remat`` recomputes each conv layer in the backward
(``torch.utils.checkpoint``), collectives included; the dense dropout of
its input stays outside the checkpoint, as in the single-device model.
``cfg.gather_dtype`` is ignored here, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from graphconvgeo_torch.models.gcn import (
    _ACTIVATIONS,
    GCNConfig,
    init_gcn_params,
    l2_penalty,
    matmul,
    torch_dtype,
)
from graphconvgeo_torch.ops.ce_stream import masked_ce_sums, streamed_argmax, streamed_rows_threshold
from graphconvgeo_torch.ops.dropout import dropout, ell_dropout_values, slab_dropout
from graphconvgeo_torch.parallel.mesh import GraphMesh, put_host_cast
from graphconvgeo_torch.parallel.partition import RowPartition, StackedEll, build_halo
from graphconvgeo_torch.parallel.spmm_dist import (
    _AllGather,
    device_slice,
    local_input_spmm,
    local_spmm_allgather,
    local_spmm_halo,
    local_spmm_halo_bsr,
    local_spmm_halo_ring,
)
from graphconvgeo_torch.sparse.formats import to_device

# the local square blocks' tile size for kernel 1 (build_halo's bsr_block)
BSR_BLOCK = 256


def sum_gradients(module: nn.Module, share: torch.Tensor, mesh: GraphMesh) -> torch.Tensor:
    """After ``share.backward()`` on every rank: sum each parameter's
    gradient and the ranks' loss shares across ``mesh`` in one all-reduce
    (a parameter with no gradient on a rank adds zeros). Returns the loss
    (detached, the same on every rank); afterwards each ``p.grad`` holds its
    gradient."""
    params = list(module.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [share.detach().reshape(1).float()])
    dist.all_reduce(flat, group=mesh.group)
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off : off + n].view_as(p).to(p.dtype)
        off += n
    return flat[-1]


class DistHighwayGCN(nn.Module):
    def __init__(
        self,
        cfg: GCNConfig,
        part: RowPartition,
        mesh: GraphMesh,
        *,
        halo: str = "auto",
        local_backend: str = "auto",
        dist_format: str = "bell",
        halo_mode: str = "alltoall",
        seed: int = 0,
    ):
        """halo: 'auto' | 'on' | 'off'. 'on' exchanges only boundary rows by
        all-to-all (partition.build_halo); 'off' all-gathers every feature
        row; 'auto' takes the halo when it moves less data.

        halo_mode: 'alltoall' (one collective, then one remote product) |
        'ring' (D−1 shifts with a per-peer product after each).

        local_backend: 'auto' | 'bsr' | 'bell'. 'bsr' runs each rank's
        local dense tiles through kernel 1 (needs rows_per_device % 256 ==
        0, i.e. partition_rows(row_align=256), and a symmetric Â); 'auto'
        takes it when the alignment allows. The resolved choice is
        :attr:`local_backend`.

        dist_format: 'bell' (degree-bucketed ELL blocks) | 'ell' (plain
        common-K ELL). ``seed`` draws the initial parameters (the same on
        every rank)."""
        super().__init__()
        if halo not in ("auto", "on", "off"):
            raise ValueError(f"halo must be 'auto', 'on' or 'off', got {halo!r}")
        if halo_mode not in ("alltoall", "ring"):
            raise ValueError(f"halo_mode must be 'alltoall' or 'ring', got {halo_mode!r}")
        data = self._rank_rows(cfg, part, mesh)
        self.dist_format = dist_format
        self.halo_mode = halo_mode
        r, dev, rpd = mesh.rank, mesh.device, part.rows_per_device
        self.halo = None
        if halo in ("on", "auto"):
            if halo_mode == "ring" and local_backend == "bsr":
                raise ValueError("halo_mode='ring' composes with local_backend='bell' only")
            if local_backend == "auto":
                local_backend = ("bsr" if rpd % BSR_BLOCK == 0 and halo_mode != "ring"
                                 else "bell")
            hx = build_halo(part, local_backend=local_backend, bsr_block=BSR_BLOCK)
            if not (halo == "auto" and hx.halo_fraction >= 1.0):  # else gathering wins
                self.halo = hx
        if self.halo is not None:
            hx = self.halo
            # the ring reads the per-peer remote operands, not the whole
            # remote pair: build and move only what the mode reads
            keys = ("al", "alt") if halo_mode == "ring" else ("al", "alt", "ar", "art")
            for k, op in hx.operands(dist_format, keys=keys).items():
                data[k] = device_slice(op, r, dev)
            if halo_mode == "ring":
                for k, op in hx.ring_operands(dist_format).items():
                    mine = device_slice(op, r, dev)
                    data[k] = [device_slice(mine, s) for s in range(mesh.world_size)]
            data["send_idx"] = torch.as_tensor(hx.send_idx[r], dtype=torch.int64, device=dev)
            if hx.bsr is not None:
                data["bsr"] = to_device(hx.bsr[r], dev)
        else:
            a_op, at_op = part.a_operands(dist_format)
            data["a"] = device_slice(a_op, r, dev)
            data["at"] = device_slice(at_op, r, dev)
        self.data = data
        self.local_backend = "bsr" if "bsr" in data else "bell"
        init_gcn_params(self, cfg, torch.Generator().manual_seed(seed))
        self.to(device=dev, dtype=torch_dtype(cfg.dtype))

    def _rank_rows(self, cfg, part: RowPartition, mesh: GraphMesh) -> dict:
        """Keep ``cfg``, ``part`` and ``mesh``; return what every model of the
        family holds on the rank's device beside its propagation operands:
        its blocks of X (both layouts), of the input slab if any, of the
        labels and of the train mask."""
        if mesh.world_size != part.n_devices:
            raise ValueError(f"the partition has {part.n_devices} blocks, the mesh "
                             f"{mesh.world_size} ranks")
        self.cfg = cfg
        self.part = part
        self.mesh = mesh
        self.device = mesh.device
        r, dev, rpd = mesh.rank, mesh.device, part.rows_per_device
        rows = slice(r * rpd, (r + 1) * rpd)
        data = {
            "x": device_slice(StackedEll(part.x_idx, part.x_val), r, dev),
            "xt": device_slice(StackedEll(part.xt_idx, part.xt_val), r, dev),
            "y": torch.as_tensor(part.y[rows], dtype=torch.int64, device=dev),
            "mask": torch.as_tensor(part.mask[rows], dtype=torch.float32, device=dev),
        }
        if part.slab is not None:
            # the Zipf-head input slab: the rank's dense [rpd, C] row block
            data["x_slab"] = put_host_cast(part.slab, torch_dtype(cfg.slab_dtype), mesh)
            data["x_cols"] = torch.as_tensor(part.slab_col_ids, dtype=torch.int64, device=dev)
        return data

    def set_mask(self, mask) -> None:
        """Replace the train mask by ``mask`` [n_pad] (host array, the same
        on every rank); the rank keeps its rows."""
        rpd, r = self.part.rows_per_device, self.mesh.rank
        self.data["mask"] = torch.as_tensor(mask[r * rpd : (r + 1) * rpd], dtype=torch.float32,
                                            device=self.device)

    # ---- forward --------------------------------------------------------
    def _input_layer(self, *, drop: bool, x_seed: int) -> torch.Tensor:
        """The rank's rows of X · W₀ (before the bias), with the hashed
        sparse-input dropout keyed by global entry ids."""
        cfg, data = self.cfg, self.data
        v = self.part.n_features
        row0 = self.mesh.rank * self.part.rows_per_device
        w0 = self.input.w
        x, xt = data["x"], data["xt"]
        if drop:
            # the rank's block of the global X: its row ids are offset by the
            # rank's first row, in both layouts, so the masks agree
            x = StackedEll(x.indices, ell_dropout_values(
                x.indices, x.values, rate=cfg.dropout, seed=x_seed, n_cols=v,
                transposed=False, row_offset=row0))
            xt = StackedEll(xt.indices, ell_dropout_values(
                xt.indices, xt.values, rate=cfg.dropout, seed=x_seed, n_cols=v,
                transposed=True, row_offset=row0))
        out = local_input_spmm(w0, x, xt)
        if "x_slab" in data:
            # the dense head-slab term, summed in float32 (JAX's
            # preferred_element_type); its dW₀ rows scatter through autograd
            slab, cols = data["x_slab"], data["x_cols"]
            if drop:
                slab = slab_dropout(slab, cols, rate=cfg.dropout, seed=x_seed, n_cols=v,
                                    row_offset=row0)
            w_head = w0.index_select(0, cols).to(slab.dtype)
            out = out + torch.matmul(slab.float(), w_head.float()).to(out.dtype)
        return out

    def _conv(self, hw: torch.Tensor) -> torch.Tensor:
        d, mesh = self.data, self.mesh
        if self.halo is None:
            return local_spmm_allgather(hw, d["a"], d["at"], mesh)
        if self.halo_mode == "ring":
            return local_spmm_halo_ring(hw, d["al"], d["alt"], d["arp"], d["artp"],
                                        d["send_idx"], mesh)
        if "bsr" in d:
            return local_spmm_halo_bsr(hw, d["al"], d["alt"], d["ar"], d["art"], d["send_idx"],
                                       d["bsr"], mesh)
        return local_spmm_halo(hw, d["al"], d["alt"], d["ar"], d["art"], d["send_idx"], mesh)

    def _forward(self, *, train: bool, x_seed: int, generator, with_logits: bool) -> torch.Tensor:
        """The rank's logits [rpd, C], or (``with_logits=False``) its final
        hidden state after the output dropout."""
        cfg = self.cfg
        act = _ACTIVATIONS[cfg.activation]
        drop = train and cfg.dropout > 0.0
        if drop and generator is None:
            raise ValueError("generator required when train=True and dropout > 0")

        def conv_layer(layer, h, h_in):
            conv = act(self._conv(matmul(h_in, layer.w)) + layer.b)
            if hasattr(layer, "w_t"):
                gate = torch.sigmoid(matmul(h_in, layer.w_t) + layer.b_t)
                return gate * conv + (1.0 - gate) * h
            return conv

        with record_function("input_layer"):
            h = self._input_layer(drop=drop, x_seed=x_seed)
            h = act(h.to(torch_dtype(cfg.dtype)) + self.input.b)
        for i, layer in enumerate(self.layers):
            with record_function(f"conv_{i}"):
                h_in = dropout(h, rate=cfg.dropout, generator=generator) if drop else h
                if cfg.remat:
                    h = checkpoint(functools.partial(conv_layer, layer), h, h_in,
                                   use_reentrant=False)
                else:
                    h = conv_layer(layer, h, h_in)
        with record_function("output_layer"):
            if drop:
                h = dropout(h, rate=cfg.dropout, generator=generator)
            if not with_logits:
                return h
            return matmul(h, self.out.w) + self.out.b

    def apply(self, *, train: bool = False, x_seed: int = 0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The rank's logits [rows_per_device, n_classes]."""
        return self._forward(train=train, x_seed=x_seed, generator=generator, with_logits=True)

    def _streamed_head(self) -> bool:
        """Stream the head over row blocks when the global logits (n_pad × C)
        would pass the single-device model's gate."""
        return self.part.n_pad * self.cfg.n_classes > streamed_rows_threshold()

    # ---- loss -----------------------------------------------------------
    def loss_share(self, *, train: bool = True, x_seed: int = 0,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """This rank's share of the masked cross-entropy (+ L2 on rank 0):
        the shares of all ranks sum to the loss. Above the logits-size gate
        the head streams over row blocks (``ops/ce_stream.py``)."""
        y, mask = self.data["y"], self.data["mask"]
        if self._streamed_head():
            h = self._forward(train=train, x_seed=x_seed, generator=generator, with_logits=False)
            num, den = masked_ce_sums(h, self.out.w, self.out.b, y, mask)
        else:
            logits = self.apply(train=train, x_seed=x_seed, generator=generator)
            ce = -F.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0]
            m = mask.to(ce.dtype)
            num, den = torch.sum(ce * m), torch.sum(m)
        den = den.detach().float().clone()
        dist.all_reduce(den, group=self.mesh.group)
        share = num / torch.clamp(den, min=1.0)
        if self.cfg.l2 > 0.0 and self.mesh.rank == 0:
            share = share + self.cfg.l2 * l2_penalty(self)
        return share

    def loss_and_backward(self, *, train: bool = True, x_seed: int = 0,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Backpropagate this rank's :meth:`loss_share`, then sum every
        parameter's gradient and the shares across ranks in one all-reduce.
        Clear the gradients first. Returns the loss (detached, the same on
        every rank); afterwards each ``p.grad`` holds the loss's gradient."""
        share = self.loss_share(train=train, x_seed=x_seed, generator=generator)
        share.backward()
        return sum_gradients(self, share, self.mesh)

    @torch.no_grad()
    def predict_classes(self) -> torch.Tensor:
        """argmax class of every node row [n_pad], all-gathered to every
        rank (the JAX package replicates its predictions)."""
        if self._streamed_head():
            h = self._forward(train=False, x_seed=0, generator=None, with_logits=False)
            pred = streamed_argmax(h, self.out.w, self.out.b)
        else:
            pred = torch.argmax(self.apply(train=False), dim=-1)
        return _AllGather.apply(pred, self.mesh)

    # ---- training -------------------------------------------------------
    def make_train_step(self, learning_rate: float = 5e-3):
        """(optimizer, step): ``step(x_seed, generator)`` runs one full-graph
        Adam step (``optax.adam``'s update: betas 0.9 / 0.999, eps 1e-8) and
        returns the loss before the update."""
        opt = torch.optim.Adam(self.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

        def step(x_seed: int, generator: Optional[torch.Generator]) -> torch.Tensor:
            opt.zero_grad(set_to_none=True)
            loss = self.loss_and_backward(train=True, x_seed=x_seed, generator=generator)
            opt.step()
            return loss

        return opt, step
