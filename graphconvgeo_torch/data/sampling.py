"""Neighbor sampling for GraphSAGE-style mini-batch training (port of
``graphconvgeo_tpu/data/sampling.py``; BASELINE.json:11 — "Twitter-World
with neighbor-sampled mini-batches"). Numpy only: the sampler runs on the
host, and :func:`graphconvgeo_torch.models.sampled.batch_to_device` moves
its arrays to the card.

Each batch is padded to fixed sizes, as the JAX package needs for jit, so
every step of a run has the same shapes:

- layer node sets ``nodes[l]``: [cap_l] global node ids (pad = 0, masked),
- per-layer edge lists (src-slot in layer l+1's set, dst-slot in layer l's
  set, Â value), padded to ``cap_l * fanout``.

The device side is gathers, a segment sum and GEMMs
(``models/sampled.py``).

Sampling estimator: each node keeps at most ``fanout`` of its neighbors,
with the kept Â values rescaled by (true_degree / kept) so the aggregation
is an unbiased estimate of the full-graph SpMM row.

The generator ``self.rng`` is drawn in the JAX package's order (one
``integers(0, 2**63 - 1)`` per layer on the native path, one
``random((cap_l, width))`` per layer on the numpy path, ``shuffle`` per
epoch), and the native library is a copy of the JAX package's, so the same
graph, seed and targets give the same batches and epoch orders in both
packages.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import scipy.sparse as sp

from graphconvgeo_torch.native import sample_neighbors


@dataclasses.dataclass
class SampledBatch:
    """One mini-batch; arrays are numpy, padded to static shapes."""

    # per layer l = 0 (targets) .. L (deepest): global node ids, [cap_l]
    nodes: list
    node_mask: list  # [cap_l] float32 (1 = real)
    # per layer l = 0..L-1: edges aggregating layer l+1 -> layer l
    edge_src: list  # [cap_l * fanout] slot in nodes[l+1]
    edge_dst: list  # [cap_l * fanout] slot in nodes[l]
    edge_val: list  # [cap_l * fanout] float32 rescaled Â values (pad = 0)
    targets: np.ndarray  # [batch] global ids of the loss rows (= nodes[0][:batch])
    target_mask: np.ndarray


class NeighborSampler:
    def __init__(
        self,
        adj: sp.csr_matrix,
        *,
        fanouts: Sequence[int] = (10, 10),
        batch_size: int = 512,
        seed: int = 0,
        use_native: bool = True,
    ):
        """``use_native`` picks the C++ Floyd sampler (O(fanout²) per row)
        over the numpy path's [rows, max_degree] argsort; both keep distinct
        picks and the d/fanout rescale, from different random streams. The
        native library builds at the first sample and raises if it cannot:
        there is no silent fall-back to the numpy path."""
        self.adj = adj.tocsr()
        self.fanouts = tuple(fanouts)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.deg = np.diff(self.adj.indptr)
        self._native = sample_neighbors if use_native else None

    @property
    def native(self) -> bool:
        """Whether the batches come from the native sampler."""
        return self._native is not None

    def _caps(self):
        caps = [self.batch_size]
        for f in self.fanouts:
            caps.append(caps[-1] * (1 + f))
        return caps

    def sample(self, target_ids: np.ndarray) -> SampledBatch:
        """Layer l+1's node array is [nodes[l] (first cap_l slots) | sampled
        neighbors] so the highway gate's H_{prev}[dst] is just a prefix slice
        of the deeper layer's representations."""
        caps = self._caps()
        b = len(target_ids)
        nodes = []
        node_mask = []
        cur = np.zeros(caps[0], dtype=np.int64)
        cur[:b] = target_ids
        cmask = np.zeros(caps[0], dtype=np.float32)
        cmask[:b] = 1.0
        nodes.append(cur)
        node_mask.append(cmask)
        edge_src, edge_dst, edge_val = [], [], []
        for l, fanout in enumerate(self.fanouts):
            cap_l = caps[l]
            nxt = np.zeros(caps[l + 1], dtype=np.int64)
            nmask = np.zeros(caps[l + 1], dtype=np.float32)
            nxt[:cap_l] = nodes[l]
            nmask[:cap_l] = node_mask[l]
            # For nodes with degree d <= fanout take the first d neighbors
            # unscaled; for d > fanout draw `fanout` *distinct* offsets and
            # rescale by d/fanout.
            u = nodes[l]
            slot_ar = np.arange(fanout)[None, :]
            if self._native is not None:
                seed_l = int(self.rng.integers(0, 2**63 - 1))
                nbrs, vals, sel_mask, take = self._native(
                    self.adj.indptr, self.adj.indices, self.adj.data,
                    u, node_mask[l], fanout, seed_l,
                )
            else:
                deg = self.deg[u] * (node_mask[l] > 0)
                starts = self.adj.indptr[u]
                # random distinct offsets: rank of uniforms over [0, d) per
                # row. width ≥ fanout so the [:, :fanout] slice below always
                # broadcasts against sel_mask even when every degree is below
                # the fanout.
                width = max(int(deg.max()) if deg.size and deg.max() else 1, fanout)
                r = self.rng.random((cap_l, width))
                # mask invalid positions with +inf so argsort puts them last
                valid = np.arange(r.shape[1])[None, :] < deg[:, None]
                r = np.where(valid, r, np.inf)
                order = np.argsort(r, axis=1)[:, :fanout]  # distinct offsets per row
                take = np.minimum(deg, fanout)  # how many are real per row
                sel_mask = slot_ar < take[:, None]
                offs = np.where(sel_mask, order, 0)
                eidx = starts[:, None] + offs
                nbrs = self.adj.indices[eidx]
                vals = self.adj.data[eidx].astype(np.float32)
                scale = np.where(deg > fanout, deg / fanout, 1.0).astype(np.float32)
                vals = vals * scale[:, None] * sel_mask
            base = cap_l + np.arange(cap_l)[:, None] * fanout + slot_ar
            nxt[base[sel_mask]] = nbrs[sel_mask]
            nmask[base[sel_mask]] = 1.0
            n_edges = int(sel_mask.sum())
            es = np.zeros(cap_l * fanout, dtype=np.int64)
            ed = np.zeros(cap_l * fanout, dtype=np.int64)
            ev = np.zeros(cap_l * fanout, dtype=np.float32)
            es[:n_edges] = base[sel_mask]
            ed[:n_edges] = np.repeat(np.arange(cap_l), take)
            ev[:n_edges] = vals[sel_mask]
            nodes.append(nxt)
            node_mask.append(nmask)
            edge_src.append(es)
            edge_dst.append(ed)
            edge_val.append(ev)
        tmask = np.zeros(self.batch_size, dtype=np.float32)
        tmask[:b] = 1.0
        return SampledBatch(
            nodes=nodes,
            node_mask=node_mask,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_val=edge_val,
            targets=nodes[0],
            target_mask=tmask,
        )

    def epoch(self, train_ids: np.ndarray, *, shuffle: bool = True):
        ids = np.array(train_ids)
        if shuffle:
            self.rng.shuffle(ids)
        for i in range(0, len(ids), self.batch_size):
            yield self.sample(ids[i : i + self.batch_size])
