"""Data-parallel neighbor-sampled training across ranks (port of
``graphconvgeo_tpu/parallel/sampled_dist.py``; BASELINE config 5 with
``--dist``).

The batch axis is split over the ranks of a
:class:`~graphconvgeo_torch.parallel.mesh.GraphMesh`: each step takes D
sub-batches of ``sampler.batch_size`` targets, one a rank, and one loss over
the global batch.

- The model is the single-device
  :class:`~graphconvgeo_torch.models.gcn.HighwayGCN` on every rank; its
  parameters and Adam's state are replicated (the same init, the same
  summed gradients, the same update).
- Each rank computes its own sub-batch's ``sampled_forward``, the numerator
  ``Σ ce·mask`` of its targets; the denominator ``Σ_r Σ mask`` is
  all-reduced as a constant. The rank's share of the loss is ``num_r /
  max(den, 1)``, with the L2 term on rank 0 alone, and one all-reduce after
  ``backward`` sums the gradients and the shares (slice A's rule,
  :func:`~graphconvgeo_torch.parallel.model_dist.sum_gradients`). The
  numerator goes through no collective of its own: a collective whose
  backward all-reduces the cotangent (``spmm_dist._AllReduce``) would make
  that sum count every term D times.
- Each step's sub-batches are those the JAX package's single host sampler
  draws one after another from one ``NeighborSampler.rng``. A rank makes
  only its own: on the native path the sampler draws one integer a layer
  per sub-batch, so the rank skips the draws of the real sub-batches before
  and after its own (:meth:`NeighborSampler.skip`). The numpy path's draws
  have a width that depends on the data, so there a rank samples every
  real sub-batch of the step and keeps its own (D times the host work of
  the native path). A rank past the step's real sub-batches gets an
  all-zero, all-masked sub-batch of the sampler's shapes and draws nothing,
  as JAX's tail padding does.
- Evaluation runs as in
  :class:`~graphconvgeo_torch.train.trainer_sampled.SampledTrainer`, on
  every rank with the same parameters: full-graph (kernel 1 through the
  ``hybrid`` conv on the card) or, with ``eval_mode="sampled"``, through
  :func:`~graphconvgeo_torch.train.trainer_sampled.sampled_predict`. So
  every rank makes the same early-stopping decision, and no rank leaves the
  loop alone while another waits in a collective.

**Dropout.** Every dropout of a rank's step draws from the rank's
``torch.Generator``, seeded ``seed + (rank << 32)`` (rank 0's is the
single-device trainer's). JAX folds the device index into a ``jax.random``
key, which the port cannot reproduce, so the two packages agree at dropout
0, not mask for mask.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from graphconvgeo_torch.data.sampling import NeighborSampler, SampledBatch
from graphconvgeo_torch.models.gcn import l2_penalty
from graphconvgeo_torch.models.sampled import batch_to_device, sampled_forward
from graphconvgeo_torch.parallel.mesh import GraphMesh
from graphconvgeo_torch.parallel.model_dist import sum_gradients
from graphconvgeo_torch.train.checkpoint import save_checkpoint
from graphconvgeo_torch.train.trainer import TrainConfig
from graphconvgeo_torch.train.trainer_sampled import SampledTrainer, prefetch


def stack_batches(batches, n_devices: int, batch_size: int) -> dict:
    """Stack D :class:`SampledBatch`es into one leading-device-axis batch
    dict (numpy), array for array the JAX package's: int32 node ids and edge
    slots, float32 values and target masks. Missing tail chunks become
    all-zero sub-batches of ``batches[0]``'s shapes (all masked out). The
    ranks never build it: each takes its own row (:func:`rank_sub_batch`)."""
    assert batches, "need at least one sub-batch"
    ref = batches[0]
    while len(batches) < n_devices:
        empty = type(ref)(
            nodes=[np.zeros_like(a) for a in ref.nodes],
            node_mask=[np.zeros_like(a) for a in ref.node_mask],
            edge_src=[np.zeros_like(a) for a in ref.edge_src],
            edge_dst=[np.zeros_like(a) for a in ref.edge_dst],
            edge_val=[np.zeros_like(a) for a in ref.edge_val],
            targets=np.zeros_like(ref.targets),
            target_mask=np.zeros_like(ref.target_mask),
        )
        batches = list(batches) + [empty]

    def stack(field, dtype):
        return [np.stack([np.asarray(getattr(b, field)[l], dtype) for b in batches])
                for l in range(len(getattr(ref, field)))]

    return {
        "nodes": stack("nodes", np.int32),
        "edge_src": stack("edge_src", np.int32),
        "edge_dst": stack("edge_dst", np.int32),
        "edge_val": stack("edge_val", np.float32),
        "targets": np.stack([np.asarray(b.targets, np.int32) for b in batches]),
        "target_mask": np.stack([np.asarray(b.target_mask, np.float32) for b in batches]),
    }


def rank_sub_batch(sampler: NeighborSampler, chunk: np.ndarray, n_devices: int,
                   rank: int) -> SampledBatch:
    """Sub-batch ``rank`` of one step over the targets ``chunk`` (at most
    ``n_devices · sampler.batch_size``): what sampling the step's real
    sub-batches one after another from ``sampler.rng`` gives at position
    ``rank``, or an all-zero sub-batch past them. ``sampler.rng`` ends
    where that sequence leaves it, on every rank."""
    bsz = sampler.batch_size
    n_real = -(-len(chunk) // bsz)
    if n_real > n_devices:
        raise ValueError(f"{len(chunk)} targets need {n_real} sub-batches of {bsz}, "
                         f"more than the {n_devices} ranks")
    part = lambda j: chunk[j * bsz : (j + 1) * bsz]
    if not sampler.native:  # the draws' widths depend on the data: sample them all
        subs = [sampler.sample(part(j)) for j in range(n_real)]
        return subs[rank] if rank < n_real else sampler.empty_batch()
    if rank >= n_real:
        sampler.skip(n_real)
        return sampler.empty_batch()
    sampler.skip(rank)
    mine = sampler.sample(part(rank))
    sampler.skip(n_real - rank - 1)
    return mine


def dist_sampled_loss(model, x_ell, batch: dict, y: torch.Tensor, mesh: GraphMesh, *,
                      generator=None, train: bool = True) -> torch.Tensor:
    """This rank's share of the global batch's mean masked cross-entropy
    (+ L2 on rank 0): ``Σ ce·mask`` of the rank's sub-batch ``batch`` (a
    :func:`batch_to_device` dict) with labels ``y`` over the all-reduced
    mask count. The shares of all ranks sum to the loss; backpropagate the
    share and sum the gradients with :func:`sum_gradients`. ``model`` is the
    :class:`HighwayGCN` (JAX's ``params, cfg`` pair); its dropouts draw from
    ``generator``."""
    logits = sampled_forward(model, x_ell, batch, train=train, generator=generator)
    ce = -F.log_softmax(logits, dim=-1).gather(1, y.long()[:, None])[:, 0]
    mask = batch["target_mask"].to(ce.dtype)
    num = torch.sum(ce * mask)
    den = torch.sum(mask).detach().float().clone()
    dist.all_reduce(den, group=mesh.group)
    share = num / torch.clamp(den, min=1.0)
    if model.cfg.l2 > 0.0 and mesh.rank == 0:
        share = share + model.cfg.l2 * l2_penalty(model)
    return share


class DistSampledTrainer(SampledTrainer):
    """:class:`SampledTrainer`'s semantics with the batch axis split over
    ``mesh``: one sub-batch of ``sampler.batch_size`` targets a rank and
    step (module docstring). ``model`` is the single-device HighwayGCN on
    the rank's device; ``sampler`` and ``eval_mode`` / ``eval_sampler`` as
    in :class:`SampledTrainer`. Every rank runs the same loop; rank 0
    prints and writes the metrics log and the checkpoints."""

    def __init__(self, model, sampler: NeighborSampler, mesh: GraphMesh,
                 cfg: TrainConfig = TrainConfig(), *, eval_mode: str = "full",
                 eval_sampler=None):
        if torch.device(model.device) != mesh.device:
            raise ValueError(f"the model is on {model.device}, the rank on {mesh.device}")
        self.mesh = mesh
        self.n_devices = mesh.world_size
        super().__init__(model, sampler, cfg, eval_mode=eval_mode, eval_sampler=eval_sampler)

    @property
    def _lead(self) -> bool:
        return self.mesh.rank == 0

    def _reseed(self) -> None:
        self.generator.manual_seed(self.cfg.seed + (self.mesh.rank << 32))

    def rank_batches(self, train_idx: np.ndarray, rng_np) -> Iterator[SampledBatch]:
        """This rank's sub-batch of each step of one epoch: ``train_idx``
        shuffled by ``rng_np`` (the same permutation on every rank), cut into
        steps of ``n_devices · batch_size`` targets."""
        ids = np.array(train_idx)
        rng_np.shuffle(ids)
        span = self.sampler.batch_size * self.n_devices
        for i in range(0, len(ids), span):
            yield rank_sub_batch(self.sampler, ids[i : i + span], self.n_devices, self.mesh.rank)

    def train_step(self, batch: SampledBatch, y_dev: torch.Tensor) -> torch.Tensor:
        """One Adam step on the global batch whose rank-th sub-batch is
        ``batch``; returns the loss (before the update, the same on every
        rank)."""
        model = self.model
        bd = batch_to_device(batch, model.device)
        self.optimizer.zero_grad(set_to_none=True)
        share = dist_sampled_loss(model, self.x_ell, bd, y_dev[bd["nodes"][0]], self.mesh,
                                  generator=self.generator, train=True)
        share.backward()
        loss = sum_gradients(model, share, self.mesh)
        self.optimizer.step()
        return loss

    def train_epoch(self, train_idx: np.ndarray, y_dev: torch.Tensor) -> torch.Tensor:
        """One pass over ``train_idx``, shuffled by the trainer's generator
        as JAX's ``_stacked_epoch`` shuffles it; returns the steps' losses."""
        return torch.stack([self.train_step(b, y_dev)
                            for b in prefetch(self.rank_batches(train_idx, self._rng_np))])

    def save(self, directory: str, step: int, *, opt_state: bool = True,
             metrics=None) -> None:
        """Rank 0 saves the current parameters (and Adam's state) as ``step``
        under ``directory``; every rank waits until it is written."""
        if self._lead:
            save_checkpoint(directory, self.model.state_dict(),
                            opt_state=self.optimizer.state_dict() if opt_state else None,
                            step=step, metrics=metrics)
        dist.barrier(group=self.mesh.group)
