"""Mini-batch (neighbor-sampled) training loop — BASELINE config 5 (port of
``graphconvgeo_tpu/train/trainer_sampled.py``).

Same epoch, early-stopping and evaluation semantics as the full-graph
:class:`~graphconvgeo_torch.train.trainer.Trainer` (reference ``GCN.fit``),
but each step consumes one sampled batch from the host-side
:class:`NeighborSampler`; a background thread samples the next batches
while the main thread moves the current one to the device and steps.
Evaluation runs full-graph with the SAME module (the sampled and full
models share it), or, with ``eval_mode="sampled"``, through the sampled
forward on the evaluated rows only.

The optimizer is the full-graph trainer's ``torch.optim.Adam``; every
dropout mask of a step draws from one ``torch.Generator`` on the model's
device, seeded with ``TrainConfig.seed``. The sampler draws from its own
numpy generator, in the JAX package's order, so both packages train on the
same batches. Of ``TrainConfig``'s options the loop reads those JAX's
sampled trainer reads (``learning_rate``, ``epochs``, ``patience``,
``min_epochs``, ``seed``, ``monitor``, ``log_every``, ``verbose``) and
``metrics_path``; checkpoints are the CLI's, after training.

Each history entry records the epoch's CUDA kernel launches by kernel name
(``launches``: steps and dev evaluation; ``step_launches``: the steps
alone; all zero on the CPU).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from graphconvgeo_torch.data.sampling import NeighborSampler
from graphconvgeo_torch.models.sampled import batch_to_device, sampled_forward, sampled_loss
from graphconvgeo_torch.ops.ce_stream import predict_classes
from graphconvgeo_torch.sparse.formats import to_device
from graphconvgeo_torch.train.evaluate import geo_eval
from graphconvgeo_torch.train.trainer import MONITORS, TrainConfig
from graphconvgeo_torch.utils import cuda_build
from graphconvgeo_torch.utils.logging import MetricsLogger


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue —
    overlaps host-side sampling with device steps. An exception raised in
    the thread is raised again here; leaving the loop early stops the
    thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def worker():
        try:
            for item in iterable:
                if stop.is_set():
                    return
                q.put((item, None))
            q.put((done, None))
        except BaseException as exc:  # handed to the consumer, which raises it
            q.put((done, exc))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item, exc = q.get()
            if exc is not None:
                raise exc
            if item is done:
                return
            yield item
    finally:
        stop.set()
        while t.is_alive():  # unblock a worker waiting on a full queue
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        t.join()


@torch.no_grad()
def sampled_predict(model, sampler: NeighborSampler, x_ell, idx) -> np.ndarray:
    """Predict classes for ``idx`` through the SAMPLED forward only — no
    full-graph Â operand, no [N, H] activation chain, no [N, C] logits.
    Memory high-water is one batch subtree. With fanouts ≥ every node's
    degree the L-hop subtree IS the full neighborhood and predictions equal
    full-graph inference (the sampler takes all d neighbors unscaled when
    d ≤ fanout); capped fanouts give standard GraphSAGE approximate
    inference."""
    idx = np.asarray(idx)
    out = np.zeros(len(idx), np.int64)
    pos = 0
    for batch in prefetch(sampler.epoch(idx, shuffle=False)):
        logits = sampled_forward(model, x_ell, batch_to_device(batch, model.device))
        k = int(batch.target_mask.sum())
        out[pos : pos + k] = torch.argmax(logits[:k], dim=-1).cpu().numpy()
        pos += k
    if pos != len(idx):
        raise RuntimeError(f"sampled_predict covered {pos} of {len(idx)} rows")
    return out


class SampledTrainer:
    def __init__(
        self,
        model,
        sampler: NeighborSampler,
        cfg: TrainConfig = TrainConfig(),
        *,
        eval_mode: str = "full",
        eval_sampler: Optional[NeighborSampler] = None,
    ):
        """``model``: a :class:`~graphconvgeo_torch.models.gcn.HighwayGCN`
        on its device. ``eval_mode``: "full" (full-graph inference per dev
        eval — needs the model's full-graph operands) | "sampled" (dev/test
        rows only, via :func:`sampled_predict`; the model may be built with
        ``adj=None`` and no full-graph buffer is ever made).
        ``eval_sampler``: sampler for the sampled eval (defaults to the
        training sampler; pass one with larger fanouts for exact
        full-neighborhood inference)."""
        if eval_mode not in ("full", "sampled"):
            raise ValueError(f"eval_mode must be 'full' or 'sampled', got {eval_mode!r}")
        self.model = model
        self.sampler = sampler
        self.cfg = cfg
        self.eval_mode = eval_mode
        self.eval_sampler = eval_sampler if eval_sampler is not None else sampler
        self.optimizer = torch.optim.Adam(
            model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
        self.generator = torch.Generator(device=model.device).manual_seed(cfg.seed)
        self._x_ell = None  # row-capped ELL on the device, shared by fit and eval

    @property
    def x_ell(self):
        """The model's BoW input as a :class:`CappedEll` on its device
        (built at first use). The sampled input layer reads X's rows only:
        no transpose of X is needed, since autograd scatters dW₀."""
        if self._x_ell is None:
            self._x_ell = to_device(self.model.x.ell_capped(), self.model.device)
        return self._x_ell

    def train_step(self, batch, y_dev: torch.Tensor) -> torch.Tensor:
        """One Adam step on a :class:`SampledBatch`; returns the
        (pre-update) loss on the device, unsynchronized."""
        model = self.model
        bd = batch_to_device(batch, model.device)
        self.optimizer.zero_grad(set_to_none=True)
        loss = sampled_loss(model, self.x_ell, bd, y_dev[bd["nodes"][0]], bd["target_mask"],
                            train=True, generator=self.generator)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train_epoch(self, train_idx: np.ndarray, y_dev: torch.Tensor) -> torch.Tensor:
        """One pass over ``train_idx`` in sampled batches (sampled in a
        background thread); returns the steps' losses on the device."""
        return torch.stack([self.train_step(b, y_dev)
                            for b in prefetch(self.sampler.epoch(train_idx))])

    def _predict_rows(self, idx) -> np.ndarray:
        """Predicted classes for the given rows, per eval_mode."""
        if self.eval_mode == "sampled":
            return sampled_predict(self.model, self.eval_sampler, self.x_ell, idx)
        return predict_classes(self.model).cpu().numpy()[np.asarray(idx)]

    def fit(
        self,
        y: np.ndarray,
        train_idx: np.ndarray,
        dev_idx: np.ndarray,
        *,
        lat: np.ndarray,
        lon: np.ndarray,
        class_lat_median: np.ndarray,
        class_lon_median: np.ndarray,
        params: Optional[dict] = None,
        label_fraction: float = 1.0,
    ) -> dict:
        """Train with early stopping on the dev metric ``cfg.monitor``;
        returns {params, history, best_epoch} and leaves the best
        parameters in the model. ``params`` (a state dict) replaces the
        model's initial parameters; ``label_fraction`` < 1 thins the target
        pool as the JAX trainer does (``default_rng(seed)``)."""
        cfg = self.cfg
        model = self.model
        if params is not None:
            model.load_state_dict(params)
        self.generator.manual_seed(cfg.seed)
        if label_fraction < 1.0:
            # semi-supervised curves (the reference's fraction-of-labels
            # flag): thin the target pool the sampler draws batches from
            keep = np.random.default_rng(cfg.seed).random(len(train_idx)) < label_fraction
            train_idx = train_idx[keep]
        y_dev = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=model.device)
        sign = MONITORS[cfg.monitor]
        best_score, best_epoch = -np.inf, 0
        best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        mlog = MetricsLogger(cfg.metrics_path)
        history = []
        t0 = time.perf_counter()
        for epoch in range(cfg.epochs):
            launched = dict(cuda_build.launch_counts)
            loss = float(self.train_epoch(train_idx, y_dev).double().mean())
            stepped = dict(cuda_build.launch_counts)
            pred_dev = self._predict_rows(dev_idx)
            m = geo_eval(pred_dev, lat[dev_idx], lon[dev_idx], class_lat_median, class_lon_median)
            history.append(
                {
                    "epoch": epoch,
                    "loss": loss,
                    "dev_acc_at_161": m["acc_at_161"],
                    "dev_mean_km": m["mean_km"],
                    "dev_median_km": m["median_km"],
                    "seconds": time.perf_counter() - t0,
                    "launches": {
                        k: n - launched[k] for k, n in cuda_build.launch_counts.items()
                    },
                    "step_launches": {k: n - launched[k] for k, n in stepped.items()},
                }
            )
            mlog.log(history[-1])
            score = sign * m[cfg.monitor]
            if score > best_score:
                best_score, best_epoch = score, epoch
                best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            if cfg.verbose and epoch % cfg.log_every == 0:
                h = history[-1]
                print(
                    f"epoch {epoch:4d} loss {h['loss']:.4f} dev acc@161 "
                    f"{h['dev_acc_at_161']:.3f} ({h['seconds']:.1f}s)"
                )
            if epoch >= cfg.min_epochs and epoch - best_epoch >= cfg.patience:
                break
        model.load_state_dict(best_state)
        return {"params": best_state, "history": history, "best_epoch": best_epoch}

    def evaluate(
        self, params, idx, *, lat, lon, class_lat_median, class_lon_median
    ) -> dict:
        """Geo metrics on ``idx`` with ``params`` (a state dict, or None for
        the model's current parameters): full-graph inference, or — with
        ``eval_mode='sampled'`` — row-scoped sampled inference that never
        makes a full-graph buffer."""
        if params is not None:
            self.model.load_state_dict(params)
        pred = self._predict_rows(idx)
        m = geo_eval(pred, lat[idx], lon[idx], class_lat_median, class_lon_median)
        m.pop("distances")
        return m
