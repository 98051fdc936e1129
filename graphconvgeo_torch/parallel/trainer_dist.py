"""Distributed training loop: the full-graph ``Trainer``'s semantics (one
full-graph step an epoch, dev early stopping on ``monitor``, best-parameter
restore, checkpoint and resume, periodic saves, JSONL metrics,
``label_fraction``) driving a distributed model across ranks: the
:class:`DistHighwayGCN` of ``model_dist.py`` or its subclasses
``DistGAT`` and ``DistFactorizedGCN`` (their checkpoints hold the
single-device models' parameter names).

Every rank runs the same loop: the same step seeds, the same replicated
predictions (all-gathered), so the same early-stopping decisions. The
hashed input dropout's seed comes from ``default_rng(seed)`` as in the
single-device trainer; the dense dropouts from a generator seeded
``seed + (rank << 32)``, one stream per rank (rank 0's is the single-device
trainer's). Rank 0 writes the checkpoints and the metrics log, then every
rank waits at a barrier; every rank restores.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from graphconvgeo_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from graphconvgeo_torch.train.evaluate import geo_eval
from graphconvgeo_torch.train.trainer import MONITORS, TrainConfig
from graphconvgeo_torch.utils import cuda_build
from graphconvgeo_torch.utils.logging import MetricsLogger


class DistTrainer:
    def __init__(self, model, cfg: TrainConfig = TrainConfig()):
        self.model = model
        self.cfg = cfg
        self.optimizer, self._step = model.make_train_step(cfg.learning_rate)
        self.generator = torch.Generator(device=model.device)
        self._reseed()

    def _reseed(self) -> None:
        self.generator.manual_seed(self.cfg.seed + (self.model.mesh.rank << 32))
        self._seeds = np.random.default_rng(self.cfg.seed)

    @property
    def mesh(self):
        """The model's mesh."""
        return self.model.mesh

    @property
    def _lead(self) -> bool:
        """Rank 0: the one that prints, logs and writes checkpoints."""
        return self.model.mesh.rank == 0

    def train_step(self) -> torch.Tensor:
        """One full-graph Adam step on every rank; returns the loss (before
        the update). Under ``debug_nans`` a non-finite loss or gradient
        raises."""
        x_seed = int(self._seeds.integers(0, 2**31 - 1))
        anomaly = (torch.autograd.detect_anomaly(check_nan=True) if self.cfg.debug_nans
                   else contextlib.nullcontext())
        with anomaly:
            loss = self._step(x_seed, self.generator)
        if self.cfg.debug_nans and not math.isfinite(value := float(loss)):
            raise FloatingPointError(f"non-finite loss {value}")
        return loss

    def predict(self) -> np.ndarray:
        """The predicted class of every node, on every rank."""
        return self.model.predict_classes().cpu().numpy()[: self.model.part.n_nodes]

    def save(self, directory: str, step: int, *, opt_state: bool = True,
             metrics: Optional[dict] = None) -> None:
        """Rank 0 saves the current parameters (and Adam's state) as ``step``
        under ``directory``; every rank waits until it is written."""
        if self._lead:
            save_checkpoint(directory, self.model.state_dict(),
                            opt_state=self.optimizer.state_dict() if opt_state else None,
                            step=step, metrics=metrics)
        dist.barrier(group=self.model.mesh.group)

    def fit(
        self,
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
        returns {params, history, best_epoch}. ``params`` (a state dict)
        replaces the initial parameters. ``label_fraction`` < 1 keeps that
        share of the partition's train rows, drawn as the JAX trainer draws
        it (``default_rng(seed)``), so both keep the same labels."""
        cfg, model = self.cfg, self.model
        if params is not None:
            model.load_state_dict(params)
        self._reseed()
        if label_fraction < 1.0:
            mask = np.asarray(model.part.mask, dtype=np.float32).copy()
            train_rows = np.flatnonzero(mask > 0)
            keep = np.random.default_rng(cfg.seed).random(len(train_rows)) < label_fraction
            mask[train_rows[~keep]] = 0.0
            model.set_mask(mask)
        start_epoch = 0
        if cfg.checkpoint_dir:
            path = latest_checkpoint(cfg.checkpoint_dir)
            if path is not None:
                saved = restore_checkpoint(path, map_location=model.device)
                model.load_state_dict(saved["params"])
                if "opt_state" in saved:
                    self.optimizer.load_state_dict(saved["opt_state"])
                start_epoch = int(path.rsplit("_", 1)[-1]) + 1
                if cfg.verbose and self._lead:
                    print(f"resumed from {path} (epoch {start_epoch})")

        sign = MONITORS[cfg.monitor]
        best_score, best_epoch = -np.inf, 0
        best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        mlog = MetricsLogger(cfg.metrics_path if self._lead else None)
        history = []
        t0 = time.perf_counter()
        for epoch in range(start_epoch, cfg.epochs):
            launched = dict(cuda_build.launch_counts)
            loss = self.train_step()
            if cfg.checkpoint_dir and cfg.save_every and (epoch + 1) % cfg.save_every == 0:
                self.save(cfg.checkpoint_dir, epoch)
            pred = self.predict()
            m = geo_eval(pred[dev_idx], lat[dev_idx], lon[dev_idx], class_lat_median,
                         class_lon_median)
            history.append({
                "epoch": epoch,
                "loss": float(loss),
                "dev_acc_at_161": m["acc_at_161"],
                "dev_mean_km": m["mean_km"],
                "dev_median_km": m["median_km"],
                "seconds": time.perf_counter() - t0,
                "launches": {k: n - launched[k] for k, n in cuda_build.launch_counts.items()},
            })
            mlog.log(history[-1])
            score = sign * m[cfg.monitor]
            if score > best_score:
                best_score, best_epoch = score, epoch
                best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            if cfg.verbose and self._lead and epoch % cfg.log_every == 0:
                h = history[-1]
                print(f"epoch {epoch:4d} loss {h['loss']:.4f} dev acc@161 "
                      f"{h['dev_acc_at_161']:.3f} ({h['seconds']:.1f}s)")
            if epoch >= cfg.min_epochs and epoch - best_epoch >= cfg.patience:
                break
        model.load_state_dict(best_state)
        return {"params": best_state, "history": history, "best_epoch": best_epoch}

    def evaluate(self, params, idx, *, lat, lon, class_lat_median, class_lon_median) -> dict:
        """Geo metrics on ``idx`` (the same on every rank); ``params`` (a
        state dict, or None for the current parameters) is loaded first."""
        if params is not None:
            self.model.load_state_dict(params)
        pred = self.predict()
        m = geo_eval(pred[idx], lat[idx], lon[idx], class_lat_median, class_lon_median)
        m.pop("distances")
        return m
