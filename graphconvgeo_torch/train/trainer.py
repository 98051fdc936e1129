"""Full-graph training loop (reference: ``gcnmodel.py :: GCN.fit``).

Semantics preserved from the reference: every epoch is ONE full-graph
forward/backward with the loss masked to the train index set; dev metrics are
computed each epoch; early stopping with patience on the dev metric
(``TrainConfig.monitor``: Acc@161, higher is better, or the median error,
lower is better); the best parameters are snapshotted (on the device) and
restored at the end.

The optimizer is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, the
update of ``optax.adam``'s defaults. Randomness per step: one integer seed
for the sparse-input dropout hash (from a numpy generator seeded with
``TrainConfig.seed``) and the dense dropout masks from a ``torch.Generator``
on the model's device, seeded the same.

Each history entry records the epoch's CUDA kernel launches by kernel name
(``launches``: step plus predict; all zero on the CPU) and the differences of
:data:`graphconvgeo_torch.utils.profiling.counters` (``counters``).

``fit`` marks its parts with :class:`~graphconvgeo_torch.utils.profiling.span`:
``fit.step``, ``fit.predict`` (with the copy to the host), ``fit.eval``
(``geo_eval`` and the score), ``fit.record`` (the history entry, the metrics
log, the print) and ``fit.best_state`` (each clone of the best state and the
final load).

Options of the JAX trainer: periodic checkpoints and resume
(``checkpoint_dir``, ``save_every``: :mod:`graphconvgeo_torch.train.checkpoint`;
a resumed fit restores the parameters and Adam's state and starts after the
saved epoch, its random streams restarting from ``seed`` as JAX's key does),
``debug_nans`` (autograd's anomaly mode plus a finite check of each loss)
and a trace of epochs ``[profile_start, profile_stop)`` into
``profile_dir`` (:func:`graphconvgeo_torch.utils.profiling.trace`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from graphconvgeo_torch.ops.ce_stream import predict_classes
from graphconvgeo_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from graphconvgeo_torch.train.evaluate import geo_eval
from graphconvgeo_torch.utils import cuda_build, profiling
from graphconvgeo_torch.utils.logging import MetricsLogger
from graphconvgeo_torch.utils.profiling import span, trace

MONITORS = {"acc_at_161": 1.0, "median_km": -1.0}  # dev metric -> sign (higher is better)


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 5e-3
    epochs: int = 500
    patience: int = 10
    min_epochs: int = 20
    seed: int = 0
    monitor: str = "acc_at_161"  # early-stopping dev metric: "acc_at_161" ↑ or "median_km" ↓
    log_every: int = 10
    verbose: bool = True
    # periodic checkpoints; fit() resumes from the latest step in the directory
    checkpoint_dir: Optional[str] = None
    save_every: int = 0  # epochs between periodic saves (0: none)
    debug_nans: bool = False  # anomaly mode and a finite check of each loss
    metrics_path: Optional[str] = None  # JSONL per-epoch metrics log
    # trace epochs [profile_start, profile_stop) into profile_dir
    profile_dir: Optional[str] = None
    profile_start: int = 2  # after the warm-up epochs
    profile_stop: int = 4

    def __post_init__(self):
        if self.monitor not in MONITORS:
            raise ValueError(f"monitor must be one of {sorted(MONITORS)}, got {self.monitor!r}")


class Trainer:
    def __init__(self, model, cfg: TrainConfig = TrainConfig()):
        self.model = model
        self.cfg = cfg
        self.optimizer = torch.optim.Adam(
            model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
        self.generator = torch.Generator(device=model.device).manual_seed(cfg.seed)
        self._seeds = np.random.default_rng(cfg.seed)

    def train_step(self, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """One full-graph Adam step; returns the (pre-update) loss. Under
        ``debug_nans`` a non-finite loss or gradient raises."""
        x_seed = int(self._seeds.integers(0, 2**31 - 1))
        self.optimizer.zero_grad(set_to_none=True)
        anomaly = (torch.autograd.detect_anomaly(check_nan=True) if self.cfg.debug_nans
                   else contextlib.nullcontext())
        with anomaly:
            loss = self.model.loss(y, mask, train=True, x_seed=x_seed, generator=self.generator)
            if self.cfg.debug_nans and not math.isfinite(value := float(loss.detach())):
                raise FloatingPointError(f"non-finite loss {value}")
            loss.backward()
        self.optimizer.step()
        return loss.detach()

    def predict(self) -> np.ndarray:
        return predict_classes(self.model).cpu().numpy()

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
        returns {params, history, best_epoch}. ``params`` (a state dict)
        replaces the model's initial parameters. ``label_fraction`` < 1
        keeps that share of ``train_idx``, drawn as the JAX trainer draws it
        (``default_rng(seed)``), so both keep the same labels."""
        cfg = self.cfg
        model = self.model
        if params is not None:
            model.load_state_dict(params)
        self.generator.manual_seed(cfg.seed)
        self._seeds = np.random.default_rng(cfg.seed)
        start_epoch = 0
        if cfg.checkpoint_dir:
            path = latest_checkpoint(cfg.checkpoint_dir)
            if path is not None:
                saved = restore_checkpoint(path, map_location=model.device)
                model.load_state_dict(saved["params"])
                if "opt_state" in saved:
                    self.optimizer.load_state_dict(saved["opt_state"])
                start_epoch = int(path.rsplit("_", 1)[-1]) + 1
                if cfg.verbose:
                    print(f"resumed from {path} (epoch {start_epoch})")
        n = len(y)
        if label_fraction < 1.0:
            # semi-supervised curves (the reference's fraction-of-labels flag)
            keep = np.random.default_rng(cfg.seed).random(len(train_idx)) < label_fraction
            train_idx = train_idx[keep]
        mask = np.zeros(n, dtype=np.float32)
        mask[train_idx] = 1.0
        y_dev = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=model.device)
        mask_dev = torch.as_tensor(mask, device=model.device)

        sign = MONITORS[cfg.monitor]
        best_score = -np.inf
        with span("fit.best_state"):
            best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        best_epoch = 0
        mlog = MetricsLogger(cfg.metrics_path)
        history = []
        t0 = time.perf_counter()
        # the trace covers epochs [profile_start, profile_stop); leaving the
        # block (early stopping, or an error) stops it
        with contextlib.ExitStack() as tracing:
            for epoch in range(start_epoch, cfg.epochs):
                if cfg.profile_dir and epoch == cfg.profile_start:
                    tracing.enter_context(trace(cfg.profile_dir))
                launched = dict(cuda_build.launch_counts)
                counted = dict(profiling.counters)
                with span("fit.step", epoch=epoch):
                    loss = self.train_step(y_dev, mask_dev)
                if epoch + 1 == cfg.profile_stop:
                    tracing.close()
                if cfg.checkpoint_dir and cfg.save_every and (epoch + 1) % cfg.save_every == 0:
                    save_checkpoint(cfg.checkpoint_dir, model.state_dict(),
                                    opt_state=self.optimizer.state_dict(), step=epoch)
                with span("fit.predict", epoch=epoch):
                    pred = self.predict()
                with span("fit.eval", epoch=epoch):
                    dev_metrics = geo_eval(
                        pred[dev_idx], lat[dev_idx], lon[dev_idx], class_lat_median,
                        class_lon_median
                    )
                    score = sign * dev_metrics[cfg.monitor]
                with span("fit.record", epoch=epoch):
                    history.append(
                        {
                            "epoch": epoch,
                            "loss": float(loss),
                            "dev_acc_at_161": dev_metrics["acc_at_161"],
                            "dev_mean_km": dev_metrics["mean_km"],
                            "dev_median_km": dev_metrics["median_km"],
                            "seconds": time.perf_counter() - t0,
                            "launches": {
                                k: n - launched[k] for k, n in cuda_build.launch_counts.items()
                            },
                            "counters": {
                                k: n - counted[k] for k, n in profiling.counters.items()
                            },
                        }
                    )
                    mlog.log(history[-1])
                    if cfg.verbose and epoch % cfg.log_every == 0:
                        h = history[-1]
                        print(
                            f"epoch {epoch:4d} loss {h['loss']:.4f} dev acc@161 "
                            f"{h['dev_acc_at_161']:.3f} median {h['dev_median_km']:.1f}km "
                            f"({h['seconds']:.1f}s)"
                        )
                if score > best_score:
                    best_score = score
                    best_epoch = epoch
                    with span("fit.best_state", epoch=epoch):
                        best_state = {
                            k: v.detach().clone() for k, v in model.state_dict().items()
                        }
                if epoch >= cfg.min_epochs and epoch - best_epoch >= cfg.patience:
                    break
        with span("fit.best_state"):
            model.load_state_dict(best_state)
        return {"params": best_state, "history": history, "best_epoch": best_epoch}

    def evaluate(
        self, params, idx, *, lat, lon, class_lat_median, class_lon_median
    ) -> dict:
        """Geo metrics on ``idx``; ``params`` (a state dict, or None for the
        model's current parameters) is loaded first."""
        if params is not None:
            self.model.load_state_dict(params)
        pred = self.predict()
        m = geo_eval(pred[idx], lat[idx], lon[idx], class_lat_median, class_lon_median)
        m.pop("distances")
        return m
