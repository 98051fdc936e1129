"""Full-graph training loop (reference: ``gcnmodel.py :: GCN.fit``).

Semantics preserved from the reference: every epoch is ONE full-graph
forward/backward with the loss masked to the train index set; dev metrics are
computed each epoch; early stopping with patience on the dev metric; the best
parameters are snapshotted (on the device) and restored at the end.

The optimizer is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, the
update of ``optax.adam``'s defaults. Randomness per step: one integer seed
for the sparse-input dropout hash (from a numpy generator seeded with
``TrainConfig.seed``) and the dense dropout masks from a ``torch.Generator``
on the model's device, seeded the same.

Each history entry records the epoch's CUDA kernel launches by kernel name
(``launches``: step plus predict; all zero on the CPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from graphconvgeo_torch.ops.ce_stream import predict_classes
from graphconvgeo_torch.train.evaluate import geo_eval
from graphconvgeo_torch.utils import cuda_build
from graphconvgeo_torch.utils.logging import MetricsLogger


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 5e-3
    epochs: int = 500
    patience: int = 10
    min_epochs: int = 20
    seed: int = 0
    log_every: int = 10
    verbose: bool = True
    metrics_path: Optional[str] = None  # JSONL per-epoch metrics log


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
        """One full-graph Adam step; returns the (pre-update) loss."""
        x_seed = int(self._seeds.integers(0, 2**31 - 1))
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.loss(y, mask, train=True, x_seed=x_seed, generator=self.generator)
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
    ) -> dict:
        """Train with early stopping on dev Acc@161; returns {params,
        history, best_epoch}. ``params`` (a state dict) replaces the model's
        initial parameters."""
        cfg = self.cfg
        model = self.model
        if params is not None:
            model.load_state_dict(params)
        n = len(y)
        mask = np.zeros(n, dtype=np.float32)
        mask[train_idx] = 1.0
        y_dev = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=model.device)
        mask_dev = torch.as_tensor(mask, device=model.device)

        best_score = -np.inf
        best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        best_epoch = 0
        mlog = MetricsLogger(cfg.metrics_path)
        history = []
        t0 = time.perf_counter()
        for epoch in range(cfg.epochs):
            launched = dict(cuda_build.launch_counts)
            loss = self.train_step(y_dev, mask_dev)
            pred = self.predict()
            dev_metrics = geo_eval(
                pred[dev_idx], lat[dev_idx], lon[dev_idx], class_lat_median, class_lon_median
            )
            score = dev_metrics["acc_at_161"]
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
                }
            )
            mlog.log(history[-1])
            if score > best_score:
                best_score = score
                best_epoch = epoch
                best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            if cfg.verbose and epoch % cfg.log_every == 0:
                h = history[-1]
                print(
                    f"epoch {epoch:4d} loss {h['loss']:.4f} dev acc@161 "
                    f"{h['dev_acc_at_161']:.3f} median {h['dev_median_km']:.1f}km "
                    f"({h['seconds']:.1f}s)"
                )
            if epoch >= cfg.min_epochs and epoch - best_epoch >= cfg.patience:
                break
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
