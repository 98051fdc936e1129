"""Checkpoints of the PyTorch port (``train/checkpoint.py``) against the JAX
package's (``tests/test_checkpoint.py``): the same file names and metrics
record, a bit-exact round trip of JAX parameters through a port checkpoint
(the served logits equal JAX's at rtol 2e-4, atol 2e-5, the model tests'
tolerance), the newest step selected and a left-over temporary file never,
a resumed ``Trainer``, and the CLI's ``--eval-only`` round trip and refusals
on the CPU."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from graphconvgeo_torch import cli as t_cli
from graphconvgeo_torch.models import gcn as t_gcn
from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.sparse.formats import SparseGraph as TGraph
from graphconvgeo_torch.train import checkpoint as t_ckpt
from graphconvgeo_torch.train.trainer import TrainConfig, Trainer
from graphconvgeo_tpu.models import gcn as j_gcn
from graphconvgeo_tpu.sparse.formats import SparseGraph as JGraph
from graphconvgeo_tpu.sparse.formats import normalize_adjacency
from graphconvgeo_tpu.train import checkpoint as j_ckpt
from tests.conftest import random_csr


def _problem(rng, n=60, v=20, c=4):
    adj = random_csr(rng, n, n, 3, symmetric=True)
    adj.data = np.abs(adj.data)
    x = random_csr(rng, n, v, 4)
    x.data = np.abs(x.data).astype(np.float32)
    return x, normalize_adjacency(adj), c


def _model(x, a_hat, c, **kw):
    cfg = t_gcn.GCNConfig(n_features=x.shape[1], n_classes=c, hidden=(8, 8), **kw)
    return t_gcn.HighwayGCN(cfg, TGraph(csr=x), TGraph(csr=a_hat, symmetric=True), device="cpu")


def test_checkpoint_roundtrip_serves_jax_params(tmp_path, rng):
    """JAX parameters saved by the port restore bit-exactly, and the restored
    model's logits equal JAX's; the step file and the metrics record are
    named and written as JAX writes them."""
    x, a_hat, c = _problem(rng)
    jm = j_gcn.HighwayGCN(
        j_gcn.GCNConfig(n_features=x.shape[1], n_classes=c, hidden=(8, 8), dropout=0.0),
        JGraph(csr=x), JGraph(csr=a_hat, symmetric=True),
    )
    params = jm.init(jax.random.key(0))
    state = params_from_jax(jax.tree.map(np.asarray, params))
    metrics = {"dev": {"acc_at_161": 0.5, "median_km": np.float64(12.25)}}
    path = t_ckpt.save_checkpoint(str(tmp_path / "t"), state, step=7, metrics=metrics)
    j_path = j_ckpt.save_checkpoint(str(tmp_path / "j"), params, step=7, metrics=metrics)
    assert os.path.basename(path) == os.path.basename(j_path) == "step_00000007"
    assert t_ckpt.latest_checkpoint(str(tmp_path / "t")) == path
    read = lambda d: json.loads((tmp_path / d / "metrics_00000007.json").read_text())
    assert read("t") == read("j")

    restored = t_ckpt.restore_checkpoint(path)["params"]
    assert set(restored) == set(state)
    for k in state:
        assert torch.equal(restored[k], state[k]), k
    tm = _model(x, a_hat, c, dropout=0.0)
    tm.load_state_dict(restored)
    with torch.no_grad():
        got = tm.apply(train=False).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(params, train=False)),
                               rtol=2e-4, atol=2e-5)


def test_checkpoint_multiple_steps_and_leftover_tmp(tmp_path, rng, monkeypatch):
    x, a_hat, c = _problem(rng)
    state = _model(x, a_hat, c).state_dict()
    d = str(tmp_path)
    t_ckpt.save_checkpoint(d, state, step=1)
    path2 = t_ckpt.save_checkpoint(d, state, step=2)
    assert t_ckpt.latest_checkpoint(d) == path2
    # an interrupted save leaves its temporary name behind: never selected
    (tmp_path / "step_00000009.tmp-4242").write_bytes(b"partial")
    assert t_ckpt.latest_checkpoint(d) == path2
    assert t_ckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    # a save that fails part-way leaves nothing behind, under any name
    def failing_save(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(t_ckpt.torch, "save", failing_save)
    with pytest.raises(OSError):
        t_ckpt.save_checkpoint(d, state, step=3)
    assert t_ckpt.latest_checkpoint(d) == path2
    assert not [f for f in os.listdir(d) if f.startswith("step_00000003")]


def test_trainer_resume_from_checkpoint(tmp_path, rng):
    """The JAX trainer's resume test on the port: 6 epochs saving every 2;
    a second trainer resumes after epoch 5, with the parameters and Adam's
    state of that save, and trains no further."""
    x, a_hat, c = _problem(rng)
    n = x.shape[0]
    y = rng.integers(0, c, n).astype(np.int32)
    lat, lon = rng.uniform(0, 10, n), rng.uniform(0, 10, n)
    med = np.full(c, 5.0)

    def mk_trainer():
        return Trainer(
            _model(x, a_hat, c, dropout=0.2),
            TrainConfig(epochs=6, patience=10, min_epochs=6, verbose=False,
                        checkpoint_dir=str(tmp_path), save_every=2),
        )

    kw = dict(lat=lat, lon=lon, class_lat_median=med, class_lon_median=med)
    first = mk_trainer()
    out1 = first.fit(y, np.arange(40), np.arange(40, 50), **kw)
    assert len(out1["history"]) == 6
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("step_")) == [
        "step_00000001", "step_00000003", "step_00000005"]
    saved = t_ckpt.restore_checkpoint(str(tmp_path / "step_00000005"))
    assert saved["opt_state"]["state"][0]["step"] == 6

    second = mk_trainer()
    out2 = second.fit(y, np.arange(40), np.arange(40, 50), **kw)
    assert len(out2["history"]) == 0
    for k, v in second.model.state_dict().items():
        assert torch.equal(v, saved["params"][k]), k
    assert second.optimizer.state_dict()["state"][0]["step"] == 6


def test_cli_eval_only_roundtrip(tmp_path):
    """Train with --checkpoint-dir, then --eval-only restores the saved
    parameters and reproduces the dev and test metrics without training,
    leaving the checkpoint untouched."""
    ckpt = tmp_path / "ckpt"
    common = ["--preset", "synthetic", "--quiet", "--hidden", "32", "32", "--device", "cpu",
              "--checkpoint-dir", str(ckpt)]
    trained = t_cli.main(common + ["--epochs", "15", "--patience", "15"])
    before = sorted(os.listdir(ckpt))
    assert before == [f"metrics_{trained['run']['best_epoch']:08d}.json",
                      f"step_{trained['run']['best_epoch']:08d}"]
    served = t_cli.main(common + ["--eval-only"])
    assert served["dev"] == trained["dev"] and served["test"] == trained["test"]
    assert served["run"]["history"] == [] and served["run"]["best_epoch"] == -1
    assert sorted(os.listdir(ckpt)) == before


def test_cli_eval_only_refusals(tmp_path):
    """As the JAX CLI: --eval-only needs --checkpoint-dir (checked when the
    flags are parsed) and a checkpoint in it, and excludes --tune."""
    with pytest.raises(SystemExit):
        t_cli.main(["--preset", "synthetic", "--quiet", "--device", "cpu", "--eval-only"])
    with pytest.raises(SystemExit, match="no checkpoint found"):
        t_cli.main(["--preset", "synthetic", "--quiet", "--device", "cpu", "--eval-only",
                    "--checkpoint-dir", str(tmp_path / "empty")])
    with pytest.raises(SystemExit):
        t_cli.parse_args(["--eval-only", "--tune", "3", "--checkpoint-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        t_cli.parse_args(["--eval-only"])
