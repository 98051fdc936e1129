"""The PyTorch port's trainer and CLI: Adam steps against the JAX trainer,
and the CLI's healthy band on the synthetic preset (CPU), for the
Highway-GCN and the GAT on both attention operands."""

import json

import jax
import numpy as np
import pytest

from graphconvgeo_torch import cli as t_cli
from graphconvgeo_torch.data import pipeline as t_pipeline
from graphconvgeo_torch.models import gat as t_gat
from graphconvgeo_torch.models import gcn as t_gcn
from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.sparse.formats import SparseGraph as TGraph
from graphconvgeo_torch.train import trainer as t_trainer
from graphconvgeo_tpu.data.synthetic import make_synthetic_dumps
from graphconvgeo_tpu.models import gat as j_gat
from graphconvgeo_tpu.models import gcn as j_gcn
from graphconvgeo_tpu.sparse.formats import SparseGraph as JGraph
from graphconvgeo_tpu.train import trainer as j_trainer


def _synthetic_600(path):
    make_synthetic_dumps(path, n_users=600, n_clusters=6, seed=0)
    pcfg = t_pipeline.PreprocessConfig(bucket_size=30, min_df=2, celebrity_threshold=10)
    ds, _ = t_pipeline.preprocess(path, pcfg, use_cache=False).reorder()
    return ds


def test_adam_steps_match_jax_trainer(tmp_path):
    """Three full-graph Adam steps from the same parameters, dropout 0: the
    loss trajectory matches the JAX trainer's (optax.adam) at rtol 1e-4."""
    ds = _synthetic_600(str(tmp_path))
    common = dict(n_features=ds.x.shape[1], n_classes=ds.n_classes, hidden=(32, 32), dropout=0.0)
    fit_kw = dict(
        lat=ds.lat, lon=ds.lon,
        class_lat_median=ds.class_lat_median, class_lon_median=ds.class_lon_median,
    )
    jm = j_gcn.HighwayGCN(
        j_gcn.GCNConfig(**common), JGraph(csr=ds.x), JGraph(csr=ds.adj, symmetric=True)
    )
    params = jm.init(jax.random.key(2))
    j_out = j_trainer.Trainer(
        jm, j_trainer.TrainConfig(learning_rate=5e-3, epochs=3, verbose=False)
    ).fit(ds.y, ds.train_idx, ds.dev_idx, params=params, **fit_kw)

    tm = t_gcn.HighwayGCN(
        t_gcn.GCNConfig(**common), TGraph(csr=ds.x), TGraph(csr=ds.adj, symmetric=True),
        device="cpu",
    )
    assert tm.backend == "hybrid"
    log = tmp_path / "metrics.jsonl"
    t_out = t_trainer.Trainer(
        tm, t_trainer.TrainConfig(learning_rate=5e-3, epochs=3, verbose=False,
                                  metrics_path=str(log))
    ).fit(
        ds.y, ds.train_idx, ds.dev_idx,
        params=params_from_jax(jax.tree.map(np.asarray, params)), **fit_kw,
    )
    want = [h["loss"] for h in j_out["history"]]
    got = [h["loss"] for h in t_out["history"]]
    assert len(got) == len(want) == 3
    assert got[2] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    logged = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["loss"] for r in logged] == got


def test_cli_synthetic_healthy_band(capsys):
    report = t_cli.main([
        "--preset", "synthetic", "--epochs", "25", "--patience", "25",
        "--hidden", "32", "32", "--device", "cpu", "--json", "--no-cache",
    ])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {"dev", "test"}
    assert printed["dev"] == pytest.approx(report["dev"])
    assert report["dev"]["acc_at_161"] >= 0.9
    run = report["run"]
    assert run["backend"] == "hybrid" and run["n_tiles"] > 0
    assert run["device"] == "cpu" and len(run["history"]) == 25
    # CPU tensors take the plain versions: no epoch launched a kernel
    assert all(set(h["launches"].values()) == {0} for h in run["history"])
    assert "bsr_flat_matmul" in run["history"][0]["launches"]


@pytest.mark.parametrize("backend", ["bsr", "ell", "oracle"])
def test_cli_synthetic_backends_healthy_band(backend):
    """The GCN on the other single-device backends: the same healthy band
    as the default path, no kernel launched on the CPU."""
    report = t_cli.main([
        "--preset", "synthetic", "--epochs", "10", "--patience", "10", "--backend", backend,
        "--hidden", "32", "32", "--device", "cpu", "--json", "--no-cache", "--quiet",
    ])
    assert report["dev"]["acc_at_161"] >= 0.9
    run = report["run"]
    assert (run["backend"], run["device"], len(run["history"])) == (backend, "cpu", 10)
    assert (run["n_tiles"] > 0) == (backend == "bsr")
    assert all(set(h["launches"].values()) == {0} for h in run["history"])
    assert "bsr_matmul" in run["history"][0]["launches"]


def test_gat_adam_steps_match_jax_trainer(tmp_path):
    """Three Adam steps of the GAT (tiled operand), dropout 0: the loss
    trajectory matches the JAX trainer's at rtol 1e-4."""
    ds = _synthetic_600(str(tmp_path))
    common = dict(n_features=ds.x.shape[1], n_classes=ds.n_classes, hidden=(32, 32),
                  heads=2, dropout=0.0, att_backend="tiled")
    fit_kw = dict(
        lat=ds.lat, lon=ds.lon,
        class_lat_median=ds.class_lat_median, class_lon_median=ds.class_lon_median,
    )
    jm = j_gat.GraphAttentionNet(
        j_gat.GATConfig(**common), JGraph(csr=ds.x), JGraph(csr=ds.adj, symmetric=True)
    )
    params = jm.init(jax.random.key(2))
    j_out = j_trainer.Trainer(
        jm, j_trainer.TrainConfig(learning_rate=5e-3, epochs=3, verbose=False)
    ).fit(ds.y, ds.train_idx, ds.dev_idx, params=params, **fit_kw)
    tm = t_gat.GraphAttentionNet(
        t_gat.GATConfig(**common), TGraph(csr=ds.x), TGraph(csr=ds.adj, symmetric=True),
        device="cpu",
    )
    t_out = t_trainer.Trainer(
        tm, t_trainer.TrainConfig(learning_rate=5e-3, epochs=3, verbose=False)
    ).fit(
        ds.y, ds.train_idx, ds.dev_idx,
        params=params_from_jax(jax.tree.map(np.asarray, params)), **fit_kw,
    )
    want = [h["loss"] for h in j_out["history"]]
    got = [h["loss"] for h in t_out["history"]]
    assert len(got) == len(want) == 3
    assert got[2] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("att_backend", ["bucketed", "tiled"])
def test_cli_gat_synthetic_healthy_band(att_backend):
    report = t_cli.main([
        "--preset", "synthetic", "--model", "gat", "--heads", "2", "--att-backend", att_backend,
        "--epochs", "25", "--patience", "25", "--hidden", "32", "32", "--device", "cpu",
        "--json", "--no-cache", "--quiet",
    ])
    assert report["dev"]["acc_at_161"] >= 0.9
    run = report["run"]
    assert (run["model"], run["att_backend"], run["device"]) == ("gat", att_backend, "cpu")
    assert len(run["history"]) == 25
    assert (run["n_tiles"] > 0) == (att_backend == "tiled")
    assert run["tiled_edges"] + run["rest_edges"] > 0
    assert all(set(h["launches"].values()) == {0} for h in run["history"])


def test_cli_preset_flags():
    a = t_cli.parse_args(["--preset", "geotext", "-d", "/tmp/x"])
    assert (a.bucket, a.encoding, a.min_df, a.hidden, a.device) == (
        50, "latin1", 10, (300, 300), "cuda")
    o = t_cli.parse_args(["--preset", "geotext", "-d", "/tmp/x", "--bucket", "7"])
    assert o.bucket == 7
    with pytest.raises(SystemExit):
        t_cli.parse_args(["--hidden", "32", "16"])
    g = t_cli.parse_args(["--model", "gat", "--hidden", "32", "16"])  # no highway check
    assert (g.model, g.heads, g.attn_dropout, g.att_backend) == ("gat", 4, 0.0, "bucketed")
    with pytest.raises(SystemExit):
        t_cli.parse_args(["--model", "gat", "--heads", "3", "--hidden", "32", "32"])
