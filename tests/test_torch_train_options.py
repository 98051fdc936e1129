"""The PyTorch port's remaining single-device options against the JAX
package: remat (against no remat), ``dtype="bfloat16"`` (and the GAT's
``gather_dtype``), ``label_fraction``,
``monitor="median_km"``, ``--tune``'s trials, ``--profile-dir``,
``roofline_report`` and ``device_seconds_per_iter``, ``debug_nans``, the
presets and the CLI's input-layer flags, all on the CPU.

Tolerances: remat against no remat, rtol 1e-5 (the same products, the
backward re-running the forward); bf16 against JAX, the repo's bf16 limits
(loss rtol 1e-3, activations and gradients 2e-2 × max|ref|: the same
roundings in another summation order can land a partial on the
neighbouring bf16, 2^-8 relative); loss trajectories rtol 1e-4 (as
``test_torch_train_cli.py``).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphconvgeo_torch import cli as t_cli
from graphconvgeo_torch.data.synthetic import make_synthetic_dumps
from graphconvgeo_torch.models import gat as t_gat
from graphconvgeo_torch.models import gcn as t_gcn
from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.sparse.formats import SparseGraph as TGraph
from graphconvgeo_torch.train import trainer as t_trainer
from graphconvgeo_torch.utils import profiling as t_prof
from graphconvgeo_torch.utils import timing as t_timing
from graphconvgeo_tpu import cli as j_cli
from graphconvgeo_tpu.models import gcn as j_gcn
from graphconvgeo_tpu.sparse.formats import SparseGraph as JGraph
from graphconvgeo_tpu.sparse.formats import normalize_adjacency
from graphconvgeo_tpu.train import trainer as j_trainer
from graphconvgeo_tpu.utils import profiling as j_prof
from tests.conftest import random_csr

BF16_LOSS_RTOL = 1e-3
BF16_REL = 2e-2


def _problem(rng, n=90, v=40, c=7):
    x = random_csr(rng, n, v, 6)
    x.data = np.abs(x.data).astype(np.float32)
    adj = random_csr(rng, n, n, 4, symmetric=True)
    adj.data = np.abs(adj.data)
    y = rng.integers(0, c, n).astype(np.int32)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    return x, normalize_adjacency(adj), c, y, mask


def _rel_close(got, want, rel, what):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{what}: max|diff| {err}"


def _loss_and_grads(model, y, mask, **kw):
    model.zero_grad(set_to_none=True)
    loss = model.loss(torch.from_numpy(y), torch.from_numpy(mask), train=True, **kw)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("family,operand", [("gcn", "hybrid"), ("gcn", "bell"),
                                            ("gat", "bucketed"), ("gat", "tiled")])
def test_remat_matches_no_remat(rng, family, operand):
    """Train mode with every dropout on (the GAT's attention dropout too):
    the remat model's loss and gradients equal the plain model's, so the
    recomputed layers drew the same masks (the dense dropout stays outside
    the checkpoint; the attention dropout is keyed by the layer's seed)."""
    x, a_hat, c, y, mask = _problem(rng)
    graphs = (TGraph(csr=x), TGraph(csr=a_hat, symmetric=True))

    def build(remat):
        if family == "gat":
            cfg = t_gat.GATConfig(n_features=x.shape[1], n_classes=c, hidden=(32, 32), heads=2,
                                  dropout=0.3, attn_dropout=0.35, att_backend=operand,
                                  remat=remat)
            return t_gat.GraphAttentionNet(cfg, *graphs, device="cpu", seed=5)
        cfg = t_gcn.GCNConfig(n_features=x.shape[1], n_classes=c, hidden=(32, 32),
                              dropout=0.3, spmm_backend=operand, remat=remat)
        return t_gcn.HighwayGCN(cfg, *graphs, device="cpu", seed=5)

    results = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(11)
        results.append(_loss_and_grads(build(remat), y, mask, x_seed=1234, generator=gen))
    (l0, g0), (l1, g1) = results
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("backend", ["bell", "ell", "bsr", "hybrid"])
def test_bf16_dtype_matches_jax(rng, backend):
    """``dtype="bfloat16"``: bf16 parameters and input-layer output, float32
    from the first conv on (JAX's promotion); activations, loss and the
    bf16 gradients against JAX's at the bf16 limits."""
    x, a_hat, c, y, mask = _problem(rng)
    common = dict(n_features=x.shape[1], n_classes=c, hidden=(32, 32), dropout=0.0,
                  spmm_backend=backend, dtype="bfloat16")
    jm = j_gcn.HighwayGCN(j_gcn.GCNConfig(**common), JGraph(csr=x),
                          JGraph(csr=a_hat, symmetric=True))
    params = jm.init(jax.random.key(1))
    tm = t_gcn.HighwayGCN(t_gcn.GCNConfig(**common), TGraph(csr=x),
                          TGraph(csr=a_hat, symmetric=True), device="cpu")
    state = params_from_jax(jax.tree.map(np.asarray, params))
    assert {v.dtype for v in state.values()} == {torch.bfloat16}
    tm.load_state_dict(state)

    with torch.no_grad():
        got = tm.hidden_states(train=False)
    want = jm.hidden_states(params, train=False)
    assert [g.dtype for g in got] == [torch.bfloat16] + [torch.float32] * (len(got) - 1)
    assert [str(w.dtype) for w in want] == ["bfloat16"] + ["float32"] * (len(want) - 1)
    for i, (g_, w_) in enumerate(zip(got, want)):
        _rel_close(g_, np.asarray(w_, np.float32), BF16_REL, f"layer {i}")

    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, a: jm.loss(p, jnp.asarray(y), jnp.asarray(mask), a, train=True)
    ))(params, jm.arrays)
    t_loss, t_grads = _loss_and_grads(tm, y, mask)
    assert np.isfinite(t_loss)
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=BF16_LOSS_RTOL)
    want_g = params_from_jax(jax.tree.map(np.asarray, j_grads))
    for k, g_ in t_grads.items():
        assert g_.dtype == torch.bfloat16, k
        _rel_close(g_, want_g[k].float().numpy(), BF16_REL, k)


@pytest.mark.parametrize("att_backend", ["bucketed", "tiled"])
@pytest.mark.parametrize("option", ["dtype", "gather_dtype"])
def test_gat_bf16_options_match_jax(rng, att_backend, option):
    """The GAT with ``dtype="bfloat16"`` (bf16 parameters; the attention
    runs in float32 from the promoted operands, as JAX's does) or with
    ``gather_dtype="bfloat16"`` (the input layer's W0 gathers only): loss
    and gradients against JAX's at the bf16 limits."""
    from graphconvgeo_tpu.models import gat as j_gat

    x, a_hat, c, y, mask = _problem(rng)
    common = dict(n_features=x.shape[1], n_classes=c, hidden=(32, 32), heads=2, dropout=0.0,
                  att_backend=att_backend, **{option: "bfloat16"})
    jm = j_gat.GraphAttentionNet(j_gat.GATConfig(**common), JGraph(csr=x),
                                 JGraph(csr=a_hat, symmetric=True))
    params = jm.init(jax.random.key(1))
    tm = t_gat.GraphAttentionNet(t_gat.GATConfig(**common), TGraph(csr=x),
                                 TGraph(csr=a_hat, symmetric=True), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, a: jm.loss(p, jnp.asarray(y), jnp.asarray(mask), a, train=True)
    ))(params, jm.arrays)
    t_loss, t_grads = _loss_and_grads(tm, y, mask)
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=BF16_LOSS_RTOL)
    want_g = params_from_jax(jax.tree.map(np.asarray, j_grads))
    # each gradient in its parameter's dtype (JAX's tiled custom VJP hands
    # back float32 cotangents for the bf16 attention vectors)
    param_dtype = torch.bfloat16 if option == "dtype" else torch.float32
    for k, g_ in t_grads.items():
        assert g_.dtype == param_dtype, k
        _rel_close(g_, want_g[k].float().numpy(), BF16_REL, k)


def _fit_kw(rng, n, c):
    return dict(lat=rng.uniform(0, 10, n), lon=rng.uniform(0, 10, n),
                class_lat_median=np.full(c, 5.0), class_lon_median=np.full(c, 5.0))


def test_label_fraction_keeps_jax_labels(rng):
    """``label_fraction=0.5`` keeps the same training labels as the JAX
    trainer: from the same parameters at dropout 0 the loss trajectories
    agree (rtol 1e-4), and differ from the full label set's."""
    x, a_hat, c, y, _ = _problem(rng)
    n = x.shape[0]
    common = dict(n_features=x.shape[1], n_classes=c, hidden=(16, 16), dropout=0.0)
    kw = _fit_kw(rng, n, c)
    train_idx, dev_idx = np.arange(60), np.arange(60, 80)
    jm = j_gcn.HighwayGCN(j_gcn.GCNConfig(**common), JGraph(csr=x),
                          JGraph(csr=a_hat, symmetric=True))
    params = jm.init(jax.random.key(2))
    tcfg = dict(learning_rate=5e-3, epochs=3, verbose=False, seed=9)
    j_out = j_trainer.Trainer(jm, j_trainer.TrainConfig(**tcfg)).fit(
        y, train_idx, dev_idx, params=params, label_fraction=0.5, **kw)
    state = params_from_jax(jax.tree.map(np.asarray, params))
    losses = {}
    for frac in (0.5, 1.0):
        tm = t_gcn.HighwayGCN(t_gcn.GCNConfig(**common), TGraph(csr=x),
                              TGraph(csr=a_hat, symmetric=True), device="cpu")
        out = t_trainer.Trainer(tm, t_trainer.TrainConfig(**tcfg)).fit(
            y, train_idx, dev_idx, params=state, label_fraction=frac, **kw)
        losses[frac] = [h["loss"] for h in out["history"]]
    np.testing.assert_allclose(losses[0.5], [h["loss"] for h in j_out["history"]], rtol=1e-4)
    assert abs(losses[1.0][0] - losses[0.5][0]) > 1e-3


def _scripted_geo_eval(script):
    """A geo_eval that returns the scripted (acc, median) of each call."""
    calls = iter(script)

    def geo_eval(*_):
        acc, med = next(calls)
        return {"acc_at_161": acc, "mean_km": med, "median_km": med,
                "distances": np.zeros(1)}

    return geo_eval


@pytest.mark.parametrize("monitor", ["median_km", "acc_at_161"])
def test_monitor_stops_at_jax_epoch(rng, monkeypatch, monitor):
    """On the same dev history (a scripted geo_eval in both trainers), the
    port stops where JAX stops and keeps the same best epoch: Acc@161 rises
    throughout, the median error is best at epoch 3, so ``median_km``
    stops after patience 3 and ``acc_at_161`` runs all 12 epochs."""
    x, a_hat, c, y, _ = _problem(rng)
    n = x.shape[0]
    script = [(0.1 + 0.05 * e, [900, 500, 300, 100, 150, 200, 250, 300, 350, 400, 450, 500][e])
              for e in range(12)]
    common = dict(n_features=x.shape[1], n_classes=c, hidden=(8, 8), dropout=0.0)
    tcfg = dict(epochs=12, patience=3, min_epochs=2, monitor=monitor, verbose=False)
    kw = _fit_kw(rng, n, c)
    idx = (np.arange(60), np.arange(60, 80))

    monkeypatch.setattr(j_trainer, "geo_eval", _scripted_geo_eval(script))
    jm = j_gcn.HighwayGCN(j_gcn.GCNConfig(**common), JGraph(csr=x),
                          JGraph(csr=a_hat, symmetric=True))
    j_out = j_trainer.Trainer(jm, j_trainer.TrainConfig(**tcfg)).fit(y, *idx, **kw)
    monkeypatch.setattr(t_trainer, "geo_eval", _scripted_geo_eval(script))
    tm = t_gcn.HighwayGCN(t_gcn.GCNConfig(**common), TGraph(csr=x),
                          TGraph(csr=a_hat, symmetric=True), device="cpu")
    t_out = t_trainer.Trainer(tm, t_trainer.TrainConfig(**tcfg)).fit(y, *idx, **kw)
    assert len(t_out["history"]) == len(j_out["history"]) == (7 if monitor == "median_km" else 12)
    assert t_out["best_epoch"] == j_out["best_epoch"] == (3 if monitor == "median_km" else 11)
    with pytest.raises(ValueError, match="monitor"):
        t_trainer.TrainConfig(monitor="mean_km")


def test_tune_trials_match_jax(monkeypatch, capsys):
    """``--tune 3`` tries the same configurations as the JAX CLI (the same
    ``default_rng(seed)`` draws): each CLI's run_one is replaced by a stub,
    so the printed trials are compared without training."""
    dev = {"acc_at_161": 0.5, "mean_km": 1.0, "median_km": 1.0}
    ds = types.SimpleNamespace(n_nodes=1, adj=types.SimpleNamespace(nnz=0),
                               x=np.zeros((1, 1)), n_classes=1)
    monkeypatch.setattr(j_cli, "load_dataset", lambda args: ds)
    monkeypatch.setattr(j_cli, "run_one", lambda *a, **k: (None, dev, dev))
    argv = ["--preset", "synthetic", "--tune", "3", "--quiet", "--hidden", "48", "48",
            "--seed", "4"]
    j_cli.main(argv)
    want = [l.split(" -> ")[0] for l in capsys.readouterr().out.splitlines()
            if l.startswith("tune[")]
    monkeypatch.setattr(t_cli, "run_one", lambda *a, **k: (None, dev, dev, None))
    t_cli.tune(t_cli.parse_args(argv + ["--device", "cpu"]), ds)
    got = [l.split(" -> ")[0] for l in capsys.readouterr().out.splitlines()
           if l.startswith("tune[")]
    assert len(want) == 3 and got == want


def test_cli_tune_end_to_end(capsys):
    report = t_cli.main(["--preset", "synthetic", "--tune", "2", "--epochs", "2", "--patience",
                         "2", "--quiet", "--hidden", "32", "32", "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("tune[")]
    assert len(lines) == 2 and all("'hidden':" in l for l in lines)
    assert len(report["run"]["history"]) == 2


def test_profile_dir_trace_holds_named_ranges(tmp_path):
    """``--profile-dir``: a Chrome trace of the profiled epochs whose events
    include the model's named ranges (the JAX package's named scopes)."""
    trace_dir = tmp_path / "trace"
    t_cli.main(["--preset", "synthetic", "--epochs", "5", "--patience", "5", "--quiet",
                "--hidden", "16", "16", "--device", "cpu", "--profile-dir", str(trace_dir)])
    events = json.loads((trace_dir / t_prof.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"input_layer", "conv_0", "conv_1", "output_layer"} <= names


def test_roofline_report_matches_jax():
    """The port's H100 report is JAX's arithmetic with the H100's limits."""
    kw = dict(nnz=208_783, n_rows=9475, feat=300, seconds=1e-4)
    got = t_prof.roofline_report(**kw)
    h = t_prof.H100
    want = j_prof.roofline_report(**kw, chip={"hbm_gbps": h["hbm_bytes_per_s"] / 1e9,
                                              "f32_tflops": h["f32_flops"] / 1e12})
    assert got.keys() == want.keys() and got["memory_bound"] == want["memory_bound"]
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    assert got["memory_bound"] and 0 < got["roofline_fraction"] < 1


def test_device_seconds_per_iter_on_cpu(monkeypatch):
    """On a CPU tensor the differenced protocol times the step by the host's
    clock, and a run's fixed cost cancels: on a fake clock that each step
    advances by exactly 2 ms and each reading by a fixed 0.75 ms, every
    differenced measurement is the step's 2 ms."""
    now = [0.0]

    def perf_counter():
        now[0] += 7.5e-4  # a run's fixed cost: two readings
        return now[0]

    def step(x):
        now[0] += 2e-3
        return x + 1

    monkeypatch.setattr(t_timing.time, "perf_counter", perf_counter)
    secs = t_timing.device_trial_seconds(step, torch.zeros(4), iters_lo=1, iters_hi=5, trials=2)
    assert len(secs) == 2
    assert secs == pytest.approx([2e-3, 2e-3])
    best = t_timing.device_seconds_per_iter(step, torch.zeros(4), iters_lo=1, iters_hi=5)
    assert best == pytest.approx(2e-3)


def test_debug_nans_raises(rng):
    x, a_hat, c, y, mask = _problem(rng)
    cfg = t_gcn.GCNConfig(n_features=x.shape[1], n_classes=c, hidden=(8, 8), dropout=0.0)
    model = t_gcn.HighwayGCN(cfg, TGraph(csr=x), TGraph(csr=a_hat, symmetric=True),
                             device="cpu")
    with torch.no_grad():
        model.input.w[0, 0] = float("nan")
    trainer = t_trainer.Trainer(model, t_trainer.TrainConfig(debug_nans=True))
    with pytest.raises(FloatingPointError):
        trainer.train_step(torch.from_numpy(y), torch.from_numpy(mask))


def test_presets_match_jax():
    assert t_cli.PRESETS == j_cli.PRESETS
    a = t_cli.parse_args(["--preset", "twitter-us", "-d", "/nowhere"])
    assert a.slab_dtype == "bfloat16"
    assert t_cli.parse_args(["--preset", "geotext", "-d", "/nowhere"]).slab_dtype is None


def test_cli_input_flags_record_the_slab(tmp_path):
    """``--input slab --slab-dtype bfloat16 --slab-cols 128`` on 1,100
    synthetic users: the run record names a bf16 slab of 128 columns with a
    bucketed-ELL rest, the operand JAX's CLI flags build (the same
    columns)."""
    make_synthetic_dumps(str(tmp_path), n_users=1100, n_clusters=32, seed=0)
    flags = ["--preset", "synthetic", "-d", str(tmp_path), "--input", "slab",
             "--slab-dtype", "bfloat16", "--slab-cols", "128", "--quiet"]
    report = t_cli.main(flags + ["--epochs", "2", "--patience", "2", "--hidden", "16", "16",
                                 "--device", "cpu", "--no-cache"])
    run = report["run"]
    assert (run["input_operand"], run["slab_dtype"], run["slab_cols"], run["input_rest"]) == (
        "SlabbedBell", "bfloat16", 128, "BucketedEll")
    args = t_cli.parse_args(flags + ["--device", "cpu"])
    ds = t_cli.load_dataset(args)
    t_op = t_gcn.input_operands_of(t_cli._model_config(args, ds), TGraph(csr=ds.x))["x"]
    j_args = j_cli.parse_args(flags)
    j_op = j_gcn.build_input_operands(JGraph(csr=ds.x), input_backend="slab", slab_cols=128,
                                      slab_dtype=j_args.slab_dtype)["x"]
    np.testing.assert_array_equal(t_op.cols.numpy(), np.asarray(j_op.cols))
