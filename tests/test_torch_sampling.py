"""Neighbor-sampled training of the PyTorch port against the JAX package
(the single-device cases of ``tests/test_sampling.py``), on the CPU: the
sampler's batches and epoch orders (native and numpy paths), the row-capped
ELL, the segment reductions, the sampled forward, loss and every gradient,
a 2-epoch ``SampledTrainer.fit`` in both eval modes, and the CLI's
``--sampled`` run with its ``--eval-only`` round trip.

Tolerances: float32, rtol 2e-4 and atol 2e-5 (``TOL``, as
``tests/test_sampling.py``); ``gather_dtype="bfloat16"``, ``BF16_TOL`` (rtol
and atol 1e-2, as ``tests/test_torch_factorized.py``): both round W₀ and the
token values to bf16, but JAX sums dW₀'s bf16 rows in bf16 and the port in
float32; loss trajectories of a fit, rtol 1e-4 (as
``tests/test_torch_train_cli.py``). Integer arrays are held equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch import cli as t_cli
from graphconvgeo_torch.data.sampling import NeighborSampler as TSampler
from graphconvgeo_torch.models import gcn as t_gcn
from graphconvgeo_torch.models import sampled as t_sampled
from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.ops import scatter_gather as t_sg
from graphconvgeo_torch.sparse.formats import CappedEll as TCappedEll
from graphconvgeo_torch.sparse.formats import SparseGraph as TGraph
from graphconvgeo_torch.train import trainer as t_trainer
from graphconvgeo_torch.train.trainer_sampled import SampledTrainer as TSampledTrainer
from graphconvgeo_torch.train.trainer_sampled import prefetch
from graphconvgeo_tpu.data.sampling import NeighborSampler as JSampler
from graphconvgeo_tpu.models import gcn as j_gcn
from graphconvgeo_tpu.models import sampled as j_sampled
from graphconvgeo_tpu.ops import scatter_gather as j_sg
from graphconvgeo_tpu.sparse.formats import SparseGraph as JGraph
from graphconvgeo_tpu.sparse.formats import normalize_adjacency
from graphconvgeo_tpu.train import trainer as j_trainer
from graphconvgeo_tpu.train.trainer_sampled import SampledTrainer as JSampledTrainer
from tests.conftest import random_csr

TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
LOSS_RTOL = 1e-4


def _graph(rng, n=60, v=30):
    """(Â, X) as ``tests/test_sampling.py :: _setup`` draws them."""
    adj = random_csr(rng, n, n, 3, symmetric=True)
    adj.data = np.abs(adj.data)
    x = random_csr(rng, n, v, 5)
    x.data = np.abs(x.data).astype(np.float32)
    return normalize_adjacency(adj), x


def _outlier_x(rng, n, v, outlier_row=7, outlier_nnz=250):
    """A BoW matrix of ~7 tokens a row and one outlier document."""
    deg = rng.poisson(6, n) + 1
    deg[outlier_row] = outlier_nnz
    rows = np.repeat(np.arange(n), deg)
    cols = np.concatenate([rng.choice(v, d, replace=False) for d in deg])
    vals = np.abs(rng.normal(size=len(rows))).astype(np.float32)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, v)).tocsr()


def _models(x, a_hat, *, with_adj=True, **cfg_kw):
    """The JAX model with its parameters (key 0) and the port's model on the
    CPU holding the same parameters."""
    kw = dict(n_features=x.shape[1], hidden=(16, 16), highway=True)
    kw.update(cfg_kw)
    jm = j_gcn.HighwayGCN(j_gcn.GCNConfig(**kw), JGraph(csr=x),
                          JGraph(csr=a_hat, symmetric=True) if with_adj else None)
    params = jm.init(jax.random.key(0))
    tm = t_gcn.HighwayGCN(t_gcn.GCNConfig(**kw), TGraph(csr=x),
                          TGraph(csr=a_hat, symmetric=True) if with_adj else None, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _assert_batches_equal(tb, jb):
    for field in ("nodes", "node_mask", "edge_src", "edge_dst", "edge_val"):
        got, want = getattr(tb, field), getattr(jb, field)
        assert len(got) == len(want), field
        for g, w in zip(got, want):
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)
    np.testing.assert_array_equal(tb.targets, jb.targets)
    np.testing.assert_array_equal(tb.target_mask, jb.target_mask)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_sampler_batches_match_jax(rng, use_native):
    """Same CSR, seed, fanouts and targets: the same batches array for
    array, and the same epoch orders (the generator drawn in JAX's order),
    on both paths. Fanout 3 is below most degrees (distinct picks, rescaled
    values), fanout 8 above many."""
    a_hat, _ = _graph(rng)
    kw = dict(fanouts=(3, 8), batch_size=8, seed=5, use_native=use_native)
    ts, js = TSampler(a_hat, **kw), JSampler(a_hat, **kw)
    assert ts.native == (js._native is not None) == use_native
    targets = np.array([3, 7, 11, 19, 25, 33, 41, 59])
    _assert_batches_equal(ts.sample(targets), js.sample(targets))
    _assert_batches_equal(ts.sample(targets[:5]), js.sample(targets[:5]))  # padded batch
    t_epoch = list(ts.epoch(np.arange(50)))
    j_epoch = list(js.epoch(np.arange(50)))
    assert len(t_epoch) == len(j_epoch) == 7
    for tb, jb in zip(t_epoch, j_epoch):
        _assert_batches_equal(tb, jb)
    targets_deg = ts.deg[np.concatenate([b.nodes[0] for b in t_epoch])]
    assert (targets_deg > 3).any() and (targets_deg <= 3).any()  # rescaled and not


@pytest.mark.parametrize("overflow", [True, False], ids=["overflow", "no_overflow"])
def test_ell_capped_matches_jax(rng, overflow):
    """(main, ov, ov_id) as JAX builds them: the outlier's tail in overflow
    row 1 and the all-zero row 0; without an outlier ov and ov_id are None
    and main is the plain ELL."""
    n, v = 120, 300
    x = _outlier_x(rng, n, v) if overflow else random_csr(rng, n, v, 4)
    got = TGraph(csr=x).ell_capped(quantile=0.99)
    want = JGraph(csr=x).ell_capped(quantile=0.99)
    assert isinstance(got, TCappedEll) and got.n_cols == want.n_cols == v
    pairs = [(got.main, want.main)]
    if overflow:
        assert got.main.k < 64 and got.ov.n_rows == want.ov.n_rows == 2
        assert got.ov_id.dtype == torch.int32
        np.testing.assert_array_equal(got.ov_id.numpy(), np.asarray(want.ov_id))
        np.testing.assert_array_equal(got.ov.values[0].numpy(), 0.0)
        pairs.append((got.ov, want.ov))
    else:
        assert got.ov is got.ov_id is want.ov is want.ov_id is None
    for g, w in pairs:
        assert g.indices.dtype == torch.int32
        np.testing.assert_array_equal(g.indices.numpy(), np.asarray(w.indices))
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(w.values))


def test_segment_reductions_match_jax(rng):
    data = rng.normal(size=(40, 6)).astype(np.float32)
    seg = rng.integers(0, 9, 40)
    seg[seg == 4] = 5  # an empty segment
    for name in ("segment_sum", "segment_mean"):
        got = getattr(t_sg, name)(torch.from_numpy(data), torch.from_numpy(seg), 9)
        want = getattr(j_sg, name)(jnp.asarray(data), jnp.asarray(seg), 9)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=name)
    idx = rng.integers(0, 40, 17)
    got = t_sg.gather_rows(torch.from_numpy(data), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), data[idx])


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_sampled_forward_loss_grads_match_jax(rng, gather_dtype):
    """Dropout 0, a CappedEll input with an overflow tail, a batch reaching
    the outlier's neighborhood: logits, loss and the gradient of every
    parameter equal JAX's (float32: TOL; bf16 W₀ and values: BF16_TOL)."""
    n, v, c = 120, 300, 5
    x = _outlier_x(rng, n, v)
    adj = random_csr(rng, n, n, 3, symmetric=True)
    adj.data = np.abs(adj.data)
    a_hat = normalize_adjacency(adj)
    jm, params, tm = _models(x, a_hat, with_adj=False, n_classes=c, hidden=(8, 8),
                             dropout=0.0, gather_dtype=gather_dtype, l2=1e-3)
    j_x = JGraph(csr=x).ell_capped(quantile=0.99)
    t_x = TGraph(csr=x).ell_capped(quantile=0.99)
    assert t_x.ov is not None
    batch = JSampler(a_hat, fanouts=(3, 3), batch_size=16, seed=1).sample(np.arange(16))
    assert 7 in batch.nodes[-1]
    y = rng.integers(0, c, n)[batch.targets].astype(np.int32)
    mask = batch.target_mask
    j_bd = j_sampled.batch_to_device(batch)
    t_bd = t_sampled.batch_to_device(batch, "cpu")
    tol = TOL if gather_dtype is None else BF16_TOL

    want_logits = j_sampled.sampled_forward(params, jm.cfg, j_x, j_bd, train=False)
    got_logits = t_sampled.sampled_forward(tm, t_x, t_bd, train=False)
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(want_logits), **tol)

    j_loss, j_grads = jax.value_and_grad(
        lambda p: j_sampled.sampled_loss(p, jm.cfg, j_x, j_bd, jnp.asarray(y),
                                         jnp.asarray(mask), train=True)
    )(params)
    t_loss = t_sampled.sampled_loss(tm, t_x, t_bd, torch.from_numpy(y), torch.from_numpy(mask),
                                    train=True)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), **tol)
    want_grads = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got_grads = dict(tm.named_parameters())
    assert set(got_grads) == set(want_grads)
    for k, want in want_grads.items():
        np.testing.assert_allclose(got_grads[k].grad.float().numpy(), want.float().numpy(),
                                   **tol, err_msg=k)


def test_full_fanout_matches_full_graph(rng):
    """With fanout ≥ max degree the sampler keeps every edge unscaled, so
    the sampled forward equals the full-graph forward on the target rows."""
    a_hat, x = _graph(rng)
    _, _, tm = _models(x, a_hat, n_classes=4, dropout=0.3)
    max_deg = int(np.diff(a_hat.indptr).max())
    targets = np.array([3, 7, 11, 19, 25, 33, 41, 59])
    batch = TSampler(a_hat, fanouts=(max_deg, max_deg), batch_size=8, seed=1).sample(targets)
    with torch.no_grad():
        got = t_sampled.sampled_forward(tm, tm.x.ell(), t_sampled.batch_to_device(batch, "cpu"))
        want = tm.apply(train=False)[targets]
    np.testing.assert_allclose(got[: len(targets)].numpy(), want.numpy(), **TOL)


def test_sampled_dropout_keep_statistics(rng):
    """At rate > 0 the masks come from the generator: the same seed gives
    the same logits, another seed others; the input values keep 1 − rate of
    their entries, scaled by 1/(1 − rate); and on a model that is linear in
    every mask (no activation, no gate) the mean of many draws approaches
    the logits without dropout (inverted dropout is unbiased)."""
    rate = 0.3
    a_hat, x = _graph(rng)
    _, _, tm = _models(x, a_hat, with_adj=False, n_classes=4, highway=False,
                       activation="none", dropout=rate)
    x_ell = tm.x.ell()
    batch = TSampler(a_hat, fanouts=(4, 4), batch_size=16, seed=3).sample(np.arange(16))
    bd = t_sampled.batch_to_device(batch, "cpu")

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return t_sampled.sampled_forward(tm, x_ell, bd, train=True, generator=gen)

    assert torch.equal(draw(1), draw(1)) and not torch.equal(draw(1), draw(2))
    with torch.no_grad():
        ref = t_sampled.sampled_forward(tm, x_ell, bd, train=False)
        mean = sum(draw(s) for s in range(600)) / 600
    assert float((mean - ref).abs().max()) < 0.1 * float(ref.abs().max())

    ones = TGraph(csr=sp.csr_matrix((np.ones_like(x.data), x.indices, x.indptr), shape=x.shape))
    with torch.no_grad():
        tm.input.w.fill_(1.0)
        deep = torch.arange(x.shape[0]).repeat(200)
        h = t_sampled._input_bag(tm, ones.ell(), deep, drop=True,
                                 generator=torch.Generator().manual_seed(0))
    kept = h[:, 0] * (1.0 - rate)  # kept entries per row
    np.testing.assert_allclose(kept.numpy(), np.round(kept.numpy()), atol=1e-4)
    share = float(kept.sum()) / (x.nnz * 200)
    assert abs(share - (1.0 - rate)) < 0.01, share


@pytest.mark.parametrize("eval_mode,label_fraction",
                         [("full", 1.0), ("sampled", 1.0), ("full", 0.6)])
def test_sampled_fit_matches_jax(rng, eval_mode, label_fraction):
    """Two epochs at dropout 0 from the same parameters and sampler seeds:
    the per-epoch losses (rtol 1e-4) and dev metrics equal JAX's, also on
    a thinned target pool. The sampled eval runs on a model without an
    adjacency, with an eval sampler whose fanouts cover every degree."""
    n, c = 80, 4
    a_hat, x = _graph(rng, n=n)
    full = eval_mode == "full"
    jm, params, tm = _models(x, a_hat, with_adj=full, n_classes=c, dropout=0.0)
    state = params_from_jax(jax.tree.map(np.asarray, params))
    max_deg = int(np.diff(a_hat.indptr).max())
    y = rng.integers(0, c, n).astype(np.int32)
    fit_kw = dict(lat=rng.uniform(20, 50, n), lon=rng.uniform(-120, -70, n),
                  class_lat_median=rng.uniform(20, 50, c),
                  class_lon_median=rng.uniform(-120, -70, c))
    outs = {}
    for pkg, sampler_cls, trainer_cls, tcfg_cls, model, p in (
        ("jax", JSampler, JSampledTrainer, j_trainer.TrainConfig, jm, params),
        ("torch", TSampler, TSampledTrainer, t_trainer.TrainConfig, tm, state),
    ):
        trainer = trainer_cls(
            model, sampler_cls(a_hat, fanouts=(3, 3), batch_size=16, seed=0),
            tcfg_cls(epochs=2, min_epochs=2, patience=5, verbose=False, learning_rate=1e-2),
            eval_mode=eval_mode,
            eval_sampler=sampler_cls(a_hat, fanouts=(max_deg, max_deg), batch_size=16, seed=1),
        )
        out = trainer.fit(y, np.arange(50), np.arange(50, 65), params=p,
                          label_fraction=label_fraction, **fit_kw)
        test = trainer.evaluate(out["params"], np.arange(65, 80), **fit_kw)
        outs[pkg] = (out, test)
    (j_out, j_test), (t_out, t_test) = outs["jax"], outs["torch"]
    assert len(t_out["history"]) == len(j_out["history"]) == 2
    np.testing.assert_allclose([h["loss"] for h in t_out["history"]],
                               [h["loss"] for h in j_out["history"]], rtol=LOSS_RTOL)
    for th, jh in zip(t_out["history"], j_out["history"]):
        assert th["dev_acc_at_161"] == jh["dev_acc_at_161"]
        assert th["dev_median_km"] == pytest.approx(jh["dev_median_km"], rel=1e-9)
        assert set(th["launches"].values()) == set(th["step_launches"].values()) == {0}
    assert t_out["best_epoch"] == j_out["best_epoch"]
    assert t_test == pytest.approx(j_test, rel=1e-9)


def test_cli_sampled_and_eval_only_roundtrip(tmp_path):
    """``--sampled`` trains on the native sampler's batches with JAX's
    defaults (fanout 10 per layer) and saves its best parameters;
    ``--eval-only`` serves them full-graph with the same dev and test
    metrics, leaving the checkpoint untouched; ``--sampled --model gat`` is
    refused, as in JAX."""
    ckpt = tmp_path / "ckpt"
    common = ["--preset", "synthetic", "--quiet", "--hidden", "32", "32", "--device", "cpu",
              "--sampled", "--batch", "128", "--checkpoint-dir", str(ckpt), "--no-cache"]
    trained = t_cli.main(common + ["--epochs", "4", "--patience", "4"])
    run = trained["run"]
    assert (run["sampled"], run["sampler"], run["batch"], run["fanouts"]) == (
        True, "native", 128, [10, 10])
    assert len(run["history"]) == 4 and run["backend"] == "hybrid"
    losses = [h["loss"] for h in run["history"]]
    assert losses[-1] < losses[0] and trained["dev"]["acc_at_161"] >= 0.9
    assert all(set(h["launches"].values()) == {0} for h in run["history"])
    before = sorted(os.listdir(ckpt))
    assert before == [f"metrics_{run['best_epoch']:08d}.json", f"step_{run['best_epoch']:08d}"]
    served = t_cli.main(common + ["--eval-only"])
    assert served["dev"] == trained["dev"] and served["test"] == trained["test"]
    assert served["run"]["history"] == [] and sorted(os.listdir(ckpt)) == before
    args = t_cli.parse_args(["--sampled"])
    assert (args.batch, args.fanout) == (512, None)
    with pytest.raises(SystemExit):
        t_cli.parse_args(["--sampled", "--model", "gat"])


def test_sampled_entry_points_refuse_without_cuda(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main(["--preset", "synthetic", "--sampled", "--epochs", "1", "--quiet"])
    a_hat, x = _graph(rng)
    cfg = t_gcn.GCNConfig(n_features=x.shape[1], n_classes=3, hidden=(4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_gcn.HighwayGCN(cfg, TGraph(csr=x), None)


def test_prefetch_raises_and_stops():
    """An error in the sampling thread reaches the consumer, and leaving the
    loop early stops the thread."""
    def broken():
        yield 1
        raise ValueError("sampler failed")

    with pytest.raises(ValueError, match="sampler failed"):
        list(prefetch(broken()))
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = prefetch(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    n = len(produced)
    assert n <= 3 + 2 + 2  # consumed + queued + the one in hand, then stopped


def test_input_bag_padding_on_a_non_finite_w0(rng):
    """``models/sampled.py :: spread_slots`` points the ELL's padding slots
    (weight 0) at row ``j mod n_rows`` of W₀; JAX points them all at row 0.
    On a finite W₀ the two input layers agree. With W₀'s row 0 set to Inf,
    a weight 0 on it gives 0·Inf = NaN: in JAX on every node whose ELL row
    has a padding slot, in the port only on nodes with a padding slot j ≡ 0
    (mod V); a real token 0 gives Inf in both (NaN after the identity
    conv). So NaN reaches other rows than in JAX (a stated difference).
    The batch is one layer of self edges with identity weights, so each
    logits row is its node's input-layer row."""
    a_hat, x = _graph(rng)
    n, v = x.shape
    h = 8
    jm, params, tm = _models(x, a_hat, with_adj=False, n_classes=h, hidden=(h,),
                             highway=False, activation="none")
    params = jax.tree.map(np.array, params)  # writable copies
    params["layers"][0]["w"] = np.eye(h, dtype=np.float32)
    params["out"]["w"] = np.eye(h, dtype=np.float32)
    ids = np.arange(n)
    batch = _one_layer_batch(nodes=[ids, ids], edge_src=[ids], edge_dst=[ids],
                             edge_val=[np.ones(n, np.float32)])
    ell = tm.x.ell()
    pad = ell.values.numpy() == 0
    assert pad.any(axis=1).sum() > 1  # rows of other lengths: padding slots exist

    def logits(w0_row0):
        params["input"]["w"][0] = w0_row0
        tm.load_state_dict(params_from_jax(params))
        with torch.no_grad():
            got = t_sampled.sampled_forward(tm, ell, t_sampled.batch_to_device(batch, "cpu"))
        want = j_sampled.sampled_forward(jax.tree.map(jnp.asarray, params), jm.cfg,
                                         jm.x.ell(), j_sampled.batch_to_device(batch))
        return got.numpy(), np.asarray(want)

    got, want = logits(np.full(h, 0.25, np.float32))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got).all()

    got, want = logits(np.full(h, np.inf, np.float32))
    token0 = ((ell.indices.numpy() == 0) & ~pad).any(axis=1)
    spread_hits = (pad & (np.arange(pad.size).reshape(pad.shape) % v == 0)).any(axis=1)
    np.testing.assert_array_equal(np.isnan(want).all(axis=1), pad.any(axis=1) | token0)
    np.testing.assert_array_equal(np.isnan(got).all(axis=1), spread_hits | token0)
    assert np.isfinite(got[~(spread_hits | token0)]).all()
    assert (pad.any(axis=1) & ~spread_hits & ~token0).any()  # rows NaN in JAX only


def _one_layer_batch(*, nodes, edge_src, edge_dst, edge_val):
    """A one-layer SampledBatch (both packages read the same fields)."""
    from graphconvgeo_torch.data.sampling import SampledBatch

    return SampledBatch(
        nodes=nodes, node_mask=[np.ones(len(a), np.float32) for a in nodes],
        edge_src=edge_src, edge_dst=edge_dst, edge_val=edge_val,
        targets=nodes[0], target_mask=np.ones(len(nodes[0]), np.float32),
    )
