"""Data-parallel neighbor-sampled training of the port
(``graphconvgeo_torch/parallel/sampled_dist.py``) against the JAX package's
``DistSampledTrainer`` on 4 of conftest's 8 virtual CPU devices.

- In this process: ``stack_batches`` array-equal to JAX's, with a ragged
  tail (3 real sub-batches of 4).
- Ranks: one group of 4 spawned gloo ranks
  (``tests/test_torch_parallel.py :: spawn_ranks``; the ranks never import
  JAX) runs every case: ``dist_sampled_loss`` and every gradient after the
  one all-reduce, on 4 real sub-batches and on 3 of 4 (loss rtol 1e-5,
  gradients rtol 2e-4 / atol 1e-6, ``tests/test_parallel_sampled.py``'s
  tolerances); the loss at world 1, 2 and 4 (subgroups) against the
  single-device composition of the same sub-batches; each rank's
  sub-batches over two epochs array-equal to position r of JAX's
  ``_stacked_epoch`` (native and numpy sampler); ``DistSampledTrainer``
  against JAX's (loss history at rtol 1e-4, dev metrics, at dropout 0; with
  ``label_fraction`` 0.5 the same thinned target pool exactly and
  ``eval_mode="sampled"``), and its parameters bit-equal across the ranks.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from graphconvgeo_torch.data.sampling import NeighborSampler as TSampler
from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.models.gcn import GCNConfig as TCfg
from graphconvgeo_torch.models.gcn import HighwayGCN as THighwayGCN
from graphconvgeo_torch.models.sampled import batch_to_device, sampled_forward
from graphconvgeo_torch.parallel import mesh as t_mesh
from graphconvgeo_torch.parallel import sampled_dist as t_sd
from graphconvgeo_torch.parallel.model_dist import sum_gradients
from graphconvgeo_torch.sparse.formats import SparseGraph as TGraph
from graphconvgeo_torch.sparse.formats import to_device
from graphconvgeo_torch.train.trainer import TrainConfig as TTrainConfig
from tests.test_torch_parallel import spawn_ranks

WORLD = 4
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
HISTORY_RTOL = 1e-4
SEED = 3
EPOCHS = 4
LF_EPOCHS = 2
LABEL_FRACTION = 0.5


def _problem() -> dict:
    """``tests/test_parallel_sampled.py :: _setup``'s problem at 200 nodes,
    batch 12 a rank: 150 train targets make steps of 48, the last one with
    1 real sub-batch of 6 targets; label_fraction 0.5's pool a last step
    of 3 real sub-batches."""
    from tests.conftest import random_csr
    from graphconvgeo_torch.sparse.formats import normalize_adjacency

    rng = np.random.default_rng(11)
    n, v = 200, 40
    adj = random_csr(rng, n, n, 4, symmetric=True)
    adj.data = np.abs(adj.data)
    x = random_csr(rng, n, v, 5)
    return dict(
        a_hat=normalize_adjacency(adj), x=x, y=rng.integers(0, 6, n).astype(np.int32),
        cfg_kw=dict(n_features=v, n_classes=6, hidden=(16, 16), highway=True, dropout=0.0,
                    l2=1e-4, activation="tanh"),
        sampler_kw=dict(fanouts=(3, 3), batch_size=12, seed=SEED),
        train_idx=np.arange(150), dev_idx=np.arange(150, 200),
        geo=dict(lat=rng.normal(size=n), lon=rng.normal(size=n),
                 class_lat_median=np.zeros(6), class_lon_median=np.zeros(6)),
        step_targets=rng.permutation(n)[: 12 * WORLD],
    )


@functools.cache
def _jax():
    """The JAX package's modules, the problem's JAX model and parameters
    (imported and built here, never by a rank)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from graphconvgeo_tpu.data.sampling import NeighborSampler as JSampler
    from graphconvgeo_tpu.models.gcn import GCNConfig, HighwayGCN
    from graphconvgeo_tpu.parallel import sampled_dist as j_sd
    from graphconvgeo_tpu.sparse.formats import SparseGraph
    from graphconvgeo_tpu.train.trainer import TrainConfig

    prob = _problem()
    model = HighwayGCN(GCNConfig(**prob["cfg_kw"]), SparseGraph(csr=prob["x"]),
                       SparseGraph(csr=prob["a_hat"], symmetric=True))
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    return SimpleNamespace(jax=jax, jnp=jnp, mesh=Mesh(np.array(jax.devices()[:WORLD]), ("graph",)),
                           Sampler=JSampler, sd=j_sd, TrainConfig=TrainConfig, model=model,
                           params=params, prob=prob)


def _sub_batches(sampler, targets):
    bsz = sampler.batch_size
    return [sampler.sample(targets[j : j + bsz]) for j in range(0, len(targets), bsz)]


# ---- what the ranks run --------------------------------------------------------
def _port_model(prob, params):
    model = THighwayGCN(TCfg(**prob["cfg_kw"]), TGraph(csr=prob["x"]),
                        TGraph(csr=prob["a_hat"], symmetric=True), device="cpu")
    model.load_state_dict(params)
    return model


def _loss_grads(model, x_ell, subs, prob, mesh) -> dict:
    """The rank's dist_sampled_loss on its sub-batch (an empty one past
    ``subs``), backpropagated, the gradients summed by sum_gradients."""
    sampler = TSampler(prob["a_hat"], **prob["sampler_kw"])
    batch = subs[mesh.rank] if mesh.rank < len(subs) else sampler.empty_batch()
    bd = batch_to_device(batch, "cpu")
    y = torch.as_tensor(prob["y"], dtype=torch.int64)[bd["nodes"][0]]
    model.zero_grad(set_to_none=True)
    share = t_sd.dist_sampled_loss(model, x_ell, bd, y, mesh, train=True)
    share.backward()
    loss = sum_gradients(model, share, mesh)
    return dict(loss=float(loss), grads={k: p.grad.numpy().copy()
                                         for k, p in model.named_parameters()})


class _Recording(t_sd.DistSampledTrainer):
    """Records the target pool of each epoch (after label_fraction's thinning)."""

    def rank_batches(self, train_idx, rng_np):
        self.pools.append(np.array(train_idx))
        return super().rank_batches(train_idx, rng_np)


def _trainer_runs(prob, params, mesh) -> dict:
    def fit(cfg, **kw):
        sampler = TSampler(prob["a_hat"], **prob["sampler_kw"])
        eval_mode = kw.pop("eval_mode", "full")
        trainer = _Recording(_port_model(prob, params), sampler, mesh, cfg, eval_mode=eval_mode)
        trainer.pools = []
        out = trainer.fit(prob["y"], prob["train_idx"], prob["dev_idx"], **prob["geo"], **kw)
        return dict(history=out["history"], best_epoch=out["best_epoch"], pools=trainer.pools,
                    params={k: v.numpy().copy() for k, v in out["params"].items()})

    base = dict(learning_rate=5e-3, verbose=False, seed=SEED)
    return dict(
        full=fit(TTrainConfig(epochs=EPOCHS, patience=EPOCHS, **base)),
        lf=fit(TTrainConfig(epochs=LF_EPOCHS, patience=LF_EPOCHS, **base),
               label_fraction=LABEL_FRACTION, eval_mode="sampled"),
    )


def _rank_epochs(prob, params, mesh, native: bool) -> list:
    """The rank's sub-batches of two epochs (DistSampledTrainer.rank_batches
    from one rng_np, as fit drives it)."""
    sampler = TSampler(prob["a_hat"], **prob["sampler_kw"], use_native=native)
    trainer = t_sd.DistSampledTrainer(_port_model(prob, params), sampler, mesh,
                                      TTrainConfig(seed=SEED))
    rng_np = np.random.default_rng(SEED)
    return [list(trainer.rank_batches(prob["train_idx"], rng_np)) for _ in range(2)]


def _all_cases(rank, world, prob, params, subs):
    mesh = t_mesh.make_graph_mesh("cpu")
    model = _port_model(prob, params)
    x_ell = to_device(model.x.ell_capped(), "cpu")
    out = {"loss": {n_real: _loss_grads(model, x_ell, subs[:n_real], prob, mesh)
                    for n_real in (WORLD, 3)}}
    singles = [dist.new_group([r]) for r in range(world)]
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    out["world_loss"] = {world: out["loss"][WORLD]["loss"]}
    for group in (pairs[rank // 2], singles[rank]):
        sub = t_mesh.make_graph_mesh("cpu", group=group)
        out["world_loss"][sub.world_size] = _loss_grads(model, x_ell, subs[: sub.world_size],
                                                        prob, sub)["loss"]
    out["epochs"] = {native: _rank_epochs(prob, params, mesh, native) for native in (True, False)}
    out["trainer"] = _trainer_runs(prob, params, mesh)
    return out


# ---- the parent's side ---------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    prob = _problem()
    params = params_from_jax(_jax().params)
    subs = _sub_batches(TSampler(prob["a_hat"], **prob["sampler_kw"]), prob["step_targets"])
    results = spawn_ranks(WORLD, _all_cases, tmp_path_factory.mktemp("ranks"), prob, params, subs)
    return SimpleNamespace(results=results, prob=prob, params=params, subs=subs)


def _jax_sub_batches():
    j = _jax()
    return _sub_batches(j.Sampler(j.prob["a_hat"], **j.prob["sampler_kw"]), j.prob["step_targets"])


def _assert_stacked_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        g, w = (got[k], want[k]) if isinstance(got[k], list) else ([got[k]], [want[k]])
        assert len(g) == len(w), k
        for a, b in zip(g, w):
            assert a.dtype == np.asarray(b).dtype, k
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)


def test_stack_batches_matches_jax():
    """Four and three real sub-batches (the fourth an all-zero tail)."""
    j = _jax()
    t_subs = _sub_batches(TSampler(j.prob["a_hat"], **j.prob["sampler_kw"]), j.prob["step_targets"])
    j_subs = _jax_sub_batches()
    bsz = j.prob["sampler_kw"]["batch_size"]
    for n_real in (WORLD, 3):
        got = t_sd.stack_batches(t_subs[:n_real], WORLD, bsz)
        _assert_stacked_equal(got, j.sd.stack_batches(j_subs[:n_real], WORLD, bsz))
    assert not got["target_mask"][3].any() and not got["nodes"][2][3].any()


@functools.cache
def _jax_loss_grads(n_real):
    j = _jax()
    prob = j.prob
    bsz = prob["sampler_kw"]["batch_size"]
    stacked = j.jax.tree.map(j.jnp.asarray, j.sd.stack_batches(_jax_sub_batches()[:n_real], WORLD,
                                                                bsz))
    y_stacked = j.jnp.asarray(prob["y"][np.asarray(stacked["targets"])], j.jnp.int32)
    x_ell = j.model.x.ell_capped()

    def loss(p):
        return j.sd.dist_sampled_loss(p, j.model.cfg, x_ell, stacked, y_stacked, j.mesh,
                                      rng=j.jax.random.key(1), train=True)

    params = j.jax.tree.map(j.jnp.asarray, j.params)
    value, grads = j.jax.jit(j.jax.value_and_grad(loss))(params)
    grads = params_from_jax(j.jax.tree.map(np.asarray, grads))
    return float(value), {k: v.numpy() for k, v in grads.items()}


@pytest.mark.parametrize("n_real", [WORLD, 3], ids=["4_of_4", "3_of_4"])
def test_dist_sampled_loss_and_grads_match_jax(ranks, n_real):
    """The summed loss and every summed gradient on every rank against JAX's
    dist_sampled_loss on the same sub-batches; 3 of 4 ranks real leaves
    rank 3 an all-masked sub-batch. A numerator sent through a collective
    whose backward all-reduces would multiply each gradient by 4 here."""
    want_loss, want_grads = _jax_loss_grads(n_real)
    for r in ranks.results:
        got = r["loss"][n_real]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
        assert got["grads"].keys() == want_grads.keys()
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, want_grads[k], **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("world", [1, 2, WORLD])
def test_loss_at_each_world_size_is_the_single_device_composition(ranks, world):
    """The loss at world 1, 2 and 4 (subgroups; the group's rank r takes
    sub-batch r) equals the single-device composition of the same
    sub-batches: Σ numerators over Σ mask counts, + L2."""
    prob = ranks.prob
    model = _port_model(prob, ranks.params)
    x_ell = to_device(model.x.ell_capped(), "cpu")
    num = den = 0.0
    with torch.no_grad():
        for sub in ranks.subs[:world]:
            bd = batch_to_device(sub, "cpu")
            logits = sampled_forward(model, x_ell, bd)
            y = torch.as_tensor(prob["y"], dtype=torch.int64)[bd["nodes"][0]]
            ce = -torch.log_softmax(logits, -1).gather(1, y[:, None])[:, 0]
            num += float((ce * bd["target_mask"]).sum())
            den += float(bd["target_mask"].sum())
        from graphconvgeo_torch.models.gcn import l2_penalty

        want = num / max(den, 1.0) + prob["cfg_kw"]["l2"] * float(l2_penalty(model))
    for r in ranks.results:
        np.testing.assert_allclose(r["world_loss"][world], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_rank_sub_batches_are_jax_positions(ranks, native):
    """Two epochs of rank r's sub-batches, stacked in rank order, array-equal
    to JAX's _stacked_epoch: every step, the ragged last step's all-zero
    tail included."""
    j = _jax()
    prob = j.prob
    sampler = j.Sampler(prob["a_hat"], **prob["sampler_kw"], use_native=native)
    assert (sampler._native is not None) == native
    trainer = j.sd.DistSampledTrainer(j.model, sampler, j.mesh, j.TrainConfig(seed=SEED))
    rng_np = np.random.default_rng(SEED)
    bsz = prob["sampler_kw"]["batch_size"]
    for epoch in range(2):
        want = list(trainer._stacked_epoch(prob["train_idx"], rng_np))
        steps = [r["epochs"][native][epoch] for r in ranks.results]
        assert [len(s) for s in steps] == [len(want)] * WORLD == [4] * WORLD
        for k, step in enumerate(want):
            got = t_sd.stack_batches([s[k] for s in steps], WORLD, bsz)
            _assert_stacked_equal(got, step)
        assert int(want[-1]["target_mask"].sum()) == 6  # 1 real sub-batch, 3 empty


@functools.cache
def _jax_trainer_runs():
    j = _jax()
    prob = j.prob

    class Recording(j.sd.DistSampledTrainer):
        def _stacked_epoch(self, train_idx, rng_np):
            self.pools.append(np.array(train_idx))
            return super()._stacked_epoch(train_idx, rng_np)

    def fit(cfg, **kw):
        sampler = j.Sampler(prob["a_hat"], **prob["sampler_kw"])
        trainer = Recording(j.model, sampler, j.mesh, cfg, eval_mode=kw.pop("eval_mode", "full"))
        trainer.pools = []
        params = j.jax.tree.map(j.jnp.asarray, j.params)  # fresh: the step donates them
        out = trainer.fit(prob["y"], prob["train_idx"], prob["dev_idx"], **prob["geo"],
                          params=params, **kw)
        return dict(history=out["history"], best_epoch=out["best_epoch"], pools=trainer.pools)

    base = dict(learning_rate=5e-3, verbose=False, seed=SEED)
    return dict(
        full=fit(j.TrainConfig(epochs=EPOCHS, patience=EPOCHS, **base)),
        lf=fit(j.TrainConfig(epochs=LF_EPOCHS, patience=LF_EPOCHS, **base),
               label_fraction=LABEL_FRACTION, eval_mode="sampled"),
    )


@pytest.mark.parametrize("run", ["full", "lf"])
def test_dist_sampled_trainer_matches_jax(ranks, run):
    """DistSampledTrainer.fit from JAX's parameters at dropout 0 against
    JAX's DistSampledTrainer: the loss history at rtol 1e-4 and the dev
    Acc@161 of every epoch, on every rank; ``lf`` (label_fraction 0.5,
    eval_mode "sampled") trains on exactly JAX's thinned target pool."""
    want = _jax_trainer_runs()[run]
    losses = [h["loss"] for h in want["history"]]
    for r in ranks.results:
        got = r["trainer"][run]
        assert [h["epoch"] for h in got["history"]] == [h["epoch"] for h in want["history"]]
        np.testing.assert_allclose([h["loss"] for h in got["history"]], losses, rtol=HISTORY_RTOL)
        assert ([h["dev_acc_at_161"] for h in got["history"]]
                == [h["dev_acc_at_161"] for h in want["history"]])
        assert got["best_epoch"] == want["best_epoch"]
        assert len(got["pools"]) == len(want["pools"])
        for a, b in zip(got["pools"], want["pools"]):
            np.testing.assert_array_equal(a, b)
    if run == "lf":
        assert 0 < len(want["pools"][0]) < len(ranks.prob["train_idx"])


def test_parameters_are_bit_equal_across_ranks(ranks):
    """Replicated parameters stay replicated: after each run every rank
    holds rank 0's parameters bit for bit."""
    for run in ("full", "lf"):
        lead = ranks.results[0]["trainer"][run]["params"]
        for r in ranks.results[1:]:
            got = r["trainer"][run]["params"]
            assert got.keys() == lead.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], lead[k], err_msg=k)
