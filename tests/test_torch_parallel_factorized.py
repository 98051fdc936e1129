"""The port's distributed factorized Highway-GCN
(``graphconvgeo_torch/parallel/factorized_dist.py``) against the JAX
package's.

- Host plans, in this process: ``partition_factorized_raw`` (the partition
  of R', ``b_blocks``, ``bt_blocks``, ``diag``, ``n_groups``) and
  ``hub_sharded_operands`` in both block formats, array-equal to JAX's.
- Ranks: one group of 4 spawned gloo ranks (``spawn_ranks`` of
  ``tests/test_torch_parallel.py``; the ranks never import JAX) runs every
  case; JAX's ``DistFactorizedGCN`` runs the same case on 4 of conftest's 8
  virtual CPU devices with the same parameters. The replicated [G, F]
  all-reduce and the hub-sharded rings, in ``bell`` and ``ell``, with the
  halo and with the all-gather of R': logits, loss and every gradient at
  dropout 0 (a backward of the all-reduce that did not sum the ranks'
  cotangents would fail these: at world size 1 the two agree). The
  hub-sharded rings against the replicated path on the ranks; the loss at
  world 1, 2 and 4 (the rings' one-rank branch at world 1) against the
  single-device port's model on the factorized adjacency; ``DistTrainer``
  (4 epochs against JAX's loss history, and a resumed run against the
  uninterrupted one).

The problem is JAX's ``tests/test_parallel_factorized.py`` one at 90 users
(40 hubs of 2–7 members, 15 direct mentions), so that the last rank holds 6
padding rows.
"""

import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.models.gcn import GCNConfig as TCfg
from graphconvgeo_torch.models.gcn import HighwayGCN as THighwayGCN
from graphconvgeo_torch.parallel import factorized_dist as t_fd
from graphconvgeo_torch.parallel import mesh as t_mesh
from graphconvgeo_torch.parallel.trainer_dist import DistTrainer as TDistTrainer
from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency as TFactorized
from graphconvgeo_torch.sparse.formats import SparseGraph as TGraph
from graphconvgeo_torch.train.trainer import TrainConfig as TTrainConfig
from tests.test_torch_parallel import _assert_csr_equal, _assert_operand_equal, spawn_ranks
from tests.test_torch_parallel import _trainer_problem

WORLD = 4
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
HUB_TOL = dict(rtol=1e-5, atol=1e-6)  # the rings against the all-reduce, on the ranks
HISTORY_RTOL = 1e-4  # Adam trajectories of the two packages, 4 epochs
RESUME_RTOL = 1e-6  # the port resumed against the port uninterrupted
EPOCHS = 4

# each rank case: DistFactorizedGCN keywords
CASES = {
    "replicated_bell": dict(dist_format="bell"),
    "replicated_ell": dict(dist_format="ell"),
    "replicated_allgather": dict(halo="off"),
    "hub_sharded_bell": dict(dist_format="bell", hub_sharded=True),
    "hub_sharded_ell": dict(dist_format="ell", hub_sharded=True),
    "hub_sharded_ring": dict(halo="on", halo_mode="ring", hub_sharded=True),
}


# ---- the problem (built in the parent, sent to the ranks as arrays) ----------
def _groups(rng, n, n_groups):
    return {f"hub{g}": rng.choice(n, size=int(rng.integers(2, 8)), replace=False).tolist()
            for g in range(n_groups)}


@functools.cache
def _problem() -> dict:
    from tests.conftest import random_csr

    rng = np.random.default_rng(0)
    n, v, classes = 90, 30, 5
    groups = _groups(rng, n, 40)
    direct = (rng.integers(0, n, 15), rng.integers(0, n, 15))
    x = random_csr(rng, n, v, 6)
    x.data = np.abs(x.data).astype(np.float32)
    return dict(groups=groups, direct=direct, x=x,
                y=rng.integers(0, classes, n).astype(np.int32),
                mask=(rng.random(n) < 0.6).astype(np.float32), classes=classes)


def _cfg_kw(prob, **over):
    kw = dict(n_features=prob["x"].shape[1], n_classes=prob["classes"], hidden=(16, 16),
              highway=True, dropout=0.0, l2=1e-4)
    kw.update(over)
    return kw


@functools.cache
def _jax():
    """The JAX package's modules (imported here, never by a rank)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from graphconvgeo_tpu.models import gcn as j_gcn
    from graphconvgeo_tpu.parallel import factorized_dist as j_fd
    from graphconvgeo_tpu.parallel import trainer_dist as j_td
    from graphconvgeo_tpu.train import trainer as j_trainer

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("graph",))
    return SimpleNamespace(jax=jax, jnp=jnp, mesh=mesh, repl=NamedSharding(mesh, PartitionSpec()),
                           gcn=j_gcn, fd=j_fd, td=j_td, trainer=j_trainer)


@functools.cache
def _params() -> dict:
    j = _jax()
    cfg = j.gcn.GCNConfig(**_cfg_kw(_problem()))
    return j.jax.tree.map(np.asarray, j.gcn.init_gcn_params(j.jax.random.key(7), cfg))


def _factorized_trainer_problem() -> dict:
    """The trainer problem of ``tests/test_torch_parallel.py`` (96 nodes,
    kd-tree classes) over a mention structure of 40 hubs."""
    j = _jax()
    tp = _trainer_problem()
    rng = np.random.default_rng(9)
    n = tp["x"].shape[0]
    params = j.jax.tree.map(np.asarray, j.gcn.init_gcn_params(
        j.jax.random.key(3), j.gcn.GCNConfig(**tp["cfg_kw"])))
    return {**tp, "groups": _groups(rng, n, 40),
            "direct": (rng.integers(0, n, 15), rng.integers(0, n, 15)), "params": params}


def _fpart(module, prob, world):
    return module.partition_factorized_raw(prob["groups"], prob["x"], prob["y"], prob["mask"],
                                           world, direct=prob["direct"])


# ---- what the ranks run --------------------------------------------------------
def _model_case(mesh, prob, params, model_kw):
    model = t_fd.DistFactorizedGCN(TCfg(**_cfg_kw(prob)), _fpart(t_fd, prob, mesh.world_size),
                                   mesh, **model_kw)
    model.load_state_dict(params_from_jax(params))
    logits = model.apply(train=False).detach().numpy()
    loss = float(model.loss_and_backward(train=False))
    return dict(logits=logits, loss=loss, halo=model.halo is not None,
                grads={k: p.grad.numpy().copy() for k, p in model.named_parameters()})


def _trainer_runs(mesh, tp, out_dir):
    fpart = t_fd.partition_factorized_raw(tp["groups"], tp["x"], tp["y"], tp["mask"],
                                          mesh.world_size, direct=tp["direct"])
    params = params_from_jax(tp["params"])

    def fit(cfg):
        model = t_fd.DistFactorizedGCN(TCfg(**tp["cfg_kw"]), fpart, mesh, hub_sharded=True)
        return TDistTrainer(model, cfg).fit(tp["dev_idx"], params=params, **tp["geo"])

    base = dict(patience=EPOCHS, min_epochs=EPOCHS, verbose=False)
    full = fit(TTrainConfig(epochs=EPOCHS, **base))
    ckdir = os.path.join(out_dir, "ck_factorized")
    fit(TTrainConfig(epochs=2, checkpoint_dir=ckdir, save_every=1, **base))
    resumed = fit(TTrainConfig(epochs=EPOCHS, checkpoint_dir=ckdir, save_every=1, **base))
    return dict(full=full["history"], resumed=resumed["history"])


def _all_cases(rank, world, prob, params, tp, out_dir):
    """Every rank case of this file, in one spawn group."""
    mesh = t_mesh.make_graph_mesh("cpu")
    out = {"cases": {name: _model_case(mesh, prob, params, kw) for name, kw in CASES.items()}}
    # the same loss on smaller worlds: subgroups {r} and {0, 1}, {2, 3}
    singles = [dist.new_group([r]) for r in range(world)]
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    out["world_loss"] = {(world, hub): out["cases"][
        "hub_sharded_bell" if hub else "replicated_bell"]["loss"] for hub in (False, True)}
    for group in (pairs[rank // 2], singles[rank]):
        sub = t_mesh.make_graph_mesh("cpu", group=group)
        for hub in (False, True):
            out["world_loss"][(sub.world_size, hub)] = _model_case(
                sub, prob, params, dict(hub_sharded=hub))["loss"]
    out["trainer"] = _trainer_runs(mesh, tp, out_dir)
    return out


# ---- the parent's side ---------------------------------------------------------
@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    prob, params, tp = _problem(), _params(), _factorized_trainer_problem()
    out_dir = tmp_path_factory.mktemp("factorized_ranks")
    results = spawn_ranks(WORLD, _all_cases, out_dir, prob, params, tp, str(out_dir))
    return SimpleNamespace(results=results, out_dir=out_dir)


@functools.cache
def _jax_case(name):
    """JAX's logits [n_pad, C], loss and gradients (by the port's parameter
    names) of DistFactorizedGCN under a case's keywords on 4 virtual
    devices."""
    j = _jax()
    prob = _problem()
    model = j.fd.DistFactorizedGCN(j.gcn.GCNConfig(**_cfg_kw(prob)), _fpart(j.fd, prob, WORLD),
                                   j.mesh, **CASES[name])
    params = j.jax.device_put(j.jax.tree.map(j.jnp.asarray, _params()), j.repl)
    logits = np.asarray(j.jax.jit(lambda p: model.apply(p, train=False))(params))
    loss, grads = j.jax.jit(j.jax.value_and_grad(lambda p: model.loss(p, train=False)))(params)
    grads = params_from_jax(j.jax.tree.map(np.asarray, grads))
    return logits, float(loss), {k: v.numpy() for k, v in grads.items()}, model.halo is not None


@pytest.mark.parametrize("name", list(CASES))
def test_dist_factorized_matches_jax(rank_results, name):
    """Logits, loss and every parameter gradient of the 4 gloo ranks against
    JAX's 4-device DistFactorizedGCN, replicated and hub-sharded."""
    per_rank = [r["cases"][name] for r in rank_results.results]
    want_logits, want_loss, want_grads, want_halo = _jax_case(name)
    logits = np.concatenate([c["logits"] for c in per_rank])
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, want_logits, **LOGIT_TOL)
    for c in per_rank:  # the loss and the summed gradients reach every rank
        np.testing.assert_allclose(c["loss"], want_loss, rtol=LOSS_RTOL)
        assert c["grads"].keys() == want_grads.keys()
        for k, g in c["grads"].items():
            np.testing.assert_allclose(g, want_grads[k], **GRAD_TOL, err_msg=k)
        assert c["halo"] == want_halo


@pytest.mark.parametrize("fmt", ["bell", "ell"])
def test_hub_sharded_matches_replicated(rank_results, fmt):
    """The hub-sharded rings compute the replicated all-reduce's function:
    logits, loss and gradients, on every rank."""
    for r in rank_results.results:
        rep, hub = r["cases"][f"replicated_{fmt}"], r["cases"][f"hub_sharded_{fmt}"]
        np.testing.assert_allclose(hub["logits"], rep["logits"], **HUB_TOL)
        np.testing.assert_allclose(hub["loss"], rep["loss"], rtol=LOSS_RTOL)
        for k, g in hub["grads"].items():
            np.testing.assert_allclose(g, rep["grads"][k], **HUB_TOL, err_msg=k)


@pytest.mark.parametrize("hub_sharded", [False, True], ids=["replicated", "hub_sharded"])
@pytest.mark.parametrize("world", [1, 2, WORLD])
def test_factorized_loss_does_not_depend_on_world_size(rank_results, world, hub_sharded):
    """At dropout 0 the loss at world 1, 2 and 4 is the single-device port
    HighwayGCN's on the factorized adjacency, with the same parameters."""
    prob = _problem()
    fa = TFactorized.from_groups(prob["groups"], prob["x"].shape[0], direct=prob["direct"])
    single = THighwayGCN(TCfg(**_cfg_kw(prob)), TGraph(csr=prob["x"]), fa, device="cpu")
    single.load_state_dict(params_from_jax(_params()))
    y = torch.as_tensor(prob["y"], dtype=torch.int64)
    want = float(single.loss(y, torch.as_tensor(prob["mask"]), train=False).detach())
    for r in rank_results.results:
        np.testing.assert_allclose(r["world_loss"][(world, hub_sharded)], want, rtol=LOSS_RTOL)


@functools.cache
def _jax_trainer_history():
    j = _jax()
    tp = _factorized_trainer_problem()
    fpart = j.fd.partition_factorized_raw(tp["groups"], tp["x"], tp["y"], tp["mask"], WORLD,
                                          direct=tp["direct"])
    model = j.fd.DistFactorizedGCN(j.gcn.GCNConfig(**tp["cfg_kw"]), fpart, j.mesh,
                                   hub_sharded=True)
    params = j.jax.device_put(j.jax.tree.map(j.jnp.asarray, tp["params"]), j.repl)
    cfg = j.trainer.TrainConfig(epochs=EPOCHS, patience=EPOCHS, min_epochs=EPOCHS, verbose=False)
    return j.td.DistTrainer(model, cfg).fit(tp["dev_idx"], params=params, **tp["geo"])["history"]


def _losses(history):
    return [h["loss"] for h in history]


def test_dist_factorized_trainer_matches_jax(rank_results):
    """4 epochs of DistTrainer on the hub-sharded DistFactorizedGCN from
    JAX's parameters: JAX's loss history and dev metrics, on every rank."""
    want = _jax_trainer_history()
    for r in rank_results.results:
        got = r["trainer"]["full"]
        assert [h["epoch"] for h in got] == list(range(EPOCHS))
        np.testing.assert_allclose(_losses(got), _losses(want), rtol=HISTORY_RTOL)
        assert [h["dev_acc_at_161"] for h in got] == [h["dev_acc_at_161"] for h in want]


def test_dist_factorized_trainer_resumes_from_checkpoint(rank_results):
    """2 epochs with a checkpoint each, then a fresh trainer resumes at
    epoch 2 and continues the uninterrupted trajectory."""
    ck = rank_results.out_dir / "ck_factorized"
    assert sorted(os.listdir(ck))[-1] == f"step_{EPOCHS - 1:08d}"
    for r in rank_results.results:
        full, resumed = r["trainer"]["full"], r["trainer"]["resumed"]
        assert [h["epoch"] for h in resumed] == list(range(2, EPOCHS))
        np.testing.assert_allclose(_losses(resumed), _losses(full[2:]), rtol=RESUME_RTOL)


# ---- host plans, in this process -----------------------------------------------
def test_partition_factorized_matches_jax():
    prob = _problem()
    got, want = _fpart(t_fd, prob, WORLD), _fpart(_jax().fd, prob, WORLD)
    assert got.n_groups == want.n_groups
    np.testing.assert_array_equal(got.diag, want.diag)
    for name in ("b_blocks", "bt_blocks"):
        for g, w in zip(getattr(got, name), getattr(want, name), strict=True):
            _assert_csr_equal(g, w)
    for name in ("n_pad", "rows_per_device", "x_idx", "x_val", "y", "mask"):
        np.testing.assert_array_equal(getattr(got.part, name), getattr(want.part, name))
    for g, w in zip(got.part.a_blocks, want.part.a_blocks, strict=True):
        _assert_csr_equal(g, w)
    assert got.part.n_pad > len(prob["y"])  # the last rank has padding rows


@pytest.mark.parametrize("fmt", ["bell", "ell"])
def test_hub_sharded_operands_match_jax(fmt):
    """The hub-sharded incidence [D_rank, D_block, …] and its transpose,
    and the hub block size."""
    prob = _problem()
    got = t_fd.hub_sharded_operands(_fpart(t_fd, prob, WORLD), fmt)
    want = _jax().fd.hub_sharded_operands(_fpart(_jax().fd, prob, WORLD), fmt)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        _assert_operand_equal(g, w)
        first = g.indices[0] if isinstance(g.indices, tuple) else g.indices
        assert first.shape[:2] == (WORLD, WORLD)
