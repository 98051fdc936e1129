"""The port's distributed Highway-GCN (``graphconvgeo_torch/parallel``)
against the JAX package's.

- Host plans, in this process: ``partition_rows`` (with and without the
  slab, row_align 8 and 256), the stacked ELL / bucketed operands,
  ``build_halo`` (``bell`` and ``bsr``), ``ring_operands``,
  ``halo_fraction`` and ``boundary_stats`` array-equal to JAX's;
  ``ell_dropout_values`` bit-equal to JAX's mask with a row offset, ids past
  2³¹ included.
- Ranks: one group of 4 spawned gloo ranks (``torch.multiprocessing``, a
  file store under ``tmp_path``; the ranks import torch and the port, never
  JAX, so this module imports JAX only inside its functions) runs every
  case; JAX's ``DistHighwayGCN`` runs the same case on 4 of conftest's 8
  virtual CPU devices with the same parameters. Logits at rtol 1e-4 /
  atol 1e-5, loss at rtol 1e-5, every gradient at rtol 1e-4 / atol 1e-6,
  all at dropout 0 (the dense dropout masks come from each rank's own
  generator). The same group holds the world-size invariance (the loss at
  world 1, 2 and 4, on subgroups, against the single-device port's, rtol
  1e-5) and the ``DistTrainer`` against JAX's (loss history at rtol 1e-4,
  ``label_fraction``'s mask exactly, a resumed run against the
  uninterrupted one at rtol 1e-6).
"""

import contextlib
import dataclasses
import datetime
import functools
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.models.gcn import GCNConfig as TCfg
from graphconvgeo_torch.models.gcn import HighwayGCN as THighwayGCN
from graphconvgeo_torch.ops import dropout as t_dropout
from graphconvgeo_torch.parallel import mesh as t_mesh
from graphconvgeo_torch.parallel import model_dist as t_md
from graphconvgeo_torch.parallel import partition as t_part
from graphconvgeo_torch.parallel.trainer_dist import DistTrainer as TDistTrainer
from graphconvgeo_torch.sparse.formats import SparseGraph as TGraph
from graphconvgeo_torch.train.trainer import TrainConfig as TTrainConfig

WORLD = 4
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
HISTORY_RTOL = 1e-4  # Adam trajectories of the two packages, 6 epochs
RESUME_RTOL = 1e-6  # the port resumed against the port uninterrupted
RANK_TIMEOUT_S = 240  # the whole spawn group; a collective waits at most 60 s


# ---- spawned gloo ranks ------------------------------------------------------
def _rank_main(rank, world, store, out_dir, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn_ranks(world, fn, out_dir, *args):
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks (a file
    store in ``out_dir``); returns the ranks' results in rank order. A rank
    that raises fails the call; so does a group still running after
    RANK_TIMEOUT_S (its ranks are terminated)."""
    out_dir = str(out_dir)
    ctx = mp.start_processes(_rank_main, args=(world, os.path.join(out_dir, "store"), out_dir,
                                               fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"the {world} ranks did not finish in {RANK_TIMEOUT_S} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---- problems (built in the parent, sent to the ranks as arrays) -------------
def _random_csr(rng, n_rows, n_cols, avg_deg, *, symmetric=False):
    from tests.conftest import random_csr

    return random_csr(rng, n_rows, n_cols, avg_deg, symmetric=symmetric)


def _graph(rng, n, v, deg_x=6):
    from graphconvgeo_torch.sparse.formats import normalize_adjacency

    adj = _random_csr(rng, n, n, 4, symmetric=True)
    adj.data = np.abs(adj.data)
    x = _random_csr(rng, n, v, deg_x)
    x.data = np.abs(x.data).astype(np.float32)
    return normalize_adjacency(adj), x


def _problem(kind: str) -> dict:
    """base: 100 nodes, vocabulary 37; bsr: 1,024 nodes (row_align 256:
    rpd 256, dense local tiles); slab: 1,024 nodes, vocabulary 1,100 with a
    Zipf-like head (a distributed slab of 128 columns)."""
    rng = np.random.default_rng({"base": 0, "bsr": 1, "slab": 2}[kind])
    if kind == "slab":
        n, v = 1024, 1100
        rows = np.repeat(np.arange(n), 12)
        cols = np.minimum(rng.integers(0, 40, rows.shape[0]) * rng.integers(1, 4, rows.shape[0]),
                          v - 1)
        cols[::7] = rng.integers(0, v, cols[::7].shape[0])
        x = sp.coo_matrix((rng.random(rows.shape[0]).astype(np.float32) + 0.1, (rows, cols)),
                          shape=(n, v)).tocsr()
        x.sum_duplicates()
        a_hat, _ = _graph(rng, n, 8)
    else:
        n, v = (100, 37) if kind == "base" else (1024, 30)
        a_hat, x = _graph(rng, n, v, 6 if kind == "base" else 5)
    classes = 5
    return dict(
        a_hat=a_hat, x=x, y=rng.integers(0, classes, n).astype(np.int32),
        mask=(rng.random(n) < 0.6).astype(np.float32), classes=classes,
        part_kw=dict(row_align=256) if kind == "bsr" else (
            dict(slab_cols=128) if kind == "slab" else {}),
        hidden=(24, 24) if kind == "base" else (16, 16),
    )


def _cfg_kw(prob, **over):
    kw = dict(n_features=prob["x"].shape[1], n_classes=prob["classes"], hidden=prob["hidden"],
              highway=True, dropout=0.0, l2=1e-4)
    kw.update(over)
    return kw


# each rank case: (problem, DistHighwayGCN keywords, config changes, streamed CE head)
CASES = {
    "allgather_bell": ("base", dict(halo="off", dist_format="bell"), {}, False),
    "allgather_ell": ("base", dict(halo="off", dist_format="ell"), {}, False),
    "halo_bell": ("base", dict(halo="on", dist_format="bell"), {}, False),
    "halo_ell": ("base", dict(halo="on", dist_format="ell"), {}, False),
    "ring": ("base", dict(halo="on", halo_mode="ring"), {}, False),
    "halo_bsr": ("bsr", dict(halo="on", local_backend="bsr"), {}, False),
    "slab": ("slab", dict(halo="on"), dict(input_backend="slab", slab_cols=128), False),
    "remat": ("base", dict(halo="on"), dict(remat=True), False),
    "streamed_ce": ("base", dict(halo="on"), {}, True),
}


@functools.cache
def _jax():
    """The JAX package's modules (imported here, never by a rank)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from graphconvgeo_tpu.data.kdtree import KDTreeDiscretizer
    from graphconvgeo_tpu.models import gcn as j_gcn
    from graphconvgeo_tpu.ops import dropout as j_dropout
    from graphconvgeo_tpu.parallel import model_dist as j_md
    from graphconvgeo_tpu.parallel import partition as j_part
    from graphconvgeo_tpu.parallel import trainer_dist as j_td
    from graphconvgeo_tpu.train import trainer as j_trainer

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("graph",))
    return SimpleNamespace(
        jax=jax, jnp=jnp, mesh=mesh, repl=NamedSharding(mesh, PartitionSpec()),
        KDTree=KDTreeDiscretizer, gcn=j_gcn, dropout=j_dropout, md=j_md, part=j_part,
        td=j_td, trainer=j_trainer,
    )


@functools.cache
def _params(kind: str) -> dict:
    """JAX's initial parameters for a problem (numpy leaves)."""
    j = _jax()
    prob = _problem(kind)
    params = j.gcn.init_gcn_params(j.jax.random.key(7), j.gcn.GCNConfig(**_cfg_kw(prob)))
    return j.jax.tree.map(np.asarray, params)


def _trainer_problem() -> dict:
    """JAX's DistTrainer checkpoint test problem: 96 nodes, kd-tree classes
    from 64 training rows, dev rows 64..79."""
    j = _jax()
    rng = np.random.default_rng(5)
    n = 96
    a_hat, x = _graph(rng, n, 37)
    lat = rng.uniform(25, 48, n)
    lon = rng.uniform(-120, -70, n)
    disc = j.KDTree(bucket_size=24).fit(lat[:64], lon[:64])
    y = np.zeros(n, np.int32)
    y[:64] = disc.class_of_train
    y[64:] = disc.assign(lat[64:], lon[64:])
    mask = np.zeros(n, np.float32)
    mask[:64] = 1.0
    cfg_kw = dict(n_features=x.shape[1], n_classes=disc.n_classes, hidden=(16, 16),
                  highway=True, dropout=0.0)
    params = j.jax.tree.map(
        np.asarray, j.gcn.init_gcn_params(j.jax.random.key(3), j.gcn.GCNConfig(**cfg_kw)))
    return dict(a_hat=a_hat, x=x, y=y, mask=mask, cfg_kw=cfg_kw, params=params,
                geo=dict(lat=lat, lon=lon, class_lat_median=disc.class_lat_median,
                         class_lon_median=disc.class_lon_median),
                dev_idx=np.arange(64, 80))


# ---- what the ranks run --------------------------------------------------------
def _model_case(mesh, prob, params, model_kw, cfg_over, streamed):
    part = t_part.partition_rows(prob["a_hat"], prob["x"], prob["y"], prob["mask"],
                                 mesh.world_size, **prob["part_kw"])
    model = t_md.DistHighwayGCN(TCfg(**_cfg_kw(prob, **cfg_over)), part, mesh, **model_kw)
    model.load_state_dict(params_from_jax(params))
    original = t_md.streamed_rows_threshold
    if streamed:  # this case lowers the head's gate so the loss streams
        t_md.streamed_rows_threshold = lambda: 0
    try:
        logits = model.apply(train=False).detach().numpy()
        loss = float(model.loss_and_backward(train=False))
    finally:
        t_md.streamed_rows_threshold = original
    return dict(logits=logits, loss=loss, local_backend=model.local_backend,
                grads={k: p.grad.numpy().copy() for k, p in model.named_parameters()})


def _trainer_runs(rank, mesh, tp, out_dir):
    part = t_part.partition_rows(tp["a_hat"], tp["x"], tp["y"], tp["mask"], mesh.world_size)
    params = params_from_jax(tp["params"])

    def fit(cfg, **kw):
        model = t_md.DistHighwayGCN(TCfg(**tp["cfg_kw"]), part, mesh)
        out = TDistTrainer(model, cfg).fit(tp["dev_idx"], params=params, **tp["geo"], **kw)
        return model, out

    base = dict(patience=6, min_epochs=6, verbose=False)
    _, full = fit(TTrainConfig(epochs=6, metrics_path=os.path.join(out_dir, "metrics.jsonl"),
                               **base))
    ckdir = os.path.join(out_dir, "ck")
    fit(TTrainConfig(epochs=3, checkpoint_dir=ckdir, save_every=1, **base))
    _, resumed = fit(TTrainConfig(epochs=6, checkpoint_dir=ckdir, save_every=1, **base))
    thinned, lf = fit(TTrainConfig(epochs=2, min_epochs=2, patience=2, verbose=False),
                      label_fraction=0.5)
    return dict(full=full["history"], resumed=resumed["history"], lf=lf["history"],
                lf_mask=thinned.data["mask"].numpy())


def _all_cases(rank, world, problems, params, tp, out_dir):
    """Every rank case of this file, in one spawn group."""
    mesh = t_mesh.make_graph_mesh("cpu")
    out = {"cases": {}}
    for name, (kind, model_kw, cfg_over, streamed) in CASES.items():
        out["cases"][name] = _model_case(mesh, problems[kind], params[kind], model_kw,
                                         cfg_over, streamed)
    # the same loss on smaller worlds: subgroups {r} and {0, 1}, {2, 3}
    singles = [dist.new_group([r]) for r in range(world)]
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    out["world_loss"] = {world: out["cases"]["halo_bell"]["loss"]}
    for group in (pairs[rank // 2], singles[rank]):
        sub = t_mesh.make_graph_mesh("cpu", group=group)
        out["world_loss"][sub.world_size] = _model_case(
            sub, problems["base"], params["base"], dict(halo="on"), {}, False)["loss"]
    out["trainer"] = _trainer_runs(rank, mesh, tp, out_dir)
    return out


# ---- the parent's side ---------------------------------------------------------
@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    problems = {kind: _problem(kind) for kind in ("base", "bsr", "slab")}
    params = {kind: _params(kind) for kind in problems}
    tp = _trainer_problem()
    out_dir = tmp_path_factory.mktemp("ranks")
    results = spawn_ranks(WORLD, _all_cases, out_dir, problems, params, tp, str(out_dir))
    return SimpleNamespace(results=results, problems=problems, params=params, tp=tp,
                           out_dir=out_dir)


@functools.cache
def _jax_case(name):
    """JAX's logits [n_pad, C], loss and gradients (flattened by the
    port's parameter names) for a rank case, on 4 virtual devices."""
    import unittest.mock

    j = _jax()
    kind, model_kw, cfg_over, streamed = CASES[name]
    prob = _problem(kind)
    part = j.part.partition_rows(prob["a_hat"], prob["x"], prob["y"], prob["mask"], WORLD,
                                 **prob["part_kw"])
    model = j.md.DistHighwayGCN(j.gcn.GCNConfig(**_cfg_kw(prob, **cfg_over)), part, j.mesh,
                                **model_kw)
    params = j.jax.device_put(j.jax.tree.map(j.jnp.asarray, _params(kind)), j.repl)
    gate = (unittest.mock.patch.object(j.md, "streamed_rows_threshold", lambda: 0) if streamed
            else contextlib.nullcontext())
    with gate:
        logits = np.asarray(j.jax.jit(lambda p: model.apply(p, train=False))(params))
        loss, grads = j.jax.jit(j.jax.value_and_grad(lambda p: model.loss(p, train=False)))(params)
    grads = params_from_jax(j.jax.tree.map(np.asarray, grads))
    backend = "bsr" if model.halo is not None and model.halo.bsr_tiles is not None else "bell"
    return logits, float(loss), {k: v.numpy() for k, v in grads.items()}, backend


@pytest.mark.parametrize("name", list(CASES))
def test_dist_model_matches_jax(rank_results, name):
    """Logits, loss and every parameter gradient of the 4 gloo ranks against
    JAX's 4-device DistHighwayGCN, for each halo mode, block format, the bsr
    local backend (kernel 1's plain version on the CPU; the slab problem's
    rpd of 256 takes it too), the slab, remat and the streamed CE head."""
    per_rank = [r["cases"][name] for r in rank_results.results]
    want_logits, want_loss, want_grads, want_backend = _jax_case(name)
    logits = np.concatenate([c["logits"] for c in per_rank])
    np.testing.assert_allclose(logits, want_logits, **LOGIT_TOL)
    for c in per_rank:  # the loss and the summed gradients reach every rank
        np.testing.assert_allclose(c["loss"], want_loss, rtol=LOSS_RTOL)
        assert c["grads"].keys() == want_grads.keys()
        for k, g in c["grads"].items():
            np.testing.assert_allclose(g, want_grads[k], **GRAD_TOL, err_msg=k)
    assert {c["local_backend"] for c in per_rank} == {want_backend}


@pytest.mark.parametrize("world", [1, 2, WORLD])
def test_loss_does_not_depend_on_world_size(rank_results, world):
    """At dropout 0 the distributed loss at world 1, 2 and 4 is the
    single-device port HighwayGCN's on the same parameters."""
    prob = rank_results.problems["base"]
    single = THighwayGCN(TCfg(**_cfg_kw(prob), spmm_backend="bell"), TGraph(csr=prob["x"]),
                         TGraph(csr=prob["a_hat"], symmetric=True), device="cpu")
    single.load_state_dict(params_from_jax(rank_results.params["base"]))
    y = torch.as_tensor(prob["y"], dtype=torch.int64)
    want = float(single.loss(y, torch.as_tensor(prob["mask"]), train=False).detach())
    for r in rank_results.results:
        np.testing.assert_allclose(r["world_loss"][world], want, rtol=LOSS_RTOL)


@functools.cache
def _jax_trainer_runs():
    """JAX's DistTrainer on the trainer problem: 6 epochs, and 2 epochs
    with label_fraction 0.5 (its thinned mask too)."""
    j = _jax()
    tp = _trainer_problem()
    part = j.part.partition_rows(tp["a_hat"], tp["x"], tp["y"], tp["mask"], WORLD)

    def fit(cfg, **kw):
        model = j.md.DistHighwayGCN(j.gcn.GCNConfig(**tp["cfg_kw"]), part, j.mesh)
        # fresh parameters for each fit: the step donates its inputs
        params = j.jax.device_put(j.jax.tree.map(j.jnp.asarray, tp["params"]), j.repl)
        out = j.td.DistTrainer(model, cfg).fit(tp["dev_idx"], params=params, **tp["geo"], **kw)
        return model, out

    _, full = fit(j.trainer.TrainConfig(epochs=6, patience=6, min_epochs=6, verbose=False))
    thinned, lf = fit(j.trainer.TrainConfig(epochs=2, min_epochs=2, patience=2, verbose=False),
                      label_fraction=0.5)
    return full["history"], lf["history"], np.asarray(thinned.data["mask"])


def _losses(history):
    return [h["loss"] for h in history]


def test_dist_trainer_matches_jax(rank_results):
    """6 epochs of DistTrainer from JAX's parameters: the loss history and
    the dev metrics of JAX's DistTrainer, on every rank; rank 0's JSONL
    metrics log has one line an epoch."""
    want, _, _ = _jax_trainer_runs()
    for r in rank_results.results:
        got = r["trainer"]["full"]
        assert [h["epoch"] for h in got] == list(range(6))
        np.testing.assert_allclose(_losses(got), _losses(want), rtol=HISTORY_RTOL)
        assert [h["dev_acc_at_161"] for h in got] == [h["dev_acc_at_161"] for h in want]
    lines = [json.loads(l) for l in open(rank_results.out_dir / "metrics.jsonl")]
    assert [l["epoch"] for l in lines] == list(range(6))


def test_dist_trainer_resumes_from_checkpoint(rank_results):
    """3 epochs with a checkpoint each (rank 0 writes), then a fresh trainer
    resumes at epoch 3 and continues the uninterrupted trajectory."""
    assert sorted(os.listdir(rank_results.out_dir / "ck"))[-1] == "step_00000005"
    for r in rank_results.results:
        full, resumed = r["trainer"]["full"], r["trainer"]["resumed"]
        assert [h["epoch"] for h in resumed] == [3, 4, 5]
        np.testing.assert_allclose(_losses(resumed), _losses(full[3:]), rtol=RESUME_RTOL)


def test_dist_trainer_label_fraction(rank_results):
    """label_fraction 0.5 thins the train mask exactly as JAX's DistTrainer
    does (only real train rows turned off), and the 2 epochs' losses follow
    JAX's."""
    _, want_hist, want_mask = _jax_trainer_runs()
    got_mask = np.concatenate([r["trainer"]["lf_mask"] for r in rank_results.results])
    np.testing.assert_array_equal(got_mask, want_mask)
    full_mask = np.zeros_like(want_mask)
    full_mask[: len(rank_results.tp["mask"])] = rank_results.tp["mask"]
    assert 0 < got_mask.sum() < full_mask.sum() and np.all(full_mask[got_mask > 0] > 0)
    for r in rank_results.results:
        np.testing.assert_allclose(_losses(r["trainer"]["lf"]), _losses(want_hist),
                                   rtol=HISTORY_RTOL)


# ---- host plans, in this process -----------------------------------------------
def _both_partitions(kind, **over):
    prob = _problem(kind)
    kw = {**prob["part_kw"], **over}
    args = (prob["a_hat"], prob["x"], prob["y"], prob["mask"], WORLD)
    return t_part.partition_rows(*args, **kw), _jax().part.partition_rows(*args, **kw)


def _assert_csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.toarray(), b.toarray())


def _assert_operand_equal(got, want):
    """Two stacked operands (either format, any nesting of tuples) hold
    equal arrays under equal field names."""
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        g, w = (g, w) if isinstance(g, tuple) else ((g,), (w,))
        assert len(g) == len(w), f.name
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)


@pytest.mark.parametrize("kind", ["base", "bsr", "slab"])
def test_partition_rows_matches_jax(kind):
    got, want = _both_partitions(kind)
    for name in ("n_devices", "n_nodes", "n_pad", "rows_per_device", "n_features"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("x_idx", "x_val", "xt_idx", "xt_val", "y", "mask", "slab", "slab_col_ids"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.slab is not None) == (kind == "slab")
    for g, w in zip(got.a_blocks, want.a_blocks, strict=True):
        _assert_csr_equal(g, w)
    assert got.boundary_stats == want.boundary_stats


@pytest.mark.parametrize("fmt", ["ell", "bell"])
def test_stacked_operands_match_jax(fmt):
    got, want = _both_partitions("base")
    for g, w in zip(got.a_operands(fmt), want.a_operands(fmt), strict=True):
        _assert_operand_equal(g, w)


@pytest.mark.parametrize("kind,local_backend", [("base", "bell"), ("bsr", "bsr")])
def test_build_halo_matches_jax(kind, local_backend):
    """The halo plan: send_idx, the split blocks, their stacked operands in
    both formats, the per-peer ring operands, halo_fraction, and with bsr
    the dense local tiles in JAX's stacked layout (tiles, rowblk, colblk,
    first)."""
    got_p, want_p = _both_partitions(kind)
    got = t_part.build_halo(got_p, local_backend=local_backend)
    want = _jax().part.build_halo(want_p, local_backend=local_backend)
    assert (got.h_max, got.rpd, got.block) == (want.h_max, want.rpd, want.block)
    np.testing.assert_array_equal(got.send_idx, want.send_idx)
    assert got.halo_fraction == want.halo_fraction
    for name in ("local_blocks", "remote_blocks"):
        for g, w in zip(getattr(got, name), getattr(want, name), strict=True):
            _assert_csr_equal(g, w)
    for fmt in ("ell", "bell"):
        for key, op in got.operands(fmt).items():
            _assert_operand_equal(op, want.operands(fmt)[key])
        for key, op in got.ring_operands(fmt).items():
            _assert_operand_equal(op, want.ring_operands(fmt)[key])
    assert (got.bsr is not None) == (local_backend == "bsr")
    for name in ("bsr_tiles", "bsr_rowblk", "bsr_colblk", "bsr_first"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("fmt", ["bell", "ell", "tiled"])
def test_attention_operands_match_jax(fmt):
    """build_attention_operands on the base problem's halo plan: the port's
    per-rank operands, stacked, hold JAX's stacked arrays (the tiled
    pattern's fields and its rest's; ``tests/test_torch_parallel_gat.py``
    holds the run bounds against JAX's ``first`` flags)."""
    got, want = _both_partitions("base")
    ops = t_part.build_attention_operands(t_part.build_halo(got), fmt)
    stacked = _jax().part.build_attention_operands(_jax().part.build_halo(want), fmt)
    assert len(ops) == WORLD
    pairs = [(ops, stacked)]
    if fmt == "tiled":
        for name in ("mask_bits", "rowblk", "colblk", "mask_bits_t", "rowblk_t", "colblk_t"):
            got_stack = np.stack([getattr(op, name).numpy() for op in ops])
            want_arr = np.asarray(getattr(stacked, name))
            np.testing.assert_array_equal(got_stack.view(want_arr.dtype), want_arr, err_msg=name)
        pairs = [([op.rest for op in ops], stacked.rest)]
    for per_rank, want_op in pairs:
        for f in dataclasses.fields(want_op):
            w = getattr(want_op, f.name)
            if isinstance(w, int):
                assert {getattr(op, f.name) for op in per_rank} == {w}, f.name
                continue
            w = w if isinstance(w, tuple) else (w,)
            g = [getattr(op, f.name) for op in per_rank]
            g = [x if isinstance(x, tuple) else (x,) for x in g]
            assert all(len(x) == len(w) for x in g), f.name
            for i, arr in enumerate(w):
                np.testing.assert_array_equal(np.stack([x[i].numpy() for x in g]), np.asarray(arr),
                                              err_msg=f"{f.name}[{i}]")


@pytest.mark.parametrize("transposed", [False, True])
def test_ell_dropout_values_bit_equal_to_jax(transposed):
    """The hashed sparse-input dropout of a rank's block (row offset > 0)
    keeps exactly JAX's entries, ids that wrap int32 included: at a row
    offset of 2²⁰ and 4,096 columns the ids pass 2³²."""
    j = _jax()
    rng = np.random.default_rng(11)
    n_cols, offset = 4096, 1 << 20
    n, k = (64, 9) if not transposed else (n_cols, 5)
    hi = n_cols if not transposed else 64
    idx = rng.integers(0, hi, (n, k)).astype(np.int32)
    val = rng.random((n, k)).astype(np.float32) + 0.5
    assert (offset + hi) * n_cols > 2**32
    kw = dict(rate=0.4, seed=1234, n_cols=n_cols, transposed=transposed, row_offset=offset)
    got = t_dropout.ell_dropout_values(torch.as_tensor(idx), torch.as_tensor(val), **kw).numpy()
    want = np.asarray(j.dropout.ell_dropout_values(
        j.jnp.asarray(idx), j.jnp.asarray(val), **{**kw, "seed": j.jnp.int32(1234)}))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-7)
    assert 0.5 < (got != 0).mean() < 0.7


def test_mesh_refuses_more_ranks_without_a_launcher(monkeypatch):
    """Two ranks asked for with no launcher's environment raise, naming
    torchrun, and set nothing up."""
    for k in t_mesh.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        t_mesh.make_graph_mesh("cpu", n_devices=2)
    assert not dist.is_initialized()
