"""The port's distributed GAT (``graphconvgeo_torch/parallel/gat_dist.py``) and
its attention operands against the JAX package's.

- Host plans, in this process: ``attention_schedule``, the scheduled
  ``BucketedAttention`` (forward and transpose layouts), ``AttentionEll``
  with ``fixed_k`` / ``fixed_k_t``, ``TiledAttentionPattern`` with a rest
  schedule and ``pad_to``, and ``build_attention_operands`` in all three
  formats (the port's per-rank operands stacked as JAX stacks them; the
  port's ``row_ptr`` / ``col_ptr_t`` read as JAX's ``first`` flags)
  array-equal to JAX's. The bucketed and fixed-K attention on a rank's
  extended block: JAX's outputs and gradients, zero on rows with no edge.
- Ranks: one group of 4 spawned gloo ranks (``spawn_ranks`` of
  ``tests/test_torch_parallel.py``; the ranks never import JAX) runs every
  case; JAX's ``DistGAT`` runs the same case on 4 of conftest's 8 virtual
  CPU devices with the same parameters, its tiled kernels in interpret
  mode. ``DistGAT`` in ``bell``, ``ell`` and ``tiled``: logits, loss and
  every gradient at dropout 0 and attention dropout 0 (the port's dropout
  masks are its own draws). The same group holds the world-size invariance
  (the loss at world 1, 2 and 4 against the single-device port's GAT) and
  ``DistTrainer`` on ``DistGAT`` (4 epochs against JAX's loss history, and
  a resumed run against the uninterrupted one).

The problem: 1,000 nodes in communities of 50 plus a few far edges and a
dense band between ranks 0 and 1, so that at block 128 and
``min_tile_nnz`` 16 every rank's extended pattern (256 rows × 544 columns:
more column blocks than row blocks) has real tiles, filler tiles and rest
edges, the ranks' tile counts differ (``pad_to`` pads three of them) and
rank 3 has 24 padding rows with no edge. (JAX's own test takes
``min_tile_nnz`` 4 on a random graph, where every tile is dense and no
edge is left for the rest.)
"""

import dataclasses
import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.models.gat import GATConfig as TCfg
from graphconvgeo_torch.models.gat import GraphAttentionNet as TGAT
from graphconvgeo_torch.ops import attention as t_attention
from graphconvgeo_torch.parallel import mesh as t_mesh
from graphconvgeo_torch.parallel import partition as t_part
from graphconvgeo_torch.parallel.gat_dist import DistGAT as TDistGAT
from graphconvgeo_torch.parallel.trainer_dist import DistTrainer as TDistTrainer
from graphconvgeo_torch.sparse import formats as t_formats
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern as TTiled
from graphconvgeo_torch.sparse.formats import SparseGraph as TGraph
from graphconvgeo_torch.train.trainer import TrainConfig as TTrainConfig
from tests.test_torch_parallel import _trainer_problem, spawn_ranks

WORLD = 4
FORMATS = ("bell", "ell", "tiled")
MIN_TILE_NNZ = 16
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# one rank's attention against JAX's on its extended block: max|got − want|
# ≤ ATT_REL_TOL × max|want| (one softmax and one aggregation, the sums in
# other orders; a_src's and a_dst's gradients sum 256 rows of magnitude ~30)
ATT_REL_TOL = 1e-5
HISTORY_RTOL = 1e-4  # Adam trajectories of the two packages, 4 epochs
RESUME_RTOL = 1e-6  # the port resumed against the port uninterrupted
EPOCHS = 4
ATTN_DROPOUT = 0.3  # the ranks' training case with attention dropout on


# ---- the problem (built in the parent, sent to the ranks as arrays) ----------
def _community_graph(rng, n=1000, comm=50):
    """Symmetric Â: 3 edges a node inside its community of ``comm``
    contiguous ids, a far edge on 5% of the nodes, and a dense band between
    rows 0–59 (rank 0) and 256–299 (rank 1)."""
    src = np.repeat(np.arange(n), 3)
    dst = (src // comm) * comm + rng.integers(0, comm, src.size)
    far = np.flatnonzero(rng.random(n) < 0.05)
    rows = np.concatenate([src, far, rng.integers(0, 60, 400)])
    cols = np.concatenate([dst, rng.integers(0, n, far.size), rng.integers(256, 300, 400)])
    a = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(n, n)).tocsr()
    a = ((a + a.T) > 0).astype(np.float32)
    return t_formats.normalize_adjacency(a)


@functools.cache
def _problem() -> dict:
    rng = np.random.default_rng(12)
    n, v, classes = 1000, 33, 5
    a_hat = _community_graph(rng, n)
    x = sp.random(n, v, density=0.15, format="csr", random_state=3, dtype=np.float32)
    return dict(a_hat=a_hat, x=x, y=rng.integers(0, classes, n).astype(np.int32),
                mask=(rng.random(n) < 0.6).astype(np.float32), classes=classes)


def _cfg_kw(prob, **over):
    kw = dict(n_features=prob["x"].shape[1], n_classes=prob["classes"], hidden=(24, 24),
              heads=3, dropout=0.0, l2=1e-4)
    kw.update(over)
    return kw


@functools.cache
def _jax():
    """The JAX package's modules (imported here, never by a rank)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from graphconvgeo_tpu.models import gat as j_gat
    from graphconvgeo_tpu.ops import attention as j_attention
    from graphconvgeo_tpu.parallel import gat_dist as j_gd
    from graphconvgeo_tpu.parallel import partition as j_part
    from graphconvgeo_tpu.parallel import trainer_dist as j_td
    from graphconvgeo_tpu.sparse import attention_tiles as j_tiles
    from graphconvgeo_tpu.sparse import formats as j_formats
    from graphconvgeo_tpu.train import trainer as j_trainer

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("graph",))
    return SimpleNamespace(jax=jax, jnp=jnp, mesh=mesh, repl=NamedSharding(mesh, PartitionSpec()),
                           gat=j_gat, attention=j_attention, gd=j_gd, part=j_part, td=j_td,
                           tiles=j_tiles, formats=j_formats, trainer=j_trainer)


@functools.cache
def _params() -> dict:
    j = _jax()
    cfg = j.gat.GATConfig(**_cfg_kw(_problem()))
    return j.jax.tree.map(np.asarray, j.gat.init_gat_params(j.jax.random.key(21), cfg))


def _gat_trainer_problem() -> dict:
    """The GCN trainer problem of ``tests/test_torch_parallel.py`` (96 nodes,
    kd-tree classes) with a GAT of 2 heads and JAX's initial parameters."""
    j = _jax()
    tp = _trainer_problem()
    kw = tp["cfg_kw"]
    cfg_kw = dict(n_features=kw["n_features"], n_classes=kw["n_classes"], hidden=(16, 16),
                  heads=2, dropout=0.0)
    params = j.jax.tree.map(np.asarray, j.gat.init_gat_params(
        j.jax.random.key(4), j.gat.GATConfig(**cfg_kw)))
    return {**tp, "cfg_kw": cfg_kw, "params": params}


# ---- what the ranks run --------------------------------------------------------
def _partition(prob, world):
    return t_part.partition_rows(prob["a_hat"], prob["x"], prob["y"], prob["mask"], world)


def _gat_case(mesh, prob, params, fmt):
    model = TDistGAT(TCfg(**_cfg_kw(prob)), _partition(prob, mesh.world_size), mesh, fmt,
                     min_tile_nnz=MIN_TILE_NNZ)
    model.load_state_dict(params_from_jax(params))
    logits = model.apply(train=False).detach().numpy()
    loss = float(model.loss_and_backward(train=False))
    att = model.data["att"]
    return dict(logits=logits, loss=loss, att_stats=att.stats() if fmt == "tiled" else None,
                grads={k: p.grad.numpy().copy() for k, p in model.named_parameters()})


def _dropout_case(mesh, prob, params):
    """One training step's loss and gradients with attention dropout on
    (tiled) and the input and dense dropouts: finite, and each rank's
    attention seed its own."""
    cfg = TCfg(**_cfg_kw(prob, dropout=0.2, attn_dropout=ATTN_DROPOUT, att_backend="tiled"))
    model = TDistGAT(cfg, _partition(prob, mesh.world_size), mesh, "tiled",
                     min_tile_nnz=MIN_TILE_NNZ)
    model.load_state_dict(params_from_jax(params))
    gen = torch.Generator().manual_seed(5 + mesh.rank)
    loss = float(model.loss_and_backward(train=True, x_seed=77, generator=gen))
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    return dict(loss=loss, grads_finite=grads_finite, seeds=[model.attn_seed(77, i) for i in (0, 1)])


def _trainer_runs(mesh, tp, out_dir):
    part = t_part.partition_rows(tp["a_hat"], tp["x"], tp["y"], tp["mask"], mesh.world_size)
    params = params_from_jax(tp["params"])

    def fit(cfg):
        model = TDistGAT(TCfg(**tp["cfg_kw"]), part, mesh, "bell")
        return TDistTrainer(model, cfg).fit(tp["dev_idx"], params=params, **tp["geo"])

    base = dict(patience=EPOCHS, min_epochs=EPOCHS, verbose=False)
    full = fit(TTrainConfig(epochs=EPOCHS, **base))
    ckdir = os.path.join(out_dir, "ck_gat")
    fit(TTrainConfig(epochs=2, checkpoint_dir=ckdir, save_every=1, **base))
    resumed = fit(TTrainConfig(epochs=EPOCHS, checkpoint_dir=ckdir, save_every=1, **base))
    return dict(full=full["history"], resumed=resumed["history"])


def _all_cases(rank, world, prob, params, tp, out_dir):
    """Every rank case of this file, in one spawn group."""
    mesh = t_mesh.make_graph_mesh("cpu")
    out = {"cases": {fmt: _gat_case(mesh, prob, params, fmt) for fmt in FORMATS}}
    out["dropout"] = _dropout_case(mesh, prob, params)
    # the same loss on smaller worlds: subgroups {r} and {0, 1}, {2, 3}
    singles = [dist.new_group([r]) for r in range(world)]
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    out["world_loss"] = {world: out["cases"]["bell"]["loss"]}
    for group in (pairs[rank // 2], singles[rank]):
        sub = t_mesh.make_graph_mesh("cpu", group=group)
        out["world_loss"][sub.world_size] = _gat_case(sub, prob, params, "bell")["loss"]
    out["trainer"] = _trainer_runs(mesh, tp, out_dir)
    return out


# ---- the parent's side ---------------------------------------------------------
@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    prob, params, tp = _problem(), _params(), _gat_trainer_problem()
    out_dir = tmp_path_factory.mktemp("gat_ranks")
    results = spawn_ranks(WORLD, _all_cases, out_dir, prob, params, tp, str(out_dir))
    return SimpleNamespace(results=results, out_dir=out_dir)


@functools.cache
def _jax_case(fmt):
    """JAX's logits [n_pad, C], loss and gradients (by the port's parameter
    names) of DistGAT in ``fmt`` on 4 virtual devices."""
    j = _jax()
    prob = _problem()
    part = j.part.partition_rows(prob["a_hat"], prob["x"], prob["y"], prob["mask"], WORLD)
    model = j.gd.DistGAT(j.gat.GATConfig(**_cfg_kw(prob)), part, j.mesh, att_format=fmt,
                         min_tile_nnz=MIN_TILE_NNZ)
    params = j.jax.device_put(j.jax.tree.map(j.jnp.asarray, _params()), j.repl)
    logits = np.asarray(j.jax.jit(lambda p: model.apply(p, train=False))(params))
    loss, grads = j.jax.jit(j.jax.value_and_grad(lambda p: model.loss(p, train=False)))(params)
    grads = params_from_jax(j.jax.tree.map(np.asarray, grads))
    return logits, float(loss), {k: v.numpy() for k, v in grads.items()}


@pytest.mark.parametrize("fmt", FORMATS)
def test_dist_gat_matches_jax(rank_results, fmt):
    """Logits, loss and every parameter gradient of the 4 gloo ranks against
    JAX's 4-device DistGAT; padding rows' logits are finite."""
    per_rank = [r["cases"][fmt] for r in rank_results.results]
    want_logits, want_loss, want_grads = _jax_case(fmt)
    logits = np.concatenate([c["logits"] for c in per_rank])
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, want_logits, **LOGIT_TOL)
    for c in per_rank:  # the loss and the summed gradients reach every rank
        np.testing.assert_allclose(c["loss"], want_loss, rtol=LOSS_RTOL)
        assert c["grads"].keys() == want_grads.keys()
        for k, g in c["grads"].items():
            np.testing.assert_allclose(g, want_grads[k], **GRAD_TOL, err_msg=k)
    if fmt == "tiled":  # the problem exercises tiles and the rest on every rank
        for c in per_rank:
            assert c["att_stats"]["tiled_edges"] > 0 and c["att_stats"]["rest_edges"] > 0


@pytest.mark.parametrize("world", [1, 2, WORLD])
def test_gat_loss_does_not_depend_on_world_size(rank_results, world):
    """At dropout 0 the distributed GAT's loss at world 1, 2 and 4 is the
    single-device port GAT's on the same parameters."""
    prob = _problem()
    single = TGAT(TCfg(**_cfg_kw(prob)), TGraph(csr=prob["x"]),
                  TGraph(csr=prob["a_hat"], symmetric=True), device="cpu")
    single.load_state_dict(params_from_jax(_params()))
    y = torch.as_tensor(prob["y"], dtype=torch.int64)
    want = float(single.loss(y, torch.as_tensor(prob["mask"]), train=False).detach())
    for r in rank_results.results:
        np.testing.assert_allclose(r["world_loss"][world], want, rtol=LOSS_RTOL)


def test_dist_gat_attention_dropout(rank_results):
    """A training step with attention dropout on the tiled operand: the same
    finite loss on every rank, finite gradients, and a seed of its own on
    each rank (JAX folds the rank into its key)."""
    per_rank = [r["dropout"] for r in rank_results.results]
    assert np.isfinite(per_rank[0]["loss"])
    assert len({c["loss"] for c in per_rank}) == 1
    assert all(c["grads_finite"] for c in per_rank)
    seeds = [tuple(c["seeds"]) for c in per_rank]
    assert len(set(seeds)) == WORLD


@functools.cache
def _jax_trainer_history():
    j = _jax()
    tp = _gat_trainer_problem()
    part = j.part.partition_rows(tp["a_hat"], tp["x"], tp["y"], tp["mask"], WORLD)
    model = j.gd.DistGAT(j.gat.GATConfig(**tp["cfg_kw"]), part, j.mesh, att_format="bell")
    params = j.jax.device_put(j.jax.tree.map(j.jnp.asarray, tp["params"]), j.repl)
    cfg = j.trainer.TrainConfig(epochs=EPOCHS, patience=EPOCHS, min_epochs=EPOCHS, verbose=False)
    return j.td.DistTrainer(model, cfg).fit(tp["dev_idx"], params=params, **tp["geo"])["history"]


def _losses(history):
    return [h["loss"] for h in history]


def test_dist_gat_trainer_matches_jax(rank_results):
    """4 epochs of DistTrainer on DistGAT from JAX's parameters: JAX's loss
    history and dev metrics, on every rank."""
    want = _jax_trainer_history()
    for r in rank_results.results:
        got = r["trainer"]["full"]
        assert [h["epoch"] for h in got] == list(range(EPOCHS))
        np.testing.assert_allclose(_losses(got), _losses(want), rtol=HISTORY_RTOL)
        assert [h["dev_acc_at_161"] for h in got] == [h["dev_acc_at_161"] for h in want]


def test_dist_gat_trainer_resumes_from_checkpoint(rank_results):
    """2 epochs with a checkpoint each (rank 0 writes), then a fresh trainer
    resumes at epoch 2 and continues the uninterrupted trajectory."""
    assert sorted(os.listdir(rank_results.out_dir / "ck_gat"))[-1] == f"step_{EPOCHS - 1:08d}"
    for r in rank_results.results:
        full, resumed = r["trainer"]["full"], r["trainer"]["resumed"]
        assert [h["epoch"] for h in resumed] == list(range(2, EPOCHS))
        np.testing.assert_allclose(_losses(resumed), _losses(full[2:]), rtol=RESUME_RTOL)


# ---- host plans, in this process -----------------------------------------------
@functools.cache
def _halos():
    """(the port's, JAX's) halo plans of the problem, bell local backend."""
    prob = _problem()
    args = (prob["a_hat"], prob["x"], prob["y"], prob["mask"], WORLD)
    j = _jax()
    return (t_part.build_halo(t_part.partition_rows(*args)),
            j.part.build_halo(j.part.partition_rows(*args)))


def _ext_blocks(hx):
    return [sp.hstack([l, r]).tocsr() for l, r in zip(hx.local_blocks, hx.remote_blocks)]


def _first(rowblk) -> np.ndarray:
    """JAX's ``first`` flags from a tile order's row (or column) blocks: 1
    where a tile opens its block; padding tiles repeat the last block."""
    rowblk = np.asarray(rowblk)
    first = np.ones(rowblk.shape, np.int32)
    first[1:] = rowblk[1:] != rowblk[:-1]
    return first


def _fields(op) -> dict:
    """A port operand's arrays by JAX's field names (the tiled pattern's run
    bounds read as ``first`` flags; its rest's fields under ``rest.``)."""
    if isinstance(op, TTiled):
        out = {f: getattr(op, f).numpy() for f in
               ("mask_bits", "rowblk", "colblk", "mask_bits_t", "rowblk_t", "colblk_t")}
        out["mask_bits"] = out["mask_bits"].view(np.uint32)
        out["mask_bits_t"] = out["mask_bits_t"].view(np.uint32)
        out["first"], out["first_t"] = _first(op.rowblk), _first(op.colblk_t)
        # the run bounds are the flags' positions
        assert np.array_equal(op.row_ptr.numpy()[:-1], np.flatnonzero(out["first"]))
        assert np.array_equal(op.col_ptr_t.numpy()[:-1], np.flatnonzero(out["first_t"]))
        assert op.row_ptr[-1] == op.col_ptr_t[-1] == op.n_tiles
        if op.rest is not None:
            out.update({f"rest.{k}": v for k, v in _fields(op.rest).items()})
        return out
    out = {}
    for f in dataclasses.fields(op):
        val = getattr(op, f.name)
        if isinstance(val, tuple):
            out.update({f"{f.name}.{i}": a.numpy() for i, a in enumerate(val)})
        elif isinstance(val, torch.Tensor):
            out[f.name] = val.numpy()
    return out


def _jax_fields(op) -> dict:
    j = _jax()
    out = {}
    for f in dataclasses.fields(op):
        val = getattr(op, f.name)
        if isinstance(val, tuple):
            out.update({f"{f.name}.{i}": np.asarray(a) for i, a in enumerate(val)})
        elif dataclasses.is_dataclass(val):
            out.update({f"{f.name}.{k}": v for k, v in _jax_fields(val).items()})
        elif isinstance(val, (np.ndarray, j.jax.Array)):
            out[f.name] = np.asarray(val)
    return out


def _assert_fields_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_attention_schedule_matches_jax():
    """The common (width, padded rows) schedule over the ranks' row degrees
    and column in-degrees, and over degree vectors with all-zero blocks."""
    j = _jax()
    ext = _ext_blocks(_halos()[0])
    n_ext = ext[0].shape[1]
    rng = np.random.default_rng(1)
    cases = [
        [np.diff(b.indptr) for b in ext],
        [np.bincount(b.indices, minlength=n_ext) for b in ext],
        [rng.zipf(1.7, 300).clip(0, 900) * (rng.random(300) < 0.7) for _ in range(3)],
        [np.zeros(40, np.int64), np.zeros(40, np.int64)],
    ]
    for degs in cases:
        for align in (8, 1):
            assert (t_formats.attention_schedule(degs, row_align=align)
                    == j.formats.attention_schedule(degs, row_align=align))


def test_scheduled_bucketed_attention_matches_jax():
    """BucketedAttention.from_scipy under the ranks' forward and transpose
    schedules, for each rank's extended block: every array JAX's (padded
    bucket rows, a perm longer than n_rows), and shapes common to the
    ranks."""
    j = _jax()
    ext = _ext_blocks(_halos()[0])
    n_ext = ext[0].shape[1]
    sched = t_formats.attention_schedule([np.diff(b.indptr) for b in ext])
    sched_t = t_formats.attention_schedule([np.bincount(b.indices, minlength=n_ext) for b in ext])
    shapes = set()
    for b in ext:
        got = t_formats.BucketedAttention.from_scipy(b, schedule=sched, schedule_t=sched_t)
        want = j.formats.BucketedAttention.from_scipy(b, schedule=sched, schedule_t=sched_t)
        _assert_fields_equal(_fields(got), _jax_fields(want))
        assert got.perm.shape[0] > got.n_rows == b.shape[0]
        shapes.add(tuple(a.shape for a in got.indices + got.indices_t))
    assert len(shapes) == 1
    with pytest.raises(ValueError, match="attention_schedule"):
        t_formats.BucketedAttention.from_scipy(ext[0], schedule=[(k, 1) for k, _ in sched])


def test_attention_ell_fixed_k_matches_jax():
    j = _jax()
    for b in _ext_blocks(_halos()[0])[:2]:
        for kw in ({}, dict(fixed_k=24, fixed_k_t=32)):
            got = t_formats.AttentionEll.from_scipy(b, **kw)
            want = j.formats.AttentionEll.from_scipy(b, **kw)
            _assert_fields_equal(_fields(got), _jax_fields(want))
            assert got.n_cols == want.n_cols == b.shape[1]


def test_tiled_pattern_rest_schedule_and_pad_to_match_jax():
    """TiledAttentionPattern.from_scipy with a rest schedule, then pad_to:
    every array JAX's; the padding tiles add no entry to the edge lists."""
    j = _jax()
    ext = _ext_blocks(_halos()[0])
    block = 128
    resids = [t_formats.split_dense_tiles(b, block=block, min_tile_nnz=MIN_TILE_NNZ)[1]
              for b in ext]
    sched = t_formats.attention_schedule([np.diff(r.indptr) for r in resids])
    sched_t = t_formats.attention_schedule(
        [np.bincount(r.indices, minlength=ext[0].shape[1]) for r in resids])
    kw = dict(block=block, min_tile_nnz=MIN_TILE_NNZ, rest_schedule=sched,
              rest_schedule_t=sched_t)
    for b in ext:
        got = TTiled.from_scipy(b, **kw)
        want = j.tiles.TiledAttentionPattern.from_scipy(b, **kw)
        _assert_fields_equal(_fields(got), _jax_fields(want))
        padded = got.pad_to(got.n_tiles + 3)
        _assert_fields_equal(_fields(padded), _jax_fields(want.pad_to(want.n_tiles + 3)))
        assert padded.n_tiles == got.n_tiles + 3 and got.pad_to(got.n_tiles) is got
        for name in ("edges", "edges_t"):
            for f in ("ptr", "idx"):
                assert torch.equal(getattr(getattr(padded, name), f),
                                   getattr(getattr(got, name), f)), (name, f)


@pytest.mark.parametrize("fmt", FORMATS)
def test_build_attention_operands_matches_jax(fmt):
    """The port's per-rank operands, stacked, are JAX's stacked operands
    array for array; the tiled ones share one tile count (three ranks
    padded)."""
    j = _jax()
    t_hx, j_hx = _halos()
    got = t_part.build_attention_operands(t_hx, fmt, min_tile_nnz=MIN_TILE_NNZ)
    want = _jax_fields(j.part.build_attention_operands(j_hx, fmt, min_tile_nnz=MIN_TILE_NNZ))
    assert len(got) == WORLD
    per_rank = [_fields(op) for op in got]
    stacked = {k: np.stack([p[k] for p in per_rank]) for k in per_rank[0]}
    _assert_fields_equal(stacked, want)
    if fmt == "tiled":
        real = [int(TTiled.from_scipy(b, min_tile_nnz=MIN_TILE_NNZ).n_tiles)
                for b in _ext_blocks(t_hx)]
        assert len(set(real)) > 1 and {op.n_tiles for op in got} == {max(real)}


@pytest.mark.parametrize("fmt", ["bell", "ell"])
def test_rank_attention_matches_jax(fmt):
    """gat_attention on rank 3's extended operand (24 rows with no edge)
    against JAX's on the same operand: outputs and the gradients of hw,
    a_src and a_dst; the empty rows give 0 and a finite gradient."""
    j = _jax()
    t_hx, j_hx = _halos()
    t_att = t_part.build_attention_operands(t_hx, fmt)[3]
    j_att = j.jax.tree.map(lambda a: a[3], j.part.build_attention_operands(j_hx, fmt))
    heads, f = 3, 8
    rng = np.random.default_rng(7)
    hw = rng.normal(size=(t_att.n_cols, heads * f)).astype(np.float32)
    a_src, a_dst = (rng.normal(size=(heads, f)).astype(np.float32) for _ in range(2))
    tgt = rng.normal(size=(t_att.n_rows, heads * f)).astype(np.float32)

    def j_loss(h, s, d):
        out = j.attention.gat_attention(j_att, h, s, d)
        return ((out - tgt) ** 2).sum(), out

    (_, j_out), j_g = j.jax.jit(j.jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True))(
        j.jnp.asarray(hw), j.jnp.asarray(a_src), j.jnp.asarray(a_dst))
    ts = [torch.tensor(v, requires_grad=True) for v in (hw, a_src, a_dst)]
    out = t_attention.gat_attention(t_att, *ts)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    for got, want in [(out.detach(), j_out), *((t.grad, g) for t, g in zip(ts, j_g))]:
        want = np.asarray(want)
        assert torch.isfinite(got).all()
        assert np.abs(got.numpy() - want).max() <= ATT_REL_TOL * np.abs(want).max()
    empty = np.diff(_ext_blocks(t_hx)[3].indptr) == 0
    assert empty.sum() == 24
    assert not out.detach().numpy()[empty].any()
