"""Experiment CLI of the PyTorch port (reference: ``gcnmain.py`` — flags C1 in
SURVEY.md §2). Presets encode the reference README's commands::

    python -m graphconvgeo_torch.cli --preset geotext -d ~/data/cmu
    python -m graphconvgeo_torch.cli --preset synthetic          # no data needed
    python -m graphconvgeo_torch.cli --preset synthetic --device cpu
    python -m graphconvgeo_torch.cli --preset geotext -d ~/data/cmu --backend bsr
    python -m graphconvgeo_torch.cli --preset geotext -d ~/data/cmu --model gat --att-backend tiled
    python -m graphconvgeo_torch.cli --preset geotext -d ~/data/cmu --adjacency factorized \
        --gather-dtype bfloat16
    python -m graphconvgeo_torch.cli --preset geotext -d ~/data/cmu --input slab \
        --slab-dtype bfloat16 --slab-cols 1024 --checkpoint-dir ckpt
    python -m graphconvgeo_torch.cli --preset geotext -d ~/data/cmu --eval-only \
        --checkpoint-dir ckpt
    python -m graphconvgeo_torch.cli --preset geotext -d ~/data/cmu --sampled \
        --batch 512 --fanout 10 10

Runs on CUDA by default; ``--device cpu`` runs the plain PyTorch versions of
the kernels on the CPU. This port covers full-graph training of the
Highway-GCN (``--model gcn``) on the materialized adjacency, on every
single-device SpMM backend (``auto``, ``ell``, ``bell``, ``bsr``,
``hybrid``, ``oracle``), or on the factorized projection adjacency
(``--adjacency factorized``), and of the graph attention network
(``--model gat``, on the ``bucketed`` or ``tiled`` attention operand), each
with ``--gather-dtype``, the input layer's options (``--input``,
``--slab-cols``, ``--slab-dtype``, ``--input-cache``), ``--label-fraction``,
``--tune``, checkpoints (``--checkpoint-dir``, ``--eval-only``) and
``--profile-dir``; and neighbor-sampled mini-batch training of the
Highway-GCN (``--sampled``, ``--batch``, ``--fanout``), evaluated
full-graph, whose checkpoints ``--eval-only`` serves full-graph; and
edge-partitioned full-graph training across ``torch.distributed`` ranks
(``--dist``, ``--dist-devices``, ``--halo``, ``--halo-mode``,
``--dist-format``; with ``--eval-only``) of the Highway-GCN on the
materialized adjacency, of the Highway-GCN on the factorized one (one
[G, F] all-reduce of the hub sums, or with ``--hub-sharded`` two rings over
a sharded hub axis) and of the GAT (``--model gat``: the bucketed attention
in ``--dist-format``, or ``--att-backend tiled``); and data-parallel
neighbor-sampled training (``--sampled --dist``: each rank samples
``--batch`` / world size targets a step, one loss over the global batch,
replicated parameters, full-graph evaluation on every rank; its checkpoint
serves the single-device model)::

    python -m graphconvgeo_torch.cli --preset geotext -d ~/data/cmu --dist
    python -m graphconvgeo_torch.cli --preset geotext -d ~/data/cmu --dist --model gat \
        --att-backend tiled
    python -m graphconvgeo_torch.cli --preset geotext -d ~/data/cmu --dist \
        --adjacency factorized --hub-sharded
    torchrun --nproc-per-node 4 -m graphconvgeo_torch.cli --preset geotext \
        -d ~/data/cmu --dist --dist-devices 4
    torchrun --nproc-per-node 4 -m graphconvgeo_torch.cli --preset geotext \
        -d ~/data/cmu --sampled --dist --batch 512 --fanout 10 10

Without a launcher ``--dist`` is a world of one rank (NCCL on the card).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

PRESETS = {
    # hyperparams mirror the reference README commands / paper §4 [SURVEY §6]
    "geotext": dict(bucket=50, hidden=(300, 300), min_df=10, encoding="latin1",
                    celebrity=5, dropout=0.5, l2=0.0, lr=5e-3),
    # slab_dtype bf16 on the Twitter presets only, as in the JAX package:
    # modest datasets keep float32 input numerics under --input auto
    "twitter-us": dict(bucket=2400, hidden=(600, 600), min_df=10, encoding="latin1",
                       celebrity=15, dropout=0.5, l2=0.0, lr=5e-3,
                       slab_dtype="bfloat16"),
    "twitter-world": dict(bucket=2400, hidden=(900, 900), min_df=10, encoding="utf-8",
                          celebrity=5, dropout=0.5, l2=0.0, lr=5e-3,
                          slab_dtype="bfloat16"),
    "synthetic": dict(bucket=30, hidden=(64, 64), min_df=2, encoding="latin1",
                      celebrity=10, dropout=0.3, l2=0.0, lr=5e-3),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", choices=sorted(PRESETS), default="synthetic")
    p.add_argument("-d", "--data-home", default=None, help="directory with user_info.{train,dev,test}")
    p.add_argument("--bucket", type=int, default=None, help="kd-tree leaf size")
    p.add_argument("--hidden", type=int, nargs="+", default=None, help="hidden layer sizes")
    p.add_argument("--min-df", type=int, default=None)
    p.add_argument("--encoding", default=None)
    p.add_argument("--celebrity", type=int, default=None, help="celebrity degree threshold")
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--l2", type=float, default=None, help="L2 regularization weight")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--highway", dest="highway", action="store_true", default=True)
    p.add_argument("--no-highway", dest="highway", action="store_false")
    p.add_argument("--model", choices=("gcn", "gat"), default="gcn",
                   help="model family: highway-GCN (reference) or graph attention")
    p.add_argument("--heads", type=int, default=4, help="attention heads (--model gat)")
    p.add_argument("--attn-dropout", type=float, default=0.0,
                   help="dropout on attention coefficients (--model gat)")
    p.add_argument("--att-backend", choices=("bucketed", "tiled"), default="bucketed",
                   help="GAT attention operand: degree-bucketed gathers (any graph) "
                        "or the flash-style tile kernels plus a bucketed rest "
                        "(community-reordered mention graphs)")
    p.add_argument("--reorder", choices=("auto", "off"), default="auto",
                   help="community-reorder nodes so the tile-based hybrid SpMM "
                        "catches the edge mass; a pure relabeling (labels/"
                        "metrics unaffected)")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="auto",
                   choices=("auto", "ell", "bell", "bsr", "hybrid", "oracle"),
                   help="spmm backend")
    p.add_argument("--adjacency", choices=("materialized", "factorized"), default="materialized",
                   help="factorized keeps Â as B'B'ᵀ + corrections over the user × hub "
                        "mention incidence: cost ∝ #mentions instead of #projected edges "
                        "(GCN only)")
    p.add_argument("--gather-dtype", default=None, choices=["bfloat16", "float32"],
                   help="cast dtype for the SpMM row gathers and the input layer's W0 "
                        "(sums stay float32); on the factorized adjacency bfloat16 also "
                        "contracts its tiles in bf16")
    p.add_argument("--input", dest="input_backend", choices=("auto", "bell", "slab"),
                   default="auto",
                   help="X·W0 input backend: slab = the Zipf-head dense slab plus a "
                        "gather rest (auto: when the vocabulary is big and head-heavy "
                        "enough), bell = gathers only")
    p.add_argument("--slab-cols", type=int, default=4096,
                   help="most dense-slab columns (capped by the slab's byte budget)")
    p.add_argument("--slab-dtype", default=None, choices=["bfloat16", "float32"],
                   help="input-slab storage dtype (default float32; the Twitter presets "
                        "take bfloat16)")
    p.add_argument("--input-cache", action="store_true",
                   help="hot-column cache for the BoW input layer (for very large "
                        "vocabularies; see GCNConfig.input_hot_cache)")
    p.add_argument("--dist", action="store_true",
                   help="edge-partitioned full-graph training across torch.distributed "
                        "ranks (BASELINE config 4): one process per device, started by "
                        "torchrun; without a launcher a world of one rank")
    p.add_argument("--dist-devices", type=int, default=None,
                   help="ranks for --dist (default: the launcher's world size; must "
                        "equal it)")
    p.add_argument("--halo", choices=("auto", "on", "off"), default="auto",
                   help="boundary-row halo exchange vs full all-gather (--dist)")
    p.add_argument("--halo-mode", choices=("alltoall", "ring"), default="alltoall",
                   help="halo collective: one all-to-all, or a ring of point-to-point "
                        "shifts with a product after each (--dist)")
    p.add_argument("--dist-format", choices=("bell", "ell"), default="bell",
                   help="each rank's sparse block format (--dist)")
    p.add_argument("--hub-sharded", action="store_true",
                   help="shard the hub axis of the factorized adjacency over the ranks "
                        "(--dist --adjacency factorized)")
    p.add_argument("--sampled", action="store_true",
                   help="neighbor-sampled mini-batch training (reference "
                        "gcnmain.py -batch; BASELINE config 5)")
    p.add_argument("--batch", type=int, default=512,
                   help="mini-batch target count (--sampled; reference -batch); with "
                        "--dist the global count, batch // world size a rank")
    p.add_argument("--fanout", type=int, nargs="+", default=None,
                   help="neighbors sampled per layer (--sampled); default 10 "
                        "per hidden layer")
    p.add_argument("--label-fraction", type=float, default=1.0,
                   help="train on this share of the training labels")
    p.add_argument("--tune", type=int, default=0, metavar="N",
                   help="random search over N configurations (dropout, L2, lr, width)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save the best parameters here after training")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training: restore the latest checkpoint from "
                        "--checkpoint-dir and report dev/test geo metrics (model flags "
                        "must match the checkpointed shapes)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of training epochs 2-3 "
                        "here (the layers carry named ranges)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs (cuda needs a CUDA device; there is "
                        "no silent fallback to the CPU)")
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--json", action="store_true", help="print final metrics as one JSON line")
    args = p.parse_args(argv)
    for k, v in PRESETS[args.preset].items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    args.hidden = tuple(args.hidden)
    if args.model == "gcn" and args.highway and any(
        a != b for a, b in zip(args.hidden, args.hidden[1:])
    ):
        p.error(
            f"--highway needs equal hidden sizes (got {args.hidden}); "
            "pass --no-highway or matching --hidden values"
        )
    if args.model == "gat" and any(h % args.heads for h in args.hidden):
        p.error(
            f"--model gat needs hidden sizes divisible by --heads {args.heads} "
            f"(got {args.hidden})"
        )
    if args.eval_only and args.tune:
        p.error("--eval-only and --tune are mutually exclusive")
    if args.eval_only and not args.checkpoint_dir:
        p.error("--eval-only requires --checkpoint-dir")
    if args.sampled and args.model == "gat":
        p.error("--sampled supports --model gcn only")
    if args.dist and args.model == "gat" and args.adjacency == "factorized":
        p.error("--dist --model gat needs --adjacency materialized")
    return args


def load_dataset(args):
    from graphconvgeo_torch.data.pipeline import PreprocessConfig, preprocess

    if args.data_home is None:
        if args.preset != "synthetic":
            sys.exit("--data-home is required unless --preset synthetic")
        import tempfile

        from graphconvgeo_torch.data.synthetic import make_synthetic_dumps

        d = tempfile.mkdtemp(prefix="gcg_synth_")
        make_synthetic_dumps(d, n_users=600, n_clusters=6, seed=args.seed)
        args.data_home = d
    cfg = PreprocessConfig(
        bucket_size=args.bucket,
        celebrity_threshold=args.celebrity,
        min_df=args.min_df,
        encoding=args.encoding,
    )
    ds = preprocess(args.data_home, cfg, use_cache=not args.no_cache)
    if args.reorder == "auto":
        ds, _ = ds.reorder()
    return ds


def _model_config(args, ds, *, dropout=None, l2=None, hidden=None):
    from graphconvgeo_torch.models.gat import GATConfig
    from graphconvgeo_torch.models.gcn import GCNConfig

    common = dict(
        n_features=ds.x.shape[1],
        n_classes=ds.n_classes,
        hidden=tuple(hidden or args.hidden),
        dropout=args.dropout if dropout is None else dropout,
        l2=args.l2 if l2 is None else l2,
        gather_dtype=args.gather_dtype,
        input_hot_cache=args.input_cache,
        input_backend=args.input_backend,
        slab_cols=args.slab_cols,
        slab_dtype=args.slab_dtype or "float32",
    )
    if args.model == "gat":
        return GATConfig(
            **common,
            heads=args.heads,
            attn_dropout=args.attn_dropout,
            att_backend=args.att_backend,
        )
    return GCNConfig(**common, highway=args.highway, spmm_backend=args.backend)


def _restore_params(args) -> dict:
    """The latest checkpoint's parameters under ``--checkpoint-dir``."""
    from graphconvgeo_torch.train.checkpoint import latest_checkpoint, restore_checkpoint

    path = latest_checkpoint(args.checkpoint_dir)
    if path is None:
        raise SystemExit(f"no checkpoint found under {args.checkpoint_dir}")
    return restore_checkpoint(path)["params"]


def _build_sampled(args, ds, cfg, tcfg):
    """BASELINE config 5: neighbor-sampled mini-batch training (reference
    ``gcnmain.py`` -batch) of the Highway-GCN on the materialized
    adjacency, which its full-graph evaluation runs on; with ``--dist``
    data-parallel across the ranks of the default process group, each rank
    sampling ``--batch`` / world size targets a step. Returns the
    trainer."""
    from graphconvgeo_torch.data.sampling import NeighborSampler
    from graphconvgeo_torch.models.gcn import HighwayGCN
    from graphconvgeo_torch.sparse.formats import SparseGraph
    from graphconvgeo_torch.train.trainer_sampled import SampledTrainer

    mesh, batch, device = None, args.batch, args.device
    if args.dist:
        from graphconvgeo_torch.parallel.mesh import make_graph_mesh

        mesh = make_graph_mesh(args.device, n_devices=args.dist_devices)
        batch, device = max(1, args.batch // mesh.world_size), mesh.device
    model = HighwayGCN(cfg, SparseGraph(csr=ds.x), SparseGraph(csr=ds.adj, symmetric=True),
                       device=device, seed=args.seed)
    fanouts = tuple(args.fanout) if args.fanout else (10,) * len(cfg.hidden)
    sampler = NeighborSampler(ds.adj, fanouts=fanouts, batch_size=batch, seed=args.seed)
    if mesh is None:
        return SampledTrainer(model, sampler, tcfg)
    from graphconvgeo_torch.parallel.sampled_dist import DistSampledTrainer

    return DistSampledTrainer(model, sampler, mesh, tcfg)


def _build_dist(args, ds, cfg, tcfg):
    """BASELINE config 4: edge-partitioned full-graph training across the
    ranks of the default process group, of the GAT (``--model gat``), the
    Highway-GCN on the factorized adjacency (``--adjacency factorized``,
    ``--hub-sharded``) or on the materialized one. Returns the trainer."""
    from graphconvgeo_torch.parallel.mesh import make_graph_mesh
    from graphconvgeo_torch.parallel.partition import partition_dataset
    from graphconvgeo_torch.parallel.trainer_dist import DistTrainer

    mesh = make_graph_mesh(args.device, n_devices=args.dist_devices)
    # the Zipf-head input slab in its distributed form (zipf_head_cols still
    # decides; --input bell disables it)
    slab_kw = dict(slab_cols=0 if cfg.input_backend == "bell" else cfg.slab_cols,
                   slab_byte_budget=cfg.slab_byte_budget)
    if args.model == "gat":
        from graphconvgeo_torch.parallel.gat_dist import DistGAT

        part = partition_dataset(ds, mesh.world_size, **slab_kw)
        att_format = {"bucketed": args.dist_format, "tiled": "tiled"}[args.att_backend]
        model = DistGAT(cfg, part, mesh, att_format, seed=args.seed)
    elif args.adjacency == "factorized":
        from graphconvgeo_torch.parallel.factorized_dist import (
            DistFactorizedGCN,
            partition_factorized,
        )

        model = DistFactorizedGCN(cfg, partition_factorized(ds, mesh.world_size, **slab_kw), mesh,
                                  halo=args.halo, dist_format=args.dist_format,
                                  halo_mode=args.halo_mode, hub_sharded=args.hub_sharded,
                                  seed=args.seed)
    else:
        from graphconvgeo_torch.parallel.model_dist import DistHighwayGCN

        model = DistHighwayGCN(cfg, partition_dataset(ds, mesh.world_size, **slab_kw), mesh,
                               halo=args.halo, dist_format=args.dist_format,
                               halo_mode=args.halo_mode, seed=args.seed)
    return DistTrainer(model, tcfg)


def run_one(args, ds, *, dropout=None, l2=None, hidden=None, lr=None, quiet=None):
    """Build the model on ``args.device``, train it (or, with
    ``--eval-only``, restore it from the latest checkpoint), evaluate dev
    and test, and save the best parameters under ``--checkpoint-dir`` after
    training. Returns (fit output, dev metrics, test metrics, trainer)."""
    from graphconvgeo_torch.models.gat import GraphAttentionNet
    from graphconvgeo_torch.models.gcn import HighwayGCN
    from graphconvgeo_torch.sparse.formats import SparseGraph
    from graphconvgeo_torch.train.trainer import TrainConfig, Trainer

    cfg = _model_config(args, ds, dropout=dropout, l2=l2, hidden=hidden)
    tcfg = TrainConfig(
        learning_rate=args.lr if lr is None else lr,
        epochs=args.epochs,
        patience=args.patience,
        seed=args.seed,
        verbose=not (args.quiet if quiet is None else quiet),
        profile_dir=args.profile_dir,
    )
    if args.sampled:
        trainer = _build_sampled(args, ds, cfg, tcfg)
        model = trainer.model
    elif args.dist:
        trainer = _build_dist(args, ds, cfg, tcfg)
        model = trainer.model
    else:
        model_cls = GraphAttentionNet if args.model == "gat" else HighwayGCN
        if args.adjacency == "factorized" and args.model == "gcn":
            adj = ds.factorized_adjacency()
        else:
            adj = SparseGraph(csr=ds.adj, symmetric=True)
        model = model_cls(cfg, SparseGraph(csr=ds.x), adj, device=args.device, seed=args.seed)
        trainer = Trainer(model, tcfg)
    if args.eval_only:
        # serve the checkpointed model: no training, the checkpoint untouched;
        # a sampled-trained checkpoint serves full-graph (one module), also
        # one trained data-parallel
        model.load_state_dict(_restore_params(args))
        out = {"params": None, "history": [], "best_epoch": -1}
    else:
        # the distributed full-graph trainer's partition carries the labels
        # and mask
        data = () if args.dist and not args.sampled else (ds.y, ds.train_idx)
        out = trainer.fit(
            *data, ds.dev_idx,
            lat=ds.lat, lon=ds.lon,
            class_lat_median=ds.class_lat_median, class_lon_median=ds.class_lon_median,
            label_fraction=args.label_fraction,
        )
    ev = lambda idx: trainer.evaluate(
        None, idx, lat=ds.lat, lon=ds.lon,
        class_lat_median=ds.class_lat_median, class_lon_median=ds.class_lon_median,
    )
    dev, test = ev(ds.dev_idx), ev(ds.test_idx)
    if args.checkpoint_dir and not args.eval_only:
        metrics = {"dev": dev, "test": test}
        if args.dist:  # rank 0 writes, every rank waits
            trainer.save(args.checkpoint_dir, out["best_epoch"], opt_state=False,
                         metrics=metrics)
        else:
            from graphconvgeo_torch.train.checkpoint import save_checkpoint

            save_checkpoint(args.checkpoint_dir, out["params"], step=out["best_epoch"],
                            metrics=metrics)
    return out, dev, test, trainer


def tune(args, ds) -> tuple:
    """The reference's ``-tune``: a random search over dropout, L2, learning
    rate and hidden width (depth follows ``--hidden``), drawn from
    ``default_rng(seed)`` as the JAX package draws it, so both try the same
    configurations. Returns the best trial's :func:`run_one` output."""
    rng = np.random.default_rng(args.seed)
    base_width = args.hidden[0]
    widths = sorted({max(32, base_width // 2), base_width, base_width * 2})
    best = None
    for t in range(args.tune):
        trial = dict(
            dropout=float(rng.choice([0.3, 0.4, 0.5, 0.6])),
            l2=float(10 ** rng.uniform(-7, -4)),
            lr=float(10 ** rng.uniform(-3.3, -2)),
            hidden=(int(rng.choice(widths)),) * len(args.hidden),
        )
        result = run_one(args, ds, quiet=True, **trial)
        dev = result[1]
        print(f"tune[{t}] {trial} -> dev acc@161 {dev['acc_at_161']:.3f}")
        if best is None or dev["acc_at_161"] > best[1][1]["acc_at_161"]:
            best = (trial, result)
    print(f"best: {best[0]}")
    return best[1]


def _dist_record(args, ds, out, model) -> dict:
    """:func:`main`'s run record for ``--dist``."""
    from graphconvgeo_torch.parallel.factorized_dist import DistFactorizedGCN
    from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern

    part, slab = model.part, model.data.get("x_slab")
    bsr = model.data.get("bsr")
    run = {
        "history": out["history"],
        "best_epoch": out["best_epoch"],
        "model": args.model,
        "input_operand": "StackedEll",
        "slab_dtype": str(slab.dtype).removeprefix("torch.") if slab is not None else None,
        "slab_cols": int(slab.shape[1]) if slab is not None else 0,
        "reorder": ds.reorder_method,
        "device": str(model.device),
        "sampled": False,
        "adjacency": "factorized" if isinstance(model, DistFactorizedGCN) else "materialized",
        "hub_sharded": bool(getattr(model, "hub_sharded", False)),
        "gather_dtype": args.gather_dtype,
        "backend": model.local_backend,
        "n_tiles": bsr.n_tiles if bsr is not None else 0,
        "dist": True,
        "world_size": model.mesh.world_size,
        "rank": model.mesh.rank,
        "rows_per_device": part.rows_per_device,
        "halo": model.halo is not None,
        "halo_mode": model.halo_mode,
        "dist_format": model.dist_format,
    }
    if args.model == "gat":
        # the rank's attention operand: its tiles (padded to the ranks'
        # largest count) and edges, or the bucketed / fixed-K pattern's edges
        att = model.data["att"]
        run["att_backend"] = args.att_backend
        if isinstance(att, TiledAttentionPattern):
            run.update(att.stats())
        else:
            run.update(n_tiles=0, tiled_edges=0, rest_edges=int(sum(
                float(v.sum()) for v in (att.valid if isinstance(att.valid, tuple)
                                         else (att.valid,)))))
    return run


def main(argv=None):
    """Run the CLI. Prints the report (``--json``: one JSON line with the dev
    and test metrics) and returns it, together with the run's record
    (``"run"``: per-epoch history (empty under ``--eval-only``), best epoch,
    model family, the input operand with its slab dtype, slab columns and
    rest type, resolved backend or attention operand, reorder candidate,
    dense-tile count and, for the GAT, the attention operand's tile and
    rest-edge counts; for the GCN its adjacency and gather dtype, and for
    the factorized one each tile operand's tiles and each rest's rows) that
    is not printed; under ``--sampled`` also the sampler's path (native or
    numpy), the batch size a rank samples, the fanouts, ``dist`` and under
    ``--dist`` the world size and rank; under ``--dist`` (where only rank 0
    prints) the ranks, rows per rank, halo, halo mode, block format, the
    adjacency and ``hub_sharded``, the rank's local backend (``bsr``: kernel
    1 on its dense local tiles, which ``n_tiles`` counts) and, for the GAT,
    the rank's attention operand's tile and edge counts. With ``--tune`` the
    record is the best trial's."""
    from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern
    from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency
    from graphconvgeo_torch.sparse.formats import BsrFlat, BsrMatrix, SlabbedBell
    from graphconvgeo_torch.utils.device import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)  # fail before preprocessing, not after
    ds = load_dataset(args)
    if not args.quiet:
        print(
            f"dataset: {ds.n_nodes} nodes, {ds.adj.nnz} edges, "
            f"{ds.x.shape[1]} features, {ds.n_classes} classes"
        )
    out, dev, test, trainer = tune(args, ds) if args.tune > 0 else run_one(args, ds)
    report = {"dev": dev, "test": test}
    model = trainer.model
    lead = not args.dist or trainer.mesh.rank == 0  # one rank reports
    if lead and args.json:
        print(json.dumps(report))
    elif lead:
        for split, m in report.items():
            print(
                f"{split}: Acc@161 {m['acc_at_161']:.3f}  mean {m['mean_km']:.0f} km  "
                f"median {m['median_km']:.0f} km"
            )
    if args.dist and not args.sampled:
        return {**report, "run": _dist_record(args, ds, out, model)}
    x_op = model.arrays["x"]
    slabbed = isinstance(x_op, SlabbedBell)
    run = {
        "history": out["history"],
        "best_epoch": out["best_epoch"],
        "model": args.model,
        "input_operand": type(x_op).__name__,
        "slab_dtype": str(x_op.slab.dtype).removeprefix("torch.") if slabbed else None,
        "slab_cols": int(x_op.cols.shape[0]) if slabbed else 0,
        "input_rest": type(x_op.rest).__name__ if slabbed and x_op.rest is not None else None,
        "reorder": ds.reorder_method,
        "device": str(model.device),
        "sampled": args.sampled,
    }
    if args.sampled:
        sampler = trainer.sampler
        run.update(sampler="native" if sampler.native else "numpy",
                   batch=sampler.batch_size, fanouts=list(sampler.fanouts), dist=args.dist)
        if args.dist:
            run.update(world_size=trainer.mesh.world_size, rank=trainer.mesh.rank)
    if args.model == "gat":
        att = model.arrays["att"]
        run["att_backend"] = args.att_backend
        if isinstance(att, TiledAttentionPattern):
            run.update(att.stats())
        else:
            run.update(n_tiles=0, tiled_edges=0, rest_edges=int(ds.adj.nnz))
    else:
        adj_op = model.arrays.get("adj")
        run["backend"] = model.backend
        run["adjacency"] = ("factorized" if isinstance(adj_op, FactorizedAdjacency)
                            else "materialized")
        run["gather_dtype"] = args.gather_dtype
        if isinstance(adj_op, FactorizedAdjacency):
            st = adj_op.stats()
            run.update(st)
            run["n_tiles"] = sum(st[f"{k}_tiles"] for k in ("bt", "b", "r", "zr"))
        else:
            tiles = adj_op[0] if isinstance(adj_op, tuple) else adj_op
            run["n_tiles"] = tiles.n_tiles if isinstance(tiles, (BsrFlat, BsrMatrix)) else 0
    return {**report, "run": run}


if __name__ == "__main__":
    main()
