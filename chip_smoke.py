#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (graphconvgeo_torch) on one GPU.

    python3 chip_smoke.py              # the smoke test
    python3 chip_smoke.py --profile    # set-up, then where an epoch's time goes

Phases, in order; any failure raises and the script exits non-zero:

1. Set-up: print the card's name and power limit, require CUDA, pin float32
   products to full float32 (no TF32), build every CUDA kernel from
   ``graphconvgeo_torch/csrc`` (one nvcc per source, all started together).
2. Each kernel against its plain PyTorch version on the card, forward and
   backward, on the edge-case operands below and on the GeoText-scale hybrid
   operand; time the kernel, the plain version and one library call.
3. The main path: the port's CLI (``graphconvgeo_torch.cli.main``) trains
   the ``geotext`` preset on GeoText-scale synthetic dumps. Launch counts
   are zeroed just before and read just after.
4. Card against CPU at full width: one forward, loss and gradient from the
   same parameters on ``cuda`` (kernels) and on ``cpu`` (plain versions).
5. Report: the card's line, one JSON line with every kernel, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time

# ---- edge-case operands, sizes and tolerances (later slices extend these) ----
# A kernel passes when max|kernel - plain| <= KERNEL_REL_TOL * max|plain|,
# forward and backward: both sum the same float32 products, in another order.
KERNEL_REL_TOL = 1e-4
# Empty-row-block operands: row block 1 has no edges (its output rows must be
# exactly zero), row block 0 many tiles, the rest about one each.
EMPTY_ROW_BLOCK_CASES = (
    {"block": 128, "n_rows": 500, "n_cols": 400, "f": 40, "seed": 0},
    {"block": 256, "n_rows": 1000, "n_cols": 800, "f": 300, "seed": 1},
)
# GeoText scale: the generator parameters of benchmarks/geotext_scale.py
GEOTEXT_DUMPS = dict(
    n_users=9475, n_clusters=64, seed=0, words_per_user=60,
    mentions_per_user=5, cluster_spread_deg=0.5,
)
GEOTEXT_PREPROCESS = dict(bucket_size=50, celebrity_threshold=5, min_df=10, encoding="latin1")
GEOTEXT_F = 300  # the geotext preset's hidden width (padded to 384 for the kernel)
EPOCHS = 30
MIN_DEV_ACC = 0.8  # dev Acc@161 after EPOCHS (the JAX package on a CPU: 0.94)
LOSS_DROP = 0.5  # the last epoch's loss must be below this × the first's
# launches each training epoch must make on the main path: 2 conv forwards
# + 2 backwards in the step, 2 forwards in the epoch's predict
EXPECTED_LAUNCHES_PER_EPOCH = {"bsr_flat_matmul": 6}
# Card vs CPU at full width (phase 4)
CARD_CPU_LOSS_RTOL = 1e-5
CARD_CPU_REL_TOL = 1e-4
# H100 SXM published peaks (NVIDIA data sheet, 700 W), for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TIMING_WARMUP = 3
TIMING_ITERS = 20
DEVICE = "cuda"  # where the port runs; phase 4 compares it with "cpu"

KERNEL_META = {
    "bsr_flat_matmul": {
        "route": "cuda",
        "source": "graphconvgeo_torch/csrc/bsr_flat.cu",
        "replaces": "graphconvgeo_tpu/ops/spmm_pallas.py:171",
        "replaces_function": "graphconvgeo_tpu/ops/spmm_pallas.py::_bsr_flat_matmul",
    },
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def check_close(name: str, got, want, tol: float) -> float:
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    print(f"  {name}: max abs err {err!r} (max |ref| {scale!r}, limit {tol * scale!r})")
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max abs err {err} > {tol} x {scale}")
    return err


def cuda_ms(fn) -> float:
    """Mean milliseconds per call over TIMING_ITERS back-to-back calls, after
    a warm-up, timed with CUDA events."""
    import torch

    for _ in range(TIMING_WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMING_ITERS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / TIMING_ITERS


def empty_row_block_matrix(case: dict):
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(case["seed"])
    b, n, c = case["block"], case["n_rows"], case["n_cols"]
    n_dense = 24 * b
    rows = np.r_[rng.integers(0, b, n_dense), rng.integers(2 * b, n, 4 * b)]
    cols = np.r_[rng.integers(0, c, n_dense), rng.integers(0, b, 4 * b)]
    m = sp.coo_matrix(
        (rng.normal(size=len(rows)).astype(np.float32), (rows, cols)), shape=(n, c)
    ).tocsr()
    m.sum_duplicates()
    return m


def compare_flat(name: str, mat, mat_t, f: int, seed: int, *, empty_row_block=None) -> dict:
    """The kernel against its plain version on one operand: the forward
    through the wrapper at the padded width, the backward through
    spmm_bsr_flat's autograd Function against plain autograd."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from graphconvgeo_torch.ops.spmm_bsr import (
        bsr_flat_matmul,
        bsr_flat_matmul_plain,
        spmm_bsr_flat,
    )
    from graphconvgeo_torch.sparse.formats import _round_up

    dev = mat.tiles.device
    rng = np.random.default_rng(seed)
    h = torch.tensor(rng.normal(size=(mat.n_cols, f)).astype(np.float32), device=dev)
    w = torch.tensor(rng.normal(size=(mat.n_rows, f)).astype(np.float32), device=dev)
    f_pad = _round_up(f, 128)
    pad = (0, f_pad - f, 0, mat.n_cols_padded - mat.n_cols)
    h_p = F.pad(h, pad).contiguous()
    print(f"{name}: {mat.n_tiles} tiles of {mat.block}^2, h {tuple(h_p.shape)}")
    out_k = bsr_flat_matmul(mat, h_p)
    out_p = bsr_flat_matmul_plain(mat, h_p)
    torch.cuda.synchronize()
    fwd = check_close("forward", out_k, out_p, KERNEL_REL_TOL)
    if empty_row_block is not None:
        b = mat.block
        blk = out_k[empty_row_block * b : (empty_row_block + 1) * b]
        if not bool((blk == 0).all()):
            raise AssertionError(f"{name}: empty row block {empty_row_block} is not zero")
        print(f"  empty row block {empty_row_block}: exactly zero")
    hk = h.clone().requires_grad_(True)
    (spmm_bsr_flat(mat, mat_t, hk) * w).sum().backward()
    hp = h.clone().requires_grad_(True)
    (bsr_flat_matmul_plain(mat, F.pad(hp, pad))[: mat.n_rows, :f] * w).sum().backward()
    torch.cuda.synchronize()
    bwd = check_close("backward dh", hk.grad, hp.grad, KERNEL_REL_TOL)
    return {"fwd": fwd, "bwd": bwd, "h_p": h_p}


def phase_setup():
    import torch

    print("== phase 1: set-up")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    from graphconvgeo_torch.utils import cuda_build

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 must be False")
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log = cuda_build.build()
    print(f"kernels built in {time.perf_counter() - t0!r} s")
    for stem, rec in log.items():
        print(f"  {stem}: nvcc {rec['seconds']!r} s\n{rec['ptxas']}")


def make_geotext_dataset(data_dir: str):
    from graphconvgeo_torch.data.pipeline import PreprocessConfig, preprocess
    from graphconvgeo_torch.data.synthetic import make_synthetic_dumps

    make_synthetic_dumps(data_dir, **GEOTEXT_DUMPS)
    ds = preprocess(data_dir, PreprocessConfig(**GEOTEXT_PREPROCESS), use_cache=False)
    ds, _ = ds.reorder()
    return ds


def phase_kernels(ds) -> dict:
    import numpy as np
    import torch

    from graphconvgeo_torch.ops.spmm_bsr import bsr_flat_matmul, bsr_flat_matmul_plain
    from graphconvgeo_torch.sparse.formats import BsrFlat, SparseGraph, split_dense_tiles, to_device

    print("== phase 2: kernels against their plain versions")
    dev = torch.device(DEVICE)
    for case in EMPTY_ROW_BLOCK_CASES:
        m = empty_row_block_matrix(case)
        mat = to_device(BsrFlat.from_scipy(m, block=case["block"]), dev)
        mat_t = to_device(BsrFlat.from_scipy(m.T.tocsr(), block=case["block"]), dev)
        compare_flat(
            f"empty-row-block B={case['block']}", mat, mat_t, case["f"], case["seed"],
            empty_row_block=1,
        )

    graph = SparseGraph(csr=ds.adj, symmetric=True)
    bsr, _ = graph.hybrid()
    mat = to_device(bsr, dev)
    res = compare_flat("GeoText-scale hybrid BsrFlat", mat, mat, GEOTEXT_F, 2)
    h_p = res["h_p"]

    dense, _ = split_dense_tiles(ds.adj, block=bsr.block, min_tile_nnz=96)
    n = dense.shape[0]
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(dense.indptr.astype(np.int64)),
        torch.from_numpy(dense.indices.astype(np.int64)),
        torch.from_numpy(dense.data.astype(np.float32)),
        size=dense.shape,
        check_invariants=False,
    ).to(dev)
    h_lib = h_p[:n].contiguous()
    ms = cuda_ms(lambda: bsr_flat_matmul(mat, h_p))
    plain_ms = cuda_ms(lambda: bsr_flat_matmul_plain(mat, h_p))
    library_ms = cuda_ms(lambda: torch.sparse.mm(csr, h_lib))
    lib_err = float((torch.sparse.mm(csr, h_lib) - bsr_flat_matmul(mat, h_p)[:n]).abs().max())

    # The bound counts what this product's data needs: each nonzero once as
    # a float32 value and an int32 column (CSR), the row pointers, h read
    # once and the output written once; 2 flops per nonzero and column. The
    # tile format's own traffic (every dense tile, zeros included) and its
    # dense-tile flops are printed beside it, not used as the bound.
    f_pad = h_p.shape[1]
    nnz = int((bsr.tiles != 0).sum())
    h_out_bytes = 4 * (h_p.numel() + mat.n_rows_padded * f_pad)
    n_bytes = 8 * nnz + 4 * (mat.n_rows_padded + 1) + h_out_bytes
    flops = 2 * nnz * f_pad
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    tile_bytes = 4 * mat.tiles.numel() + h_out_bytes
    dense_flops = 2 * mat.n_tiles * mat.block**2 * f_pad
    print(
        f"  tiles {mat.n_tiles} of {mat.block}^2, nnz {nnz}, fill {nnz / (mat.n_tiles * mat.block**2)!r}\n"
        f"  bound: bytes {n_bytes} -> {bytes_ms!r} ms at 3.35 TB/s; flops {flops} -> "
        f"{ops_ms!r} ms at 67 TFLOP/s f32; bound {bound_ms!r} ms\n"
        f"  tile format: bytes {tile_bytes} -> {tile_bytes / HBM_BYTES_PER_S * 1e3!r} ms; "
        f"dense-tile flops {dense_flops} -> {dense_flops / FP32_FLOPS * 1e3!r} ms\n"
        f"  kernel {ms!r} ms, plain {plain_ms!r} ms, torch.sparse.mm (CSR) {library_ms!r} ms "
        f"(library vs kernel max abs diff {lib_err!r})"
    )
    return {
        "bsr_flat_matmul": {
            "fwd_max_err": res["fwd"],
            "bwd_max_err": res["bwd"],
            "max_abs_err": max(res["fwd"], res["bwd"]),
            "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
    }


def phase_main_path(data_dir: str) -> dict:
    import math

    from graphconvgeo_torch import cli
    from graphconvgeo_torch.utils import cuda_build

    print("== phase 3: the main path (graphconvgeo_torch.cli.main, geotext preset)")
    argv = ["--preset", "geotext", "-d", data_dir, "--epochs", str(EPOCHS),
            "--patience", str(EPOCHS), "--device", DEVICE, "--json"]
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    report = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.launch_counts)
    run = report["run"]
    hist = run["history"]
    losses = [h["loss"] for h in hist]
    secs = [h["seconds"] for h in hist]
    per_epoch = [b - a for a, b in zip([0.0] + secs[:-1], secs)]
    # each epoch's launches, as the trainer counted them; the rest of the
    # run's launches are the final dev and test evaluation
    in_training = {k: sum(h["launches"][k] for h in hist) for k in launches}
    print(
        f"  device {run['device']}, backend {run['backend']}, input {run['input_operand']}, "
        f"reorder candidate {run['reorder']!r}, {run['n_tiles']} dense tiles\n"
        f"  epochs {len(hist)}, loss {losses[0]!r} -> {losses[-1]!r}, "
        f"dev Acc@161 {report['dev']['acc_at_161']!r}, test Acc@161 {report['test']['acc_at_161']!r}\n"
        f"  seconds per epoch (step + predict + geo_eval): first {per_epoch[0]!r}, "
        f"median of the rest {sorted(per_epoch[1:])[len(per_epoch[1:]) // 2]!r}; "
        f"main() wall {wall!r} s\n"
        f"  launches {launches}: in the {len(hist)} training epochs {in_training}, "
        f"after them {({k: launches[k] - in_training[k] for k in launches})}"
    )
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < LOSS_DROP * losses[0]:
        raise AssertionError(f"loss {losses[0]} -> {losses[-1]} did not halve")
    if not report["dev"]["acc_at_161"] >= MIN_DEV_ACC:
        raise AssertionError(f"dev Acc@161 {report['dev']['acc_at_161']} < {MIN_DEV_ACC}")
    if run["backend"] != "hybrid":
        raise AssertionError(f"backend resolved to {run['backend']}, not hybrid")
    for name, per in EXPECTED_LAUNCHES_PER_EPOCH.items():
        counts = [h["launches"][name] for h in hist]
        if any(c != per for c in counts):
            raise AssertionError(f"{name}: launches per epoch {counts}, expected {per} each")
        if launches[name] < per * len(hist):
            raise AssertionError(f"{name}: {launches[name]} launches < {per} x {len(hist)}")
    return {
        "launches": launches, "in_training": in_training,
        "epochs": len(hist), "per_epoch_s": per_epoch,
    }


def phase_card_vs_cpu(ds) -> None:
    import torch

    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.models.gcn import GCNConfig, HighwayGCN
    from graphconvgeo_torch.sparse.formats import SparseGraph

    print("== phase 4: card against CPU at full width (dropout 0)")
    cfg = GCNConfig(
        n_features=ds.x.shape[1], n_classes=ds.n_classes,
        hidden=PRESETS["geotext"]["hidden"], dropout=0.0,
    )
    x_graph, adj_graph = SparseGraph(csr=ds.x), SparseGraph(csr=ds.adj, symmetric=True)
    y = torch.as_tensor(ds.y, dtype=torch.int64)
    mask = torch.zeros(ds.n_nodes)
    mask[torch.as_tensor(ds.train_idx)] = 1.0
    results = {}
    state = None
    for dev in (DEVICE, "cpu"):
        model = HighwayGCN(cfg, x_graph, adj_graph, device=dev, seed=3)
        if state is None:
            state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        logits = model.apply(train=False).detach()
        loss = model.loss(y.to(dev), mask.to(dev), train=True)
        loss.backward()
        results[dev] = {
            "backend": model.backend,
            "logits": logits.cpu(),
            "loss": float(loss.detach()),
            "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
        }
    gpu, cpu = results[DEVICE], results["cpu"]
    print(f"  backend {gpu['backend']} (cuda) / {cpu['backend']} (cpu); "
          f"loss {gpu['loss']!r} (cuda) vs {cpu['loss']!r} (cpu)")
    if abs(gpu["loss"] - cpu["loss"]) > CARD_CPU_LOSS_RTOL * abs(cpu["loss"]):
        raise AssertionError("loss differs between card and CPU")
    check_close("logits", gpu["logits"], cpu["logits"], CARD_CPU_REL_TOL)
    for k in cpu["grads"]:
        check_close(f"grad {k}", gpu["grads"][k], cpu["grads"][k], CARD_CPU_REL_TOL)


def phase_profile(ds, epochs: int = 5) -> None:
    """Where one main-path epoch's time goes (geotext preset, on the card):
    the wall time of ``epochs`` epochs (train step + predict + geo_eval),
    then the same epochs under torch.profiler — device busy time per epoch
    and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.models.gcn import GCNConfig, HighwayGCN
    from graphconvgeo_torch.sparse.formats import SparseGraph
    from graphconvgeo_torch.train.evaluate import geo_eval
    from graphconvgeo_torch.train.trainer import TrainConfig, Trainer

    print("== profile: one main-path epoch (geotext preset)")
    pre = PRESETS["geotext"]
    cfg = GCNConfig(n_features=ds.x.shape[1], n_classes=ds.n_classes,
                    hidden=pre["hidden"], dropout=pre["dropout"], l2=pre["l2"])
    model = HighwayGCN(cfg, SparseGraph(csr=ds.x), SparseGraph(csr=ds.adj, symmetric=True),
                       device=DEVICE, seed=0)
    trainer = Trainer(model, TrainConfig(learning_rate=pre["lr"], verbose=False))
    y = torch.as_tensor(ds.y, dtype=torch.int64, device=DEVICE)
    mask = torch.zeros(ds.n_nodes, device=DEVICE)
    mask[torch.as_tensor(ds.train_idx, device=DEVICE)] = 1.0
    dev_idx = ds.dev_idx

    def epoch():
        trainer.train_step(y, mask)
        pred = trainer.predict()
        geo_eval(pred[dev_idx], ds.lat[dev_idx], ds.lon[dev_idx],
                 ds.class_lat_median, ds.class_lon_median)

    for _ in range(3):
        epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(epochs):
        epoch()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / epochs * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(epochs):
            epoch()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) / epochs * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / epochs
    print(f"  epoch wall {wall_ms!r} ms (under the profiler {prof_wall_ms!r} ms); "
          f"device busy {busy_ms!r} ms per epoch = {busy_ms / wall_ms!r} of the "
          f"unprofiled wall, idle share {1 - busy_ms / wall_ms!r}")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:15]:
        ms = e.self_device_time_total / 1e3 / epochs
        print(f"  {ms:10.4f} ms/epoch {ms / busy_ms:7.2%} x{e.count // epochs:<4d} {e.key[:90]}")


def main() -> int:
    import torch

    phase_setup()
    data_dir = tempfile.mkdtemp(prefix="gcg_geotext_")
    try:
        t0 = time.perf_counter()
        ds = make_geotext_dataset(data_dir)
        print(f"GeoText-scale dataset: {ds.n_nodes} nodes, {ds.adj.nnz} adjacency nonzeros, "
              f"vocab {ds.x.shape[1]}, {ds.n_classes} classes, reorder {ds.reorder_method!r} "
              f"({time.perf_counter() - t0!r} s)")
        if "--profile" in sys.argv[1:]:
            phase_profile(ds)
            return 0
        kernels = phase_kernels(ds)
        main_path = phase_main_path(data_dir)
        phase_card_vs_cpu(ds)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    print("== phase 5: report")
    rows = []
    for name, k in kernels.items():
        launches = main_path["launches"][name]
        in_training = main_path["in_training"][name]
        rows.append({
            "name": name,
            **KERNEL_META[name],
            "launches": launches,
            "launches_per_epoch": in_training / main_path["epochs"],
            "launches_after_training": launches - in_training,
            "epochs": main_path["epochs"],
            **{key: k[key] for key in (
                "max_abs_err", "fwd_max_err", "bwd_max_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms",
            )},
            "kernel_ms": k["ms"],
        })
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
