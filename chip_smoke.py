#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (graphconvgeo_torch) on one GPU.

    python3 chip_smoke.py              # the smoke test
    python3 chip_smoke.py --profile    # set-up, then where an epoch's time goes (each main
                                       # path) and the factorized operator's step at 262k
    python3 chip_smoke.py --kernels    # set-up and phase 2 only (no ok line)
    python3 chip_smoke.py --world      # set-up and the World paths only (no ok line)

Phases, in order; any failure raises and the script exits non-zero:

1. Set-up: print the card's name and power limit, require CUDA, pin float32
   products to full float32 (no TF32), build every CUDA kernel from
   ``graphconvgeo_torch/csrc`` (one nvcc per source, all started together).
2. Each kernel against its plain PyTorch version on the card, forward and
   backward, on the edge-case operands below and on the GeoText-scale
   operands; time the kernel, the plain version and one library call where
   one exists. For the GAT: the three sweep kernels (all three walk the
   pattern's edge lists: at GeoText and 32k their
   build is timed once, their lengths printed and their entry count checked
   against the tiled edges), then the whole tiled
   layer (its autograd Function) against a plain edge-list layer under
   autograd, and the tiled layer's forward + backward timed against the
   bucketed layer's (alternating repeats, host included and device alone),
   at GeoText scale and on the 32k mention-projection operand. The three
   sweeps with bf16 tile contractions (``mxu_precision="default"``,
   kernels 3-5') against their bf16-rounding plain versions on the same
   operands (both dropout settings, the empty block, the hot column, the
   padded head width), timed at GeoText and 32k beside their bounds; then
   their path, ``gat_attention_tiled(..., mxu_precision="default")``
   forward + backward once at GeoText, with the counts zeroed before and
   read after (one launch of each variant), held against the float32
   edge-list layer at a bf16 tolerance.
   For the padded-list BSR: its product (forward and backward), the BSR
   SDDMM (mask on and off) and the row gather (bit-equal) on edge-case
   patterns and at GeoText scale, each timed beside its plain version and
   one library call, in turns (the padded-list product also in its bf16
   contraction). The two BSR products (one packed-row kernel)
   and the SDDMM also run on a full-tile operand (the SDDMM once more with
   its rows scaled over 1e-3..1e3, where the mask-off kernel's 3xTF32 must
   keep float32's accuracy); at GeoText scale the pack
   of each operand is timed once and its entry count checked against the
   tiles', and one SDDMM call is shown to be one allocation and one
   launch. The gather is held bit-equal to ``index_select`` at 16-byte and
   full-width rows, short and long, and timed in turns with it.
   For the factorized adjacency: kernel 1's bf16 contraction against its
   plain twin (h in float32 and in bfloat16) on the edge-case operands and
   on the GeoText factorized operand's two tile operands (B'ᵀ and the
   non-square merged [R' + diag | 0 | B']); the factorized operator (its
   autograd Function, forward and backward) against Â·h of the materialized
   Â, in float32 and bf16; its forward + backward timed (host included and
   device alone) at GeoText and at bench.py's headline shape (262,144 users,
   F 512), with kernel 1 on each tile operand beside its bound, its plain
   twin and torch.sparse.mm.
   The input layer X·W0 (forward + backward) at GeoText is timed on the
   bucketed gathers and on the Zipf-head slab, float32 and bf16
   (``utils/timing.device_trial_seconds``; printed, not asserted).
   The 3×TF32 dense products (``ops/dense.py``, ``phase_dense``) at every
   shape a driven path gives the kernel (the World cell's, gcn_world_cli's
   and the sampled outer conv's), nn, nt and tn: their error against
   float64 beside torch.matmul's and one TF32 product's, two calls bitwise
   equal, kernel and torch.matmul timed in turns beside the 3×TF32 bound;
   the autograd Function (forward and backward) against torch.autograd at
   the head's and the slab's shapes; the error by contraction depth
   (printed); and the sweep of rows, which must show the kernel ahead from
   ``dense.MIN_ROWS`` rows at every swept shape ``dense.MIN_WIDTH`` lets
   take it.
3. The main paths: the port's CLI (``graphconvgeo_torch.cli.main``) trains
   the ``geotext`` preset on GeoText-scale synthetic dumps: the Highway-GCN
   on the default (``hybrid``) backend, the GAT on the tiled attention
   operand, the Highway-GCN on ``--backend bsr``, then on
   ``--adjacency factorized`` without and with ``--gather-dtype bfloat16``,
   then on a bf16 input slab of 1,024 columns with a bucketed rest
   (``--input slab --slab-dtype bfloat16 --slab-cols 1024``), saving its
   best parameters under ``--checkpoint-dir``; ``--eval-only`` then serves
   them back and must reproduce its dev and test metrics exactly. A
   ``--profile-dir`` run leaves a trace with the models' ranges and the
   kernel's events; ``--tune 2`` runs two trials. Then the Highway-GCN
   trains on neighbor-sampled mini-batches (``--sampled --batch 512
   --fanout 10 10``, the native sampler): its steps launch no kernel, each
   epoch's full-graph dev evaluation 2 of kernel 1 and the final dev + test
   evaluation 4; ``--eval-only`` serves its checkpoint full-graph with the
   same metrics. The sampler's host ms per batch (native and numpy paths),
   a step's device ms and its peak CUDA memory are printed. Then the
   distributed Highway-GCN (``graphconvgeo_torch/parallel``) at world size
   1 on NCCL: (a) ``DistHighwayGCN`` on ``partition_rows(row_align=256)``
   with the halo on runs kernel 1 on the rank's dense local tiles (the
   hybrid path's tiles), its loss and gradients at dropout 0 hold against
   the single-device hybrid model, and 30 epochs through ``DistTrainer``
   make 6 kernel-1 launches each and reach MIN_DEV_ACC, with one epoch's
   device breakdown; (b) ``cli.main --dist`` (the CLI's partition, 9,480
   rows per rank, so the ``bell`` local backend and no launch) trains to
   MIN_DEV_ACC; (c) ``--dist --eval-only`` serves its checkpoint with the
   same metrics. Then slice B: (e) ``DistGAT(att_format="tiled")`` at world
   size 1 on the CLI's partition (9,480 rows, 5 of them padding rows with
   no edge): the rank's extended pattern (9,480 x 9,488) holds the
   single-device GAT's tiles and rest edges, kernels 3-5 hold against
   their plain twins on it (exactly neutral on its rows and columns with
   no edge), its loss and gradients at dropout 0 against the single-device
   tiled GAT's, 30 epochs through ``DistTrainer`` with the single GAT's
   launches to MIN_DEV_ACC, one epoch's device breakdown; (g) ``cli.main
   --dist --model gat --att-backend tiled`` and (h) its ``--eval-only``;
   (i) ``cli.main --dist --adjacency factorized`` without and with
   ``--hub-sharded`` (no kernel; equal metrics). Then slice C: (j)
   ``DistSampledTrainer`` at world size 1: a step's loss and gradients at
   dropout 0 against ``SampledTrainer``'s on the same sub-batch, and one
   epoch's device breakdown; (k) ``cli.main --sampled --dist`` (batch 512
   a rank, fanouts 10 10): no launch in the steps, 2 of kernel 1 in each
   dev evaluation, 4 after, to MIN_DEV_ACC; (l) its ``--eval-only``
   exact. Then, after every GeoText path, the World paths: ``gcn_world``,
   the twitter-world preset's Highway-GCN (hidden 900-900, 930 classes, a
   50,000-token vocabulary) at WORLD_N users on ``world_problem``'s data,
   on the factorized Â with bf16 gathers and kernel 1's bf16 contraction,
   remat and the bf16 input slab cut to WORLD_SLAB_COLS columns by its
   byte budget: the operands' sizes, kernel 1-bf16 on both tile operands
   at F 900 against its plain twin (timed in turns with torch.sparse.mm,
   beside its bound), Adam steps whose streamed CE head engages by its own
   gate (its row blocks counted), 12 launches a step and 4 a predict, the
   steps' host and device seconds, peak memory and one profiled step, the
   dev evaluation through the streamed predict; ``gcn_world_cli``,
   ``cli.main --preset twitter-world --adjacency factorized --gather-dtype
   bfloat16`` for 3 epochs on 65,536 synthetic users. Launch counts are
   zeroed just before each run and read just after.
4. Card against CPU at full width, for each main path's model: one forward,
   loss and gradient from the same parameters on ``cuda`` (kernels) and on
   ``cpu`` (plain versions); for the sampled path one sampled forward, loss
   and gradient on one batch, at hidden 300 and at the twitter-world
   preset's 900; (d) the distributed model of (a) and (f) that of (e)
   against the same model on a gloo group of the CPU; then the ``hybrid``
   GCN with ``remat``
   against the one without, on the card (6 kernel-1 launches a step
   against 4); the World config at WORLD_PARITY_N users with the streamed
   head forced on, at the bf16 limits, its streamed predictions equal
   wherever the CPU's top-2 logit margin is clear.
5. Report: the card's line, one JSON line with every kernel, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from graphconvgeo_torch.utils.profiling import H100, counters

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
# The padded-list BSR's edge cases: the B = 128 empty-row-block operand
# above, and an asymmetric B = 256 one whose sides are not multiples of B:
# row block 0 spans all 6 column blocks (k_max 6, the others 1, row block 1
# padding only), and its transpose has k_max 4.
BSR_CASES = (
    EMPTY_ROW_BLOCK_CASES[0],
    {"block": 256, "n_rows": 1100, "n_cols": 1500, "f": 300, "seed": 3},
)
BSR_GEOTEXT_TILES = 5563  # GeoText-scale Â in 128² tiles (the bsr() default)
# Full-tile operands, one per BSR kernel: tile (row block 0, column block 1)
# completely full beside scattered rows, and a few more entries in row block
# 0's rows, so those rows hold B + 1..FULL_TILE_EXTRA entries: many 32-entry
# batches of the packed-row kernel and counts that are not multiples of its
# 4-entry unroll. F 600 pads to 640: four 128-column passes and a second,
# partly masked block column.
FULL_TILE_EXTRA = 3
FULL_TILE_CASES = {
    "flat": {"block": 256, "n_rows": 700, "n_cols": 900, "f": 600, "seed": 20},
    "padded": {"block": 128, "n_rows": 450, "n_cols": 520, "f": 300, "seed": 21},
}
ALT_ROUNDS = 3  # rounds of kernel, library, library, kernel timing
GATHER_SHORT = 1000  # the short gather: not a multiple of any block
GATHER_M = (1, 31, 33, GATHER_SHORT)  # short gathers: one row, either side of a warp's 32
# GeoText scale: the generator parameters of benchmarks/geotext_scale.py
GEOTEXT_DUMPS = dict(
    n_users=9475, n_clusters=64, seed=0, words_per_user=60,
    mentions_per_user=5, cluster_spread_deg=0.5,
)
GEOTEXT_PREPROCESS = dict(bucket_size=50, celebrity_threshold=5, min_df=10, encoding="latin1")
GEOTEXT_F = 300  # the geotext preset's hidden width (a multiple of the kernels' F_ALIGN 4)
EPOCHS = 30
# dev Acc@161 after EPOCHS (the JAX package on a CPU: GCN 0.94, GAT 0.965)
MIN_DEV_ACC = 0.8
LOSS_DROP = 0.5  # the last epoch's loss must be below this × the first's
# launches each training epoch must make on each main path. GCN: 2 conv
# forwards + 2 backwards in the step, 2 forwards in the epoch's predict.
# GAT: 2 layer forwards in the step and 2 in the predict, and each layer's
# backward one row and one column sweep.
# gcn_bsr (--backend bsr): as gcn, on the padded-list kernel.
# gcn_factorized (--adjacency factorized): as gcn, with 2 kernel 1 launches
# per conv apply (B'ᵀ's tiles, then the merged tiles): 12; with
# --gather-dtype bfloat16 the same 12 in the bf16 contraction.
# gcn_slab_bf16 (--input slab --slab-dtype bfloat16 --slab-cols 1024): as
# gcn (the slab's product is a dense matmul, no kernel of its own).
# gcn_sampled (--sampled): the steps are gathers, segment sums and GEMMs;
# the epoch's full-graph dev evaluation runs 2 conv forwards. Of the GEMMs,
# the outer conv layer's H·W over its 61,952 slots takes the dense kernel
# (one nn, nt and tn a step, 300 x 300); the others are under
# dense.MIN_ROWS.
# kernels 3-5 with bf16 tile contractions (mxu_precision="default"): no model
# path reaches them, only gat_attention_tiled's argument (phase 2)
_NO_GAT_BF16 = {"gat_tile_fwd_bf16": 0, "gat_tile_bwd_row_bf16": 0, "gat_tile_bwd_col_bf16": 0}
_NO_GAT = {"gat_tile_fwd": 0, "gat_tile_bwd_row": 0, "gat_tile_bwd_col": 0, **_NO_GAT_BF16}
_NO_SPMM = {"bsr_flat_matmul": 0, "bsr_flat_matmul_bf16": 0, "bsr_matmul": 0}
# the dense products (ops/dense.py) take the kernel from dense.MIN_ROWS rows
# (and a weight dense.MIN_WIDTH deep and wide): no GeoText full-graph product
# has that many (9,475 users)
_NO_DENSE = {"dense_nn": 0, "dense_nt": 0, "dense_tn": 0}
_NO_AUX = {"sddmm_bsr": 0, "gather_rows": 0, **_NO_DENSE}
EXPECTED_LAUNCHES_PER_EPOCH = {
    "gcn": {**_NO_SPMM, "bsr_flat_matmul": 6, **_NO_GAT, **_NO_AUX},
    "gat": {**_NO_SPMM, "gat_tile_fwd": 4, "gat_tile_bwd_row": 2, "gat_tile_bwd_col": 2,
            **_NO_GAT_BF16, **_NO_AUX},
    "gcn_bsr": {**_NO_SPMM, "bsr_matmul": 6, **_NO_GAT, **_NO_AUX},
    "gcn_factorized": {**_NO_SPMM, "bsr_flat_matmul": 12, **_NO_GAT, **_NO_AUX},
    "gcn_factorized_bf16": {**_NO_SPMM, "bsr_flat_matmul_bf16": 12, **_NO_GAT, **_NO_AUX},
    "gcn_slab_bf16": {**_NO_SPMM, "bsr_flat_matmul": 6, **_NO_GAT, **_NO_AUX},
    "gcn_sampled": {**_NO_SPMM, "bsr_flat_matmul": 2, **_NO_GAT, "sddmm_bsr": 0, "gather_rows": 0},
    "gcn_sampled_dist": {**_NO_SPMM, "bsr_flat_matmul": 2, **_NO_GAT, "sddmm_bsr": 0,
                         "gather_rows": 0},
}
# neighbor-sampled training (BASELINE config 5) at the CLI's default batch
# and fanouts: layer node sets of 512, 512 x 11 = 5,632 and 5,632 x 11 =
# 61,952 slots
SAMPLED_PATH = "gcn_sampled"
SAMPLED_BATCH = 512
SAMPLED_FANOUTS = (10, 10)
SAMPLED_CAPS = (512, 5632, 61952)
SAMPLED_HIDDEN = (300, 900)  # phase 4: the geotext and twitter-world widths
SAMPLED_STEPS = 8  # steps timed one by one, each held behind a device sleep
# The bf16 slab's columns: 1,024 of GeoText's 2,560 leave a bucketed-ELL
# rest (the default 4,096 would take the whole vocabulary into the slab).
SLAB_COLS = 1024
# each main path: (model family, the CLI's extra flags, the SpMM backend it
# must resolve to, or None for the GAT, and the GCN's gather dtype)
MAIN_PATHS = {
    "gcn": ("gcn", [], "hybrid", None),
    "gat": ("gat", ["--model", "gat", "--att-backend", "tiled"], None, None),
    "gcn_bsr": ("gcn", ["--backend", "bsr"], "bsr", None),
    "gcn_factorized": ("gcn", ["--adjacency", "factorized"], "factorized", None),
    "gcn_factorized_bf16": ("gcn", ["--adjacency", "factorized", "--gather-dtype", "bfloat16"],
                            "factorized", "bfloat16"),
    "gcn_slab_bf16": ("gcn", ["--input", "slab", "--slab-dtype", "bfloat16",
                              "--slab-cols", str(SLAB_COLS)], "hybrid", None),
    SAMPLED_PATH: ("gcn", ["--sampled", "--batch", str(SAMPLED_BATCH), "--fanout",
                           *map(str, SAMPLED_FANOUTS)], "hybrid", None),
}
# The input layer of each path that sets it (as GCNConfig fields); the
# bf16 slab's path takes the bf16 card-vs-CPU limits.
MODEL_INPUT = {
    "gcn_slab_bf16": dict(input_backend="slab", slab_cols=SLAB_COLS, slab_dtype="bfloat16"),
}
# trained with --checkpoint-dir, then --eval-only
CHECKPOINT_PATHS = ("gcn_slab_bf16", SAMPLED_PATH)
# --eval-only's launches: the dev and the test predict, 2 conv forwards each
EVAL_ONLY_LAUNCHES = {**_NO_SPMM, "bsr_flat_matmul": 4, **_NO_GAT, **_NO_AUX}
# one training step (loss + backward) of the hybrid GCN: 2 conv forwards and
# 2 backward products, and with remat 2 recomputed forwards
REMAT_STEP_LAUNCHES = {False: 4, True: 6}
# parallel/ slice A (graphconvgeo_torch/parallel) at world size 1 on NCCL: the
# card's machine has one H100, and NCCL takes one device per rank.
# DistHighwayGCN on partition_rows(row_align=256) (rows per rank 9,728, a
# multiple of 256) with the halo on runs kernel 1 on the rank's dense local
# 256² tiles: 2 conv forwards + 2 backward products in the step and 2
# forwards in the epoch's predict, and the final dev + test evaluation 4.
# The CLI's --dist partitions with the default row_align 8 (rows per rank
# 9,480, not a multiple of 256), so its local backend is bell and it
# launches no kernel, as the JAX package's does.
DIST_PATH = "gcn_dist"
DIST_ROW_ALIGN = 256
DIST_RPD = {"model": 9728, "cli": 9480}
DIST_LAUNCHES_PER_EPOCH = {**_NO_SPMM, "bsr_flat_matmul": 6, **_NO_GAT, **_NO_AUX}
DIST_NO_LAUNCHES = {**_NO_SPMM, **_NO_GAT, **_NO_AUX}
DIST_PROFILE_EPOCHS = 5
# parallel/ slice B at world size 1 on NCCL. DistGAT(att_format="tiled") on
# the CLI's partition (row alignment 8: 9,480 rows per rank, the last 5
# padding rows with no edge; h_max 8 halo slots, unused at one rank): the
# rank's extended pattern is 9,480 x 9,488 and holds the single-device
# GAT's tiles and rest edges. Its launches are the single-device GAT's: 2
# layer forwards in the step and 2 in the epoch's predict, each layer's
# backward one row and one column sweep; the final dev + test evaluation 4
# forwards. The factorized --dist runs (bell local products) launch no
# kernel, with or without --hub-sharded.
GAT_DIST_PATH = "gat_dist"
GAT_DIST_RPD = 9480
GAT_DIST_HALO_COLS = 8
GAT_DIST_EVAL_LAUNCHES = {**_NO_SPMM, **_NO_GAT, "gat_tile_fwd": 4, **_NO_AUX}
GAT_DIST_FLAGS = ["--model", "gat", "--att-backend", "tiled"]
FACTORIZED_DIST_PATH = "gcn_factorized_dist"
# parallel/ slice C at world size 1 on NCCL: data-parallel sampled training
# (cli --sampled --dist) at the CLI's defaults, batch 512 // 1 a rank and
# fanouts 10 10 (layer node sets as SAMPLED_CAPS); its launches are the
# sampled path's. At dropout 0 a step's loss and gradients equal
# SampledTrainer's on the same sub-batch: the same sums in the same order at
# world size 1, so held at float32's resolution.
SAMPLED_DIST_PATH = "gcn_sampled_dist"
SAMPLED_DIST_LOSS_RTOL = 1e-6
SAMPLED_DIST_PROFILE_EPOCHS = 3
# The twitter-world preset's Highway-GCN at World width and World size
# (benchmarks/world_device_width.py's program on the single-device model):
# hidden 900-900, 930 classes, a 50,000-token vocabulary, the factorized Â
# with bf16 gathers and kernel 1's bf16 contraction, remat, the bf16 input
# slab under GCNConfig.slab_byte_budget, on world_problem's data at
# BASELINE's "~1.4M" Twitter-World users.
WORLD_PATH = "gcn_world"
WORLD_CLI_PATH = "gcn_world_cli"
WORLD_N = 1_400_000
WORLD_VOCAB = 50_000
WORLD_CLASSES = 930
WORLD_F = 900  # the preset's hidden width: kernel 1 at F 900 takes 2 block columns of 4 passes
# the slab's columns: the byte budget allows 2 GiB // (N x 2 bytes) = 766 at
# 1.4M rows of bf16, and zipf_head_cols aligns that down to 128 (1,024 at
# 1,048,576 rows); min_coverage is the slab's gate (sparse/formats.py)
WORLD_SLAB_COLS = 640
WORLD_SLAB_MIN_COVERAGE = 0.15
# the streamed CE head and predict engage by themselves once N x C > 2^28
# (ops/ce_stream.py), over row blocks of 65,536: the loss's forward and its
# recompute run the head once a block each, the predict once
WORLD_ROW_BLOCK = 65536
# a remat step: 2 conv forwards, 2 recomputed and 2 backward applies of the
# factorized Â, each one launch on B'ᵀ's tiles and one on the merged tiles;
# a predict: 2 applies. The dense products (ops/dense.py) of a step: nn conv
# 4 + remat's 4, head 22 + its recompute 22, the slab 1; nt conv 4 + head 22;
# tn conv 4 + head 22 + the slab 1; of a predict: nn conv 4 + head 22 + slab 1
WORLD_STEP_LAUNCHES = {**_NO_SPMM, "bsr_flat_matmul_bf16": 12, **_NO_GAT, **_NO_AUX,
                       "dense_nn": 53, "dense_nt": 26, "dense_tn": 27}
WORLD_PREDICT_LAUNCHES = {**_NO_SPMM, "bsr_flat_matmul_bf16": 4, **_NO_GAT, **_NO_AUX,
                          "dense_nn": 27}
# the steps: one with its launches counted, one timed on the host's clock,
# the differenced device timing's (1 + 3) x (1 + trials), one under the
# profiler after one more unprofiled
WORLD_TIMING = dict(iters_lo=1, iters_hi=3, trials=2)
# phase 4: card against CPU at World width on world_problem at the JAX dry
# run's --parity-n, the streamed head forced on; predictions compared where
# the CPU's top-2 logit margin exceeds this share of max |logit|
WORLD_PARITY_N = 16_384
WORLD_MARGIN_REL = 2e-2
# cli.main --preset twitter-world on GeoText's per-user shape at 65,536
# users, GeoText's users per cluster (9,475 / 64) kept: 443 clusters, of
# which the preset's k-d tree makes 32 classes. The CLI has no remat flag: a
# step is 8 launches, an epoch 8 + a predict's 4, and the final dev and test
# evaluation 8. Its 65,536 rows take the dense kernel, but for the output
# layer (900 x 32, under dense.MIN_WIDTH): a step's nn are the slab and the
# 4 conv, its nt the 4 conv, its tn those and the slab; a predict 5 nn.
WORLD_CLI_DUMPS = dict(n_users=65_536, n_clusters=443, seed=0, words_per_user=60,
                       mentions_per_user=5, cluster_spread_deg=0.5)
WORLD_CLI_EPOCHS = 3
WORLD_CLI_LAUNCHES_PER_EPOCH = {**_NO_SPMM, "bsr_flat_matmul_bf16": 12, **_NO_GAT, **_NO_AUX,
                                "dense_nn": 10, "dense_nt": 4, "dense_tn": 5}
WORLD_CLI_LAUNCHES_AFTER = {**_NO_SPMM, "bsr_flat_matmul_bf16": 8, **_NO_GAT, **_NO_AUX,
                            "dense_nn": 10}
WORLD_CLI_FLAGS = ["--adjacency", "factorized", "--gather-dtype", "bfloat16"]
# every path phase_main_path drives: MAIN_PATHS (single device) and the
# sampled path across ranks
ALL_PATHS = {
    **MAIN_PATHS,
    SAMPLED_DIST_PATH: ("gcn", [*MAIN_PATHS[SAMPLED_PATH][1], "--dist"], "hybrid", None),
}
PROFILE_EPOCHS = 5  # the --profile-dir run; the trainer traces epochs 2-3
TUNE_TRIALS = 2
TUNE_EPOCHS = 3
INPUT_TIMING = dict(iters_lo=2, iters_hi=18, trials=3)  # X·W0 fwd + bwd
# The bf16 paths round every operator input to bf16 (8 significant bits), so
# they are held at bf16-level limits, not float32's:
# - the factorized operator in bf16 against the float32 Â·h of the
#   materialized Â: each term carries up to 2^-8 relative error from its two
#   roundings, and z's y partials a third; 2e-2 × max|ref| leaves room for
#   those errors summed over a row;
# - card against CPU on the bf16 main path: the same roundings in another
#   summation order, so a partial that differs in its last float32 bit can
#   round to the neighbouring bf16 (2^-8 relative) and move what reads it.
FACTORIZED_BF16_REL_TOL = 2e-2
CARD_CPU_BF16_LOSS_RTOL = 1e-3
CARD_CPU_BF16_REL_TOL = 2e-2
# GAT: the geotext widths (hidden 300 = 4 heads of 75, padded to 128 in the
# kernels), the tiled operand's block, and the GeoText-scale tile count
GAT_HEADS = 4
GAT_F = 75
GAT_BLOCK = 128
GAT_GEOTEXT_TILES = 76
GAT_SLOPE = 0.2
ATTN_DROPOUT = 0.35
# edge cases at B = 128: block 1 of an n-node pattern holds no edge (its rows
# and columns must come out exactly neutral); a hot column 0 whose masked
# scores tower over every row's edge max (every output must stay finite)
GAT_EMPTY_BLOCK_N = 600
GAT_HOT_N = 700
GAT_HOT_SCORE = 150.0
# a kernel-heavy operand: bench.py's GAT graph cut to 32,768 nodes
GAT_32K = dict(n=32768, n_comm=128, seed=7, perm_seed=1, reorder_seed=0)
# the factorized operator's edge case: 4 cliques of 40 in contiguous ids and
# 15 triples over 200 nodes, block 64 (tiles on both sides, z_pad 56)
FACTORIZED_SMALL = dict(n=200, block=64, min_tile_nnz=16, seed=13)
# bench.py's headline projection shape (bench.py :: measure_projection)
FACTORIZED_262K = dict(n=262144, n_comm=1024, seed=7, perm_seed=1, f=512)
FACTORIZED_REPEATS = 3  # alternating f32 / bf16 repeats of the operator timing
# Card vs CPU at full width (phase 4)
CARD_CPU_LOSS_RTOL = 1e-5
CARD_CPU_REL_TOL = 1e-4
# H100 SXM published peaks (NVIDIA data sheet, 700 W; utils/profiling.H100),
# for the bounds
HBM_BYTES_PER_S = H100["hbm_bytes_per_s"]
FP32_FLOPS = H100["f32_flops"]
TF32_FLOPS = H100["tf32_flops"]  # dense, tensor cores: kernel 6' (mask off) does 3 TF32 products
BF16_FLOPS = H100["bf16_flops"]  # dense, on the tensor cores: the peak for bf16 operands
SDDMM_SCALE_DECADES = 3  # the wide-range SDDMM tile: rows scaled by 10^U(-3, 3)
TIMING_WARMUP = 3
TIMING_ITERS = 20
HOLD_CYCLES_PER_MS = 2_000_000  # device sleep cycles per ms, near the H100's clock
HOLD_CYCLES = 100 * HOLD_CYCLES_PER_MS  # ≈ 0.1 s of device sleep ahead of a timed run
LAYER_REPEATS = 5  # alternating repeats of the tiled-vs-bucketed layer timing
# the bf16-contraction layer (mxu_precision="default") against the float32
# edge-list layer: each contraction term carries up to 2^-8 relative error
# from its two roundings (as FACTORIZED_BF16_REL_TOL)
GAT_BF16_LAYER_REL_TOL = 2e-2
DEVICE = "cuda"  # where the port runs; phase 4 compares it with "cpu"

KERNEL_META = {
    "bsr_flat_matmul": {
        "route": "cuda",
        "source": "graphconvgeo_torch/csrc/bsr_flat.cu",
        "replaces": "graphconvgeo_tpu/ops/spmm_pallas.py:171",
        "replaces_function": "graphconvgeo_tpu/ops/spmm_pallas.py::_bsr_flat_matmul",
        "main_path": "gcn",
    },
    "bsr_flat_matmul_bf16": {
        "route": "cuda",
        "source": "graphconvgeo_torch/csrc/bsr_flat.cu",
        "replaces": "graphconvgeo_tpu/ops/spmm_pallas.py:171",
        "replaces_function": "graphconvgeo_tpu/ops/spmm_pallas.py::_bsr_flat_matmul "
                             "(mxu_dtype=bfloat16)",
        "main_path": "gcn_factorized_bf16",
    },
    "bsr_matmul": {
        "route": "cuda",
        "source": "graphconvgeo_torch/csrc/bsr_flat.cu",
        "replaces": "graphconvgeo_tpu/ops/spmm_pallas.py:58",
        "replaces_function": "graphconvgeo_tpu/ops/spmm_pallas.py::_bsr_matmul",
        "main_path": "gcn_bsr",
    },
    # kernels 6 and 7 have no caller in the JAX package, so no main path
    "sddmm_bsr": {
        "route": "cuda",
        "source": "graphconvgeo_torch/csrc/sddmm_bsr.cu",
        "replaces": "graphconvgeo_tpu/ops/sddmm_pallas.py:48",
        "replaces_function": "graphconvgeo_tpu/ops/sddmm_pallas.py::sddmm_bsr",
        "main_path": None,
    },
    "gather_rows": {
        "route": "cuda",
        "source": "graphconvgeo_torch/csrc/gather.cu",
        "replaces": "graphconvgeo_tpu/ops/gather_pallas.py:69",
        "replaces_function": "graphconvgeo_tpu/ops/gather_pallas.py::gather_rows_pallas",
        "main_path": None,
    },
    "gat_tile_fwd": {
        "route": "cuda",
        "source": "graphconvgeo_torch/csrc/gat_tiled.cu",
        "replaces": "graphconvgeo_tpu/ops/attention_tiled.py:165",
        "replaces_function": "graphconvgeo_tpu/ops/attention_tiled.py::_tile_fwd_fused",
        "main_path": "gat",
    },
    "gat_tile_bwd_row": {
        "route": "cuda",
        "source": "graphconvgeo_torch/csrc/gat_tiled.cu",
        "replaces": "graphconvgeo_tpu/ops/attention_tiled.py:246",
        "replaces_function": "graphconvgeo_tpu/ops/attention_tiled.py::_tile_bwd_row",
        "main_path": "gat",
    },
    "gat_tile_bwd_col": {
        "route": "cuda",
        "source": "graphconvgeo_torch/csrc/gat_tiled.cu",
        "replaces": "graphconvgeo_tpu/ops/attention_tiled.py:327",
        "replaces_function": "graphconvgeo_tpu/ops/attention_tiled.py::_tile_bwd_col",
        "main_path": "gat",
    },
}
# kernels 3-5' (mxu_precision=Precision.DEFAULT): their path is the public
# function gat_attention_tiled(..., mxu_precision="default"), driven once
# forward + backward at GeoText in phase 2
GAT_BF16_PATH = "gat_attention_tiled(mxu_precision='default')"
for _k in ("gat_tile_fwd", "gat_tile_bwd_row", "gat_tile_bwd_col"):
    KERNEL_META[f"{_k}_bf16"] = {
        **KERNEL_META[_k],
        "replaces_function": KERNEL_META[_k]["replaces_function"]
        + " (mxu_precision=Precision.DEFAULT)",
        "main_path": GAT_BF16_PATH,
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


def cuda_ms(fn, *, hold: bool = True) -> float:
    """Mean milliseconds per call over TIMING_ITERS back-to-back calls, after
    a warm-up, timed with CUDA events. With ``hold`` the stream first runs a
    device-side sleep, so the host enqueues the timed calls while the card
    waits and the events see device time, not the host's launch rate."""
    import torch

    for _ in range(TIMING_WARMUP):
        fn()
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMING_ITERS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / TIMING_ITERS


def held_call_ms(fn, calls: int) -> tuple:
    """(device milliseconds of each of ``calls`` single calls, how many were
    held): each call is enqueued behind its own device sleep, twice as long
    as the host took to enqueue the call before (at most HOLD_CYCLES). A
    call is held when its
    enqueue ended before the card reached it; only then is its time the
    device's alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    hold_ms, times, held = HOLD_CYCLES / HOLD_CYCLES_PER_MS, [], 0
    for _ in range(calls):
        torch.cuda._sleep(int(hold_ms * HOLD_CYCLES_PER_MS))
        start.record()
        t0 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        held += not start.query()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        hold_ms = min(2.0 * enqueue_ms + 1.0, HOLD_CYCLES / HOLD_CYCLES_PER_MS)
    return times, held


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


def full_tile_matrix(case: dict):
    """Tile (row block 0, column block 1) completely full; each of row block
    0's rows gets 1..FULL_TILE_EXTRA more entries in column block 0, and the
    rows past it about 4 scattered entries each."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(case["seed"])
    b, n, c = case["block"], case["n_rows"], case["n_cols"]
    full_r, full_c = np.divmod(np.arange(b * b), b)
    extra = rng.integers(1, FULL_TILE_EXTRA + 1, b)
    rows = np.r_[full_r, np.repeat(np.arange(b), extra), rng.integers(b, n, 4 * (n - b))]
    cols = np.r_[b + full_c, rng.integers(0, b, extra.sum()), rng.integers(0, c, 4 * (n - b))]
    vals = rng.uniform(0.5, 1.5, len(rows)) * rng.choice([-1.0, 1.0], len(rows))
    m = sp.coo_matrix((vals.astype(np.float32), (rows, cols)), shape=(n, c)).tocsr()
    m.sum_duplicates()
    m.eliminate_zeros()
    return m


def compare_full_tile(kind: str, *, mxu_dtype=None, h_dtype=None) -> float:
    """A BSR kernel against its dense twin on the full-tile operand, in the
    given contraction and h type; returns the max abs error forward and
    backward."""
    import torch

    from graphconvgeo_torch.sparse.formats import BsrFlat, BsrMatrix, to_device

    case = FULL_TILE_CASES[kind]
    cls = BsrFlat if kind == "flat" else BsrMatrix
    m = full_tile_matrix(case)
    b = case["block"]
    mat = to_device(cls.from_scipy(m, block=b), DEVICE)
    mat_t = to_device(cls.from_scipy(m.T.tocsr(), block=b), DEVICE)
    fill = (mat.tiles != 0).sum((1, 2))
    if int(fill.max()) != b * b:
        raise AssertionError(f"the full-tile operand has no full {b}x{b} tile")
    lengths = torch.diff(mat.packed.row_ptr[: b + 1])
    print(f"full-tile operand, {kind}: rows of row block 0 hold {int(lengths.min())}.."
          f"{int(lengths.max())} entries ({b} in the full tile)")
    res = compare_tile_product(f"full tile {b}x{b}, {kind}", mat, mat_t, case["f"], case["seed"],
                               kind=kind, mxu_dtype=mxu_dtype, h_dtype=h_dtype)
    return max(res["fwd"], res["bwd"])


def pack_ms(mat) -> float:
    """Build the operand's packed rows (once; later launches reuse them),
    print the time and check the entry count against the tiles'."""
    import torch

    if "packed" in vars(mat):
        raise AssertionError("the operand was packed before its pack was timed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = mat.packed
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = int((mat.tiles != 0).sum())
    print(f"  packed rows built once in {ms!r} ms (operand preparation, not per call): "
          f"nnz {packed.nnz}, tiles' nonzeros {want}")
    if packed.nnz != want:
        raise AssertionError(f"pack nnz {packed.nnz} != the tiles' nonzeros {want}")
    return ms


def alternate_ms(kernel_fn, library_fn, library: str) -> dict:
    """The kernel and one library call (named ``library``) timed in turns
    with :func:`cuda_ms`: kernel, library, library, kernel, over ALT_ROUNDS
    rounds. Prints both medians and their ratio."""
    import statistics

    k, lib = [], []
    for _ in range(ALT_ROUNDS):
        k.append(cuda_ms(kernel_fn))
        lib.append(cuda_ms(library_fn))
        lib.append(cuda_ms(library_fn))
        k.append(cuda_ms(kernel_fn))
    med_k, med_lib = statistics.median(k), statistics.median(lib)
    print(f"  in turns over {ALT_ROUNDS} rounds: kernel {k!r} ms, {library} {lib!r} ms; "
          f"medians {med_k!r} / {med_lib!r} ms, kernel / library {med_k / med_lib!r}")
    return {"ms": med_k, "library_ms": med_lib, "kernel_runs_ms": k, "library_runs_ms": lib}


def gather_line(mat, f_pad: int, ms: float) -> None:
    """Print what the packed-row kernel's design moves, beside the bound:
    each nonzero and row pointer once, one row of h gathered per nonzero,
    the padded output written once. These are counted from the design, not
    measured; the rate is those gathered bytes over the measured time."""
    nnz, rows = mat.packed.nnz, mat.n_rows_padded
    h_bytes = 4 * nnz * f_pad
    print(f"  packed-row kernel's design traffic: h rows gathered {h_bytes} bytes (nnz {nnz} x F "
          f"{f_pad} x 4; {h_bytes / (ms * 1e-3) / 1e12!r} TB/s over the measured {ms!r} ms), "
          f"nonzeros and row pointers {8 * nnz + 4 * (rows + 1)} bytes, output "
          f"{4 * rows * f_pad} bytes")


def tile_product(kind: str) -> tuple:
    """(kernel wrapper, plain twin, differentiable spmm) of the flat-tile
    ("flat", kernel 1) or padded-list ("padded", kernel 2) BSR product."""
    from graphconvgeo_torch.ops import spmm_bsr as sb

    if kind == "flat":
        return sb.bsr_flat_matmul, sb.bsr_flat_matmul_plain, sb.spmm_bsr_flat
    return sb.bsr_matmul, sb.bsr_matmul_plain, sb.spmm_bsr


def compare_tile_product(name: str, mat, mat_t, f: int, seed: int, *, empty_row_block=None,
                         kind: str = "flat", mxu_dtype=None, h_dtype=None) -> dict:
    """A BSR kernel against its plain version on one operand, in the
    contraction ``mxu_dtype`` with h in ``h_dtype`` (float32 unless given):
    the forward through the wrapper at the padded width; with a float32 h
    the backward through the spmm's autograd Function, against plain
    autograd (float32) or the plain twin on the transpose operand (bf16,
    which rounds the cotangent as the kernel does)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from graphconvgeo_torch.ops.spmm_bsr import F_ALIGN
    from graphconvgeo_torch.sparse.formats import _round_up

    mxu = mxu_dtype or torch.float32
    h_dt = h_dtype or torch.float32
    matmul, plain, spmm = tile_product(kind)
    dev = mat.tiles.device
    rng = np.random.default_rng(seed)
    h = torch.tensor(rng.normal(size=(mat.n_cols, f)).astype(np.float32), device=dev)
    w = torch.tensor(rng.normal(size=(mat.n_rows, f)).astype(np.float32), device=dev)
    f_pad = _round_up(f, F_ALIGN)
    pad = (0, f_pad - f, 0, mat.n_cols_padded - mat.n_cols)
    h_p = F.pad(h, pad).to(h_dt).contiguous()
    slots = f", k_max {mat.k_max} (transpose {mat_t.k_max})" if kind == "padded" else ""
    print(f"{name}: {mat.n_tiles} tiles of {mat.block}^2{slots}, h {tuple(h_p.shape)} {h_dt}, "
          f"contraction {mxu}")
    out_k = matmul(mat, h_p, mxu_dtype=mxu)
    out_p = plain(mat, h_p, mxu_dtype=mxu)
    torch.cuda.synchronize()
    fwd = check_close("forward", out_k, out_p, KERNEL_REL_TOL)
    if empty_row_block is not None:
        b = mat.block
        blk = out_k[empty_row_block * b : (empty_row_block + 1) * b]
        if not bool((blk == 0).all()):
            raise AssertionError(f"{name}: empty row block {empty_row_block} is not zero")
        print(f"  empty row block {empty_row_block}: exactly zero")
    if h_dt != torch.float32:
        print("  backward: checked with a float32 h (the cotangent is float32)")
        return {"fwd": fwd, "bwd": 0.0, "h_p": h_p}
    hk = h.clone().requires_grad_(True)
    (spmm(mat, mat_t, hk, mxu_dtype=mxu) * w).sum().backward()
    if mxu == torch.float32:
        hp = h.clone().requires_grad_(True)
        (plain(mat, F.pad(hp, pad))[: mat.n_rows, :f] * w).sum().backward()
        want = hp.grad
    else:
        w_p = F.pad(w, (0, f_pad - f, 0, mat_t.n_cols_padded - mat.n_rows))
        want = plain(mat_t, w_p, mxu_dtype=mxu)[: mat.n_cols, :f]
    torch.cuda.synchronize()
    bwd = check_close("backward dh", hk.grad, want, KERNEL_REL_TOL)
    return {"fwd": fwd, "bwd": bwd, "h_p": h_p}


def phase_setup():
    import torch

    print("== phase 1: set-up")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    from graphconvgeo_torch.utils import cuda_build

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"PYTORCH_CUDA_ALLOC_CONF {os.environ.get('PYTORCH_CUDA_ALLOC_CONF')!r}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 must be False")
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log = cuda_build.build()
    print(f"kernels built in {time.perf_counter() - t0!r} s")
    for stem, rec in log.items():
        print(f"  {stem}: nvcc {rec['seconds']!r} s\n{rec['ptxas']}")
        for name, regs, spills in ptxas_summary(rec["ptxas"]):
            print(f"  ptxas {stem} :: {name}: {regs} registers, {spills}")


def ptxas_summary(text: str) -> list:
    """(kernel, registers, spill line) for each entry function in the
    output of ``nvcc -Xptxas -v``."""
    import re

    rows, name, spills = [], None, "spills not reported"
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name, spills = m.group(1), "spills not reported"
        elif "spill stores" in line:
            spills = line.strip()
        elif (m := re.search(r"Used (\d+) registers", line)) and name is not None:
            rows.append((name, int(m.group(1)), spills))
            name = None
    return rows


def make_geotext_dataset(data_dir: str):
    from graphconvgeo_torch.data.pipeline import PreprocessConfig, preprocess
    from graphconvgeo_torch.data.synthetic import make_synthetic_dumps

    make_synthetic_dumps(data_dir, **GEOTEXT_DUMPS)
    ds = preprocess(data_dir, PreprocessConfig(**GEOTEXT_PREPROCESS), use_cache=False)
    ds, _ = ds.reorder()
    return ds


def torch_csr(m, dev):
    """A scipy CSR matrix as a torch sparse CSR tensor on ``dev`` (the
    library calls' operand)."""
    import numpy as np
    import torch

    return torch.sparse_csr_tensor(
        torch.from_numpy(m.indptr.astype(np.int64)),
        torch.from_numpy(m.indices.astype(np.int64)),
        torch.from_numpy(m.data.astype(np.float32)),
        size=m.shape,
        check_invariants=False,
    ).to(dev)


def phase_kernels(ds) -> dict:
    import torch

    from graphconvgeo_torch.ops.spmm_bsr import bsr_flat_matmul, bsr_flat_matmul_plain
    from graphconvgeo_torch.sparse.formats import BsrFlat, SparseGraph, split_dense_tiles, to_device

    print("== phase 2: kernels against their plain versions")
    dev = torch.device(DEVICE)
    for case in EMPTY_ROW_BLOCK_CASES:
        m = empty_row_block_matrix(case)
        mat = to_device(BsrFlat.from_scipy(m, block=case["block"]), dev)
        mat_t = to_device(BsrFlat.from_scipy(m.T.tocsr(), block=case["block"]), dev)
        compare_tile_product(
            f"empty-row-block B={case['block']}", mat, mat_t, case["f"], case["seed"],
            empty_row_block=1,
        )

    full_err = compare_full_tile("flat")

    graph = SparseGraph(csr=ds.adj, symmetric=True)
    bsr, _ = graph.hybrid()
    mat = to_device(bsr, dev)
    print("GeoText-scale hybrid BsrFlat:")
    built_ms = pack_ms(mat)
    res = compare_tile_product("GeoText-scale hybrid BsrFlat", mat, mat, GEOTEXT_F, 2)
    h_p = res["h_p"]

    dense, _ = split_dense_tiles(ds.adj, block=bsr.block, min_tile_nnz=96)
    n = dense.shape[0]
    csr = torch_csr(dense, dev)
    h_lib = h_p[:n].contiguous()
    plain_ms = cuda_ms(lambda: bsr_flat_matmul_plain(mat, h_p))
    alt = alternate_ms(lambda: bsr_flat_matmul(mat, h_p), lambda: torch.sparse.mm(csr, h_lib),
                       "torch.sparse.mm")
    lib_err = float((torch.sparse.mm(csr, h_lib) - bsr_flat_matmul(mat, h_p)[:n]).abs().max())

    bd = spmm_bound(mat, nnz=int((bsr.tiles != 0).sum()), f=GEOTEXT_F, f_pad=h_p.shape[1],
                    slots=mat.n_tiles)
    gather_line(mat, h_p.shape[1], alt["ms"])
    print(f"  kernel {alt['ms']!r} ms, plain {plain_ms!r} ms, torch.sparse.mm (CSR) "
          f"{alt['library_ms']!r} ms (library vs kernel max abs diff {lib_err!r})")
    return {
        "bsr_flat_matmul": {
            "fwd_max_err": res["fwd"],
            "bwd_max_err": res["bwd"],
            "full_tile_max_err": full_err,
            "max_abs_err": max(res["fwd"], res["bwd"], full_err),
            "plain_ms": plain_ms,
            **alt,
            "pack_ms": built_ms,
            "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"],
        }
    }


def bound_line(n_bytes: int, flops: int, peak: float = FP32_FLOPS) -> dict:
    """The least time on this card for ``n_bytes`` of traffic and ``flops``
    operations at ``peak`` (published H100 SXM peaks; float32 FFMA unless
    given), and which sets it."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return {"bytes": n_bytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def spmm_bound(mat, *, nnz: int, f: int, f_pad: int, slots: int) -> dict:
    """Bound of one BSR product (kernel 1 or 2), counted by what the data
    needs: each nonzero once as a float32 value and an int32 column (CSR),
    the row pointers, h's real rows read once and the output's real rows
    written once at the real width f; 2 flops per nonzero and column. The
    padded traffic (padded rows at f_pad), the dense-tile format's own
    (every dense tile, zeros included) and its dense-tile flops over its
    ``slots`` are printed beside it, not used as the bound."""
    bd = bound_line(8 * nnz + 4 * (mat.n_rows + 1) + 4 * f * (mat.n_cols + mat.n_rows),
                    2 * nnz * f)
    padded = 4 * f_pad * (mat.n_cols_padded + mat.n_rows_padded)
    tile_bytes = 4 * mat.tiles.numel() + padded
    dense_flops = 2 * slots * mat.block**2 * f_pad
    print(
        f"  tiles {mat.n_tiles} of {mat.block}^2, nnz {nnz}, fill {nnz / (mat.n_tiles * mat.block**2)!r}, "
        f"slots {slots}\n"
        f"  bound: bytes {bd['bytes']} -> {bd['bytes_ms']!r} ms at 3.35 TB/s; flops {bd['flops']} -> "
        f"{bd['ops_ms']!r} ms at 67 TFLOP/s f32; bound {bd['bound_ms']!r} ms ({bd['bound_by']})\n"
        f"  padded h and output (F {f_pad}, padded rows): bytes {8 * nnz + padded} -> "
        f"{(8 * nnz + padded) / HBM_BYTES_PER_S * 1e3!r} ms; the dense-tile format (not read on "
        f"the card): bytes {tile_bytes} -> {tile_bytes / HBM_BYTES_PER_S * 1e3!r} ms, flops "
        f"{dense_flops} -> {dense_flops / FP32_FLOPS * 1e3!r} ms"
    )
    return bd


# ---- the padded-list BSR: its product, the BSR SDDMM, the row gather -------
def entries_per_tile(pattern) -> tuple:
    """(largest, mean) entries of a real tile in the pattern's tile table."""
    import torch

    per = torch.diff(pattern.tile_entries.tile_ptr.long())[1:]
    return int(per.max()), float(per.double().mean())


def compare_sddmm(name: str, pattern, f: int, seed: int, *, wide_range: bool = False) -> float:
    """The SDDMM kernels against their twin with the mask on (the nonzero
    route) and off (the dense tiles, 3xTF32): scores within tolerance, tile
    0 exactly zero, and masked, exactly zero off the pattern. With
    ``wide_range`` every row of h1 and h2 is scaled by 10^U(-3, 3), where
    one TF32 product alone would miss the tolerance. Returns the max abs
    error."""
    import numpy as np
    import torch

    from graphconvgeo_torch.ops.sddmm_bsr import sddmm_bsr, sddmm_bsr_plain

    rng = np.random.default_rng(seed)

    def rows(n):
        h = rng.normal(size=(n, f))
        if wide_range:
            h *= 10.0 ** rng.uniform(-SDDMM_SCALE_DECADES, SDDMM_SCALE_DECADES, (n, 1))
        return torch.tensor(h.astype(np.float32), device=DEVICE)

    h1, h2 = rows(pattern.n_rows), rows(pattern.n_cols)
    most, mean = entries_per_tile(pattern)
    print(f"{name}: SDDMM over {pattern.n_tiles} tiles of {pattern.block}^2, F {f}; "
          f"{pattern.tile_entries.nnz} entries, per tile largest {most}, mean {mean!r}")
    err = 0.0
    for mask in (True, False):
        got = sddmm_bsr(pattern, h1, h2, mask_pattern=mask)
        want = sddmm_bsr_plain(pattern, h1, h2, mask_pattern=mask)
        torch.cuda.synchronize()
        err = max(err, check_close(f"scores, mask_pattern={mask}", got, want, KERNEL_REL_TOL))
        if not bool((got[0] == 0).all()):
            raise AssertionError(f"{name}: tile 0 is not exactly zero (mask_pattern={mask})")
        if mask and not bool((got[pattern.tiles == 0] == 0).all()):
            raise AssertionError(f"{name}: a masked score off the pattern is not exactly zero")
    print("  tile 0 exactly zero; masked, exactly zero off the pattern")
    return err


def call_footprint(fn) -> tuple:
    """(caching-allocator allocations, {device kernel: launches}) of one call
    of ``fn`` after a warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    return allocs, kernels


def sddmm_geotext(mat, csr, n: int, nnz: int) -> dict:
    """Kernel 6 at GeoText scale: one call's allocations and launches, the
    nonzero route and ``torch.sparse.sampled_addmm`` in turns, the plain
    twin, the dense-tile kernel (mask off: 3xTF32, its bound at the TF32
    rate with the FFMA bound beside it), and the bounds."""
    import numpy as np
    import torch

    from graphconvgeo_torch.ops.sddmm_bsr import sddmm_bsr, sddmm_bsr_plain

    rng = np.random.default_rng(6)
    h1 = torch.tensor(rng.normal(size=(n, GEOTEXT_F)).astype(np.float32), device=DEVICE)
    h2 = torch.tensor(rng.normal(size=(n, GEOTEXT_F)).astype(np.float32), device=DEVICE)
    h2t = h2.T.contiguous()
    allocs, kernels = call_footprint(lambda: sddmm_bsr(mat, h1, h2))
    print(f"  one mask_pattern call: {allocs} allocation(s), device kernels {kernels}")
    if allocs != 1 or sum(kernels.values()) != 1:
        raise AssertionError("a mask_pattern call must be one allocation and one launch")
    alt = alternate_ms(lambda: sddmm_bsr(mat, h1, h2),
                       lambda: torch.sparse.sampled_addmm(csr, h1, h2t, beta=0.0),
                       "torch.sparse.sampled_addmm")
    plain_ms = cuda_ms(lambda: sddmm_bsr_plain(mat, h1, h2))
    off_ms = cuda_ms(lambda: sddmm_bsr(mat, h1, h2, mask_pattern=False))
    off_plain_ms = cuda_ms(lambda: sddmm_bsr_plain(mat, h1, h2, mask_pattern=False))
    # the function's own bound: h1 and h2 read once at the real width, the
    # nonzeros in (a position each, the per-tile pointers and blocks), the
    # whole tile layout out; 2 flops per nonzero and column. Beside it the
    # nonzeros-only figure (the scores out as CSR, as sampled_addmm writes).
    t_all = mat.tiles.shape[0]
    layout = 4 * mat.tiles.numel()
    h_bytes = 4 * GEOTEXT_F * 2 * n
    bd = bound_line(h_bytes + 4 * nnz + 4 * (t_all + 1) + 8 * t_all + layout, 2 * nnz * GEOTEXT_F)
    nz_only = bound_line(h_bytes + 8 * nnz + 4 * (n + 1) + 4 * nnz, 2 * nnz * GEOTEXT_F)
    # mask off: three TF32 products a score on the tensor cores
    off_flops = 2 * mat.n_tiles * mat.block**2 * GEOTEXT_F
    off = bound_line(h_bytes + 8 * t_all + layout, 3 * off_flops, TF32_FLOPS)
    off_ffma = bound_line(h_bytes + 8 * t_all + layout, off_flops)
    print(f"  SDDMM nonzero route {alt['ms']!r} ms, plain {plain_ms!r} ms, "
          f"torch.sparse.sampled_addmm {alt['library_ms']!r} ms\n"
          f"  bound (tile layout out): bytes {bd['bytes']} -> {bd['bytes_ms']!r} ms; flops "
          f"{bd['flops']} -> {bd['ops_ms']!r} ms; bound {bd['bound_ms']!r} ms ({bd['bound_by']})\n"
          f"  nonzeros only (scores out as CSR): bytes {nz_only['bytes']} -> "
          f"{nz_only['bound_ms']!r} ms ({nz_only['bound_by']})\n"
          f"  mask off (every entry a score, dense-tile kernel, 3xTF32): {off_ms!r} ms, plain "
          f"{off_plain_ms!r} ms; bound: bytes {off['bytes']} -> {off['bytes_ms']!r} ms, flops "
          f"3 x {off_flops} -> {off['ops_ms']!r} ms at 495 TFLOP/s TF32; bound {off['bound_ms']!r} "
          f"ms ({off['bound_by']}); at 67 TFLOP/s f32 FFMA {off_ffma['ops_ms']!r} ms; half the "
          f"3xTF32 bound {off['bound_ms'] / 2 / off_ms!r} of the measured time (phase 1 prints its "
          f"ptxas registers and spills)")
    write_ms = write_rate(layout)
    most, mean = entries_per_tile(mat)
    return {
        "ms": alt["ms"], "plain_ms": plain_ms, "library_ms": alt["library_ms"],
        "layout_zero_ms": write_ms,
        "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
        "kernel_runs_ms": alt["kernel_runs_ms"], "library_runs_ms": alt["library_runs_ms"],
        "nonzeros_only_bound_ms": nz_only["bound_ms"],
        "mask_off_ms": off_ms, "mask_off_plain_ms": off_plain_ms,
        "mask_off_bound_ms": off["bound_ms"], "mask_off_bound_by": off["bound_by"],
        "mask_off_ffma_bound_ms": off_ffma["ops_ms"],
        "entries_per_tile_max": most, "entries_per_tile_mean": mean,
    }


def write_rate(n_bytes: int) -> float:
    """Milliseconds of ``zero_`` on a float32 buffer of ``n_bytes``: what a
    plain write stream of that size reaches on this card (a yardstick for
    the write-bound kernels, not a bound)."""
    import torch

    buf = torch.empty(n_bytes // 4, dtype=torch.float32, device=DEVICE)
    ms = cuda_ms(buf.zero_)
    print(f"  write yardstick: zero_ of {n_bytes} bytes {ms!r} ms, "
          f"{n_bytes / (ms * 1e-3) / 1e12!r} TB/s")
    return ms


def gather_indices(n: int, m_rows: int, rng):
    """``m_rows`` int32 indices into ``n`` rows on the card: random, with
    repeats, and the last row ``n - 1`` last."""
    import numpy as np
    import torch

    idx = rng.integers(0, n, m_rows)
    idx[: min(3, m_rows)] = 0
    idx[-1] = n - 1
    return torch.tensor(idx.astype(np.int32), device=DEVICE)


def gather_operands(ds) -> dict:
    """The gather's GeoText operands: the ELL operand's indices (all 606,400
    slots), tables at the JAX package's padded width (f32 384, bf16 256)
    and at one 16-byte vector a row (f32 4, bf16 8)."""
    import numpy as np
    import torch

    from graphconvgeo_torch.sparse.formats import EllMatrix, to_device

    rng = np.random.default_rng(7)
    n = ds.adj.shape[0]
    tables = {}
    for dtype, widths in ((torch.float32, (384, 4)), (torch.bfloat16, (256, 8))):
        for f in widths:
            tables[f"{str(dtype)[6:]} F {f}"] = torch.tensor(
                rng.normal(size=(n, f)).astype(np.float32), device=DEVICE).to(dtype)
    idx = to_device(EllMatrix.from_scipy(ds.adj), DEVICE).indices.reshape(-1).contiguous()
    short = {m: gather_indices(n, m, rng) for m in GATHER_M}
    return {"tables": tables, "ell": idx, "short": short}


def check_gather(ops: dict) -> int:
    """The gather kernel bit-equal to index_select on every table, for the
    ELL indices and each short index. Returns the cases."""
    import torch

    from graphconvgeo_torch.ops.gather import gather_rows, gather_rows_plain

    cases = 0
    for tname, h in ops["tables"].items():
        for iname, idx in [("ELL", ops["ell"])] + [(f"M {m}", i) for m, i in ops["short"].items()]:
            got, want = gather_rows(h, idx), gather_rows_plain(h, idx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"gather differs from index_select: {tname}, {iname}")
            cases += 1
    return cases


def gather_turns(ops: dict) -> dict:
    """The gather kernel and torch.index_select (int64 index) in turns on
    the ELL indices, at f32 384 and bf16 256."""
    import torch

    from graphconvgeo_torch.ops.gather import gather_rows

    idx = ops["ell"]
    idx64 = idx.long()
    out = {}
    for tname in ("float32 F 384", "bfloat16 F 256"):
        h = ops["tables"][tname]
        print(f"  gather {tname}, {idx.shape[0]} ELL indices:")
        out[tname] = alternate_ms(lambda: gather_rows(h, idx),
                                  lambda: torch.index_select(h, 0, idx64), "torch.index_select")
    return out


def gather_geotext(ds) -> dict:
    """Kernel 7: bit-equal to index_select and timed in turns with it."""
    from graphconvgeo_torch.ops.gather import gather_rows_plain

    ops = gather_operands(ds)
    print(f"gather: bit-equal to index_select in {check_gather(ops)} cases")
    t = gather_turns(ops)
    h, idx = ops["tables"]["float32 F 384"], ops["ell"]
    plain_ms = cuda_ms(lambda: gather_rows_plain(h, idx))
    m_rows = idx.shape[0]
    bd = bound_line(4 * h.numel() + 4 * m_rows * h.shape[1] + 4 * m_rows, 0)
    f32, bf16 = t["float32 F 384"], t["bfloat16 F 256"]
    print(f"  gather kernel {f32['ms']!r} ms, plain {plain_ms!r} ms, torch.index_select (int64) "
          f"{f32['library_ms']!r} ms; bound: bytes {bd['bytes']} -> {bd['bound_ms']!r} ms "
          f"({bd['bound_by']}); bf16 F 256: kernel {bf16['ms']!r} ms, index_select "
          f"{bf16['library_ms']!r} ms")
    write_ms = write_rate(4 * m_rows * h.shape[1])
    return {
        "max_abs_err": 0.0, "ms": f32["ms"], "plain_ms": plain_ms, "library_ms": f32["library_ms"],
        "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
        "kernel_runs_ms": f32["kernel_runs_ms"], "library_runs_ms": f32["library_runs_ms"],
        "bf16_ms": bf16["ms"], "bf16_library_ms": bf16["library_ms"],
        "output_zero_ms": write_ms,
    }


def phase_bsr_kernels(ds) -> dict:
    """Kernels 2, 6 and 7 against their twins on the edge-case patterns and
    at GeoText scale; their times beside the plain versions, one library
    call each in turns, and the bounds."""
    import torch

    from graphconvgeo_torch.ops.spmm_bsr import bsr_matmul, bsr_matmul_plain
    from graphconvgeo_torch.sparse.formats import BsrMatrix, to_device

    print("== phase 2 (BSR): padded-list BSR product, BSR SDDMM and row gather")
    dev = torch.device(DEVICE)
    errs = {"bsr_matmul": 0.0, "sddmm_bsr": 0.0}
    for case in BSR_CASES:
        m = empty_row_block_matrix(case)
        mat = to_device(BsrMatrix.from_scipy(m, block=case["block"]), dev)
        mat_t = to_device(BsrMatrix.from_scipy(m.T.tocsr(), block=case["block"]), dev)
        res = compare_tile_product(f"padded-list BSR, empty row block, B={case['block']}", mat, mat_t,
                           case["f"], case["seed"], empty_row_block=1, kind="padded")
        errs["bsr_matmul"] = max(errs["bsr_matmul"], res["fwd"], res["bwd"])
        errs["sddmm_bsr"] = max(errs["sddmm_bsr"], compare_sddmm(
            f"B={case['block']} pattern", mat, case["f"], case["seed"]))
    # the padded-list product's bf16 contraction (counted under bsr_matmul)
    res = compare_tile_product(f"padded-list BSR, empty row block, B={case['block']}, bf16",
                               mat, mat_t, case["f"], case["seed"], empty_row_block=1,
                               kind="padded", mxu_dtype=torch.bfloat16)
    errs["bsr_matmul"] = max(errs["bsr_matmul"], res["fwd"], res["bwd"])

    errs["bsr_matmul"] = max(errs["bsr_matmul"], compare_full_tile("padded"))
    case = FULL_TILE_CASES["padded"]
    full = to_device(BsrMatrix.from_scipy(full_tile_matrix(case), block=case["block"]), dev)
    if entries_per_tile(full)[0] != case["block"] ** 2:
        raise AssertionError("the full-tile pattern has no tile of B^2 entries")
    errs["sddmm_bsr"] = max(errs["sddmm_bsr"], compare_sddmm(
        f"full {case['block']}^2 tile pattern", full, case["f"], case["seed"]))
    errs["sddmm_bsr"] = max(errs["sddmm_bsr"], compare_sddmm(
        f"full {case['block']}^2 tile pattern, rows scaled over 1e-{SDDMM_SCALE_DECADES}.."
        f"1e{SDDMM_SCALE_DECADES}", full, case["f"], case["seed"] + 1, wide_range=True))

    t0 = time.perf_counter()
    mat = to_device(BsrMatrix.from_scipy(ds.adj, block=128), dev)
    print(f"GeoText-scale BsrMatrix built in {time.perf_counter() - t0!r} s")
    if mat.n_tiles != BSR_GEOTEXT_TILES:
        raise AssertionError(f"GeoText-scale BsrMatrix has {mat.n_tiles} tiles, not {BSR_GEOTEXT_TILES}")
    built_ms = pack_ms(mat)
    res = compare_tile_product("GeoText-scale BsrMatrix", mat, mat, GEOTEXT_F, 4, kind="padded")
    errs["bsr_matmul"] = max(errs["bsr_matmul"], res["fwd"], res["bwd"])
    h_p = res["h_p"]
    n = ds.adj.shape[0]
    csr = torch_csr(ds.adj, dev)
    h_lib = h_p[:n].contiguous()
    plain_ms = cuda_ms(lambda: bsr_matmul_plain(mat, h_p))
    alt = alternate_ms(lambda: bsr_matmul(mat, h_p), lambda: torch.sparse.mm(csr, h_lib),
                       "torch.sparse.mm")
    lib_err = float((torch.sparse.mm(csr, h_lib) - bsr_matmul(mat, h_p)[:n]).abs().max())
    nnz = int(ds.adj.nnz)
    bd = spmm_bound(mat, nnz=nnz, f=GEOTEXT_F, f_pad=h_p.shape[1], slots=mat.n_row_blocks * mat.k_max)
    gather_line(mat, h_p.shape[1], alt["ms"])
    print(f"  kernel {alt['ms']!r} ms, plain {plain_ms!r} ms, torch.sparse.mm "
          f"(CSR) {alt['library_ms']!r} ms (library vs kernel max abs diff {lib_err!r})")
    out = {"bsr_matmul": {
        "max_abs_err": errs["bsr_matmul"], "ms": alt["ms"], "plain_ms": plain_ms,
        "library_ms": alt["library_ms"], "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
        "kernel_runs_ms": alt["kernel_runs_ms"], "library_runs_ms": alt["library_runs_ms"],
        "pack_ms": built_ms,
    }}

    t0 = time.perf_counter()
    _ = mat.tile_entries
    torch.cuda.synchronize()
    print(f"  tile entries built once in {(time.perf_counter() - t0) * 1e3!r} ms "
          f"(operand preparation, not per call)")
    err = compare_sddmm("GeoText-scale pattern", mat, GEOTEXT_F, 5)
    out["sddmm_bsr"] = {"max_abs_err": max(errs["sddmm_bsr"], err), **sddmm_geotext(mat, csr, n, nnz)}
    out["gather_rows"] = gather_geotext(ds)
    return out


# ---- the factorized adjacency and kernel 1's bf16 contraction -------------
def factorized_small():
    """The factorized operator's edge-case structure (FACTORIZED_SMALL):
    (groups, n, direct, FactorizedAdjacency)."""
    import numpy as np

    from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency

    c = FACTORIZED_SMALL
    r = np.random.default_rng(c["seed"])
    n = c["n"]
    groups = {f"big{k}": list(range(k * 50, k * 50 + 40)) for k in range(4)}
    groups.update({f"x{g}": r.choice(n, size=3, replace=False).tolist() for g in range(15)})
    direct = (r.integers(0, n, 10), r.integers(0, n, 10))
    fa = FactorizedAdjacency.from_groups(groups, n, direct=direct, block=c["block"],
                                         min_tile_nnz=c["min_tile_nnz"])
    return groups, n, direct, fa


def dataset_groups(ds) -> dict:
    off, mem = ds.groups_offsets, ds.groups_members
    return {g: mem[off[g] : off[g + 1]] for g in range(len(off) - 1)}


def compare_factorized_operator(name: str, fa, a_hat, f: int, seed: int) -> dict:
    """The factorized operator (its autograd Function) against Â·h and Â·w
    of the materialized Â (torch.sparse.mm in float32; Â is symmetric, so
    the gradient of <Â·h, w> is Â·w): float32 within KERNEL_REL_TOL and bf16
    (gathers and contraction) within FACTORIZED_BF16_REL_TOL of max|ref|.
    h carries 3 padding rows, whose gradient must be exactly zero."""
    import numpy as np
    import torch

    from graphconvgeo_torch.sparse.factorized import spmm_factorized

    rng = np.random.default_rng(seed)
    n = fa.n_rows
    h = torch.tensor(rng.normal(size=(n + 3, f)).astype(np.float32), device=DEVICE)
    w = torch.tensor(rng.normal(size=(n, f)).astype(np.float32), device=DEVICE)
    csr = torch_csr(a_hat, DEVICE)
    ref, ref_dh = torch.sparse.mm(csr, h[:n]), torch.sparse.mm(csr, w)
    errs = {}
    for label, dt, tol in (("float32", None, KERNEL_REL_TOL),
                           ("bf16", torch.bfloat16, FACTORIZED_BF16_REL_TOL)):
        x = h.clone().requires_grad_(True)
        out = spmm_factorized(fa, x, gather_dtype=dt, mxu_dtype=dt)
        (out * w).sum().backward()
        out = out.detach()
        torch.cuda.synchronize()
        print(f"{name}, {label}: out {tuple(out.shape)} {out.dtype}")
        errs[label] = max(check_close("  operator forward vs materialized", out, ref, tol),
                          check_close("  operator backward vs materialized", x.grad[:n], ref_dh, tol))
        if not bool((x.grad[n:] == 0).all()):
            raise AssertionError(f"{name}: the padding rows' gradient is not zero")
    return errs


def longest_row(mat) -> int:
    import torch

    return int(torch.diff(mat.packed.row_ptr.long()).max())


def factor_bound(mat, f: int, h_itemsize: int, peak: float) -> dict:
    """Least time for one kernel-1 call on a factor's tiles, counted by what
    the data needs: each nonzero once as an int32 column and a float32
    value, the row pointers, each distinct row of h that a nonzero reads
    once at ``h_itemsize`` bytes a column, the real output rows once in
    float32; 2 operations per nonzero and column at ``peak``."""
    import torch

    pk = mat.packed
    distinct = int(torch.unique(pk.col).numel())
    n_bytes = 8 * pk.nnz + 4 * (mat.n_rows + 1) + h_itemsize * f * distinct + 4 * f * mat.n_rows
    return {**bound_line(n_bytes, 2 * pk.nnz * f, peak), "h_rows_read": distinct}


def time_factor_kernel(name: str, mat, f: int, *, bf16: bool, h_dtype, seed: int) -> dict:
    """Kernel 1 on one factor's tiles at width f: checked against its plain
    twin, then timed in turns with torch.sparse.mm on the same nonzeros
    (CSR; for the bf16 contraction the values and h rounded to bf16 and
    multiplied in float32), the plain twin timed, the bound beside them.
    h is N(0, 1) from a seeded torch generator on the card."""
    import torch

    from graphconvgeo_torch.ops.spmm_bsr import bsr_flat_matmul, bsr_flat_matmul_plain

    mxu = torch.bfloat16 if bf16 else torch.float32
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    h = torch.randn((mat.n_cols_padded, f), generator=gen, device=DEVICE).to(h_dtype)
    pk = mat.packed
    got = bsr_flat_matmul(mat, h, mxu_dtype=mxu)
    want = bsr_flat_matmul_plain(mat, h, mxu_dtype=mxu)
    torch.cuda.synchronize()
    label = f"{name}, contraction {'bf16' if bf16 else 'float32'}, h {h_dtype}"
    print(f"{label}: {mat.n_tiles} tiles of {mat.block}^2 ({mat.n_rows} x {mat.n_cols}), "
          f"{pk.nnz} nonzeros, longest row {longest_row(mat)}")
    err = check_close("  kernel vs plain twin", got, want, KERNEL_REL_TOL)
    val = pk.val.bfloat16().float() if bf16 else pk.val
    csr = torch.sparse_csr_tensor(pk.row_ptr.long(), pk.col.long(), val,
                                  size=(mat.n_rows_padded, mat.n_cols_padded))
    h_lib = h.bfloat16().float() if bf16 or h_dtype == torch.bfloat16 else h
    lib_err = float((torch.sparse.mm(csr, h_lib) - got).abs().max())
    alt = alternate_ms(lambda: bsr_flat_matmul(mat, h, mxu_dtype=mxu),
                       lambda: torch.sparse.mm(csr, h_lib), "torch.sparse.mm")
    plain_ms = cuda_ms(lambda: bsr_flat_matmul_plain(mat, h, mxu_dtype=mxu))
    bd = factor_bound(mat, f, h.element_size(), BF16_FLOPS if bf16 else FP32_FLOPS)
    print(f"  kernel {alt['ms']!r} ms, plain {plain_ms!r} ms, torch.sparse.mm {alt['library_ms']!r} "
          f"ms (vs kernel max abs diff {lib_err!r}); bound: bytes {bd['bytes']} ({bd['h_rows_read']} "
          f"distinct h rows) -> {bd['bytes_ms']!r} ms, ops {bd['flops']} -> {bd['ops_ms']!r} ms; "
          f"bound {bd['bound_ms']!r} ms ({bd['bound_by']})")
    return {"max_abs_err": err, "ms": alt["ms"], "plain_ms": plain_ms,
            "library_ms": alt["library_ms"], "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "kernel_runs_ms": alt["kernel_runs_ms"], "library_runs_ms": alt["library_runs_ms"],
            "nnz": pk.nnz, "longest_row": longest_row(mat), "n_tiles": mat.n_tiles}


def time_factorized(name: str, fa, f: int, seed: int) -> dict:
    """Kernel 1 on both tile operands as the operator calls them (B'ᵀ on a
    float32 h; the merged operand on z, float32 or bf16), then the
    operator's forward + backward, f32 and bf16 in alternating repeats:
    host included (a run of steps as training issues them) and device alone
    (the median of single held steps)."""
    import statistics

    import numpy as np
    import torch

    from graphconvgeo_torch.sparse.factorized import spmm_factorized

    kernels = {}
    for bf16 in (False, True):
        key = "bf16" if bf16 else "f32"
        kernels[f"bt_{key}"] = time_factor_kernel(f"{name} B'^T tiles", fa.bt_tiles, f, bf16=bf16,
                                                  h_dtype=torch.float32, seed=seed)
        kernels[f"zr_{key}"] = time_factor_kernel(
            f"{name} merged tiles", fa.zr_tiles, f, bf16=bf16,
            h_dtype=torch.bfloat16 if bf16 else torch.float32, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    h = torch.tensor(rng.normal(size=(fa.n_rows, f)).astype(np.float32), device=DEVICE)
    g = torch.tensor(rng.normal(size=(fa.n_rows, f)).astype(np.float32), device=DEVICE)
    outs = {}

    def step_fn(dt):
        def step():
            x = h.detach().requires_grad_(True)
            out = spmm_factorized(fa, x, gather_dtype=dt, mxu_dtype=dt)
            out.backward(g)
            return out, x.grad
        return step

    for key, dt in (("f32", None), ("bf16", torch.bfloat16)):
        out, dh = step_fn(dt)()
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(out).all()) and bool(torch.isfinite(dh).all())):
            raise AssertionError(f"{name}: the {key} operator gave a non-finite value")
        outs[key] = (out.detach(), dh)
    check_close(f"{name}: bf16 operator vs float32, forward", outs["bf16"][0], outs["f32"][0],
                FACTORIZED_BF16_REL_TOL)
    check_close(f"{name}: bf16 operator vs float32, backward", outs["bf16"][1], outs["f32"][1],
                FACTORIZED_BF16_REL_TOL)
    runs = {f"{k}_{m}": [] for k in ("f32", "bf16") for m in ("ms", "device_ms")}
    held = {"f32": 0, "bf16": 0}
    for _ in range(FACTORIZED_REPEATS):
        for key, dt in (("f32", None), ("bf16", torch.bfloat16)):
            step = step_fn(dt)
            runs[f"{key}_ms"].append(cuda_ms(step, hold=False))
            times, n_held = held_call_ms(step, TIMING_ITERS)
            runs[f"{key}_device_ms"].append(statistics.median(times))
            held[key] += n_held
    med = {k: statistics.median(v) for k, v in runs.items()}
    print(f"{name}: operator fwd+bwd over {FACTORIZED_REPEATS} repeats, host included: f32 "
          f"{runs['f32_ms']!r} ms, bf16 {runs['bf16_ms']!r} ms\n"
          f"  device (median of {TIMING_ITERS} held steps a repeat): f32 {runs['f32_device_ms']!r} ms, "
          f"bf16 {runs['bf16_device_ms']!r} ms; medians f32 {med['f32_ms']!r} / "
          f"{med['f32_device_ms']!r}, bf16 {med['bf16_ms']!r} / {med['bf16_device_ms']!r} ms; "
          f"steps whose enqueue ended inside the hold: {held} of {FACTORIZED_REPEATS * TIMING_ITERS} each")
    return {"kernels": kernels, "operator": {**runs, **{f"median_{k}": v for k, v in med.items()},
                                              "held_steps": held}}


def projection_262k():
    """bench.py :: measure_projection's structure: the mention projection of
    262,144 users in 1,024 communities, ids shuffled, bipartite-reordered
    with clique grouping; its FactorizedAdjacency and projected edge count."""
    import numpy as np

    from graphconvgeo_torch.data.synthetic import random_mention_projection_graph
    from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency
    from graphconvgeo_torch.sparse.reorder import bipartite_reordering

    c = FACTORIZED_262K
    n = c["n"]
    t0 = time.perf_counter()
    adj, groups = random_mention_projection_graph(n, c["n_comm"], seed=c["seed"],
                                                  return_structure=True)
    edges = int(adj.nnz)
    del adj
    perm = np.random.default_rng(c["perm_seed"]).permutation(n)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    groups = {g: inv[np.asarray(m)] for g, m in groups.items()}
    ro = bipartite_reordering(groups, n, clique_group=True)
    groups = {g: ro.to_new(np.asarray(m)) for g, m in groups.items()}
    t1 = time.perf_counter()
    fa = FactorizedAdjacency.from_groups(groups, n)
    t2 = time.perf_counter()
    print(f"262k projection: {n} users, {len(groups)} hubs, {edges} projected edges; structure and "
          f"reorder {t1 - t0!r} s, factorized operand {t2 - t1!r} s")
    return fa, edges


def factorized_operand_line(name: str, fa) -> None:
    st = fa.stats()
    tile_bytes = sum(4 * t.tiles.numel() for t in (fa.bt_tiles, fa.zr_tiles) if t is not None)
    print(f"{name} factorized operand: {st}, z_pad {fa.z_pad}, diag_in_tiles {fa.diag_in_tiles}, "
          f"n_groups {fa.n_groups}, nnz_factored {fa.nnz_factored}, dense tiles {tile_bytes} bytes")
    if fa.bt_tiles is None or fa.zr_tiles is None:
        raise AssertionError(f"{name}: a tile operand is empty ({st})")


def phase_factorized_kernels(ds) -> tuple:
    """Kernel 1's bf16 contraction against its plain twin (edge cases and
    the GeoText factorized operand), the factorized operator against the
    materialized Â, and their times at GeoText and at 262,144 x 512.
    Returns ({"bsr_flat_matmul_bf16": its row}, kernel 1's float32 numbers
    on the factorized operands)."""
    import torch

    from graphconvgeo_torch.sparse.factorized import materialize_projection
    from graphconvgeo_torch.sparse.formats import BsrFlat, normalize_adjacency, to_device

    print("== phase 2 (factorized): kernel 1's bf16 contraction, the factorized operator")
    dev = torch.device(DEVICE)
    bf16 = torch.bfloat16
    err = 0.0
    for case in EMPTY_ROW_BLOCK_CASES:
        m = empty_row_block_matrix(case)
        mat = to_device(BsrFlat.from_scipy(m, block=case["block"]), dev)
        mat_t = to_device(BsrFlat.from_scipy(m.T.tocsr(), block=case["block"]), dev)
        for h_dt in (torch.float32, bf16):
            res = compare_tile_product(f"empty-row-block B={case['block']}", mat, mat_t, case["f"],
                                       case["seed"], empty_row_block=1, mxu_dtype=bf16, h_dtype=h_dt)
            err = max(err, res["fwd"], res["bwd"])
    for h_dt in (torch.float32, bf16):
        err = max(err, compare_full_tile("flat", mxu_dtype=bf16, h_dtype=h_dt))

    groups, n, direct, fa = factorized_small()
    fa = to_device(fa, dev)
    a_hat = normalize_adjacency(materialize_projection(groups, n, direct=direct))
    small = compare_factorized_operator(f"factorized operator, {n} nodes, block "
                                        f"{FACTORIZED_SMALL['block']} (z_pad {fa.z_pad})", fa, a_hat, 24, 30)

    t0 = time.perf_counter()
    fa = ds.factorized_adjacency()
    print(f"GeoText factorized operand built in {time.perf_counter() - t0!r} s")
    factorized_operand_line("GeoText", fa)
    fa = to_device(fa, dev)
    for mat_name in ("bt_tiles", "zr_tiles"):
        print(f"GeoText {mat_name}:")
        pack_ms(getattr(fa, mat_name))
    a_hat = normalize_adjacency(materialize_projection(dataset_groups(ds), ds.n_nodes,
                                                       direct=(ds.direct_src, ds.direct_dst)))
    geo_op = compare_factorized_operator("factorized operator, GeoText", fa, a_hat, GEOTEXT_F, 31)
    geo = time_factorized("GeoText", fa, GEOTEXT_F, 32)
    del fa, a_hat

    fa, edges = projection_262k()
    factorized_operand_line("262k", fa)
    fa = to_device(fa, dev)
    big = time_factorized("262k x 512", fa, FACTORIZED_262K["f"], 33)
    del fa
    torch.cuda.empty_cache()

    kernel_errs = [k["max_abs_err"] for k in list(geo["kernels"].values()) + list(big["kernels"].values())]

    def summary(prefix: str) -> dict:
        """Kernel 1's numbers on both tile operands at both shapes, and the
        operator's, for one contraction (prefix f32 or bf16)."""
        out = {}
        for shape, res in (("geotext", geo), ("262k", big)):
            for op in ("bt", "zr"):
                k = res["kernels"][f"{op}_{prefix}"]
                for key in ("ms", "plain_ms", "library_ms", "bound_ms", "nnz", "longest_row", "n_tiles"):
                    out[f"{op}_{key}_{shape}"] = k[key]
            for key in ("ms", "device_ms"):
                out[f"operator_{key}_{shape}"] = res["operator"][f"median_{prefix}_{key}"]
        return out

    zr = geo["kernels"]["zr_bf16"]
    bf16_row = {
        "max_abs_err": max([err] + kernel_errs), "edge_case_max_abs_err": err,
        "operator_max_abs_err": {k: v["bf16"] for k, v in (("small", small), ("geotext", geo_op))},
        "ms": zr["ms"], "plain_ms": zr["plain_ms"], "library_ms": zr["library_ms"],
        "bound_ms": zr["bound_ms"], "bound_by": zr["bound_by"],
        "kernel_runs_ms": zr["kernel_runs_ms"], "library_runs_ms": zr["library_runs_ms"],
        "operand": "GeoText merged tiles, z bf16, F 300", **summary("bf16"),
    }
    f32 = {"operator_max_abs_err": {k: v["float32"] for k, v in (("small", small), ("geotext", geo_op))},
           **summary("f32"), "projected_edges_262k": edges}
    return {"bsr_flat_matmul_bf16": bf16_row}, f32


# ---- GAT: the tiled attention kernels ---------------------------------------
GAT_KERNELS = ("gat_tile_fwd", "gat_tile_bwd_row", "gat_tile_bwd_col")


def gat_empty_block_pattern():
    """Self-loops on every node outside block 1 plus one edge pair across
    blocks: row and column block 1 hold no edge (filler tiles only)."""
    import numpy as np
    import scipy.sparse as sp

    n, b = GAT_EMPTY_BLOCK_N, GAT_BLOCK
    keep = np.r_[0:b, 2 * b : n]
    rows, cols = np.r_[keep, 2, 400], np.r_[keep, 400, 2]
    return sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n)).tocsr()


def gat_hot_pattern(seed: int):
    """A 200-node clique (dense tiles) over sparse random edges (the rest);
    node 0 has only its self-loop, so column 0 is masked in every other row
    of its tiles and is what the rest's padding slots point at."""
    import numpy as np
    import scipy.sparse as sp

    n = GAT_HOT_N
    a = sp.random(n, n, density=0.002, format="lil", dtype=np.float32, random_state=seed)
    a[1:201, 1:201] = 1.0
    a = (a.tocsr() + a.T.tocsr() + sp.identity(n, format="csr", dtype=np.float32)).tolil()
    a[0, 1:] = 0.0
    a[1:, 0] = 0.0
    a = a.tocsr()
    a.eliminate_zeros()
    a.data[:] = 1.0
    return a


def gat_32k_pattern():
    """bench.py's GAT operand (``_gat_graph``) at 32,768 nodes: projected
    mention graph, shuffled, normalized, reordered."""
    import numpy as np

    from graphconvgeo_torch.data.synthetic import random_mention_projection_graph
    from graphconvgeo_torch.sparse.formats import normalize_adjacency
    from graphconvgeo_torch.sparse.reorder import best_reordering

    c = GAT_32K
    adj = random_mention_projection_graph(c["n"], c["n_comm"], seed=c["seed"])
    perm = np.random.default_rng(c["perm_seed"]).permutation(c["n"])
    a_hat = normalize_adjacency(adj[perm][:, perm].tocsr())
    ro = best_reordering(a_hat, seed=c["reorder_seed"])
    return ro.permute_graph(a_hat), ro.method


def gat_inputs(n: int, seed: int, *, hot: bool = False):
    """(z [n, H·f], a_src, a_dst [H, f], g [n, H·f]) on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, GAT_HEADS * GAT_F)).astype(np.float32) * 0.5
    a_src = (rng.normal(size=(GAT_HEADS, GAT_F)) * 0.3).astype(np.float32)
    a_dst = (rng.normal(size=(GAT_HEADS, GAT_F)) * 0.3).astype(np.float32)
    if hot:
        # d_0 = 150 in every head: column 0's masked scores sit ~150 above
        # every row's edge max, where an unmasked exp overflows to inf
        z[0] = (GAT_HOT_SCORE * a_dst / (a_dst**2).sum(1, keepdims=True)).ravel()
    g = rng.normal(size=(n, GAT_HEADS * GAT_F)).astype(np.float32)
    return [torch.tensor(v, device=DEVICE) for v in (z, a_src, a_dst, g)]


def gat_sweep_operands(att, inputs, *, rate: float, seed: int) -> dict:
    """The three sweeps' operands as the layer builds them: s, d, zp, the
    merged m and den (the forward through the kernels), c = ⟨g, out⟩, gp."""
    import torch

    from graphconvgeo_torch.ops import attention_tiled as at

    z, a_src, a_dst, g = inputs
    with torch.no_grad():
        out, s, d, m, den, zp = at._layer_fwd(att, z, a_src, a_dst, seed=seed, slope=GAT_SLOPE, rate=rate)
        gp, c = at._bwd_operands(att, a_src, g, out)
    return dict(s=s, d=d, zp=zp, m=m, den=den, c=c, gp=gp)


def gat_kernel_calls(att, ops: dict, *, rate: float, seed: int, mxu_precision=None):
    """{kernel: (kernel call, plain call)} on the sweep operands, both at
    ``mxu_precision``."""
    from graphconvgeo_torch.ops import attention_tiled as at

    kw = dict(slope=GAT_SLOPE, seed=seed, rate=rate, mxu_precision=mxu_precision)
    fwd = (att, ops["s"], ops["d"], ops["zp"])
    bwd = (att, ops["s"], ops["d"], ops["m"], ops["den"], ops["c"], ops["zp"], ops["gp"])
    return {
        "gat_tile_fwd": (lambda: at.gat_tile_fwd(*fwd, f=GAT_F, **kw),
                         lambda: at.gat_tile_fwd_plain(*fwd, f=GAT_F, **kw)),
        "gat_tile_bwd_row": (lambda: at.gat_tile_bwd_row(*bwd, f=GAT_F, **kw),
                             lambda: at.gat_tile_bwd_row_plain(*bwd, f=GAT_F, **kw)),
        "gat_tile_bwd_col": (lambda: at.gat_tile_bwd_col(*bwd, f=GAT_F, **kw),
                             lambda: at.gat_tile_bwd_col_plain(*bwd, f=GAT_F, **kw)),
    }


def compare_gat_kernels(name: str, att, inputs, *, rate: float, seed: int, empty_block=None,
                        empty_rows=None, empty_cols=None, mxu_precision=None) -> dict:
    """Each tile kernel against its plain twin on one operand, both at
    ``mxu_precision`` (the bf16-operand variants under "default": kernel and
    twin round the same operands and differ in the order of the float32
    sums, so KERNEL_REL_TOL holds them too). Returns {kernel: max abs err},
    the sweep operands and the calls (for timing). ``empty_block`` (a block
    index), ``empty_rows`` and ``empty_cols`` (index tensors of rows /
    columns with no edge) must come out exactly neutral."""
    import torch

    ops = gat_sweep_operands(att, inputs, rate=rate, seed=seed)
    calls = gat_kernel_calls(att, ops, rate=rate, seed=seed, mxu_precision=mxu_precision)
    st = att.stats()
    print(f"{name}: {att.n_tiles} tiles of {att.block}^2 over {att.n_row_blocks} row blocks, "
          f"{st['tiled_edges']} tiled edges, {st['rest_edges']} rest edges, fill "
          f"{st['tile_fill']!r}; z {tuple(ops['zp'].shape)}, attention dropout {rate}, "
          f"mxu_precision {mxu_precision!r}")
    outs = {}
    for kernel, (k_call, p_call) in calls.items():
        got, want = k_call(), p_call()
        torch.cuda.synchronize()
        outs[kernel] = (got, want)
    (o_k, den_k, m_k), (o_p, den_p, m_p) = outs["gat_tile_fwd"]
    valid = m_p > -5e29
    if not torch.equal(valid, m_k > -5e29):
        raise AssertionError(f"{name}: the kernel and the plain twin disagree on rows with an edge")
    errs = {"gat_tile_fwd": max(
        check_close("fwd o", o_k, o_p, KERNEL_REL_TOL),
        check_close("fwd den", den_k, den_p, KERNEL_REL_TOL),
        check_close("fwd m (rows with a tiled edge)", m_k[valid], m_p[valid], KERNEL_REL_TOL),
    )}
    ds_k, ds_p = outs["gat_tile_bwd_row"]
    errs["gat_tile_bwd_row"] = check_close("bwd_row ds", ds_k, ds_p, KERNEL_REL_TOL)
    (dz_k, dd_k), (dz_p, dd_p) = outs["gat_tile_bwd_col"]
    errs["gat_tile_bwd_col"] = max(
        check_close("bwd_col dz", dz_k, dz_p, KERNEL_REL_TOL),
        check_close("bwd_col dd", dd_k, dd_p, KERNEL_REL_TOL),
    )
    results = (o_k, den_k, ds_k, dz_k, dd_k)
    if not all(bool(torch.isfinite(t).all()) for t in results + (m_k,)):
        raise AssertionError(f"{name}: a kernel output is not finite")
    if empty_block is not None:
        b = att.block
        blk = slice(empty_block * b, (empty_block + 1) * b)
        neutral = all(bool((t[blk] == 0).all()) for t in results) and bool(
            (m_k[blk] == torch.tensor(-1e30, device=m_k.device)).all()
        )
        if not neutral:
            raise AssertionError(f"{name}: empty block {empty_block} is not exactly neutral")
        print(f"  empty block {empty_block}: o = den = ds = dz = dd = 0 and m = -1e30 exactly")
    if empty_rows is not None:
        neutral = all(bool((t[empty_rows] == 0).all()) for t in (o_k, den_k, ds_k)) and bool(
            (m_k[empty_rows] == torch.tensor(-1e30, device=m_k.device)).all())
        if not neutral:
            raise AssertionError(f"{name}: a row with no edge is not exactly neutral")
        print(f"  {len(empty_rows)} rows with no edge: o = den = ds = 0 and m = -1e30 exactly")
    if empty_cols is not None:
        if not all(bool((t[empty_cols] == 0).all()) for t in (dz_k, dd_k)):
            raise AssertionError(f"{name}: a column with no edge is not exactly neutral")
        print(f"  {len(empty_cols)} columns with no edge: dz = dd = 0 exactly")
    return {"errs": errs, "ops": ops, "calls": calls}


def gat_keep_probe(att, *, rate: float, seed: int) -> None:
    """The kernels' keep masks equal the plain twin's bit for bit: with
    s = d = 0 every tiled edge weighs exp(0) = 1, and with z[j, :, c] = 1
    exactly when c = j mod B, o[i, :, c] adds up κ of the edges (i, ·, c) —
    sums of 0 and one float, exact in both. Any flipped keep bit changes an
    entry by 1/(1 − rate)."""
    import torch

    from graphconvgeo_torch.ops import attention_tiled as at

    b, heads = att.block, GAT_HEADS
    npad, mpad = att.n_row_blocks * b, att.n_col_blocks * b
    s = torch.zeros((npad, heads), device=DEVICE)
    d = torch.zeros((mpad, heads), device=DEVICE)
    eye = torch.eye(b, device=DEVICE)
    z = eye.repeat(att.n_col_blocks, 1)[:, None, :].expand(mpad, heads, b).contiguous()
    kw = dict(slope=GAT_SLOPE, seed=seed, rate=rate)
    o_k = at.gat_tile_fwd(att, s, d, z, **kw)[0]
    o_p = at.gat_tile_fwd_plain(att, s, d, z, **kw)[0]
    o_u = at.gat_tile_fwd(att, s, d, z, slope=GAT_SLOPE, seed=seed, rate=0.0)[0]
    torch.cuda.synchronize()
    if not torch.equal(o_k, o_p):
        raise AssertionError(f"keep masks differ: max diff {float((o_k - o_p).abs().max())}")
    kept, total = float(o_k.sum()) * (1.0 - rate), float(o_u.sum())
    print(f"  keep-mask probe: kernel == plain exactly; kept {kept!r} of {total!r} "
          f"tiled edge-heads ({kept / total!r}; expected {1 - rate})")


def edge_list_gat(rows, cols, shape, z, a_src, a_dst, *, rate: float, seed: int):
    """The GAT layer over an edge list in plain PyTorch, under autograd: the
    reference for the tiled layer's autograd Function (same scores, softmax
    per row under its max, dropout keyed by the same entry ids)."""
    import torch

    from graphconvgeo_torch.ops.dropout import entry_keep

    heads, f = a_src.shape
    n_rows, n_cols = shape
    zh = z.view(z.shape[0], heads, f)
    s = torch.einsum("nhf,hf->nh", zh, a_src)
    d = torch.einsum("nhf,hf->nh", zh, a_dst)
    raw = s[rows] + d[cols]
    sc = torch.where(raw >= 0, raw, GAT_SLOPE * raw)
    idx = rows[:, None].expand(-1, heads)
    m = torch.full((z.shape[0], heads), -1e30, device=z.device)
    m = m.scatter_reduce(0, idx, sc.detach(), "amax")
    e = torch.exp(sc - m[rows])
    den = torch.zeros((z.shape[0], heads), device=z.device).index_add(0, rows, e)
    alpha = e / den[rows]
    if rate > 0.0:
        hs = torch.arange(heads, device=z.device, dtype=torch.int64) * ((n_rows * n_cols) & 0xFFFFFFFF)
        eid = rows[:, None] * n_cols + cols[:, None] + hs[None, :]
        alpha = alpha * entry_keep(eid, seed, rate).float() / (1.0 - rate)
    out = torch.zeros((z.shape[0], heads, f), device=z.device)
    out = out.index_add(0, rows, alpha[..., None] * zh[cols])
    return out.view(z.shape[0], heads * f)


def compare_gat_layer(name: str, att, csr, inputs, *, rate: float, seed: int) -> float:
    """The tiled layer (its autograd Function: kernels 3-5 over the whole
    pattern's edge lists) against :func:`edge_list_gat` under autograd:
    output and the gradients in z, a_src, a_dst."""
    import torch

    from graphconvgeo_torch.ops.attention_tiled import gat_attention_tiled

    z, a_src, a_dst, g = inputs
    coo = csr.tocoo()
    rows = torch.as_tensor(coo.row, dtype=torch.int64, device=DEVICE)
    cols = torch.as_tensor(coo.col, dtype=torch.int64, device=DEVICE)

    def run(fn):
        ts = [t.detach().clone().requires_grad_(True) for t in (z, a_src, a_dst)]
        out = fn(*ts)
        out.backward(g)
        torch.cuda.synchronize()
        return [out.detach()] + [t.grad for t in ts]

    got = run(lambda z_, s_, d_: gat_attention_tiled(
        att, z_, s_, d_, negative_slope=GAT_SLOPE, attn_dropout=rate, seed=seed))
    want = run(lambda z_, s_, d_: edge_list_gat(
        rows, cols, csr.shape, z_, s_, d_, rate=rate, seed=seed))
    errs = [check_close(f"layer {k}", a, b, KERNEL_REL_TOL)
            for k, a, b in zip(("out", "dz", "da_src", "da_dst"), got, want)]
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError(f"{name}: a layer output or gradient is not finite")
    return max(errs)


def edge_tables(att) -> dict:
    """Build the pattern's edge lists (once; the three sweep kernels reuse
    them), print the build time and the longest and mean row and
    column, and check the entry count against the tiled edges."""
    import torch

    for name in ("edges", "edges_t"):
        if name in vars(att):
            raise AssertionError(f"the pattern's {name} were built before they were timed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    edges, edges_t = att.edges, att.edges_t
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rows, cols = (torch.diff(e.ptr.long()).double() for e in (edges, edges_t))
    out = {"build_ms": ms, "nnz": edges.nnz, "row_max": int(rows.max()), "row_mean": float(rows.mean()),
           "col_max": int(cols.max()), "col_mean": float(cols.mean())}
    print(f"  edge lists built once in {ms!r} ms (operand preparation, not per call): "
          f"{edges.nnz} entries by row and {edges_t.nnz} by column; over the {rows.numel()} padded "
          f"rows longest {out['row_max']}, mean {out['row_mean']!r}; over the {cols.numel()} padded "
          f"columns longest {out['col_max']}, mean {out['col_mean']!r}")
    want = att.stats()["tiled_edges"]
    if not edges.nnz == edges_t.nnz == want:
        raise AssertionError(f"edge lists hold {edges.nnz} / {edges_t.nnz} entries, not the "
                             f"{want} tiled edges")
    return out


def gather_bytes(kernel: str, att, f: int, fp: int) -> int:
    """The bytes an edge kernel's design moves (counted, not measured), each
    once: per tiled edge and head, ceil(f/4) 16-byte pieces of a z row (fwd,
    ds) or a g row (dz/dd) and its int32 index, with d_j (fwd, ds) or the
    row's s, m, den and c (dz/dd); then its padded output, written once; the
    ds kernel also reads each row's g piece and s, m, den, c once and
    writes ds."""
    nnz, heads = att.edges.nnz, GAT_HEADS
    row_bytes = 16 * -(-f // 4)
    per_edge = row_bytes + 4 + (16 if kernel == "gat_tile_bwd_col" else 4)
    if kernel == "gat_tile_bwd_row":
        rows = att.n_row_blocks * att.block
        return nnz * heads * per_edge + rows * heads * (row_bytes + 16 + 4)
    rows = att.n_row_blocks * att.block if kernel == "gat_tile_fwd" else att.n_col_blocks * att.block
    return nnz * heads * per_edge + 4 * rows * heads * (fp + (2 if kernel == "gat_tile_fwd" else 1))


def gat_tiled_span(att) -> tuple:
    """(rows, columns) of the pattern that hold a tiled edge: the rows of g
    and the rows of z (columns of the pattern) the sweeps must read."""
    import torch

    from graphconvgeo_torch.sparse.attention_tiles import unpack_mask

    b = att.block
    mask = unpack_mask(att.mask_bits, b)
    ar = torch.arange(b, device=mask.device)
    return tuple(
        int(torch.unique((blk.long()[:, None] * b + ar)[hit]).numel())
        for blk, hit in ((att.rowblk, mask.any(2)), (att.colblk, mask.any(1)))
    )


def gat_bound(kernel: str, att, f: int, fp: int, tiled_edges: int, span: tuple,
              peak: float = FP32_FLOPS) -> dict:
    """Least time on this card for one sweep, counted by what the data
    needs: at the head width f, the rows of z (and g) that hold a tiled edge
    read once, the outputs' n_rows (or n_cols) rows written once, the packed
    masks and tile lists, the narrow [N, H] vectors; 2 flops per tiled edge,
    head and feature for each product (fwd e·z; bwd_row g·zᵀ; bwd_col g·zᵀ
    and αᵀ·g). The kernels' padded layout (Npad or Mpad rows at width Fp)
    and their dense-tile work (every tile entry, zeros included) are printed
    beside it, not used as the bound. ``peak``: the products' rate (float32
    FFMA; the bf16-operand variants take the bf16 peak)."""
    b, heads = att.block, GAT_HEADS
    tiles = 4 * att.n_tiles * (b // 32) * b + 4 * 2 * att.n_tiles + \
        4 * (max(att.n_row_blocks, att.n_col_blocks) + 1)

    def sweep_bytes(rows_in, cols_in, rows_out, cols_out, width):
        z_in, g_in = 4 * cols_in * heads * width, 4 * rows_in * heads * width
        vec_r, vec_c = 4 * rows_in * heads, 4 * cols_in * heads  # s (m, den, c); d
        if kernel == "gat_tile_fwd":  # → o, den, m
            return z_in + vec_r + vec_c + tiles + 4 * rows_out * heads * (width + 2)
        if kernel == "gat_tile_bwd_row":  # → ds
            return z_in + g_in + 4 * vec_r + vec_c + tiles + 4 * rows_out * heads
        return z_in + g_in + 4 * vec_r + vec_c + tiles + 4 * cols_out * heads * (width + 1)  # → dz, dd

    products = 2 if kernel == "gat_tile_bwd_col" else 1
    n_bytes = sweep_bytes(*span, att.n_rows, att.n_cols, f)
    npad, mpad = att.n_row_blocks * b, att.n_col_blocks * b
    layout_bytes = sweep_bytes(npad, mpad, npad, mpad, fp)
    dense_ms = 2 * products * att.n_tiles * heads * b * b * fp / FP32_FLOPS * 1e3
    return {**bound_line(n_bytes, 2 * products * tiled_edges * heads * f, peak),
            "layout_bytes_ms": layout_bytes / HBM_BYTES_PER_S * 1e3,
            "dense_tile_ms_at_peak": dense_ms}


def time_gat_kernels(att, res: dict, *, peak: float = FP32_FLOPS, suffix: str = "") -> dict:
    """Each kernel of ``res`` and its twin (CUDA events) beside its bound at
    ``peak``; rows named kernel + ``suffix``."""
    fp = res["ops"]["zp"].shape[2]
    tiled_edges = att.stats()["tiled_edges"]
    span = gat_tiled_span(att)
    print(f"  rows with a tiled edge {span[0]} of {att.n_rows}, columns {span[1]} of {att.n_cols}")
    out = {}
    for kernel, (k_call, p_call) in res["calls"].items():
        ms, plain_ms = cuda_ms(k_call), cuda_ms(p_call)
        bd = gat_bound(kernel, att, GAT_F, fp, tiled_edges, span, peak)
        out[kernel + suffix] = {"ms": ms, "plain_ms": plain_ms, **bd}
        print(f"  {kernel + suffix}: kernel {ms!r} ms, plain {plain_ms!r} ms; bound: bytes "
              f"{bd['bytes']} -> {bd['bytes_ms']!r} ms at 3.35 TB/s, flops {bd['flops']} -> "
              f"{bd['ops_ms']!r} ms at {peak / 1e12!r} TFLOP/s; bound {bd['bound_ms']!r} ms "
              f"({bd['bound_by']}); padded layout's bytes {bd['layout_bytes_ms']!r} ms, "
              f"dense-tile work {bd['dense_tile_ms_at_peak']!r} ms at the f32 peak")
        moved = gather_bytes(kernel, att, GAT_F, fp)
        print(f"    the edge kernel's design traffic: {moved} bytes gathered and written (counted), "
              f"{moved / (ms * 1e-3) / 1e12!r} TB/s over the measured {ms!r} ms")
    return out


def time_gat(name: str, att, att_b, res: dict, inputs) -> dict:
    """Each kernel and its twin (CUDA events), each bound, and the layer's
    forward + backward on the tiled operand against the bucketed one."""
    from graphconvgeo_torch.ops.attention import gat_attention

    import statistics

    z, a_src, a_dst, g = inputs
    out = time_gat_kernels(att, res)

    def layer_step(operand):
        def step():
            ts = [t.detach().requires_grad_(True) for t in (z, a_src, a_dst)]
            gat_attention(operand, *ts, negative_slope=GAT_SLOPE).backward(g)
        return step

    # Each repeat times both operands, alternating: a step as the training
    # loop runs it (host dispatch included), then the device's own time of
    # single steps, each held.
    layer = {k: [] for k in ("tiled_ms", "bucketed_ms", "tiled_device_ms", "bucketed_device_ms")}
    held = {"tiled": 0, "bucketed": 0}
    for _ in range(LAYER_REPEATS):
        for name, operand in (("tiled", att), ("bucketed", att_b)):
            step = layer_step(operand)
            layer[f"{name}_ms"].append(cuda_ms(step, hold=False))
            times, n_held = held_call_ms(step, TIMING_ITERS)
            layer[f"{name}_device_ms"].append(statistics.median(times))
            held[name] += n_held
    med = {k: statistics.median(v) for k, v in layer.items()}
    print(f"  layer fwd+bwd over {LAYER_REPEATS} repeats, host included: tiled {layer['tiled_ms']!r} "
          f"ms, bucketed {layer['bucketed_ms']!r} ms; median tiled / bucketed "
          f"{med['tiled_ms'] / med['bucketed_ms']!r}\n"
          f"  layer fwd+bwd, device (median of {TIMING_ITERS} held steps a repeat): tiled "
          f"{layer['tiled_device_ms']!r} ms, bucketed {layer['bucketed_device_ms']!r} ms; median "
          f"tiled / bucketed {med['tiled_device_ms'] / med['bucketed_device_ms']!r}; steps whose "
          f"enqueue ended inside the hold: {held} of {LAYER_REPEATS * TIMING_ITERS} each")
    return {"kernels": out, "layer": {**layer, "held_steps": held}}


def gat_bf16_layer_path(att, csr, inputs) -> dict:
    """Kernels 3-5' on their path, the public function: the counts zeroed,
    then ``gat_attention_tiled(..., mxu_precision="default")`` forward +
    backward once, then the counts read: one launch of each bf16 variant
    and none of the float32 kernels. Its output and gradients against the
    float32 edge-list layer within GAT_BF16_LAYER_REL_TOL. Returns the
    launch counts."""
    import torch

    from graphconvgeo_torch.ops.attention_tiled import gat_attention_tiled
    from graphconvgeo_torch.utils import cuda_build

    z, a_src, a_dst, g = inputs
    coo = csr.tocoo()
    rows = torch.as_tensor(coo.row, dtype=torch.int64, device=DEVICE)
    cols = torch.as_tensor(coo.col, dtype=torch.int64, device=DEVICE)

    def run(fn):
        ts = [t.detach().clone().requires_grad_(True) for t in (z, a_src, a_dst)]
        out = fn(*ts)
        out.backward(g)
        torch.cuda.synchronize()
        return [out.detach()] + [t.grad for t in ts]

    print(f"== phase 2 (GAT): the path {GAT_BF16_PATH}, forward + backward at GeoText")
    cuda_build.reset_launch_counts()
    got = run(lambda z_, s_, d_: gat_attention_tiled(att, z_, s_, d_, negative_slope=GAT_SLOPE,
                                                     mxu_precision="default"))
    launches = dict(cuda_build.launch_counts)
    print(f"  launches {launches}")
    want_launches = {k: 0 for k in launches}
    want_launches.update({k: 1 for k in _NO_GAT_BF16})
    if launches != want_launches:
        raise AssertionError(f"the bf16 layer launched {launches}, not {want_launches}")
    want = run(lambda z_, s_, d_: edge_list_gat(rows, cols, csr.shape, z_, s_, d_, rate=0.0,
                                                seed=0))
    for k, a, b in zip(("out", "dz", "da_src", "da_dst"), got, want):
        check_close(f"bf16 layer {k} vs the float32 edge-list layer", a, b, GAT_BF16_LAYER_REL_TOL)
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError("the bf16 layer's output or a gradient is not finite")
    return launches


def phase_gat_kernels(ds) -> dict:
    import time as _time

    from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern
    from graphconvgeo_torch.sparse.formats import BucketedAttention, to_device

    print("== phase 2 (GAT): tiled attention kernels against their plain versions, float32 and "
          "with bf16 tile contractions (mxu_precision='default')")
    dev = DEVICE
    tiled = lambda csr, **kw: to_device(TiledAttentionPattern.from_scipy(csr, block=GAT_BLOCK, **kw), dev)
    errs = {k + sfx: 0.0 for k in GAT_KERNELS for sfx in ("", "_bf16")}
    layer_err = 0.0

    def compare(name, att, inputs, **kw):
        """The kernels in float32 and in bf16 against their twins; returns
        the float32 and the bf16 results."""
        out = []
        for prec, sfx in ((None, ""), ("default", "_bf16")):
            res = compare_gat_kernels(name, att, inputs, mxu_precision=prec, **kw)
            for k, v in res["errs"].items():
                errs[k + sfx] = max(errs[k + sfx], v)
            out.append(res)
        return out

    empty = gat_empty_block_pattern()
    att = tiled(empty, min_tile_nnz=2)
    inputs = gat_inputs(empty.shape[0], 10)
    compare("GAT empty-block pattern", att, inputs, rate=0.0, seed=0, empty_block=1)
    layer_err = max(layer_err, compare_gat_layer("empty-block", att, empty, inputs, rate=0.0, seed=0))

    hot = gat_hot_pattern(11)
    att = tiled(hot)
    inputs = gat_inputs(hot.shape[0], 12, hot=True)
    compare("GAT hot-column-0 pattern", att, inputs, rate=0.0, seed=0)
    layer_err = max(layer_err, compare_gat_layer("hot-column-0", att, hot, inputs, rate=0.0, seed=0))

    att = tiled(ds.adj)
    if att.n_tiles != GAT_GEOTEXT_TILES:
        raise AssertionError(f"GeoText-scale GAT operand has {att.n_tiles} tiles, not {GAT_GEOTEXT_TILES}")
    inputs = gat_inputs(ds.n_nodes, 13)
    geo_edges = edge_tables(att)
    seed = 12345
    compare("GAT GeoText-scale operand, dropout", att, inputs, rate=ATTN_DROPOUT, seed=seed)
    gat_keep_probe(att, rate=ATTN_DROPOUT, seed=seed)
    layer_err = max(layer_err, compare_gat_layer("GeoText dropout", att, ds.adj, inputs,
                                                 rate=ATTN_DROPOUT, seed=seed))
    res, res_bf16 = compare("GAT GeoText-scale operand (the main path's)", att, inputs, rate=0.0,
                            seed=0)
    layer_err = max(layer_err, compare_gat_layer("GeoText", att, ds.adj, inputs, rate=0.0, seed=0))
    bf16_launches = gat_bf16_layer_path(att, ds.adj, inputs)
    att_b = to_device(BucketedAttention.from_scipy(ds.adj), dev)
    geo = time_gat("GeoText", att, att_b, res, inputs)
    geo["kernels"].update(time_gat_kernels(att, res_bf16, peak=BF16_FLOPS, suffix="_bf16"))

    t0 = _time.perf_counter()
    big, method = gat_32k_pattern()
    att = tiled(big)
    att_b = to_device(BucketedAttention.from_scipy(big), dev)
    print(f"32k mention-projection operand: {big.shape[0]} nodes, {big.nnz} nonzeros, reorder "
          f"{method!r}, operands built in {_time.perf_counter() - t0!r} s")
    inputs = gat_inputs(big.shape[0], 14)
    big_edges = edge_tables(att)
    res, res_bf16 = compare("GAT 32k operand", att, inputs, rate=0.0, seed=0)
    layer_err = max(layer_err, compare_gat_layer("32k", att, big, inputs, rate=0.0, seed=0))
    k32 = time_gat("32k", att, att_b, res, inputs)
    k32["kernels"].update(time_gat_kernels(att, res_bf16, peak=BF16_FLOPS, suffix="_bf16"))

    out = {}
    for k in errs:
        g, b = geo["kernels"][k], k32["kernels"][k]
        out[k] = {
            "max_abs_err": errs[k],
            "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
            "bound_by": g["bound_by"], "library_ms": None,
            "ms_32k": b["ms"], "plain_ms_32k": b["plain_ms"], "bound_ms_32k": b["bound_ms"],
            "bound_by_32k": b["bound_by"],
            "edge_lists_geotext": geo_edges, "edge_lists_32k": big_edges,
        }
        if k in GAT_KERNELS:
            out[k].update(layer_max_abs_err=layer_err, layer_geotext=geo["layer"],
                          layer_32k=k32["layer"])
        else:  # the bf16 variants' launches come from their path, the public function
            out[k]["launches"] = bf16_launches[k]
    return out


def checkpoint_dir(data_dir: str, path: str) -> str:
    return os.path.join(data_dir, f"checkpoints_{path}")


def phase_main_path(data_dir: str, path: str) -> dict:
    import math

    from graphconvgeo_torch import cli
    from graphconvgeo_torch.utils import cuda_build

    model, flags, backend, _ = ALL_PATHS[path]
    if path in (*CHECKPOINT_PATHS, SAMPLED_DIST_PATH):
        flags = [*flags, "--checkpoint-dir", checkpoint_dir(data_dir, path)]
    print(f"== phase 3: the main path {path} (graphconvgeo_torch.cli.main, geotext preset, "
          f"{' '.join(flags) or 'defaults'})")
    argv = ["--preset", "geotext", "-d", data_dir, "--epochs", str(EPOCHS),
            "--patience", str(EPOCHS), "--device", DEVICE, "--json", *flags]
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
    operand = (f"backend {run['backend']}, {run['n_tiles']} dense tiles" if model == "gcn" else
               f"attention operand {run['att_backend']}, {run['n_tiles']} tiles, "
               f"{run['tiled_edges']} tiled edges, {run['rest_edges']} rest edges")
    if backend == "factorized":
        operand += (f" (adjacency {run['adjacency']}, gather dtype {run['gather_dtype']}: B'^T "
                    f"{run['bt_tiles']} tiles, merged {run['zr_tiles']} tiles, rest rows "
                    f"{run['bt_rest_rows']} / {run['br_rest_rows']})")
    print(
        f"  device {run['device']}, model {run['model']}, {operand}, input {run['input_operand']} "
        f"(slab {run['slab_dtype']}, {run['slab_cols']} columns, rest {run['input_rest']}), "
        f"reorder candidate {run['reorder']!r}\n"
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
    if model == "gcn" and run["backend"] != backend:
        raise AssertionError(f"backend resolved to {run['backend']}, not {backend}")
    if backend == "factorized" and not (run["bt_tiles"] > 0 and run["zr_tiles"] > 0):
        raise AssertionError(f"a factorized tile operand is empty: {run['bt_tiles']}, {run['zr_tiles']}")
    if backend == "bsr" and run["n_tiles"] != BSR_GEOTEXT_TILES:
        raise AssertionError(f"the bsr operand has {run['n_tiles']} tiles, not {BSR_GEOTEXT_TILES}")
    if model == "gat" and (run["att_backend"], run["n_tiles"]) != ("tiled", GAT_GEOTEXT_TILES):
        raise AssertionError(f"attention operand {run['att_backend']} with {run['n_tiles']} tiles, "
                             f"not tiled with {GAT_GEOTEXT_TILES}")
    if path in (SAMPLED_PATH, SAMPLED_DIST_PATH):
        got = (run["sampled"], run["sampler"], run["batch"], tuple(run["fanouts"]))
        if got != (True, "native", SAMPLED_BATCH, SAMPLED_FANOUTS):
            raise AssertionError(f"sampled run {got}: not the native sampler at batch "
                                 f"{SAMPLED_BATCH}, fanouts {SAMPLED_FANOUTS}")
        dist_run = (run["dist"], run.get("world_size"))
        if dist_run != ((True, 1) if path == SAMPLED_DIST_PATH else (False, None)):
            raise AssertionError(f"sampled run: dist, world size {dist_run}")
        steps = [h["step_launches"] for h in hist]
        print(f"  the steps' launches in each epoch: {steps[0]} (first epoch)")
        if any({k: v for k, v in st.items() if k not in _NO_DENSE} != {
                k: 0 for k in st if k not in _NO_DENSE} for st in steps):
            raise AssertionError(f"a sampled training step launched a sparse kernel: {steps}")
        dense = [tuple(st[k] for k in _NO_DENSE) for st in steps]
        if len(set(dense)) != 1 or len(set(dense[0])) != 1 or dense[0][0] < 1:
            raise AssertionError(f"the sampled epochs' dense products {dense}: not one nn, nt "
                                 f"and tn a step in each")
        after = {k: launches[k] - in_training[k] for k in launches}
        if after != EVAL_ONLY_LAUNCHES:
            raise AssertionError(f"the final evaluation launched {after}, not {EVAL_ONLY_LAUNCHES}")
    if path in MODEL_INPUT:
        want = MODEL_INPUT[path]
        got = (run["input_operand"], run["slab_dtype"], run["slab_cols"], run["input_rest"])
        if got != ("SlabbedBell", want["slab_dtype"], want["slab_cols"], "BucketedEll"):
            raise AssertionError(f"input operand {got}, not a {want['slab_dtype']} SlabbedBell of "
                                 f"{want['slab_cols']} columns with a BucketedEll rest")
    for name, per in EXPECTED_LAUNCHES_PER_EPOCH[path].items():
        counts = [h["launches"][name] for h in hist]
        if any(c != per for c in counts):
            raise AssertionError(f"{name}: launches per epoch {counts}, expected {per} each")
        if launches[name] < per * len(hist):
            raise AssertionError(f"{name}: {launches[name]} launches < {per} x {len(hist)}")
    return {
        "launches": launches, "in_training": in_training,
        "epochs": len(hist), "per_epoch_s": per_epoch, "report": report,
    }


def phase_eval_only(data_dir: str, path: str, trained: dict) -> None:
    """``--eval-only`` on a checkpoint path's directory: no training, the
    checkpoint untouched, dev and test metrics equal to the training run's,
    and the launches of the two full-graph predicts and nothing else."""
    from graphconvgeo_torch import cli
    from graphconvgeo_torch.utils import cuda_build

    ckpt = checkpoint_dir(data_dir, path)
    _, flags, _, _ = ALL_PATHS[path]
    print(f"== phase 3: --eval-only on {path}'s checkpoint ({sorted(os.listdir(ckpt))})")
    before = sorted(os.listdir(ckpt))
    argv = ["--preset", "geotext", "-d", data_dir, "--device", DEVICE, "--json", *flags,
            "--checkpoint-dir", ckpt, "--eval-only"]
    cuda_build.reset_launch_counts()
    report = cli.main(argv)
    launches = dict(cuda_build.launch_counts)
    want = trained["report"]
    print(f"  epochs {len(report['run']['history'])}, dev {report['dev']}, test {report['test']} "
          f"(trained: dev {want['dev']}, test {want['test']}); launches {launches}")
    if report["run"]["history"]:
        raise AssertionError(f"--eval-only trained {len(report['run']['history'])} epochs")
    if (report["dev"], report["test"]) != (want["dev"], want["test"]):
        raise AssertionError("--eval-only metrics differ from the training run's")
    if launches != EVAL_ONLY_LAUNCHES:
        raise AssertionError(f"--eval-only launches {launches}, expected {EVAL_ONLY_LAUNCHES}")
    if sorted(os.listdir(ckpt)) != before:
        raise AssertionError("--eval-only changed the checkpoint directory")


def phase_profile_dir(data_dir: str) -> None:
    """``--profile-dir``: the trainer's trace of epochs 2-3 holds the conv
    range and kernel 1's events (the trace itself fails loudly when the
    card's activity cannot be traced)."""
    from graphconvgeo_torch import cli
    from graphconvgeo_torch.utils.profiling import TRACE_FILE

    trace_dir = os.path.join(data_dir, "trace")
    print(f"== phase 3: --profile-dir ({PROFILE_EPOCHS} epochs, the gcn path)")
    cli.main(["--preset", "geotext", "-d", data_dir, "--epochs", str(PROFILE_EPOCHS),
              "--patience", str(PROFILE_EPOCHS), "--device", DEVICE, "--quiet",
              "--profile-dir", trace_dir])
    path = os.path.join(trace_dir, TRACE_FILE)
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    ranges = sum(n == "conv_0" for n in names)
    kernels = sum("packed_row_kernel" in n for n in names)
    print(f"  {path}: {os.path.getsize(path)} bytes, {len(names)} events, {ranges} conv_0 "
          f"ranges, {kernels} packed_row_kernel events")
    if not (ranges and kernels):
        raise AssertionError("the trace lacks the conv_0 range or packed_row_kernel events")


def phase_tune(data_dir: str) -> None:
    """``--tune`` on the card: TUNE_TRIALS trials of TUNE_EPOCHS epochs."""
    from graphconvgeo_torch import cli

    print(f"== phase 3: --tune {TUNE_TRIALS} --epochs {TUNE_EPOCHS}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--preset", "geotext", "-d", data_dir, "--tune", str(TUNE_TRIALS),
                  "--epochs", str(TUNE_EPOCHS), "--patience", str(TUNE_EPOCHS),
                  "--device", DEVICE, "--json"])
    print(out.getvalue(), end="")
    trials = [l for l in out.getvalue().splitlines() if l.startswith("tune[")]
    if len(trials) != TUNE_TRIALS:
        raise AssertionError(f"{len(trials)} tune trials printed, not {TUNE_TRIALS}")


def build_model(path: str, ds, device, *, dropout: float, seed: int, remat: bool = False):
    """The geotext preset's model of main path ``path`` on ``device`` (its
    family, its input layer, and for the GCN its SpMM backend or the
    factorized adjacency, and its gather dtype), with ``remat`` if asked."""
    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.models.gat import GATConfig, GraphAttentionNet
    from graphconvgeo_torch.models.gcn import GCNConfig, HighwayGCN
    from graphconvgeo_torch.sparse.formats import SparseGraph

    pre = PRESETS["geotext"]
    common = dict(n_features=ds.x.shape[1], n_classes=ds.n_classes, hidden=pre["hidden"],
                  dropout=dropout, l2=pre["l2"], remat=remat)
    x_graph, adj_graph = SparseGraph(csr=ds.x), SparseGraph(csr=ds.adj, symmetric=True)
    model, _, backend, gather_dtype = MAIN_PATHS[path]
    common.update(MODEL_INPUT.get(path, {}))
    if model == "gat":
        cfg = GATConfig(**common, heads=GAT_HEADS, att_backend="tiled")
        return GraphAttentionNet(cfg, x_graph, adj_graph, device=device, seed=seed)
    if backend == "factorized":
        cfg = GCNConfig(**common, gather_dtype=gather_dtype)
        return HighwayGCN(cfg, x_graph, ds.factorized_adjacency(), device=device, seed=seed)
    cfg = GCNConfig(**common, spmm_backend=backend)
    return HighwayGCN(cfg, x_graph, adj_graph, device=device, seed=seed)


def phase_card_vs_cpu(ds, path: str) -> None:
    import torch

    print(f"== phase 4: card against CPU at full width (main path {path}, dropout 0)")
    bf16 = MAIN_PATHS[path][3] == "bfloat16" or path in MODEL_INPUT
    loss_rtol = CARD_CPU_BF16_LOSS_RTOL if bf16 else CARD_CPU_LOSS_RTOL
    rel_tol = CARD_CPU_BF16_REL_TOL if bf16 else CARD_CPU_REL_TOL
    y = torch.as_tensor(ds.y, dtype=torch.int64)
    mask = torch.zeros(ds.n_nodes)
    mask[torch.as_tensor(ds.train_idx)] = 1.0
    results = {}
    state = None
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        net = build_model(path, ds, dev, dropout=0.0, seed=3)
        if state is None:
            state = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
        net.load_state_dict(state)
        logits = net.apply(train=False).detach()
        loss = net.loss(y.to(dev), mask.to(dev), train=True)
        loss.backward()
        print(f"  {dev}: model built, forward, loss and backward in {time.perf_counter() - t0!r} s")
        results[dev] = {
            "operand": getattr(net, "backend", None) or type(net.arrays["att"]).__name__,
            "logits": logits.cpu(),
            "loss": float(loss.detach()),
            "grads": {k: p.grad.detach().cpu() for k, p in net.named_parameters()},
        }
    gpu, cpu = results[DEVICE], results["cpu"]
    print(f"  operand {gpu['operand']} (cuda) / {cpu['operand']} (cpu); "
          f"loss {gpu['loss']!r} (cuda) vs {cpu['loss']!r} (cpu)")
    if abs(gpu["loss"] - cpu["loss"]) > loss_rtol * abs(cpu["loss"]):
        raise AssertionError("loss differs between card and CPU")
    check_close("logits", gpu["logits"], cpu["logits"], rel_tol)
    for k in cpu["grads"]:
        check_close(f"grad {k}", gpu["grads"][k], cpu["grads"][k], rel_tol)


def phase_remat(ds) -> None:
    """The ``hybrid`` GCN with remat against the one without, on the card,
    one training step each from the same parameters and the same dropout
    draws (the preset's dropout 0.5): loss and every gradient within
    CARD_CPU_REL_TOL, and kernel 1 launched 6 times in the remat step (the
    recompute re-runs the 2 conv forwards) against 4."""
    import torch

    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.utils import cuda_build

    print("== phase 4: remat against no remat (gcn, on the card, dropout 0.5)")
    y = torch.as_tensor(ds.y, dtype=torch.int64, device=DEVICE)
    mask = torch.zeros(ds.n_nodes, device=DEVICE)
    mask[torch.as_tensor(ds.train_idx, device=DEVICE)] = 1.0
    results, state = {}, None
    for remat in (False, True):
        net = build_model("gcn", ds, DEVICE, dropout=PRESETS["geotext"]["dropout"], seed=3,
                          remat=remat)
        if state is None:
            state = {k: v.detach().clone() for k, v in net.state_dict().items()}
        net.load_state_dict(state)
        gen = torch.Generator(device=DEVICE).manual_seed(17)
        cuda_build.reset_launch_counts()
        loss = net.loss(y, mask, train=True, x_seed=4321, generator=gen)
        loss.backward()
        launches = cuda_build.launch_counts["bsr_flat_matmul"]
        print(f"  remat {remat}: loss {float(loss.detach())!r}, bsr_flat_matmul launches {launches}")
        if launches != REMAT_STEP_LAUNCHES[remat]:
            raise AssertionError(f"remat {remat}: {launches} launches, not {REMAT_STEP_LAUNCHES[remat]}")
        results[remat] = (loss.detach(), {k: p.grad.detach() for k, p in net.named_parameters()})
    (l0, g0), (l1, g1) = results[False], results[True]
    check_close("loss", l1.reshape(1), l0.reshape(1), CARD_CPU_REL_TOL)
    for k in g0:
        check_close(f"grad {k}", g1[k], g0[k], CARD_CPU_REL_TOL)


def sampled_trainer(ds, device, *, dropout: float, hidden=None, seed: int = 0, mesh=None):
    """The sampled path's trainer on ``device``, as ``cli.py --preset
    geotext --sampled`` builds it (hidden ``hidden`` if given): the
    Highway-GCN on the materialized adjacency, the native sampler at
    SAMPLED_BATCH and SAMPLED_FANOUTS, the preset's learning rate. Given a
    ``mesh``, the data-parallel trainer of ``--sampled --dist`` on it
    (SAMPLED_BATCH // world size targets a rank, on the rank's device)."""
    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.data.sampling import NeighborSampler
    from graphconvgeo_torch.models.gcn import GCNConfig, HighwayGCN
    from graphconvgeo_torch.parallel.sampled_dist import DistSampledTrainer
    from graphconvgeo_torch.sparse.formats import SparseGraph
    from graphconvgeo_torch.train.trainer import TrainConfig
    from graphconvgeo_torch.train.trainer_sampled import SampledTrainer

    pre = PRESETS["geotext"]
    cfg = GCNConfig(n_features=ds.x.shape[1], n_classes=ds.n_classes,
                    hidden=hidden or pre["hidden"], dropout=dropout, l2=pre["l2"])
    world = 1 if mesh is None else mesh.world_size
    model = HighwayGCN(cfg, SparseGraph(csr=ds.x), SparseGraph(csr=ds.adj, symmetric=True),
                       device=device if mesh is None else mesh.device, seed=seed)
    sampler = NeighborSampler(ds.adj, fanouts=SAMPLED_FANOUTS, batch_size=SAMPLED_BATCH // world,
                              seed=seed)
    tcfg = TrainConfig(learning_rate=pre["lr"], verbose=False)
    if mesh is None:
        return SampledTrainer(model, sampler, tcfg)
    return DistSampledTrainer(model, sampler, mesh, tcfg)


def sampled_timings(ds) -> dict:
    """The sampled path's costs at GeoText (printed, not asserted): the
    sampler's host ms per batch over one epoch, on the native and on the
    numpy path; one training step's device ms (SAMPLED_STEPS steps, each
    held behind a device sleep, CUDA events) and its wall ms; the peak
    CUDA memory of a step above what the model and operands hold."""
    import statistics

    import numpy as np
    import torch

    from graphconvgeo_torch.data.sampling import NeighborSampler

    print(f"  sampled path's costs ({card_line()}):")
    out = {}
    for native in (True, False):
        sampler = NeighborSampler(ds.adj, fanouts=SAMPLED_FANOUTS, batch_size=SAMPLED_BATCH,
                                  seed=0, use_native=native)
        sampler.sample(ds.train_idx[:SAMPLED_BATCH])  # the native library builds here
        t0 = time.perf_counter()
        batches = list(sampler.epoch(ds.train_idx))
        ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        out["native" if native else "numpy"] = ms
        print(f"    sampler ({'native' if native else 'numpy'} path): {ms!r} ms per batch over "
              f"{len(batches)} batches (host)")
    caps = tuple(len(n) for n in batches[0].nodes)
    if caps != SAMPLED_CAPS:
        raise AssertionError(f"layer node sets of {caps} slots, not {SAMPLED_CAPS}")
    trainer = sampled_trainer(ds, DEVICE, dropout=0.5)
    y = torch.as_tensor(np.asarray(ds.y), dtype=torch.int64, device=DEVICE)
    trainer.train_step(batches[0], y)  # warm-up: the capped ELL, cuBLAS, the allocator
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train_step(batches[1], y)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    syncs = step_syncs(trainer, batches[2], y)
    it = iter(batches[2:] * SAMPLED_STEPS)
    times, held = held_call_ms(lambda: trainer.train_step(next(it), y), SAMPLED_STEPS)
    out.update(step_ms=statistics.median(times), step_wall_ms=wall_ms,
               step_peak_bytes=peak - resident)
    x_ell = trainer.x_ell
    print(f"    layer node sets {caps}; X capped at {x_ell.main.k} tokens a row "
          f"(overflow rows {0 if x_ell.ov is None else x_ell.ov.n_rows - 1})\n"
          f"    step: device {sorted(times)!r} ms ({held} of {SAMPLED_STEPS} held), median "
          f"{out['step_ms']!r}; one step's wall {wall_ms!r} ms; peak CUDA memory "
          f"{peak} bytes, {peak - resident} above the resident {resident}\n"
          f"    synchronizing CUDA operations in one step: {sum(syncs.values())} {syncs}")
    out.update(time_input_bag(trainer, batches[0]), step_syncs=sum(syncs.values()))
    return out


def step_syncs(trainer, batch, y) -> dict:
    """The synchronizing CUDA operations one training step makes (each one
    stalls the host until the card has caught up), counted by
    ``torch.cuda.set_sync_debug_mode("warn")``, by the line that made them."""
    import collections
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train_step(batch, y)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return dict(collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                                    if "synchroniz" in str(w.message)))


def time_input_bag(trainer, batch) -> dict:
    """The sampled input layer's embedding bag, forward + backward into
    dW0, on one batch's deepest node set: the ELL's padding slots left at
    row 0 against spread over W0's rows (models/sampled.py ::
    spread_slots), timed in turns (row 0, spread, spread, row 0) over
    ALT_ROUNDS rounds with cuda_ms; both give the same dW0."""
    import statistics

    import torch
    import torch.nn.functional as F

    from graphconvgeo_torch.models.sampled import batch_to_device, spread_slots

    deep = batch_to_device(batch, DEVICE)["nodes"][-1]
    main = trainer.x_ell.main
    xi, xv = main.indices[deep], main.values[deep]
    w0 = trainer.model.input.w.detach().clone().requires_grad_(True)
    idx = {"row 0": xi, "spread": torch.where(xv != 0, xi, spread_slots(xi, w0.shape[0]))}
    g = torch.randn(xi.shape[0], w0.shape[1], device=DEVICE)

    def bag(which):
        w0.grad = None
        F.embedding_bag(idx[which], w0, mode="sum", per_sample_weights=xv).backward(g)
        return w0.grad

    check_close("bag dW0, spread against row 0", bag("spread"), bag("row 0"), KERNEL_REL_TOL)
    runs = {"row 0": [], "spread": []}
    for _ in range(ALT_ROUNDS):
        for which in ("row 0", "spread", "spread", "row 0"):
            runs[which].append(cuda_ms(lambda: bag(which)))
    med = {k: statistics.median(v) for k, v in runs.items()}
    pad = int((xv == 0).sum())
    print(f"    input bag fwd + bwd ({xi.shape[0]} x {xi.shape[1]} slots, {pad} padding), in "
          f"turns: padding at row 0 {runs['row 0']!r} ms, spread {runs['spread']!r} ms; "
          f"medians {med['row 0']!r} / {med['spread']!r}")
    return {"bag_row0_ms": med["row 0"], "bag_spread_ms": med["spread"]}


def phase_card_vs_cpu_sampled(ds, hidden: int) -> None:
    """One sampled forward, loss and gradient on the same SampledBatch
    (SAMPLED_BATCH targets, SAMPLED_FANOUTS) from the same parameters, on
    the card and on the CPU, at hidden ``hidden``-``hidden``, dropout 0.
    ``index_add`` sums in the card's atomic order, so the limits are
    CARD_CPU_*, not bit equality."""
    import numpy as np
    import torch

    from graphconvgeo_torch.models.sampled import batch_to_device, sampled_forward, sampled_loss

    print(f"== phase 4: card against CPU, the sampled path at hidden {hidden}-{hidden} "
          f"(batch {SAMPLED_BATCH}, fanouts {SAMPLED_FANOUTS}, dropout 0)")
    batch = None
    results, state = {}, None
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        trainer = sampled_trainer(ds, dev, dropout=0.0, hidden=(hidden, hidden), seed=3)
        if batch is None:
            batch = trainer.sampler.sample(ds.train_idx[:SAMPLED_BATCH])
            state = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
        net = trainer.model
        net.load_state_dict(state)
        bd = batch_to_device(batch, dev)
        y = torch.as_tensor(np.asarray(ds.y), dtype=torch.int64, device=dev)[bd["nodes"][0]]
        with torch.no_grad():
            logits = sampled_forward(net, trainer.x_ell, bd)
        loss = sampled_loss(net, trainer.x_ell, bd, y, bd["target_mask"])
        loss.backward()
        print(f"  {dev}: model built, forward, loss and backward in {time.perf_counter() - t0!r} s")
        results[dev] = {
            "logits": logits.cpu(),
            "loss": float(loss.detach()),
            "grads": {k: p.grad.detach().cpu() for k, p in net.named_parameters()},
        }
    gpu, cpu = results[DEVICE], results["cpu"]
    print(f"  loss {gpu['loss']!r} (cuda) vs {cpu['loss']!r} (cpu)")
    if abs(gpu["loss"] - cpu["loss"]) > CARD_CPU_LOSS_RTOL * abs(cpu["loss"]):
        raise AssertionError("sampled loss differs between card and CPU")
    check_close("logits", gpu["logits"], cpu["logits"], CARD_CPU_REL_TOL)
    for k in cpu["grads"]:
        check_close(f"grad {k}", gpu["grads"][k], cpu["grads"][k], CARD_CPU_REL_TOL)


def time_input_layer(ds) -> dict:
    """X·W0 forward + backward at GeoText (width 300) on the bucketed gathers
    and on the slab (the default auto slab over the whole vocabulary in
    float32; 1,024 columns + a bucketed rest in float32 and in bf16),
    seconds per iteration by ``utils/timing.device_trial_seconds``."""
    import numpy as np
    import torch

    from graphconvgeo_torch.models.gcn import build_input_operands
    from graphconvgeo_torch.ops.spmm import spmm_bell, spmm_slabbed
    from graphconvgeo_torch.sparse.formats import SparseGraph, to_device
    from graphconvgeo_torch.utils.timing import device_trial_seconds

    print(f"== phase 2 (input layer): X·W0 forward + backward at GeoText, F {GEOTEXT_F} "
          f"({card_line()})")
    x = SparseGraph(csr=ds.x)
    variants = {
        "bell": dict(input_backend="bell"),
        "slab_f32_all": dict(input_backend="slab"),
        "slab_f32_1024": dict(input_backend="slab", slab_cols=SLAB_COLS),
        "slab_bf16_1024": dict(input_backend="slab", slab_cols=SLAB_COLS, slab_dtype="bfloat16"),
    }
    rng = np.random.default_rng(41)
    w0 = torch.tensor(rng.normal(size=(ds.x.shape[1], GEOTEXT_F)).astype(np.float32), device=DEVICE)
    g = torch.tensor(rng.normal(size=(ds.n_nodes, GEOTEXT_F)).astype(np.float32), device=DEVICE)
    out = {}
    for name, kw in variants.items():
        ops = {k: to_device(v, DEVICE) for k, v in build_input_operands(x, **kw).items()}
        op = ops["x"]
        if name == "bell":
            product = lambda w, op=op, op_t=ops["x_t"]: spmm_bell(op, op_t, w)
        else:
            product = lambda w, op=op: spmm_slabbed(op, w)

        def step(w, product=product):
            w = w.detach().requires_grad_(True)
            (dw,) = torch.autograd.grad(product(w)[: ds.n_nodes], w, g)
            return dw.detach()

        secs = device_trial_seconds(step, w0, **INPUT_TIMING)
        ms = sorted(1e3 * t for t in secs)
        shape = (f"slab {tuple(op.slab.shape)} {op.slab.dtype}, rest "
                 f"{type(op.rest).__name__ if op.rest is not None else None}"
                 if name != "bell" else f"{ds.x.nnz} nonzeros")
        print(f"  {name} ({shape}): {ms!r} ms per fwd + bwd (median {ms[len(ms) // 2]!r})")
        out[name] = ms[len(ms) // 2]
    return out


def phase_profile(ds, path: str, epochs: int = 5) -> None:
    """Where one main-path epoch's time goes (geotext preset, on the card):
    the wall time of ``epochs`` epochs (train step + predict + geo_eval),
    then the same epochs under torch.profiler — device busy time per epoch
    and the kernels that take it."""
    import torch

    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.train.evaluate import geo_eval
    from graphconvgeo_torch.train.trainer import TrainConfig, Trainer

    print(f"== profile: one epoch of the main path {path} (geotext preset)")
    pre = PRESETS["geotext"]
    net = build_model(path, ds, DEVICE, dropout=pre["dropout"], seed=0)
    trainer = Trainer(net, TrainConfig(learning_rate=pre["lr"], verbose=False))
    y = torch.as_tensor(ds.y, dtype=torch.int64, device=DEVICE)
    mask = torch.zeros(ds.n_nodes, device=DEVICE)
    mask[torch.as_tensor(ds.train_idx, device=DEVICE)] = 1.0
    dev_idx = ds.dev_idx

    def epoch():
        trainer.train_step(y, mask)
        pred = trainer.predict()
        geo_eval(pred[dev_idx], ds.lat[dev_idx], ds.lon[dev_idx],
                 ds.class_lat_median, ds.class_lon_median)

    device_breakdown(epoch, epochs, "epoch")


def phase_profile_sampled(ds, epochs: int = 5) -> None:
    """Where one sampled epoch's time goes (geotext preset, batch 512,
    fanouts 10 10, on the card): the steps over the training rows, sampled
    in the background thread, then the full-graph dev evaluation and
    geo_eval; then the sampler's and a step's costs."""
    import numpy as np
    import torch

    from graphconvgeo_torch.train.evaluate import geo_eval

    print(f"== profile: one epoch of the main path {SAMPLED_PATH} (geotext preset)")
    trainer = sampled_trainer(ds, DEVICE, dropout=0.5)
    y = torch.as_tensor(np.asarray(ds.y), dtype=torch.int64, device=DEVICE)
    dev_idx = ds.dev_idx

    def epoch():
        trainer.train_epoch(ds.train_idx, y)
        pred = trainer._predict_rows(dev_idx)
        geo_eval(pred, ds.lat[dev_idx], ds.lon[dev_idx], ds.class_lat_median,
                 ds.class_lon_median)

    device_breakdown(epoch, epochs, "epoch")
    sampled_timings(ds)


def device_breakdown(fn, reps: int, unit: str) -> dict:
    """The wall time of ``reps`` calls of ``fn`` after 3 warm-up calls, then
    the same calls under torch.profiler: device busy time per call, the idle
    share, and the 15 kernels that take most of it (returned: the wall and
    busy ms and the idle share per call). The named ranges on the
    device timeline (the models' ``input_layer``, ``conv_<i>``, ...,
    ``Optimizer.step``) are spans over kernels, not kernels: they are
    printed apart and left out of the busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) / reps * 1e3
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ranges = [e for e in device if getattr(e, "is_user_annotation", False)]
    kernels = [e for e in device if not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    print(f"  {unit} wall {wall_ms!r} ms (under the profiler {prof_wall_ms!r} ms); "
          f"device busy {busy_ms!r} ms per {unit} = {busy_ms / wall_ms!r} of the "
          f"unprofiled wall, idle share {1 - busy_ms / wall_ms!r}")
    spans = ", ".join(f"{e.key} {e.device_time_total / 1e3 / reps:.4f}" for e in ranges)
    print(f"  device spans of the named ranges, ms per {unit}: {spans or 'none'}")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:15]:
        ms = e.self_device_time_total / 1e3 / reps
        print(f"  {ms:10.4f} ms/{unit} {ms / busy_ms:7.2%} x{e.count // reps:<4d} {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms}


def profile_factorized_262k(steps: int = 5) -> None:
    """Where the factorized operator's forward + backward spends the device
    at 262,144 x 512, in float32 and in bf16 (gathers and contraction)."""
    import numpy as np
    import torch

    from graphconvgeo_torch.sparse.factorized import spmm_factorized
    from graphconvgeo_torch.sparse.formats import to_device

    fa, _ = projection_262k()
    fa = to_device(fa, DEVICE)
    rng = np.random.default_rng(34)
    f = FACTORIZED_262K["f"]
    h = torch.tensor(rng.normal(size=(fa.n_rows, f)).astype(np.float32), device=DEVICE)
    g = torch.tensor(rng.normal(size=(fa.n_rows, f)).astype(np.float32), device=DEVICE)
    for label, dt in (("float32", None), ("bf16", torch.bfloat16)):
        print(f"== profile: the factorized operator's fwd + bwd at 262k x {f}, {label}")

        def step():
            x = h.detach().requires_grad_(True)
            spmm_factorized(fa, x, gather_dtype=dt, mxu_dtype=dt).backward(g)

        device_breakdown(step, steps, "step")


def dist_model(ds, mesh, *, dropout: float, seed: int):
    """The geotext preset's DistHighwayGCN on ``mesh``: the partition the
    CLI builds (the whole-vocabulary slab) but aligned to 256 rows, the
    halo on, kernel 1 on the rank's local tiles."""
    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.models.gcn import GCNConfig
    from graphconvgeo_torch.parallel.model_dist import DistHighwayGCN
    from graphconvgeo_torch.parallel.partition import partition_dataset

    pre = PRESETS["geotext"]
    cfg = GCNConfig(n_features=ds.x.shape[1], n_classes=ds.n_classes, hidden=pre["hidden"],
                    dropout=dropout, l2=pre["l2"])
    part = partition_dataset(ds, mesh.world_size, row_align=DIST_ROW_ALIGN,
                             slab_cols=cfg.slab_cols, slab_byte_budget=cfg.slab_byte_budget)
    return DistHighwayGCN(cfg, part, mesh, halo="on", local_backend="bsr", seed=seed)


def dist_grads(net) -> tuple:
    """(loss, logits, gradients) of a DistHighwayGCN at dropout 0 (its
    loss_and_backward: the rank's share, one all-reduce)."""
    net.zero_grad(set_to_none=True)
    logits = net.apply(train=False).detach()
    loss = net.loss_and_backward(train=False)
    return float(loss), logits, {k: p.grad.detach().clone() for k, p in net.named_parameters()}


def phase_dist_model(ds) -> dict:
    """(a) DistHighwayGCN at world size 1 on NCCL, kernel 1 on the rank's
    local tiles: the tiles are the hybrid path's; its loss and gradients at
    dropout 0 hold against the single-device hybrid HighwayGCN on the same
    parameters; 30 epochs through DistTrainer make 6 kernel-1 launches each
    and reach MIN_DEV_ACC; then one epoch's device breakdown."""
    import torch
    import torch.distributed as dist

    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.parallel.mesh import make_graph_mesh
    from graphconvgeo_torch.parallel.trainer_dist import DistTrainer
    from graphconvgeo_torch.train.evaluate import geo_eval
    from graphconvgeo_torch.train.trainer import TrainConfig
    from graphconvgeo_torch.utils import cuda_build

    print(f"== phase 3: the main path {DIST_PATH} (parallel/: DistHighwayGCN at world size 1, "
          "halo on, kernel 1 on the rank's local tiles)")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the float32 comparisons")
    mesh = make_graph_mesh(DEVICE)
    backend = dist.get_backend()
    print(f"  process group: {backend}, world size {mesh.world_size}, rank {mesh.rank}, "
          f"device {mesh.device}")
    if (backend, mesh.world_size) != ("nccl", 1):
        raise AssertionError(f"the card's mesh is {backend} with {mesh.world_size} ranks, "
                             "not NCCL with 1")
    pre = PRESETS["geotext"]
    t0 = time.perf_counter()
    net = dist_model(ds, mesh, dropout=pre["dropout"], seed=3)
    build_s = time.perf_counter() - t0
    part, bsr = net.part, net.data.get("bsr")
    ref = build_model("gcn", ds, DEVICE, dropout=0.0, seed=3)
    hybrid = ref.arrays["adj"][0]
    print(f"  partition + halo plan + operands in {build_s!r} s: rows per rank "
          f"{part.rows_per_device}, local backend {net.local_backend}, slab "
          f"{tuple(net.data['x_slab'].shape) if 'x_slab' in net.data else None}, local tiles {bsr.n_tiles if bsr else 0} "
          f"(hybrid {hybrid.n_tiles}), packed nonzeros {bsr.packed.nnz if bsr else 0} "
          f"(hybrid {hybrid.packed.nnz})")
    if (part.rows_per_device, net.local_backend) != (DIST_RPD["model"], "bsr"):
        raise AssertionError(f"rows per rank {part.rows_per_device}, local backend "
                             f"{net.local_backend}: not {DIST_RPD['model']} on bsr")
    for name in ("tiles", "rowblk", "colblk"):
        if not torch.equal(getattr(bsr, name), getattr(hybrid, name)):
            raise AssertionError(f"the rank's local tiles' {name} differ from the hybrid path's")

    print("  loss and gradients at dropout 0 against the single-device hybrid HighwayGCN")
    net.load_state_dict(ref.state_dict())
    y = torch.as_tensor(ds.y, dtype=torch.int64, device=DEVICE)
    mask = torch.zeros(ds.n_nodes, device=DEVICE)
    mask[torch.as_tensor(ds.train_idx, device=DEVICE)] = 1.0
    ref_loss = ref.loss(y, mask, train=False)
    ref_loss.backward()
    loss, logits, grads = dist_grads(net)
    ref_loss = float(ref_loss.detach())
    print(f"  loss {loss!r} (dist) vs {ref_loss!r} (single device)")
    if abs(loss - ref_loss) > CARD_CPU_LOSS_RTOL * abs(ref_loss):
        raise AssertionError("the distributed loss differs from the single-device loss")
    check_close("logits", logits[: ds.n_nodes], ref.apply(train=False).detach(), CARD_CPU_REL_TOL)
    for k, p in ref.named_parameters():
        check_close(f"grad {k}", grads[k], p.grad, CARD_CPU_REL_TOL)
    card = {"state": {k: v.detach().cpu().clone() for k, v in net.state_dict().items()},
            "loss": loss, "logits": logits.cpu(), "grads": {k: g.cpu() for k, g in grads.items()}}
    del ref

    trainer = DistTrainer(net, TrainConfig(learning_rate=pre["lr"], epochs=EPOCHS,
                                           patience=EPOCHS, verbose=False))
    geo = dict(lat=ds.lat, lon=ds.lon, class_lat_median=ds.class_lat_median,
               class_lon_median=ds.class_lon_median)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.fit(ds.dev_idx, **geo)
    dev = trainer.evaluate(None, ds.dev_idx, **geo)
    test = trainer.evaluate(None, ds.test_idx, **geo)
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.launch_counts)
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    secs = [h["seconds"] for h in hist]
    per_epoch = [b - a for a, b in zip([0.0] + secs[:-1], secs)]
    in_training = {k: sum(h["launches"][k] for h in hist) for k in launches}
    print(f"  epochs {len(hist)}, loss {losses[0]!r} -> {losses[-1]!r}, dev Acc@161 "
          f"{dev['acc_at_161']!r}, test Acc@161 {test['acc_at_161']!r} (best epoch "
          f"{out['best_epoch']})\n"
          f"  seconds per epoch (step + predict + geo_eval): first {per_epoch[0]!r}, median of "
          f"the rest {sorted(per_epoch[1:])[len(per_epoch[1:]) // 2]!r}; fit + evaluation "
          f"{wall!r} s ({card_line()})\n"
          f"  launches {launches}: in the {len(hist)} training epochs {in_training}")
    if not losses[-1] < LOSS_DROP * losses[0]:
        raise AssertionError(f"loss {losses[0]} -> {losses[-1]} did not halve")
    if not dev["acc_at_161"] >= MIN_DEV_ACC:
        raise AssertionError(f"dev Acc@161 {dev['acc_at_161']} < {MIN_DEV_ACC}")
    for name, per in DIST_LAUNCHES_PER_EPOCH.items():
        counts = [h["launches"][name] for h in hist]
        if any(c != per for c in counts):
            raise AssertionError(f"{name}: launches per epoch {counts}, expected {per} each")
    if launches != {k: v * len(hist) + (4 if v else 0)
                    for k, v in DIST_LAUNCHES_PER_EPOCH.items()}:
        raise AssertionError(f"launches {launches}: not {DIST_LAUNCHES_PER_EPOCH} an epoch + 4")
    profile_dist_epochs(trainer, ds)
    return {"launches": launches, "in_training": in_training, "epochs": len(hist),
            "per_epoch_s": per_epoch, "card": card}


def profile_dist(ds) -> None:
    """``--profile``: (a)'s and (e)'s DistTrainer epochs at the preset's
    dropout."""
    import torch.distributed as dist

    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.parallel.mesh import make_graph_mesh
    from graphconvgeo_torch.parallel.trainer_dist import DistTrainer
    from graphconvgeo_torch.train.trainer import TrainConfig

    try:
        pre = PRESETS["geotext"]
        mesh = make_graph_mesh(DEVICE)
        for path, build in ((DIST_PATH, dist_model), (GAT_DIST_PATH, gat_dist_model)):
            print(f"== profile: one epoch of the main path {path} (geotext preset)")
            net = build(ds, mesh, dropout=pre["dropout"], seed=0)
            profile_dist_epochs(DistTrainer(net, TrainConfig(learning_rate=pre["lr"],
                                                             verbose=False)), ds, path)
    finally:
        dist.destroy_process_group()


def profile_dist_epochs(trainer, ds, path: str = DIST_PATH,
                        epochs: int = DIST_PROFILE_EPOCHS) -> None:
    """One DistTrainer epoch's device breakdown (step + predict + geo_eval)."""
    from graphconvgeo_torch.train.evaluate import geo_eval

    def epoch():
        trainer.train_step()
        pred = trainer.predict()
        geo_eval(pred[ds.dev_idx], ds.lat[ds.dev_idx], ds.lon[ds.dev_idx],
                 ds.class_lat_median, ds.class_lon_median)

    print(f"  one epoch of {path}, {epochs} epochs profiled ({card_line()}):")
    device_breakdown(epoch, epochs, "epoch")


def phase_dist_card_vs_cpu(ds, trained: dict) -> None:
    """(d) (a)'s model on the card against the same model on the CPU (a
    gloo group of the one rank, kernel 1's plain version): logits, loss and
    every gradient at dropout 0 from (a)'s parameters before training, which
    (a) took on the card."""
    import torch.distributed as dist

    from graphconvgeo_torch.parallel.mesh import make_graph_mesh

    print(f"== phase 4: card against CPU at full width (main path {DIST_PATH}, dropout 0)")
    card = trained["card"]
    t0 = time.perf_counter()
    net = dist_model(ds, make_graph_mesh("cpu", group=dist.new_group([0], backend="gloo")),
                     dropout=0.0, seed=3)
    net.load_state_dict(card["state"])
    loss, logits, grads = dist_grads(net)
    print(f"  cpu: model built, forward, loss and backward in {time.perf_counter() - t0!r} s; "
          f"loss {card['loss']!r} (cuda) vs {loss!r} (cpu)")
    if abs(card["loss"] - loss) > CARD_CPU_LOSS_RTOL * abs(loss):
        raise AssertionError("loss differs between card and CPU")
    check_close("logits", card["logits"], logits, CARD_CPU_REL_TOL)
    for k in grads:
        check_close(f"grad {k}", card["grads"][k], grads[k], CARD_CPU_REL_TOL)


def dist_cli(data_dir: str, flags: list, *, ckpt=None) -> tuple:
    """``cli.main --dist`` with ``flags`` on the geotext preset at world size
    1 for EPOCHS epochs (saving its best parameters under ``ckpt`` if
    given): prints its record, its kernel launches and its epochs, checks
    that the loss halves and dev Acc@161 reaches MIN_DEV_ACC; returns
    (report, launches)."""
    from graphconvgeo_torch import cli
    from graphconvgeo_torch.utils import cuda_build

    argv = ["--preset", "geotext", "-d", data_dir, "--dist", *flags, "--epochs", str(EPOCHS),
            "--patience", str(EPOCHS), "--device", DEVICE, "--json", "--quiet"]
    if ckpt is not None:
        argv += ["--checkpoint-dir", ckpt]
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    report = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.launch_counts)
    run = report["run"]
    losses = [h["loss"] for h in run["history"]]
    secs = [h["seconds"] for h in run["history"]]
    per_epoch = sorted(b - a for a, b in zip(secs, secs[1:]))
    print(f"  --dist {' '.join(flags)}: world size {run['world_size']}, rows per rank "
          f"{run['rows_per_device']}, halo {run['halo']} ({run['halo_mode']}, "
          f"{run['dist_format']}), adjacency {run['adjacency']}, hub sharded "
          f"{run['hub_sharded']}, LOCAL BACKEND {run['backend']}, tiles {run['n_tiles']}: "
          f"kernel launches {sum(launches.values())} {launches}")
    print(f"  epochs {len(losses)}, loss {losses[0]!r} -> {losses[-1]!r}, dev Acc@161 "
          f"{report['dev']['acc_at_161']!r}, test Acc@161 {report['test']['acc_at_161']!r}; "
          f"seconds per epoch (step + predict + geo_eval), median after the first "
          f"{per_epoch[len(per_epoch) // 2]!r}; main() wall {wall!r} s ({card_line()})")
    if not losses[-1] < LOSS_DROP * losses[0]:
        raise AssertionError(f"loss {losses[0]} -> {losses[-1]} did not halve")
    if not report["dev"]["acc_at_161"] >= MIN_DEV_ACC:
        raise AssertionError(f"dev Acc@161 {report['dev']['acc_at_161']} < {MIN_DEV_ACC}")
    return report, launches


def dist_eval_only(data_dir: str, flags: list, trained: dict, expected: dict) -> None:
    """``--dist --eval-only`` with ``flags`` on ``trained["ckpt"]``: no
    training, the checkpoint untouched, the training run's dev and test
    metrics exactly, and the ``expected`` launches."""
    from graphconvgeo_torch import cli
    from graphconvgeo_torch.utils import cuda_build

    ckpt = trained["ckpt"]
    before = sorted(os.listdir(ckpt))
    cuda_build.reset_launch_counts()
    report = cli.main(["--preset", "geotext", "-d", data_dir, "--dist", *flags, "--device",
                       DEVICE, "--json", "--quiet", "--checkpoint-dir", ckpt, "--eval-only"])
    launches = dict(cuda_build.launch_counts)
    want = trained["report"]
    print(f"  dev {report['dev']}, test {report['test']} (trained: dev {want['dev']}, "
          f"test {want['test']}); launches {launches}")
    if report["run"]["history"]:
        raise AssertionError("--dist --eval-only trained")
    if (report["dev"], report["test"]) != (want["dev"], want["test"]):
        raise AssertionError("--dist --eval-only metrics differ from the training run's")
    if launches != expected:
        raise AssertionError(f"--dist --eval-only launched {launches}, expected {expected}")
    if sorted(os.listdir(ckpt)) != before:
        raise AssertionError("--dist --eval-only changed the checkpoint")


def phase_dist_cli(data_dir: str) -> dict:
    """(b) ``cli.main --dist`` at world size 1: the CLI's partition (row
    alignment 8, rows per rank 9,480) resolves the local backend to bell, so
    no kernel launches; it trains to MIN_DEV_ACC and saves its best
    parameters."""
    ckpt = checkpoint_dir(data_dir, DIST_PATH)
    print("== phase 3: cli.main --dist (geotext preset, world size 1, the CLI's partition)")
    report, launches = dist_cli(data_dir, [], ckpt=ckpt)
    run = report["run"]
    if (run["world_size"], run["rows_per_device"], run["backend"]) != (1, DIST_RPD["cli"], "bell"):
        raise AssertionError(f"--dist ran world {run['world_size']}, rows per rank "
                             f"{run['rows_per_device']}, backend {run['backend']}")
    if launches != DIST_NO_LAUNCHES:
        raise AssertionError(f"--dist launched {launches}, expected none")
    return {"report": report, "launches": launches, "ckpt": ckpt}


def phase_dist_eval_only(data_dir: str, trained: dict) -> None:
    """(c) ``--dist --eval-only`` on (b)'s checkpoint: no training, the
    checkpoint untouched, dev and test metrics equal to (b)'s, no launch."""
    print(f"== phase 3: --dist --eval-only on {DIST_PATH}'s checkpoint "
          f"({sorted(os.listdir(trained['ckpt']))})")
    dist_eval_only(data_dir, [], trained, DIST_NO_LAUNCHES)


def gat_dist_model(ds, mesh, *, dropout: float, seed: int):
    """The geotext preset's DistGAT on ``mesh`` with the tiled attention:
    the partition the CLI builds (row alignment 8, the whole-vocabulary
    slab), 4 heads of 75."""
    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.models.gat import GATConfig
    from graphconvgeo_torch.parallel.gat_dist import DistGAT
    from graphconvgeo_torch.parallel.partition import partition_dataset

    pre = PRESETS["geotext"]
    cfg = GATConfig(n_features=ds.x.shape[1], n_classes=ds.n_classes, hidden=pre["hidden"],
                    heads=GAT_HEADS, dropout=dropout, l2=pre["l2"], att_backend="tiled")
    part = partition_dataset(ds, mesh.world_size, slab_cols=cfg.slab_cols,
                             slab_byte_budget=cfg.slab_byte_budget)
    return DistGAT(cfg, part, mesh, "tiled", seed=seed)


def gat_dist_kernels(att, n_nodes: int) -> None:
    """Kernels 3-5 against their plain twins on the rank's extended
    pattern (more columns than rows), without and with attention dropout
    (edge ids over its n_rows x n_cols); its rows and columns with no edge
    (the padding rows, the unused halo slots) come out exactly neutral, and
    the whole tiled layer gives 0 there with a finite gradient."""
    import numpy as np
    import torch

    from graphconvgeo_torch.ops.attention_tiled import gat_attention_tiled

    edges, edges_t = att.edges, att.edges_t
    deg = torch.diff(edges.ptr.long())[: att.n_rows]
    deg_t = torch.diff(edges_t.ptr.long())[: att.n_cols]
    if att.rest is not None:  # rows and columns with a rest edge are not empty
        for idx, valid, rid in zip(att.rest.indices, att.rest.valid, att.rest.row_ids):
            deg.index_add_(0, rid, valid.sum(1).long())
            deg_t.index_add_(0, idx.reshape(-1), valid.reshape(-1).long())
    empty_rows = torch.nonzero(deg == 0).flatten()
    empty_cols = torch.nonzero(deg_t == 0).flatten()
    print(f"  rows with no edge {empty_rows.tolist()}, columns with no edge "
          f"{empty_cols.tolist()}")
    if not (len(empty_rows) >= att.n_rows - n_nodes > 0 and len(empty_cols) > 0):
        raise AssertionError("the extended pattern lacks its empty padding rows or halo columns")
    for rate, seed in ((0.0, 0), (ATTN_DROPOUT, 29)):
        z, a_src, a_dst, g = gat_inputs(att.n_cols, seed=31)
        compare_gat_kernels(f"  {GAT_DIST_PATH} extended pattern", att, (z, a_src, a_dst,
                            g[: att.n_rows]), rate=rate, seed=seed, empty_rows=empty_rows,
                            empty_cols=empty_cols)
    z = z.clone().requires_grad_(True)
    out = gat_attention_tiled(att, z, a_src, a_dst, negative_slope=GAT_SLOPE)
    (out * g[: att.n_rows]).sum().backward()
    if not (bool((out[empty_rows] == 0).all()) and bool(torch.isfinite(z.grad).all())):
        raise AssertionError("the tiled layer is not 0 on rows with no edge, or its gradient "
                             "is not finite")
    print(f"  the tiled layer: 0 on the {len(empty_rows)} rows with no edge, gradient finite "
          f"(max |dz| {float(np.abs(z.grad.cpu().numpy()).max())!r})")


def phase_gat_dist_model(ds) -> dict:
    """(e) DistGAT at world size 1 on NCCL with the tiled attention: the
    rank's extended pattern holds the single-device GAT's tiles and rest
    edges; kernels 3-5 against their plain twins on it; its loss, logits
    and gradients at dropout 0 against the single-device tiled
    GraphAttentionNet's; 30 epochs through DistTrainer with the single
    GAT's launches each, to MIN_DEV_ACC; one epoch's device breakdown."""
    import torch

    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.parallel.mesh import make_graph_mesh
    from graphconvgeo_torch.parallel.trainer_dist import DistTrainer
    from graphconvgeo_torch.train.trainer import TrainConfig
    from graphconvgeo_torch.utils import cuda_build

    print(f"== phase 3: the main path {GAT_DIST_PATH} (parallel/: DistGAT at world size 1, "
          "tiled attention, kernels 3-5 on the rank's extended pattern)")
    mesh = make_graph_mesh(DEVICE)
    pre = PRESETS["geotext"]
    t0 = time.perf_counter()
    net = gat_dist_model(ds, mesh, dropout=pre["dropout"], seed=3)
    build_s = time.perf_counter() - t0
    att, rpd = net.data["att"], net.part.rows_per_device
    ref = build_model("gat", ds, DEVICE, dropout=0.0, seed=3)
    st, ref_st = att.stats(), ref.arrays["att"].stats()
    print(f"  partition + halo plan + operands in {build_s!r} s: rows per rank {rpd} "
          f"({rpd - ds.n_nodes} padding rows), pattern {att.n_rows} x {att.n_cols} "
          f"({att.n_cols - rpd} halo columns), {att.n_row_blocks} row blocks x "
          f"{att.n_col_blocks} column blocks; tiles {st['n_tiles']}, tiled edges "
          f"{st['tiled_edges']}, rest edges {st['rest_edges']} (single-device gat: tiles "
          f"{ref_st['n_tiles']}, tiled edges {ref_st['tiled_edges']}, rest edges "
          f"{ref_st['rest_edges']})")
    if (rpd, att.n_cols - rpd) != (GAT_DIST_RPD, GAT_DIST_HALO_COLS):
        raise AssertionError(f"rows per rank {rpd}, halo columns {att.n_cols - rpd}")
    for k in ("n_tiles", "tiled_edges", "rest_edges"):
        if st[k] != ref_st[k]:
            raise AssertionError(f"the rank's pattern has {k} {st[k]}, the single GAT's {ref_st[k]}")
    gat_dist_kernels(att, ds.n_nodes)

    print("  loss and gradients at dropout 0 against the single-device tiled GraphAttentionNet")
    net.load_state_dict(ref.state_dict())
    y = torch.as_tensor(ds.y, dtype=torch.int64, device=DEVICE)
    mask = torch.zeros(ds.n_nodes, device=DEVICE)
    mask[torch.as_tensor(ds.train_idx, device=DEVICE)] = 1.0
    ref_loss = ref.loss(y, mask, train=False)
    ref_loss.backward()
    cuda_build.reset_launch_counts()
    loss, logits, grads = dist_grads(net)
    step_launches = dict(cuda_build.launch_counts)
    ref_loss = float(ref_loss.detach())
    print(f"  loss {loss!r} (dist) vs {ref_loss!r} (single device); the forward, loss and "
          f"backward launched {step_launches}")
    if abs(loss - ref_loss) > CARD_CPU_LOSS_RTOL * abs(ref_loss):
        raise AssertionError("the distributed GAT's loss differs from the single-device loss")
    check_close("logits", logits[: ds.n_nodes], ref.apply(train=False).detach(), CARD_CPU_REL_TOL)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("the padding rows' logits are not finite")
    for k, p in ref.named_parameters():
        check_close(f"grad {k}", grads[k], p.grad, CARD_CPU_REL_TOL)
    card = {"state": {k: v.detach().cpu().clone() for k, v in net.state_dict().items()},
            "loss": loss, "logits": logits.cpu(), "grads": {k: g.cpu() for k, g in grads.items()}}
    del ref

    trainer = DistTrainer(net, TrainConfig(learning_rate=pre["lr"], epochs=EPOCHS,
                                           patience=EPOCHS, verbose=False))
    geo = dict(lat=ds.lat, lon=ds.lon, class_lat_median=ds.class_lat_median,
               class_lon_median=ds.class_lon_median)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.fit(ds.dev_idx, **geo)
    dev = trainer.evaluate(None, ds.dev_idx, **geo)
    test = trainer.evaluate(None, ds.test_idx, **geo)
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.launch_counts)
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    secs = [h["seconds"] for h in hist]
    per_epoch = [b - a for a, b in zip([0.0] + secs[:-1], secs)]
    in_training = {k: sum(h["launches"][k] for h in hist) for k in launches}
    print(f"  epochs {len(hist)}, loss {losses[0]!r} -> {losses[-1]!r}, dev Acc@161 "
          f"{dev['acc_at_161']!r}, test Acc@161 {test['acc_at_161']!r} (best epoch "
          f"{out['best_epoch']})\n"
          f"  seconds per epoch (step + predict + geo_eval): first {per_epoch[0]!r}, median of "
          f"the rest {sorted(per_epoch[1:])[len(per_epoch[1:]) // 2]!r}; fit + evaluation "
          f"{wall!r} s ({card_line()})\n"
          f"  launches {launches}: in the {len(hist)} training epochs {in_training}")
    if not losses[-1] < LOSS_DROP * losses[0]:
        raise AssertionError(f"loss {losses[0]} -> {losses[-1]} did not halve")
    if not dev["acc_at_161"] >= MIN_DEV_ACC:
        raise AssertionError(f"dev Acc@161 {dev['acc_at_161']} < {MIN_DEV_ACC}")
    per = EXPECTED_LAUNCHES_PER_EPOCH["gat"]
    for name, n in per.items():
        counts = [h["launches"][name] for h in hist]
        if any(c != n for c in counts):
            raise AssertionError(f"{name}: launches per epoch {counts}, expected {n} each")
    want = {k: v * len(hist) + GAT_DIST_EVAL_LAUNCHES[k] for k, v in per.items()}
    if launches != want:
        raise AssertionError(f"launches {launches}: not {per} an epoch + {GAT_DIST_EVAL_LAUNCHES}")
    profile_dist_epochs(trainer, ds, GAT_DIST_PATH)
    return {"launches": launches, "in_training": in_training, "epochs": len(hist),
            "per_epoch_s": per_epoch, "card": card}


def phase_gat_dist_card_vs_cpu(ds, trained: dict) -> None:
    """(f) (e)'s model on the card against the same model on the CPU (a
    gloo group of the one rank, kernels 3-5's plain twins): logits, loss and
    every gradient at dropout 0 from (e)'s parameters before training."""
    import torch.distributed as dist

    from graphconvgeo_torch.parallel.mesh import make_graph_mesh

    print(f"== phase 4: card against CPU at full width (main path {GAT_DIST_PATH}, dropout 0)")
    card = trained["card"]
    t0 = time.perf_counter()
    net = gat_dist_model(ds, make_graph_mesh("cpu", group=dist.new_group([0], backend="gloo")),
                         dropout=0.0, seed=3)
    net.load_state_dict(card["state"])
    loss, logits, grads = dist_grads(net)
    print(f"  cpu: model built, forward, loss and backward in {time.perf_counter() - t0!r} s; "
          f"loss {card['loss']!r} (cuda) vs {loss!r} (cpu)")
    if abs(card["loss"] - loss) > CARD_CPU_LOSS_RTOL * abs(loss):
        raise AssertionError("loss differs between card and CPU")
    check_close("logits", card["logits"], logits, CARD_CPU_REL_TOL)
    for k in grads:
        check_close(f"grad {k}", card["grads"][k], grads[k], CARD_CPU_REL_TOL)


def phase_gat_dist_cli(data_dir: str) -> dict:
    """(g) ``cli.main --dist --model gat --att-backend tiled`` at world size
    1: the CLI's partition (9,480 rows), the single GAT's tiles on the
    rank's extended pattern, kernels 3-5 launched as the single GAT's each
    epoch + 4 forwards after training; best parameters saved."""
    ckpt = checkpoint_dir(data_dir, GAT_DIST_PATH)
    print(f"== phase 3: cli.main --dist {' '.join(GAT_DIST_FLAGS)} (geotext preset, world size 1)")
    report, launches = dist_cli(data_dir, GAT_DIST_FLAGS, ckpt=ckpt)
    run = report["run"]
    print(f"  the rank's pattern: {run['n_tiles']} tiles, {run['tiled_edges']} tiled edges, "
          f"{run['rest_edges']} rest edges")
    if (run["world_size"], run["rows_per_device"], run["n_tiles"]) != (
            1, GAT_DIST_RPD, GAT_GEOTEXT_TILES):
        raise AssertionError(f"--dist --model gat ran world {run['world_size']}, rows per rank "
                             f"{run['rows_per_device']}, {run['n_tiles']} tiles")
    per = EXPECTED_LAUNCHES_PER_EPOCH["gat"]
    for name, n in per.items():
        counts = [h["launches"][name] for h in run["history"]]
        if any(c != n for c in counts):
            raise AssertionError(f"{name}: launches per epoch {counts}, expected {n} each")
    want = {k: v * len(run["history"]) + GAT_DIST_EVAL_LAUNCHES[k] for k, v in per.items()}
    if launches != want:
        raise AssertionError(f"--dist --model gat launched {launches}, expected {want}")
    return {"report": report, "launches": launches, "ckpt": ckpt}


def phase_gat_dist_eval_only(data_dir: str, trained: dict) -> None:
    """(h) ``--dist --model gat --att-backend tiled --eval-only`` on (g)'s
    checkpoint: (g)'s metrics exactly, 4 forward sweeps."""
    print(f"== phase 3: --dist {' '.join(GAT_DIST_FLAGS)} --eval-only on (g)'s checkpoint "
          f"({sorted(os.listdir(trained['ckpt']))})")
    dist_eval_only(data_dir, GAT_DIST_FLAGS, trained, GAT_DIST_EVAL_LAUNCHES)


def phase_factorized_dist_cli(data_dir: str) -> None:
    """(i) ``cli.main --dist --adjacency factorized``, without and with
    ``--hub-sharded``, at world size 1: the bell local products launch no
    kernel; both train to MIN_DEV_ACC, and the one-rank ring computes what
    the all-reduce does, so the two runs' losses and metrics are equal."""
    reports = {}
    for hub in (False, True):
        flags = ["--adjacency", "factorized"] + (["--hub-sharded"] if hub else [])
        print(f"== phase 3: cli.main --dist {' '.join(flags)} (geotext preset, world size 1)")
        report, launches = dist_cli(data_dir, flags)
        run = report["run"]
        print(f"  {FACTORIZED_DIST_PATH}: the bell local products launch no kernel "
              f"({sum(launches.values())} launches)")
        if (run["adjacency"], run["hub_sharded"]) != ("factorized", hub):
            raise AssertionError(f"ran adjacency {run['adjacency']}, hub sharded "
                                 f"{run['hub_sharded']}")
        if launches != DIST_NO_LAUNCHES:
            raise AssertionError(f"--dist --adjacency factorized launched {launches}")
        reports[hub] = report
    rep, hub = reports[False], reports[True]
    loss_rep = [h["loss"] for h in rep["run"]["history"]]
    loss_hub = [h["loss"] for h in hub["run"]["history"]]
    print(f"  --hub-sharded against the all-reduce: losses equal {loss_hub == loss_rep}, dev "
          f"{hub['dev']} vs {rep['dev']}, test {hub['test']} vs {rep['test']}")
    if (hub["dev"], hub["test"]) != (rep["dev"], rep["test"]):
        raise AssertionError("--hub-sharded's metrics differ from the all-reduce path's")


def phase_sampled_dist_step(ds) -> None:
    """(j) DistSampledTrainer at world size 1 on NCCL against SampledTrainer
    from the same parameters at dropout 0: one step's loss and every
    gradient on the same sub-batch (the first of an epoch, as the rank
    draws it: at world size 1 the sampler's own batch), within
    SAMPLED_DIST_LOSS_RTOL; then SAMPLED_DIST_PROFILE_EPOCHS epochs' device
    breakdown at the preset's dropout."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.models.sampled import batch_to_device, sampled_loss
    from graphconvgeo_torch.parallel.mesh import make_graph_mesh
    from graphconvgeo_torch.parallel.model_dist import sum_gradients
    from graphconvgeo_torch.parallel.sampled_dist import dist_sampled_loss
    from graphconvgeo_torch.train.evaluate import geo_eval

    print(f"== phase 3: the main path {SAMPLED_DIST_PATH} (parallel/: DistSampledTrainer at world "
          f"size 1 against SampledTrainer, dropout 0)")
    mesh = make_graph_mesh(DEVICE)
    if (dist.get_backend(), mesh.world_size) != ("nccl", 1):
        raise AssertionError(f"the mesh is {dist.get_backend()} with {mesh.world_size} ranks")
    single = sampled_trainer(ds, DEVICE, dropout=0.0, seed=5)
    multi = sampled_trainer(ds, DEVICE, dropout=0.0, seed=5, mesh=mesh)
    multi.model.load_state_dict(single.model.state_dict())
    batch = next(multi.rank_batches(ds.train_idx, np.random.default_rng(0)))
    y = torch.as_tensor(np.asarray(ds.y), dtype=torch.int64, device=DEVICE)
    bd = batch_to_device(batch, DEVICE)
    yb = y[bd["nodes"][0]]
    single.model.zero_grad(set_to_none=True)
    want = sampled_loss(single.model, single.x_ell, bd, yb, bd["target_mask"], train=True)
    want.backward()
    multi.model.zero_grad(set_to_none=True)
    share = dist_sampled_loss(multi.model, multi.x_ell, bd, yb, mesh, train=True)
    share.backward()
    got = sum_gradients(multi.model, share, mesh)
    torch.cuda.synchronize()
    print(f"  sub-batch of {int(batch.target_mask.sum())} targets, node sets "
          f"{tuple(len(n) for n in batch.nodes)}; loss {float(got)!r} (DistSampledTrainer) vs "
          f"{float(want.detach())!r} (SampledTrainer)")
    check_close("step loss", got.reshape(1), want.detach().reshape(1), SAMPLED_DIST_LOSS_RTOL)
    want_grads = dict(single.model.named_parameters())
    for k, p in multi.model.named_parameters():
        check_close(f"grad {k}", p.grad, want_grads[k].grad, SAMPLED_DIST_LOSS_RTOL)
    del single

    trainer = sampled_trainer(ds, DEVICE, dropout=PRESETS["geotext"]["dropout"], mesh=mesh)
    dev_idx = ds.dev_idx

    def epoch():
        trainer.train_epoch(ds.train_idx, y)
        pred = trainer._predict_rows(dev_idx)
        geo_eval(pred, ds.lat[dev_idx], ds.lon[dev_idx], ds.class_lat_median,
                 ds.class_lon_median)

    print(f"  one epoch of {SAMPLED_DIST_PATH}, {SAMPLED_DIST_PROFILE_EPOCHS} epochs profiled "
          f"({card_line()}):")
    device_breakdown(epoch, SAMPLED_DIST_PROFILE_EPOCHS, "epoch")


def phase_dist(ds, data_dir: str) -> tuple:
    """parallel/ slice A on the card, (a) to (d), slice B, (e) to (i), and
    slice C, (j) to (l); the process group is destroyed whatever happens.
    Returns the GCN's, the GAT's and the sampled path's runs."""
    import torch.distributed as dist

    try:
        model = timed(f"phase 3 {DIST_PATH} (a)", phase_dist_model, ds)
        timed(f"phase 4 {DIST_PATH} (d)", phase_dist_card_vs_cpu, ds, model)
        cli_run = timed(f"phase 3 {DIST_PATH} --dist (b)", phase_dist_cli, data_dir)
        timed(f"phase 3 {DIST_PATH} --dist --eval-only (c)", phase_dist_eval_only, data_dir,
              cli_run)
        gat = timed(f"phase 3 {GAT_DIST_PATH} (e)", phase_gat_dist_model, ds)
        timed(f"phase 4 {GAT_DIST_PATH} (f)", phase_gat_dist_card_vs_cpu, ds, gat)
        gat_cli = timed(f"phase 3 {GAT_DIST_PATH} --dist (g)", phase_gat_dist_cli, data_dir)
        timed(f"phase 3 {GAT_DIST_PATH} --dist --eval-only (h)", phase_gat_dist_eval_only,
              data_dir, gat_cli)
        timed(f"phase 3 {FACTORIZED_DIST_PATH} --dist (i)", phase_factorized_dist_cli, data_dir)
        timed(f"phase 3 {SAMPLED_DIST_PATH} (j)", phase_sampled_dist_step, ds)
        sampled = timed(f"phase 3 {SAMPLED_DIST_PATH} --sampled --dist (k)", phase_main_path,
                        data_dir, SAMPLED_DIST_PATH)
        timed(f"phase 3 {SAMPLED_DIST_PATH} --eval-only (l)", phase_eval_only, data_dir,
              SAMPLED_DIST_PATH, sampled)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return ({**model, "cli_launches": cli_run["launches"]},
            {**gat, "cli_launches": gat_cli["launches"]}, sampled)


# ---- the twitter-world preset at World width and World size ----------------
def world_problem(n: int, *, vocab: int, classes: int, seed: int = 0):
    """The Twitter-World-shaped problem of ``benchmarks/world_dryrun.py ::
    build_problem``, array for array: the mention structure of
    ``random_mention_projection_graph(n, max(n // 256, 8))`` (its groups
    only), 20 tokens a user over Zipf(1.25) columns clipped to vocab - 1
    with |N(0, 1)| values, uniform labels, a train mask on the first 95% of
    rows, up to 10,000 dev rows after them, uniform coordinates and class
    medians. Returns (groups, x, y, mask, dev_idx, lat, lon, med_lat,
    med_lon) and prints each step's host seconds."""
    import numpy as np
    import scipy.sparse as sp

    from graphconvgeo_torch.data.synthetic import random_mention_projection_graph

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    _, groups = random_mention_projection_graph(n, max(n // 256, 8), seed=seed,
                                                return_structure=True)
    t1 = time.perf_counter()
    rows = np.repeat(np.arange(n), 20)
    cols = np.minimum(rng.zipf(1.25, rows.shape[0]) - 1, vocab - 1)
    x = sp.coo_matrix(
        (np.abs(rng.normal(size=rows.shape[0])).astype(np.float32), (rows, cols)),
        shape=(n, vocab),
    ).tocsr()
    x.sum_duplicates()
    t2 = time.perf_counter()
    y = rng.integers(0, classes, n).astype(np.int32)
    mask = np.zeros(n, np.float32)
    train_n = int(n * 0.95)
    mask[:train_n] = 1.0
    dev_idx = np.arange(train_n, min(train_n + 10_000, n))
    lat = rng.uniform(-60, 70, n)
    lon = rng.uniform(-180, 180, n)
    med_lat = rng.uniform(-60, 70, classes)
    med_lon = rng.uniform(-180, 180, classes)
    print(f"world problem at {n} users: mention structure {t1 - t0!r} s ({len(groups)} groups), "
          f"X {t2 - t1!r} s ({x.nnz} nonzeros), labels and coordinates "
          f"{time.perf_counter() - t2!r} s")
    return groups, x, y, mask, dev_idx, lat, lon, med_lat, med_lon


def world_config(**over):
    """The twitter-world preset's GCNConfig (cli.py PRESETS) with the World
    program's levers (benchmarks/world_device_width.py): remat, bf16 gathers
    (and so the bf16 tile contraction on the factorized Â), the bf16 slab of
    up to 4,096 columns. ``over`` replaces fields (smaller sizes in tests)."""
    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.models.gcn import GCNConfig

    pre = PRESETS["twitter-world"]
    cfg = dict(n_features=WORLD_VOCAB, n_classes=WORLD_CLASSES, hidden=pre["hidden"],
               highway=True, dropout=pre["dropout"], l2=pre["l2"], remat=True,
               gather_dtype="bfloat16", input_backend="slab", slab_cols=4096,
               slab_dtype=pre["slab_dtype"])
    return GCNConfig(**{**cfg, **over})


def world_kernels(fa) -> dict:
    """Kernel 1's bf16 contraction on the World operand's two tile operands
    at F 900: B'ᵀ's tiles on h in float32 (as the operator's first apply
    gives it) and in bf16, the merged tiles on z in bf16; each against its
    plain twin, timed in turns with torch.sparse.mm on bf16-rounded values
    in float32, beside its bound. Returns the merged operand's numbers and
    the largest error."""
    import torch

    f = WORLD_F
    runs = {
        "bt_f32h": time_factor_kernel("World B'^T tiles", fa.bt_tiles, f, bf16=True,
                                      h_dtype=torch.float32, seed=61),
        "bt": time_factor_kernel("World B'^T tiles", fa.bt_tiles, f, bf16=True,
                                 h_dtype=torch.bfloat16, seed=62),
        "zr": time_factor_kernel("World merged tiles", fa.zr_tiles, f, bf16=True,
                                 h_dtype=torch.bfloat16, seed=63),
    }
    out = {"max_abs_err": max(r["max_abs_err"] for r in runs.values())}
    for op, r in runs.items():
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "nnz", "longest_row",
                    "n_tiles"):
            out[f"{op}_{key}"] = r[key]
    return out


def world_memory(label: str) -> dict:
    import torch

    free, total = torch.cuda.mem_get_info()
    mem = {"allocated": torch.cuda.memory_allocated(),
           "max_allocated": torch.cuda.max_memory_allocated(),
           "max_reserved": torch.cuda.max_memory_reserved(),
           "free": free, "total": total}
    print(f"  memory {label}: allocated {mem['allocated']} bytes, peak allocated "
          f"{mem['max_allocated']} bytes, peak reserved {mem['max_reserved']} bytes; "
          f"the card {free} bytes free of {total} ({card_line()})")
    return mem


# the 3×TF32 dense products (ops/dense.py, csrc/dense_3xtf32.cu) at every
# shape a driven path gives the kernel, each with its input and weight
# gradients (nt, tn): the World cell's conv and gate products (WORLD_N x 900 @
# 900 x 900), a streamed head block (65,536 x 900 @ 900 x 930) and the last
# (WORLD_N mod 65,536 rows), the bf16 slab (WORLD_N x 640 @ 640 x 900; no
# input gradient); gcn_world_cli's bf16 slab (65,536 x 4,096 @ 4,096 x 900;
# its convs are the World conv's at fewer rows, its output layer is under
# dense.MIN_WIDTH); the sampled path's outer conv (61,952 slots x 300 @ 300
# x 300). The kernel's error against float64 may be at most
# DENSE_ERR_VS_MATMUL x torch.matmul's in full float32; one TF32 product
# must err more wherever an operand is float32 (a bf16 operand is exact).
# DenseProduct (forward and backward, on KERNEL_OPS) is held to the same
# rule against torch.autograd at the head's and the slab's shapes.
DENSE_ERR_VS_MATMUL = 2.0
DENSE_REF_ROWS = 65_536  # rows of an nn / nt output held against float64
DENSE_REF_CHUNK = 131_072  # rows a float64 partial sum of the tn reference
DENSE_ROUNDS = 3  # rounds of kernel, library, library, kernel
DENSE_ITERS = 3  # calls a timed run
DENSE_CLI_ROWS = 65_536  # WORLD_CLI_DUMPS' users
DENSE_CLI_SLAB_COLS = 4096  # the bf16 slab gcn_world_cli's --input auto picks
DENSE_SAMPLED_ROWS = 61_952  # the sampled outer layer's slots: 5,632 x 11
DENSE_SAMPLED_F = 300  # the geotext preset's hidden width
# the kernel's error floor at a short contraction, printed (not asserted):
# rows, output width and the depths K
DENSE_DEPTH_SHAPE = (16_384, 300)
DENSE_DEPTHS = (32, 64, 96, 160, 300, 900)
# R's sweep: rows of the large operand (GeoText's 9,475 among them) at each
# (K, N) a path sends: GeoText's and the sampled path's hidden and output
# widths, the World conv and head, gcn_world_cli's output layer.
# dense.MIN_ROWS must be at least the rows from which the kernel leads
# torch.matmul in nn, nt and tn at every swept shape that dense.MIN_WIDTH
# lets take it; the narrower ones show why it does not.
DENSE_SWEEP_ROWS = (4096, 8192, 9475, 12288, 16384, 23744, 32768, 65536)
DENSE_SWEEP_SHAPES = ((300, 300), (300, 129), (900, 900), (900, 930), (900, 32))


def dense_ms(fn) -> float:
    """Mean milliseconds a call over DENSE_ITERS calls, after one warm-up,
    CUDA events behind a device sleep (as cuda_ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(DENSE_ITERS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / DENSE_ITERS


def dense_errors(c, ref) -> tuple:
    """(max, RMS) of |c − ref| / max |ref|, ref float64."""
    d = c.double() - ref
    scale = float(ref.abs().max())
    return float(d.abs().max()) / scale, float(d.pow(2).mean().sqrt()) / scale


def dense_tn_reference(a, g):
    """aᵀ @ g in float64, summed over DENSE_REF_CHUNK rows at a time."""
    import torch

    total = torch.zeros(a.shape[1], g.shape[1], dtype=torch.float64, device=a.device)
    for r0 in range(0, a.shape[0], DENSE_REF_CHUNK):
        total += a[r0:r0 + DENSE_REF_CHUNK].double().t() @ g[r0:r0 + DENSE_REF_CHUNK].double()
    return total


def dense_case(name: str, kernel, library, one_tf32, reference, rows, flops: int, terms: int,
               fp32_operand: bool) -> dict:
    """One product at a path's shape: its error against float64
    (``reference`` on the output ``rows``, None for all) beside torch.matmul's
    and one TF32 product's, bitwise repeatability, and kernel and library
    timed in turns against the 3×TF32 bound."""
    import statistics

    import torch

    ref = reference()
    errs = {}
    first = None
    for label, fn in (("kernel", kernel), ("matmul", library), ("tf32", one_tf32)):
        out = fn()
        if label == "kernel":
            again = kernel()
            if not torch.equal(out, again):
                raise AssertionError(f"{name}: two kernel calls differ")
            del again
            first = out.shape
        errs[label] = dense_errors(out if rows is None else out[rows], ref)
        del out
    del ref
    k, lib = [], []
    for _ in range(DENSE_ROUNDS):
        k.append(dense_ms(kernel))
        lib.append(dense_ms(library))
        lib.append(dense_ms(library))
        k.append(dense_ms(kernel))
    ms, lib_ms = statistics.median(k), statistics.median(lib)
    bound_ms = terms * flops / TF32_FLOPS * 1e3
    row = {"shape": list(first), "err_max": errs["kernel"][0], "err_rms": errs["kernel"][1],
           "matmul_err_max": errs["matmul"][0], "matmul_err_rms": errs["matmul"][1],
           "tf32_err_max": errs["tf32"][0], "tf32_err_rms": errs["tf32"][1], "ms": ms,
           "library_ms": lib_ms, "speedup": lib_ms / ms, "bound_ms": bound_ms,
           "bound_share": bound_ms / ms, "terms": terms, "kernel_runs_ms": k, "library_runs_ms": lib}
    print(f"  {name}: {json.dumps(row)}")
    if not errs["kernel"][0] <= DENSE_ERR_VS_MATMUL * errs["matmul"][0]:
        raise AssertionError(f"{name}: kernel error {errs['kernel'][0]} over "
                             f"{DENSE_ERR_VS_MATMUL} x torch.matmul's {errs['matmul'][0]}")
    if fp32_operand and not errs["tf32"][0] > errs["kernel"][0]:
        raise AssertionError(f"{name}: one TF32 product ({errs['tf32'][0]}) is no worse than the "
                             f"kernel ({errs['kernel'][0]})")
    return row


def dense_triple(res: dict, tag: str, a, g, w, rows) -> None:
    """dense_case for nn a @ w, nt g @ wᵀ and tn aᵀ @ g, all float32
    (``rows``: the nn / nt output rows held against float64, None for
    all)."""
    from graphconvgeo_torch.ops import dense

    tf32 = dense.tf32_round
    pick = (lambda x: x) if rows is None else (lambda x: x[rows])
    flops = 2 * a.shape[0] * a.shape[1] * w.shape[1]
    res[f"{tag}_nn"] = dense_case(
        f"{tag} nn", lambda: dense.kernel_nn(a, w), lambda: a @ w, lambda: tf32(a) @ tf32(w),
        lambda: pick(a).double() @ w.double(), rows, flops, 3, True)
    res[f"{tag}_nt"] = dense_case(
        f"{tag} nt", lambda: dense.kernel_nt(g, w), lambda: g @ w.t(), lambda: tf32(g) @ tf32(w).t(),
        lambda: pick(g).double() @ w.double().t(), rows, flops, 3, True)
    res[f"{tag}_tn"] = dense_case(
        f"{tag} tn", lambda: dense.kernel_tn(a, g), lambda: a.t() @ g, lambda: tf32(a).t() @ tf32(g),
        lambda: dense_tn_reference(a, g), None, flops, 3, True)


def dense_slab(res: dict, tag: str, slab, ws, g, rows) -> None:
    """dense_case for a bf16 slab's nn slab @ ws (one term) and its weight
    gradient slabᵀ @ g (two)."""
    from graphconvgeo_torch.ops import dense

    flops = 2 * slab.shape[0] * slab.shape[1] * ws.shape[1]
    pick = (lambda x: x) if rows is None else (lambda x: x[rows])
    res[f"{tag}_nn"] = dense_case(
        f"{tag} nn (bf16)", lambda: dense.kernel_nn(slab, ws), lambda: slab.float() @ ws.float(),
        lambda: slab.float() @ ws.float(), lambda: pick(slab).double() @ ws.double(), rows, flops, 1,
        False)
    res[f"{tag}_tn"] = dense_case(
        f"{tag} tn (bf16, f32)", lambda: dense.kernel_tn(slab, g), lambda: slab.float().t() @ g,
        lambda: slab.float().t() @ dense.tf32_round(g), lambda: dense_tn_reference(slab, g), None,
        flops, 2, True)


def dense_autograd(name: str, a, b, grad_a: bool) -> dict:
    """DenseProduct on KERNEL_OPS, forward and backward under an upstream
    gradient ``b.shape[1]`` wide, against torch.autograd in float64 beside
    torch.autograd on torch.matmul in float32 (bf16 operands widened, as
    before the kernel): the output and each gradient within
    DENSE_ERR_VS_MATMUL x torch.matmul's error, gradients in the operands'
    dtypes, one nn, nt (where ``a`` takes a gradient) and tn launch."""
    import torch

    from graphconvgeo_torch.ops import dense
    from graphconvgeo_torch.utils import cuda_build

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    up = torch.randn(a.shape[0], b.shape[1], device=DEVICE, generator=gen)

    def run(product, dtype=None):
        x = a.detach().to(dtype or a.dtype).requires_grad_(grad_a)
        w = b.detach().to(dtype or b.dtype).requires_grad_(True)
        out = product(x, w)
        out.backward(up.to(out.dtype))
        return [out.detach(), x.grad, w.grad] if grad_a else [out.detach(), w.grad]

    ref = run(lambda x, w: x @ w, torch.float64)
    cuda_build.reset_launch_counts()
    got = run(lambda x, w: dense.DenseProduct.apply(x, w, dense.KERNEL_OPS))
    launches = {k: cuda_build.launch_counts[k] for k in ("dense_nn", "dense_nt", "dense_tn")}
    lib = run(lambda x, w: x.float() @ w.float())
    labels = ["out", "grad_a", "grad_b"] if grad_a else ["out", "grad_b"]
    row = {"launches": launches}
    for label, k, m, r in zip(labels, got, lib, ref):
        want = torch.float32 if label == "out" else (a.dtype if label == "grad_a" else b.dtype)
        if k.dtype != want or k.shape != r.shape:
            raise AssertionError(f"{name} {label}: {k.dtype} {tuple(k.shape)}, not {want} "
                                 f"{tuple(r.shape)}")
        row[label] = {"err_max": dense_errors(k, r)[0], "matmul_err_max": dense_errors(m, r)[0]}
    print(f"  {name} (DenseProduct against torch.autograd): {json.dumps(row)}")
    expect = {"dense_nn": 1, "dense_nt": int(grad_a), "dense_tn": 1}
    if launches != expect:
        raise AssertionError(f"{name}: launches {launches}, not {expect}")
    for label in labels:
        e = row[label]
        if not e["err_max"] <= DENSE_ERR_VS_MATMUL * e["matmul_err_max"]:
            raise AssertionError(f"{name} {label}: error {e['err_max']} over "
                                 f"{DENSE_ERR_VS_MATMUL} x torch.matmul's {e['matmul_err_max']}")
    return row


def dense_depths() -> dict:
    """The kernel's and torch.matmul's error against float64 in nn over the
    contraction depths DENSE_DEPTHS, float32 · float32 and bf16 · float32,
    printed: the kernel's error stops falling with the depth (the tensor
    cores truncate within a chain of products), torch.matmul's keeps
    falling."""
    import torch

    from graphconvgeo_torch.ops import dense

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    m, n = DENSE_DEPTH_SHAPE
    out = {}
    for k in DENSE_DEPTHS:
        w = torch.randn(k, n, device=DEVICE, generator=gen)
        a = torch.randn(m, k, device=DEVICE, generator=gen)
        for tag, x in (("f32", a), ("bf16", a.to(torch.bfloat16))):
            ref = x.double() @ w.double()
            out[f"{tag}_{k}"] = [dense_errors(dense.kernel_nn(x, w), ref)[0],
                                 dense_errors(x.float() @ w, ref)[0]]
    print(f"  error against float64 by depth, [kernel, torch.matmul] (rows {m}, output {n}): "
          f"{json.dumps(out)}")
    return out


def dense_sweep() -> dict:
    """Kernel and torch.matmul (ms) in nn, nt and tn over DENSE_SWEEP_ROWS at
    each of DENSE_SWEEP_SHAPES; per shape the fewest swept rows from which
    the kernel is faster in all three."""
    import torch

    from graphconvgeo_torch.ops import dense

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    out = {}
    for k, n in DENSE_SWEEP_SHAPES:
        w = torch.randn(k, n, device=DEVICE, generator=gen)
        rows = {}
        for m in DENSE_SWEEP_ROWS:
            a = torch.randn(m, k, device=DEVICE, generator=gen)
            g = torch.randn(m, n, device=DEVICE, generator=gen)
            pairs = [
                (dense_ms(lambda: dense.kernel_nn(a, w)), dense_ms(lambda: a @ w)),
                (dense_ms(lambda: dense.kernel_nt(g, w)), dense_ms(lambda: g @ w.t())),
                (dense_ms(lambda: dense.kernel_tn(a, g)), dense_ms(lambda: a.t() @ g)),
            ]
            rows[m] = {p: list(v) for p, v in zip(("nn", "nt", "tn"), pairs)}
        wins = [m for m in DENSE_SWEEP_ROWS
                if all(rows[r][p][0] < rows[r][p][1] for r in DENSE_SWEEP_ROWS if r >= m
                       for p in ("nn", "nt", "tn"))]
        out[f"{k}x{n}"] = {"ms_kernel_library": rows, "kernel_faster_from": wins[0] if wins else None}
        print(f"  sweep K {k} N {n}: {json.dumps(out[f'{k}x{n}'])}")
    return out


def phase_dense() -> dict:
    """The dense products at every shape a driven path gives the kernel
    against float64, torch.matmul and one TF32 product; DenseProduct against
    torch.autograd; the error by depth; R's sweep, held against
    dense.MIN_ROWS."""
    import torch

    from graphconvgeo_torch.ops import dense

    print(f"== phase 2 (dense): the 3×TF32 products at the paths' shapes, MIN_ROWS "
          f"{dense.MIN_ROWS} ({card_line()})")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 must be False")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    n, f, c, head, s_cols = WORLD_N, WORLD_F, WORLD_CLASSES, WORLD_ROW_BLOCK, WORLD_SLAB_COLS
    rows = torch.randperm(n, device=DEVICE, generator=gen)[:DENSE_REF_ROWS].sort().values

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, device=DEVICE, generator=gen) * scale).to(dtype)

    res = {}
    a, g = randn(n, f), randn(n, f)
    dense_triple(res, "conv", a, g, randn(f, f, scale=f ** -0.5), rows)
    wh = randn(f, c, scale=f ** -0.5)
    dense_triple(res, "head", a[:head], randn(head, c), wh, None)
    last = n % head
    dense_triple(res, "head_last", a[n - last:], randn(last, c), wh, None)
    res["head_autograd"] = dense_autograd("head", a[:head], wh, True)
    del wh
    dense_slab(res, "slab", randn(n, s_cols, dtype=torch.bfloat16),
               randn(s_cols, f, scale=s_cols ** -0.5, dtype=torch.bfloat16), g, rows)
    res["slab_autograd"] = dense_autograd(
        "slab", randn(head, s_cols, dtype=torch.bfloat16),
        randn(s_cols, f, scale=s_cols ** -0.5, dtype=torch.bfloat16), False)
    dense_slab(res, "cli_slab", randn(DENSE_CLI_ROWS, DENSE_CLI_SLAB_COLS, dtype=torch.bfloat16),
               randn(DENSE_CLI_SLAB_COLS, f, scale=DENSE_CLI_SLAB_COLS ** -0.5,
                     dtype=torch.bfloat16), g[:DENSE_CLI_ROWS], None)
    del a, g
    sf = DENSE_SAMPLED_F
    dense_triple(res, "sampled", randn(DENSE_SAMPLED_ROWS, sf), randn(DENSE_SAMPLED_ROWS, sf),
                 randn(sf, sf, scale=sf ** -0.5), None)
    torch.cuda.empty_cache()
    res["depths"] = dense_depths()
    res["sweep"] = dense_sweep()
    need = {f"{k}x{n}": res["sweep"][f"{k}x{n}"]["kernel_faster_from"]
            for k, n in DENSE_SWEEP_SHAPES if min(k, n) >= dense.MIN_WIDTH}
    if any(v is None or v > dense.MIN_ROWS for v in need.values()):
        raise AssertionError(f"the kernel leads torch.matmul from {need} rows, not from "
                             f"dense.MIN_ROWS {dense.MIN_ROWS} at every shape it takes")
    return res


def phase_world() -> dict:
    """The twitter-world preset's Highway-GCN at World width and WORLD_N
    users on the card: the factorized Â (its tile operands' pack, kernel
    1's bf16 contraction at F 900 against its plain twin), the bf16 slab
    under its byte budget, remat, the streamed CE head and predict engaged
    by their own gate; Adam steps with their launches, the head's blocks,
    host and device seconds and peak memory, one profiled step, and the dev
    evaluation through the streamed predict."""
    import math
    import statistics

    import numpy as np
    import torch

    from graphconvgeo_torch.cli import PRESETS
    from graphconvgeo_torch.models.gcn import HighwayGCN
    from graphconvgeo_torch.ops.ce_stream import streamed_rows_threshold
    from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency
    from graphconvgeo_torch.sparse.formats import SparseGraph
    from graphconvgeo_torch.train.evaluate import geo_eval
    from graphconvgeo_torch.train.trainer import TrainConfig, Trainer
    from graphconvgeo_torch.utils import cuda_build
    from graphconvgeo_torch.utils.timing import device_trial_seconds

    n, c = WORLD_N, WORLD_CLASSES
    print(f"== phase 3: the main path {WORLD_PATH} (the twitter-world preset's Highway-GCN at "
          f"{n} users, hidden {WORLD_F}, {c} classes, vocabulary {WORLD_VOCAB}; factorized "
          f"Â, bf16 gathers and contraction, remat, the bf16 slab; {card_line()})")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = world_memory("at the phase's start")
    groups, x, y, mask, dev_idx, lat, lon, med_lat, med_lon = world_problem(
        n, vocab=WORLD_VOCAB, classes=c)
    t0 = time.perf_counter()
    fa = FactorizedAdjacency.from_groups(groups, n)
    print(f"  factorized operand built in {time.perf_counter() - t0!r} s "
          f"({fa.n_groups} hubs)")
    del groups
    factorized_operand_line("World", fa)
    for name in ("bt_tiles", "zr_tiles"):
        cells = getattr(fa, name).tiles.numel()
        print(f"  {name}: {cells} tile cells for pack_rows's one nonzero (torch.nonzero on CUDA "
              f"takes fewer than 2^31)")
        if cells >= 2**31:
            raise AssertionError(f"{name}: {cells} tile cells, past torch.nonzero's 2^31 on CUDA")

    cfg = world_config()
    t0 = time.perf_counter()
    model = HighwayGCN(cfg, SparseGraph(csr=x), fa, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    print(f"  model built (input operands, transfer, parameters) in {time.perf_counter() - t0!r} s")
    del fa
    x_op = model.arrays["x"]
    cols = x_op.cols.cpu().numpy()
    freq = np.bincount(x.indices, minlength=x.shape[1])
    coverage = float(freq[cols].sum() / x.nnz)
    rest = type(x_op.rest).__name__
    print(f"  input slab {tuple(x_op.slab.shape)} {x_op.slab.dtype} ({x_op.slab.numel() * 2} bytes, "
          f"budget {cfg.slab_byte_budget}), coverage {coverage!r} of X's {x.nnz} nonzeros "
          f"(gate {WORLD_SLAB_MIN_COVERAGE}), rest {rest}")
    if (len(cols), x_op.slab.dtype) != (WORLD_SLAB_COLS, torch.bfloat16):
        raise AssertionError(f"slab of {len(cols)} {x_op.slab.dtype} columns, not "
                             f"{WORLD_SLAB_COLS} bf16")
    if not coverage >= WORLD_SLAB_MIN_COVERAGE:
        raise AssertionError(f"slab coverage {coverage} below {WORLD_SLAB_MIN_COVERAGE}")
    del x
    fa = model.arrays["adj"]
    for name in ("bt_tiles", "zr_tiles"):
        print(f"World {name}:")
        pack_ms(getattr(fa, name))
    kernels = world_kernels(fa)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    blocks = math.ceil(n / WORLD_ROW_BLOCK)
    gate = n * c > streamed_rows_threshold()
    print(f"  streamed head: N x C = {n * c} > {streamed_rows_threshold()}: {gate}; "
          f"{blocks} row blocks of {WORLD_ROW_BLOCK}")
    if not gate:
        raise AssertionError("the streamed head's gate does not engage at this N")
    pre = PRESETS["twitter-world"]
    trainer = Trainer(model, TrainConfig(learning_rate=pre["lr"], verbose=False))
    y_t = torch.as_tensor(y.astype(np.int64), device=DEVICE)
    mask_t = torch.as_tensor(mask, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    resident = world_memory("resident before the first step (operands, parameters)")
    losses = []

    def step(_=None):
        loss = trainer.train_step(y_t, mask_t)
        losses.append(loss)
        return loss

    walls = []
    cuda_build.reset_launch_counts()
    fallbacks = counters["dense_fallback"]
    seen = counters["head_blocks"]
    t0 = time.perf_counter()
    loss = step()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    step_launches = dict(cuda_build.launch_counts)
    seen = counters["head_blocks"] - seen
    print(f"  first step {walls[0]!r} s: launches {step_launches}, head blocks {seen}")
    if step_launches != WORLD_STEP_LAUNCHES:
        raise AssertionError(f"a step launched {step_launches}, not {WORLD_STEP_LAUNCHES}")
    if seen != 2 * blocks:
        raise AssertionError(f"the streamed loss ran {seen} head blocks, not 2 x {blocks}")
    t0 = time.perf_counter()
    loss = step()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    step_s = device_trial_seconds(step, loss, **WORLD_TIMING)
    print(f"  a step's wall {walls!r} s; device seconds a step (differenced, "
          f"{WORLD_TIMING}) {step_s!r}")
    profile = device_breakdown(step, 1, "step")
    peak = world_memory("after the steps")

    in_steps = dict(cuda_build.launch_counts)
    seen = counters["head_blocks"]
    t0 = time.perf_counter()
    pred = trainer.predict()
    predict_s = time.perf_counter() - t0
    launches = dict(cuda_build.launch_counts)
    seen = counters["head_blocks"] - seen
    predict_launches = {k: launches[k] - in_steps[k] for k in launches}
    dev = geo_eval(pred[dev_idx], lat[dev_idx], lon[dev_idx], med_lat, med_lon)
    dev.pop("distances")
    eval_s = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    print(f"  {len(losses)} steps, loss {losses!r}\n"
          f"  predict {predict_s!r} s, with the dev geo_eval ({len(dev_idx)} rows) {eval_s!r} s: "
          f"launches {predict_launches}, head blocks {seen}; dev {dev}\n"
          f"  peak allocated {peak['max_allocated']} bytes, peak reserved {peak['max_reserved']} "
          f"bytes, step device {statistics.median(step_s)!r} s ({card_line()})")
    if predict_launches != WORLD_PREDICT_LAUNCHES:
        raise AssertionError(f"the predict launched {predict_launches}, not {WORLD_PREDICT_LAUNCHES}")
    want = {k: v * len(losses) for k, v in WORLD_STEP_LAUNCHES.items()}
    if in_steps != want:
        raise AssertionError(f"{len(losses)} steps launched {in_steps}, not {want}")
    if seen != blocks:
        raise AssertionError(f"the streamed predict ran {seen} head blocks, not {blocks}")
    fallbacks = counters["dense_fallback"] - fallbacks
    print(f"  float32 products left to torch.matmul (dense_fallback) in the steps and the "
          f"predict: {fallbacks}")
    if fallbacks:
        raise AssertionError(f"{fallbacks} float32 products fell under dense.MIN_ROWS")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if not all(math.isfinite(dev[k]) for k in ("acc_at_161", "mean_km", "median_km")):
        raise AssertionError(f"non-finite dev metrics {dev}")
    del trainer, model, y_t, mask_t
    torch.cuda.empty_cache()
    return {"n": n, "launches": launches, "step_launches": step_launches,
            "predict_launches": predict_launches, "losses": losses, "step_wall_s": walls, "step_device_s": step_s,
            "profile": profile, "predict_s": predict_s, "dev_eval_s": eval_s, "dev": dev,
            "memory": {"start": start, "resident": resident, "peak": peak},
            "slab_cols": int(len(cols)), "slab_coverage": coverage, "kernels": kernels}


def phase_world_cli(data_dir: str) -> dict:
    """``cli.main --preset twitter-world --adjacency factorized --gather-dtype
    bfloat16`` on WORLD_CLI_DUMPS for WORLD_CLI_EPOCHS epochs: the preset's
    widths (hidden 900-900, bucket 2400, celebrity 5, utf-8) and its bf16
    slab under ``--input auto``; finite metrics, a falling loss, 12 bf16
    launches an epoch and 8 after. The preprocessing is timed first into
    the data directory's cache, which cli.main then reads."""
    import math

    from graphconvgeo_torch import cli
    from graphconvgeo_torch.data.pipeline import PreprocessConfig, preprocess
    from graphconvgeo_torch.data.synthetic import make_synthetic_dumps
    from graphconvgeo_torch.utils import cuda_build

    pre = cli.PRESETS["twitter-world"]
    print(f"== phase 3: the main path {WORLD_CLI_PATH} (cli.main --preset twitter-world "
          f"{' '.join(WORLD_CLI_FLAGS)}, {WORLD_CLI_DUMPS['n_users']} users)")
    t0 = time.perf_counter()
    make_synthetic_dumps(data_dir, **WORLD_CLI_DUMPS)
    t1 = time.perf_counter()
    preprocess(data_dir, PreprocessConfig(bucket_size=pre["bucket"],
                                          celebrity_threshold=pre["celebrity"],
                                          min_df=pre["min_df"], encoding=pre["encoding"]))
    t2 = time.perf_counter()
    print(f"  dumps written in {t1 - t0!r} s, preprocessed in {t2 - t1!r} s (cached for cli.main)")
    argv = ["--preset", "twitter-world", "-d", data_dir, *WORLD_CLI_FLAGS,
            "--epochs", str(WORLD_CLI_EPOCHS), "--patience", str(WORLD_CLI_EPOCHS),
            "--device", DEVICE, "--json"]
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    report = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.launch_counts)
    run, hist = report["run"], report["run"]["history"]
    losses = [h["loss"] for h in hist]
    in_training = {k: sum(h["launches"][k] for h in hist) for k in launches}
    after = {k: launches[k] - in_training[k] for k in launches}
    print(f"  backend {run['backend']}, B'^T {run['bt_tiles']} tiles, merged {run['zr_tiles']}, "
          f"input {run['input_operand']} ({run['slab_dtype']}, {run['slab_cols']} columns, rest "
          f"{run['input_rest']})\n"
          f"  epochs {len(hist)}, loss {losses!r}, dev {report['dev']}, test {report['test']}\n"
          f"  main() wall {wall!r} s, epoch seconds {[h['seconds'] for h in hist]!r}\n"
          f"  launches {launches}: in training {in_training}, after {after}")
    metrics = [report[s][k] for s in ("dev", "test") for k in ("acc_at_161", "mean_km", "median_km")]
    if not all(math.isfinite(v) for v in losses + metrics):
        raise AssertionError(f"non-finite losses or metrics: {losses}, {metrics}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss {losses} did not fall")
    if (run["backend"], run["gather_dtype"], run["slab_dtype"]) != ("factorized", "bfloat16",
                                                                    "bfloat16"):
        raise AssertionError(f"run {run['backend']}, {run['gather_dtype']}, {run['slab_dtype']}")
    for name, per in WORLD_CLI_LAUNCHES_PER_EPOCH.items():
        counts = [h["launches"][name] for h in hist]
        if any(v != per for v in counts):
            raise AssertionError(f"{name}: launches per epoch {counts}, expected {per} each")
    if after != WORLD_CLI_LAUNCHES_AFTER:
        raise AssertionError(f"the final evaluation launched {after}, not {WORLD_CLI_LAUNCHES_AFTER}")
    return {"launches": launches, "in_training": in_training, "epochs": len(hist),
            "report": report, "wall_s": wall, "preprocess_s": t2 - t1}


def phase_world_card_vs_cpu() -> None:
    """The World config at WORLD_PARITY_N users on the card and on the CPU
    from the same parameters, dropout 0, the streamed gate forced to 0 on
    both so the streamed loss and predict run: loss rel within
    CARD_CPU_BF16_LOSS_RTOL, every gradient within CARD_CPU_BF16_REL_TOL x
    max|ref|, and the streamed predictions equal on every row whose CPU
    top-2 logit margin is over WORLD_MARGIN_REL x max|logit|."""
    import math

    import numpy as np
    import torch

    from graphconvgeo_torch.models import gcn
    from graphconvgeo_torch.models.gcn import HighwayGCN
    from graphconvgeo_torch.ops import ce_stream
    from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency
    from graphconvgeo_torch.sparse.formats import SparseGraph

    n = WORLD_PARITY_N
    print(f"== phase 4: card against CPU at World width (main path {WORLD_PATH}, {n} users, "
          "dropout 0, the streamed head forced on)")
    groups, x, y, mask, *_ = world_problem(n, vocab=WORLD_VOCAB, classes=WORLD_CLASSES)
    fa = FactorizedAdjacency.from_groups(groups, n)
    cfg = world_config(dropout=0.0)
    y_t, mask_t = torch.as_tensor(y.astype(np.int64)), torch.as_tensor(mask)
    gates = (gcn.streamed_rows_threshold, ce_stream.streamed_rows_threshold)
    gcn.streamed_rows_threshold = ce_stream.streamed_rows_threshold = lambda: 0
    blocks = math.ceil(n / WORLD_ROW_BLOCK)
    results, state = {}, None
    try:
        for dev in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            net = HighwayGCN(cfg, SparseGraph(csr=x), fa, device=dev, seed=5)
            if state is None:
                state = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
            net.load_state_dict(state)
            seen = counters["head_blocks"]
            loss = net.loss(y_t.to(dev), mask_t.to(dev), train=True)
            loss.backward()
            pred = ce_stream.predict_classes(net).cpu()
            seen = counters["head_blocks"] - seen
            with torch.no_grad():
                logits = net.apply(train=False).cpu()
            print(f"  {dev}: model built, loss, backward and streamed predict in "
                  f"{time.perf_counter() - t0!r} s ({seen} head blocks)")
            if seen != 3 * blocks:  # the loss, its recompute, the predict
                raise AssertionError(f"{dev}: {seen} head blocks, not 3 x {blocks}")
            results[dev] = {"loss": float(loss.detach()), "pred": pred, "logits": logits,
                            "grads": {k: p.grad.detach().cpu() for k, p in net.named_parameters()}}
            del net
    finally:
        gcn.streamed_rows_threshold, ce_stream.streamed_rows_threshold = gates
    gpu, cpu = results[DEVICE], results["cpu"]
    print(f"  loss {gpu['loss']!r} ({DEVICE}) vs {cpu['loss']!r} (cpu)")
    if abs(gpu["loss"] - cpu["loss"]) > CARD_CPU_BF16_LOSS_RTOL * abs(cpu["loss"]):
        raise AssertionError("loss differs between card and CPU")
    for k in cpu["grads"]:
        check_close(f"grad {k}", gpu["grads"][k], cpu["grads"][k], CARD_CPU_BF16_REL_TOL)
    top2 = torch.topk(cpu["logits"], 2, dim=1).values
    margin = top2[:, 0] - top2[:, 1]
    clear = margin > WORLD_MARGIN_REL * float(cpu["logits"].abs().max())
    differ = int((gpu["pred"] != cpu["pred"])[clear].sum())
    print(f"  streamed predictions: {int(clear.sum())} of {n} rows with a clear top-2 margin, "
          f"{differ} differ; {int((gpu['pred'] != cpu['pred']).sum())} differ over all rows")
    if differ:
        raise AssertionError(f"{differ} clear-margin predictions differ between card and CPU")


def timed(label: str, fn, *args):
    """fn(*args), with its wall seconds printed under ``label``."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"-- {label}: {time.perf_counter() - t0!r} s")
    return out


def phase_world_paths(data_dir: str) -> tuple:
    """The World paths: gcn_world, gcn_world_cli (its dumps under
    ``data_dir``) and the card against the CPU at World width."""
    world = timed(f"phase 3 {WORLD_PATH}", phase_world)
    world_cli = timed(f"phase 3 {WORLD_CLI_PATH}", phase_world_cli,
                      os.path.join(data_dir, "world_cli"))
    timed(f"phase 4 {WORLD_PATH}", phase_world_card_vs_cpu)
    return world, world_cli


def main() -> int:
    # Segments that grow in place, so that the cache holds closer to what
    # the tensors need: for a World step's 66.9 GB of tensors on an H100,
    # fixed segments reserved 81.2 GB (2.8 GB of the card left free),
    # growable ones 75.5 GB. Set before the first CUDA call; a caller's own
    # setting wins.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    timed("phase 1", phase_setup)
    data_dir = tempfile.mkdtemp(prefix="gcg_geotext_")
    if "--world" in sys.argv[1:]:
        try:
            timed("phases 3-4 World", phase_world_paths, data_dir)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        return 0
    try:
        t0 = time.perf_counter()
        ds = make_geotext_dataset(data_dir)
        print(f"GeoText-scale dataset: {ds.n_nodes} nodes, {ds.adj.nnz} adjacency nonzeros, "
              f"vocab {ds.x.shape[1]}, {ds.n_classes} classes, reorder {ds.reorder_method!r} "
              f"({time.perf_counter() - t0!r} s)")
        if "--profile" in sys.argv[1:]:
            for path in MAIN_PATHS:
                if path == SAMPLED_PATH:
                    timed(f"profile {path}", phase_profile_sampled, ds)
                else:
                    timed(f"profile {path}", phase_profile, ds, path)
            timed("profile factorized 262k", profile_factorized_262k)
            timed(f"profile {DIST_PATH}", profile_dist, ds)
            return 0
        kernels = timed("phase 2", phase_kernels, ds)
        timed("phase 2 (input layer)", time_input_layer, ds)
        kernels.update(timed("phase 2 (BSR)", phase_bsr_kernels, ds))
        kernels.update(timed("phase 2 (GAT)", phase_gat_kernels, ds))
        bf16_row, factorized_f32 = timed("phase 2 (factorized)", phase_factorized_kernels, ds)
        kernels.update(bf16_row)
        kernels["bsr_flat_matmul"]["factorized"] = factorized_f32
        dense_run = timed("phase 2 (dense)", phase_dense)
        if "--kernels" in sys.argv[1:]:
            return 0
        main_paths = {path: timed(f"phase 3 {path}", phase_main_path, data_dir, path)
                      for path in MAIN_PATHS}
        for path in CHECKPOINT_PATHS:
            timed(f"phase 3 --eval-only {path}", phase_eval_only, data_dir, path,
                  main_paths[path])
        timed("phase 3 --profile-dir", phase_profile_dir, data_dir)
        timed("phase 3 --tune", phase_tune, data_dir)
        timed(f"phase 3 {SAMPLED_PATH} costs", sampled_timings, ds)
        dist_run, gat_dist_run, sampled_dist_run = timed(
            f"phase 3-4 {DIST_PATH}, {GAT_DIST_PATH}, {FACTORIZED_DIST_PATH}, "
            f"{SAMPLED_DIST_PATH}", phase_dist, ds, data_dir)
        for path in MAIN_PATHS:
            if path == SAMPLED_PATH:
                for hidden in SAMPLED_HIDDEN:
                    timed(f"phase 4 {path} {hidden}", phase_card_vs_cpu_sampled, ds, hidden)
            else:
                timed(f"phase 4 {path}", phase_card_vs_cpu, ds, path)
        timed("phase 4 remat", phase_remat, ds)
        del ds
        world, world_cli = timed("phases 3-4 World", phase_world_paths, data_dir)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    print("== phase 5: report")
    rows = []
    for name, k in kernels.items():
        meta = KERNEL_META[name]
        launches = {"launches": 0, "launches_per_epoch": 0.0, "launches_after_training": 0,
                    "epochs": 0}
        if meta["main_path"] == GAT_BF16_PATH:  # one call of the public function
            launches = {"launches_path": GAT_BF16_PATH}
        # kernels 6 and 7 have no path; 3-5' report their own (phase 2)
        if meta["main_path"] in main_paths:
            main_path = main_paths[meta["main_path"]]
            in_training = main_path["in_training"][name]
            launches = {
                "launches": main_path["launches"][name],
                "launches_per_epoch": in_training / main_path["epochs"],
                "launches_after_training": main_path["launches"][name] - in_training,
                "epochs": main_path["epochs"],
            }
        if name == "bsr_flat_matmul":  # kernel 1 in float32 also carries these paths
            for other, run in [*((p, main_paths[p]) for p in
                                  ("gcn_factorized", "gcn_slab_bf16", SAMPLED_PATH)),
                               (DIST_PATH, dist_run), (SAMPLED_DIST_PATH, sampled_dist_run)]:
                launches[f"launches_{other}"] = run["launches"][name]
                launches[f"launches_per_epoch_{other}"] = run["in_training"][name] / run["epochs"]
            launches[f"launches_{DIST_PATH}_cli"] = dist_run["cli_launches"][name]
        if name in GAT_KERNELS:  # kernels 3-5 also carry the distributed GAT
            launches[f"launches_{GAT_DIST_PATH}"] = gat_dist_run["launches"][name]
            launches[f"launches_per_epoch_{GAT_DIST_PATH}"] = (
                gat_dist_run["in_training"][name] / gat_dist_run["epochs"])
            launches[f"launches_{GAT_DIST_PATH}_cli"] = gat_dist_run["cli_launches"][name]
        if name == "bsr_flat_matmul_bf16":  # kernel 1-bf16 also carries the World paths
            launches[f"launches_{WORLD_PATH}"] = world["launches"][name]
            launches[f"launches_per_step_{WORLD_PATH}"] = world["step_launches"][name]
            launches[f"launches_predict_{WORLD_PATH}"] = world["predict_launches"][name]
            launches[f"launches_{WORLD_CLI_PATH}"] = world_cli["launches"][name]
            launches[f"launches_per_epoch_{WORLD_CLI_PATH}"] = (
                world_cli["in_training"][name] / world_cli["epochs"])
            k = {**k, **{f"world_{key}": v for key, v in world["kernels"].items()},
                 "world_operand": f"World merged tiles ({WORLD_N} users), z bf16, F {WORLD_F}"}
        rows.append({"name": name, **meta, **launches, **k, "kernel_ms": k["ms"]})
    rows.append({"name": "dense_3xtf32", "main_path": WORLD_PATH,
                 **{f"launches_per_step_{WORLD_PATH}": {k: world["step_launches"][k] for k in _NO_DENSE},
                    f"launches_predict_{WORLD_PATH}": {k: world["predict_launches"][k] for k in _NO_DENSE}},
                 **{k: v for k, v in dense_run.items() if k != "sweep"}, "sweep": dense_run["sweep"]})
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
