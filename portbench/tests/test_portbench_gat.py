"""The GAT cell (``twitter-world-gat.full``, family ``gat``) on the CPU at
tiny sizes: its result reads ``correct``, and reads ``correct`` false with
the timed path broken underneath; ``reference/gat.py``'s first step against
the port's ``GraphAttentionNet`` on the benchmark's seeded weights, at
dropout 0 and at the configured dropouts (its input, dense and attention
hashes against the port's); the GAT's reference and family files import no
JAX, the reference no port at all and the family none at module level; on
the card, the controls fail and the program passes::

    python -m pytest portbench/tests/test_portbench_gat.py -m cuda
"""

import ast
import os
import statistics

import pytest
import torch

from portbench import harness
from portbench.calibrate import readings_for_seed
from portbench.tests.test_portbench_run import _frozen, _half_full

CELL = "twitter-world-gat.full"
TINY_WORLD_GAT = {"generator_params": {"n_users": 4096, "vocab": 20000, "classes": 32,
                                       "dev_rows": 200},
                  "model": {"hidden": [16, 16], "heads": 4}}
SEED = 2**31 + 29


def _run(sabotage=None):
    return harness.run(CELL, 2**31 + 17, 0.1, False, device="cpu", override=TINY_WORLD_GAT,
                       sabotage=sabotage)


def test_the_cell_at_tiny_size_reads_correct():
    out = _run()
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "epoch_ms"}
    assert out["checks"]["layout_faults"]["value"] == 0


@pytest.mark.parametrize("fault", [_frozen, _half_full], ids=["unchanged", "half_batch"])
def test_the_cell_with_a_fault_reads_incorrect(fault):
    assert _run(fault)["correct"] is False


@pytest.mark.parametrize("dropouts", ["none", "configured"])
def test_reference_first_step_matches_the_port(dropouts):
    config = harness.load_file(harness.BENCH_DIR, "configs", "twitter-world-gat")
    model = dict(TINY_WORLD_GAT["model"])
    if dropouts == "none":
        model.update(dropout=0.0, attn_dropout=0.0)
    override = {"generator_params": {**TINY_WORLD_GAT["generator_params"], "n_users": 2048},
                "model": model}
    traffic = {"trainer": "full", "job_epochs": 1, "check_steps": 1}
    cell = harness.build(config, traffic, SEED, "cpu", override)
    family = cell.family
    w0 = family.initial_weights(cell.weights, SEED, "cpu")
    cap = harness.Capture(cell, w0, 1)
    harness.run_job(cell)
    prog = cap.close()
    harness.free_program(cell)
    ref = family.reference_readings(family.reference_problem(cell), w0, "cpu", 1)
    assert abs(prog["losses"][0] - ref["losses"][0]) <= 1e-6 * abs(ref["losses"][0])
    # float32 summation orders differ (the tile sweeps, the bucketed rest and
    # the port's einsums against the reference's edge lists and CSR
    # products): each leaf's gradient to 1e-5 of the larger of its norm and
    # the median leaf's
    med = statistics.median(ref["g1"].values())
    for name, want in ref["g1_tensors"].items():
        diff = float(torch.linalg.vector_norm(prog["g1_tensors"][name].double() - want.double()))
        assert diff <= 1e-5 * max(ref["g1"][name], med), (name, diff, ref["g1"][name])
    assert family.layout_faults(cell.layout, ref["layout"]) == 0


def _imported(path: str, anywhere: bool) -> set:
    tree = ast.parse(open(path).read())
    nodes = ast.walk(tree) if anywhere else tree.body
    names = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path,anywhere", [("reference/gat.py", True),
                                           ("families/gat.py", False)])
def test_the_gat_files_import_no_port(path, anywhere):
    full = os.path.join(harness.BENCH_DIR, path)
    assert not _imported(full, True) & {"jax", "jaxlib", "flax", "graphconvgeo_tpu"}
    assert "graphconvgeo_torch" not in _imported(full, anywhere)


@pytest.mark.cuda
def test_controls_fail_and_the_program_passes(card):
    limits = harness.load_file(harness.BENCH_DIR, "limits", CELL)
    small = {"generator_params": {"n_users": 262144}}
    kinds = ["tf32", "bf16attn", "half"]
    for seed in (21, 22):
        got = dict(readings_for_seed(CELL, seed, kinds, device=card, override=small))
        assert all(got["program"][k] <= lim for k, lim in limits.items()), got["program"]
        for kind in kinds:
            assert any(got[kind].get(k, 0) > lim for k, lim in limits.items()), (kind, got[kind])
