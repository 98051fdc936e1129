"""The graph transformer cell (``twitter-us-transformer.full``, family
``graph_transformer``) on the CPU at tiny sizes: its result reads
``correct``, and reads ``correct`` false with the timed path broken
underneath; ``reference/transformer.py``'s first step against the port's
``GraphTransformerNet`` on the benchmark's seeded weights, at dropout 0 and
at the configured dropouts; the reference and family files import no JAX,
the reference no port at all and the family none at module level; on the
card, the controls fail and the program passes::

    python -m pytest portbench/tests/test_portbench_transformer.py -m cuda
"""

import os
import statistics

import pytest
import torch

from portbench import harness
from portbench.calibrate import readings_for_seed
from portbench.tests.test_portbench_gat import _imported
from portbench.tests.test_portbench_run import _frozen, _half_full

CELL = "twitter-us-transformer.full"
CONFIG = "twitter-us-transformer"
TINY = {"generator_params": {"n_users": 4096, "vocab": 20000, "classes": 32, "dev_rows": 200,
                             "train_share": 0.9},
        "model": {"hidden": [16, 16], "heads": 4}}
SEED = 2**31 + 31


def _run(sabotage=None):
    return harness.run(CELL, 2**31 + 19, 0.1, False, device="cpu", override=TINY,
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
    config = harness.load_file(harness.BENCH_DIR, "configs", CONFIG)
    model = dict(TINY["model"])
    if dropouts == "none":
        model.update(dropout=0.0, attn_dropout=0.0)
    override = {"generator_params": {**TINY["generator_params"], "n_users": 2048},
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
    # float32 summation orders differ (the edge walks and the fused [d, 4d]
    # projection against the reference's CSR products and four GEMMs, the
    # gate's rearranged sum, LayerNorm's kernel against its equations): each
    # leaf's gradient to 1e-5 of the larger of its norm and the median leaf's;
    # dW0, rounded to bf16 at the end of the chain, to 1e-4, since a last-bit
    # difference of its float32 cotangent moves an entry by a bf16 step (2^-8)
    med = statistics.median(ref["g1"].values())
    for name, want in ref["g1_tensors"].items():
        diff = float(torch.linalg.vector_norm(prog["g1_tensors"][name].double() - want.double()))
        tol = 1e-4 if name == "input.w" else 1e-5
        assert diff <= tol * max(ref["g1"][name], med), (name, diff, ref["g1"][name])
    assert family.layout_faults(cell.layout, ref["layout"]) == 0


@pytest.mark.parametrize("path,anywhere", [("reference/transformer.py", True),
                                           ("families/graph_transformer.py", False)])
def test_the_transformer_files_import_no_port(path, anywhere):
    full = os.path.join(harness.BENCH_DIR, path)
    assert not _imported(full, True) & {"jax", "jaxlib", "flax", "graphconvgeo_tpu"}
    assert "graphconvgeo_torch" not in _imported(full, anywhere)


@pytest.mark.cuda
def test_controls_fail_and_the_program_passes(card):
    limits = harness.load_file(harness.BENCH_DIR, "limits", CELL)
    small = {"generator_params": {"n_users": 131072}}
    kinds = ["tf32", "bf16attn", "half"]
    for seed in (21, 22):
        got = dict(readings_for_seed(CELL, seed, kinds, device=card, override=small))
        assert all(got["program"][k] <= lim for k, lim in limits.items()), got["program"]
        for kind in kinds:
            assert any(got[kind].get(k, 0) > lim for k, lim in limits.items()), (kind, got[kind])
