"""A run's result on the CPU at tiny sizes (the harness's look for a card
skipped), and the check's verdict with the timed path broken underneath:
a step that leaves the state unchanged, and half of the batch left out with
the mean taken over the rest, each read ``correct`` false."""

import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import TINY_GEOTEXT, TINY_WORLD, spec_with_geotext

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(workload, override, trace=False, sabotage=None):
    return harness.run(workload, 2**31 + 17, 0.1, trace, device="cpu", override=override,
                       sabotage=sabotage, spec=spec_with_geotext())


def _frozen(cell):
    for g in cell.trainer.optimizer.param_groups:
        g["lr"] = 0.0


def _half_full(cell):
    loss = cell.model.loss

    def half(y, mask, **kw):
        m = mask.clone()
        rows = torch.nonzero(m).ravel()
        m[rows[len(rows) // 2:]] = 0.0
        return loss(y, m, **kw)

    cell.model.loss = half


@pytest.mark.parametrize("trace", [False, True])
def test_full_cell_result_line(trace):
    out = _run("geotext-gcn.full", TINY_GEOTEXT, trace)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    names = set(out["metrics"])
    if trace:
        assert {"data_s", "operands_s", "mfu"} <= names and "breakdown" in out
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert names == {"setup_s", "epoch_ms"}
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload", ["twitter-world-gcn.full", "geotext-gcn.full"])
@pytest.mark.parametrize("fault", [_frozen, _half_full], ids=["unchanged", "half_batch"])
def test_full_cell_fault_reads_incorrect(workload, fault):
    tiny = TINY_WORLD if workload.startswith("twitter") else TINY_GEOTEXT
    out = _run(workload, tiny, sabotage=fault)
    assert out["correct"] is False


def test_world_cell_at_tiny_size_is_close():
    # at N 4,096 and width 16 the bf16 roundings (the gathers, the slab, a dW0
    # summed in bf16) read larger than at World size: hold them to bf16's order
    out = _run("twitter-world-gcn.full", TINY_WORLD)
    assert all(c["value"] < 1e-2 for c in out["checks"].values()), out["checks"]


def test_entry_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the card is here")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "twitter-world-gcn.full",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
