"""The controls on the card (``calibrate.py``), at sizes a test run holds:
the reference in the program's place in the precision below each stated
one (TF32 for the float32 GEMMs; e4m3 for the World cell's bf16 roundings),
and half of the batch left out, each fails one of the cell's numbers; the
program passes them. The GeoText cell is not in ``BENCHMARK.json`` (PERF.md
§7): its files are named directly."""

import pytest

from portbench import harness
from portbench.calibrate import readings_for_seed

CELLS = {"geotext-gcn.full": ("geotext-gcn", "full_30"),
         "twitter-world-gcn.full": ("twitter-world-gcn", "full_5")}
SMALL = {"geotext-gcn.full": {"generator_params": {"n_users": 4000, "n_clusters": 32}},
         "twitter-world-gcn.full": {"generator_params": {"n_users": 262144}}}
CONTROLS = {"geotext-gcn.full": ["tf32"], "twitter-world-gcn.full": ["tf32", "fp8"]}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_controls_fail_and_the_program_passes(card, workload):
    limits = harness.load_file(harness.BENCH_DIR, "limits", workload)
    config, traffic = CELLS[workload]
    for seed in (21, 22, 23):
        kinds = CONTROLS[workload] + ["half"]
        got = dict(readings_for_seed(workload, seed, kinds, device=card, config=config,
                                     traffic=traffic, override=SMALL[workload]))
        assert all(got["program"][k] <= lim for k, lim in limits.items()), got["program"]
        for kind in kinds:
            assert any(got[kind].get(k, 0) > lim for k, lim in limits.items()), (kind, got[kind])
