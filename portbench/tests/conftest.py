"""Fixtures of the benchmark's own tests. ``cuda`` marks a test that needs
the card; the ``card`` fixture decides at run time and skips here."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (runs on the card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return "cuda"


# tiny sizes of the two generators, for the CPU
TINY_GEOTEXT = {"generator_params": {"n_users": 600, "n_clusters": 6, "words_per_user": 30,
                                     "mentions_per_user": 4, "cluster_spread_deg": 0.3,
                                     "min_df": 2, "bucket": 30},
                "model": {"hidden": [16, 16]}}
TINY_WORLD = {"generator_params": {"n_users": 4096, "vocab": 20000, "classes": 32,
                                   "dev_rows": 200},
              "model": {"hidden": [16, 16]}}


def spec_with_geotext() -> dict:
    """``BENCHMARK.json`` with the GeoText full-graph cell added (its
    configuration, traffic and limits files are the benchmark's; the cell is
    not, PERF.md §7) and reporting every metric."""
    from portbench import harness

    spec = harness.load_spec()
    spec["workloads"].append({"name": "geotext-gcn.full", "config": "geotext-gcn",
                              "traffic": "full_30", "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + ["geotext-gcn.full"]
    spec["per_layer"].append({"name": "data_s", "unit": "s"})
    return spec
