"""The port's CLI with ``--dist`` on 2 spawned gloo ranks (one spawn group;
``tests/test_torch_parallel.py :: spawn_ranks``), against the port's
single-device CLI in this process, at dropout 0 on the synthetic preset:
the loss history at rtol 1e-4 and the dev and test metrics within one user
(the two sum Â·h in other orders); ``--dist --eval-only`` on the trained
run's checkpoint reproduces its metrics exactly; the combinations that
belong to later slices, and ``--dist-devices`` other than the world size,
raise on both ranks before any collective."""

import os

import numpy as np
import pytest

from graphconvgeo_torch import cli
from tests.test_torch_parallel import spawn_ranks

RANKS = 2
EPOCHS = 6
HISTORY_RTOL = 1e-4
BASE = ["--preset", "synthetic", "--device", "cpu", "--dropout", "0", "--hidden", "16", "16",
        "--epochs", str(EPOCHS), "--patience", str(EPOCHS), "--quiet", "--json"]
# name: (extra flags, the exception, what its message names)
REFUSALS = {
    "gat": (["--dist", "--model", "gat", "--heads", "2"], NotImplementedError, "slice B"),
    "factorized": (["--dist", "--adjacency", "factorized"], NotImplementedError, "slice B"),
    "hub_sharded": (["--dist", "--hub-sharded"], NotImplementedError, "slice B"),
    "sampled": (["--dist", "--sampled"], NotImplementedError, "slice C"),
    "dist_devices": (["--dist", "--dist-devices", "3"], ValueError, "3 devices"),
}


def _cli_runs(rank, world, out_dir):
    ckpt = os.path.join(out_dir, "ckpt")
    trained = cli.main([*BASE, "--dist", "--checkpoint-dir", ckpt])
    served = cli.main([*BASE, "--dist", "--checkpoint-dir", ckpt, "--eval-only"])
    refused = {}
    for name, (flags, exc, _) in REFUSALS.items():
        try:
            cli.main([*BASE, *flags])
        except exc as e:
            refused[name] = (type(e).__name__, str(e))
    return dict(trained=trained, served=served, refused=refused)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("cli_ranks")
    ranks = spawn_ranks(RANKS, _cli_runs, out_dir, str(out_dir))
    return ranks, cli.main(BASE)


def _metrics(report):
    return {split: report[split] for split in ("dev", "test")}


def test_cli_dist_matches_single_device(runs):
    ranks, single = runs
    want = [h["loss"] for h in single["run"]["history"]]
    n_dev = 120  # the synthetic preset's dev users (600 users, a fifth)
    for r in ranks:
        got = r["trained"]
        assert _metrics(got) == _metrics(ranks[0]["trained"])  # every rank reports the same
        np.testing.assert_allclose([h["loss"] for h in got["run"]["history"]], want,
                                   rtol=HISTORY_RTOL)
        for split in ("dev", "test"):
            assert abs(got[split]["acc_at_161"] - single[split]["acc_at_161"]) <= 1 / n_dev


def test_cli_dist_run_record(runs):
    ranks, _ = runs
    for rank, r in enumerate(ranks):
        run = r["trained"]["run"]
        assert (run["dist"], run["world_size"], run["rank"]) == (True, RANKS, rank)
        # --halo auto: at 600 users each rank reads as many rows as it owns
        # from its peer (halo_fraction >= 1), so the all-gather is taken
        assert (run["backend"], run["halo"], run["halo_mode"], run["dist_format"]) == (
            "bell", False, "alltoall", "bell")
        assert run["rows_per_device"] * RANKS >= 600 and run["n_tiles"] == 0
        assert len(run["history"]) == EPOCHS


def test_cli_dist_eval_only_reproduces(runs):
    ranks, _ = runs
    for r in ranks:
        assert r["served"]["run"]["history"] == []
        assert _metrics(r["served"]) == _metrics(r["trained"])


@pytest.mark.parametrize("name", list(REFUSALS))
def test_cli_dist_refusals(runs, name):
    ranks, _ = runs
    _, exc, says = REFUSALS[name]
    for r in ranks:
        assert name in r["refused"], f"{name} did not raise"
        kind, msg = r["refused"][name]
        assert kind == exc.__name__ and says in msg
