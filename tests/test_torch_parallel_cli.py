"""The port's CLI with ``--dist`` on 2 spawned gloo ranks (one spawn group;
``tests/test_torch_parallel.py :: spawn_ranks``), against the port's
single-device CLI in this process, at dropout 0 on the synthetic preset:
the Highway-GCN, the GAT (bucketed and ``--att-backend tiled``) and the
Highway-GCN on the factorized adjacency (with and without
``--hub-sharded``). Each run's loss history at rtol 1e-4 and its dev and
test metrics within one user of the single-device run's (the two sum in
other orders); ``--dist --eval-only`` on each trained run's checkpoint
reproduces its metrics exactly; ``--dist-devices`` other than the world
size raises on both ranks before any collective; ``--dist --model gat
--adjacency factorized`` exits in ``parse_args`` with the JAX CLI's
message.

``--sampled --dist`` (data-parallel sampled training, ``--batch`` the
global count) runs in the same group against the JAX CLI's ``--sampled
--dist --dist-devices 2`` in this process (its ``run_one``, which returns
the history): the loss history at rtol 1e-4, dev and test metrics within
one user. The two packages draw their initial parameters from different
generators, so the ranks start from the parameters the JAX CLI's trainer
draws (``key(seed)`` split, as its ``fit`` does), given to the port's
trainer as ``fit``'s ``params``; everything else is the CLI's own. Its
``--eval-only`` reproduces its metrics exactly."""

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
# name: the model's flags, with and without --dist
MODELS = {
    "gcn": [],
    "gat": ["--model", "gat", "--heads", "2"],
    "gat_tiled": ["--model", "gat", "--heads", "2", "--att-backend", "tiled"],
    "factorized": ["--adjacency", "factorized"],
    "hub_sharded": ["--adjacency", "factorized", "--hub-sharded"],
}
# name: (extra flags, the exception, what its message names)
REFUSALS = {
    "dist_devices": (["--dist", "--dist-devices", "3"], ValueError, "3 devices"),
}
SAMPLED = ["--sampled", "--batch", "128"]  # 64 targets a rank and step
PARSE_REFUSAL = ["--preset", "synthetic", "--dist", "--model", "gat", "--adjacency", "factorized"]


def _sampled_runs(out_dir, params):
    """``--sampled --dist`` from ``params`` (see the module docstring), then
    its ``--eval-only``."""
    from graphconvgeo_torch.parallel.sampled_dist import DistSampledTrainer

    fit = DistSampledTrainer.fit
    DistSampledTrainer.fit = lambda self, *a, **kw: fit(self, *a, **{**kw, "params": params})
    ckpt = os.path.join(out_dir, "ckpt_sampled")
    try:
        trained = cli.main([*BASE, *SAMPLED, "--dist", "--checkpoint-dir", ckpt])
    finally:
        DistSampledTrainer.fit = fit
    served = cli.main([*BASE, *SAMPLED, "--dist", "--checkpoint-dir", ckpt, "--eval-only"])
    return dict(trained=trained, served=served)


def _cli_runs(rank, world, out_dir, sampled_params):
    runs = {}
    for name, flags in MODELS.items():
        ckpt = os.path.join(out_dir, f"ckpt_{name}")
        trained = cli.main([*BASE, *flags, "--dist", "--checkpoint-dir", ckpt])
        served = cli.main([*BASE, *flags, "--dist", "--checkpoint-dir", ckpt, "--eval-only"])
        runs[name] = dict(trained=trained, served=served)
    runs["sampled"] = _sampled_runs(out_dir, sampled_params)
    refused = {}
    for name, (flags, exc, _) in REFUSALS.items():
        try:
            cli.main([*BASE, *flags])
        except exc as e:
            refused[name] = (type(e).__name__, str(e))
    return dict(runs=runs, refused=refused)


def _jax_sampled_dist():
    """The JAX CLI's ``--sampled --dist --dist-devices 2`` run (its history
    and dev / test metrics) and the initial parameters its trainer draws,
    in the port's names."""
    import jax

    from graphconvgeo_torch.models.convert import params_from_jax
    from graphconvgeo_tpu import cli as j_cli
    from graphconvgeo_tpu.models.gcn import init_gcn_params

    flags = [a for a in BASE if a not in ("--device", "cpu")]
    args = j_cli.parse_args([*flags, *SAMPLED, "--dist", "--dist-devices", str(RANKS)])
    ds = j_cli.load_dataset(args)
    init_key = jax.random.split(jax.random.key(args.seed))[1]  # DistSampledTrainer.fit's
    params = init_gcn_params(init_key, j_cli._model_config(args, ds))
    out, dev, test = j_cli.run_one(args, ds)
    return dict(history=out["history"], dev=dev, test=test), params_from_jax(
        jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("cli_ranks")
    jax_sampled, params = _jax_sampled_dist()
    ranks = spawn_ranks(RANKS, _cli_runs, out_dir, str(out_dir), params)
    singles = {name: cli.main([*BASE, *flags]) for name, flags in MODELS.items()}
    return ranks, {**singles, "sampled": jax_sampled}


def _metrics(report):
    return {split: report[split] for split in ("dev", "test")}


SLICE_B = ["gat", "gat_tiled", "factorized", "hub_sharded"]


def _check_matches_single_device(runs, name):
    ranks, singles = runs
    single = singles[name]
    want = [h["loss"] for h in single["run"]["history"]]
    n_dev = 120  # the synthetic preset's dev users (600 users, a fifth)
    for r in ranks:
        got = r["runs"][name]["trained"]
        assert _metrics(got) == _metrics(ranks[0]["runs"][name]["trained"])  # every rank reports the same
        np.testing.assert_allclose([h["loss"] for h in got["run"]["history"]], want,
                                   rtol=HISTORY_RTOL)
        for split in ("dev", "test"):
            assert abs(got[split]["acc_at_161"] - single[split]["acc_at_161"]) <= 1 / n_dev


def test_cli_dist_matches_single_device(runs):
    _check_matches_single_device(runs, "gcn")


@pytest.mark.parametrize("name", SLICE_B)
def test_cli_dist_slice_b_matches_single_device(runs, name):
    """--dist --model gat (bucketed, tiled), --dist --adjacency factorized
    (with and without --hub-sharded) against the single-device CLI."""
    _check_matches_single_device(runs, name)


def test_cli_dist_run_record(runs):
    ranks, _ = runs
    for rank, r in enumerate(ranks):
        run = r["runs"]["gcn"]["trained"]["run"]
        assert (run["dist"], run["world_size"], run["rank"]) == (True, RANKS, rank)
        # --halo auto: at 600 users each rank reads as many rows as it owns
        # from its peer (halo_fraction >= 1), so the all-gather is taken
        assert (run["backend"], run["halo"], run["halo_mode"], run["dist_format"]) == (
            "bell", False, "alltoall", "bell")
        assert run["rows_per_device"] * RANKS >= 600 and run["n_tiles"] == 0
        assert len(run["history"]) == EPOCHS


@pytest.mark.parametrize("name", SLICE_B)
def test_cli_dist_run_record_of_slice_b(runs, name):
    """The GAT runs record their attention operand (the tiled one its
    tiles on the rank's extended pattern); the factorized runs their
    adjacency and hub sharding."""
    ranks, _ = runs
    for rank, r in enumerate(ranks):
        run = r["runs"][name]["trained"]["run"]
        assert (run["world_size"], run["rank"], len(run["history"])) == (RANKS, rank, EPOCHS)
        if name.startswith("gat"):
            assert run["model"] == "gat" and run["halo"] and run["adjacency"] == "materialized"
            tiled = name == "gat_tiled"
            assert run["att_backend"] == ("tiled" if tiled else "bucketed")
            assert run["dist_format"] == ("tiled" if tiled else "bell")
            assert (run["n_tiles"] > 0) == tiled
            assert run["tiled_edges" if tiled else "rest_edges"] > 0
        else:
            assert (run["adjacency"], run["hub_sharded"]) == ("factorized", name == "hub_sharded")


def _check_eval_only(runs, name):
    ranks, _ = runs
    for r in ranks:
        served, trained = r["runs"][name]["served"], r["runs"][name]["trained"]
        assert served["run"]["history"] == []
        assert _metrics(served) == _metrics(trained)


def test_cli_dist_eval_only_reproduces(runs):
    _check_eval_only(runs, "gcn")


@pytest.mark.parametrize("name", SLICE_B)
def test_cli_dist_slice_b_eval_only_reproduces(runs, name):
    _check_eval_only(runs, name)


def test_cli_dist_gat_factorized_exits_in_parse_args(capsys):
    """--dist --model gat --adjacency factorized exits in parse_args with
    the JAX CLI's message (before any process group)."""
    from graphconvgeo_tpu import cli as j_cli

    messages = []
    for parse in (cli.parse_args, j_cli.parse_args):
        with pytest.raises(SystemExit) as exc:
            parse(PARSE_REFUSAL)
        assert exc.value.code == 2
        messages.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[-1])
    assert messages[0] == messages[1] == "--dist --model gat needs --adjacency materialized"


def test_cli_sampled_dist_matches_jax_cli(runs):
    """--sampled --dist on 2 ranks against the JAX CLI's --sampled --dist
    --dist-devices 2: the loss history at rtol 1e-4, dev and test Acc@161
    within one user; each rank samples --batch / 2 targets a step."""
    ranks, singles = runs
    want = singles["sampled"]
    n_users = 120  # the synthetic preset's dev (and test) users
    for rank, r in enumerate(ranks):
        got = r["runs"]["sampled"]["trained"]
        run = got["run"]
        assert (run["sampled"], run["dist"], run["world_size"], run["rank"]) == (
            True, True, RANKS, rank)
        assert (run["sampler"], run["batch"]) == ("native", 128 // RANKS)
        assert _metrics(got) == _metrics(ranks[0]["runs"]["sampled"]["trained"])
        np.testing.assert_allclose([h["loss"] for h in run["history"]],
                                   [h["loss"] for h in want["history"]], rtol=HISTORY_RTOL)
        for split in ("dev", "test"):
            assert abs(got[split]["acc_at_161"] - want[split]["acc_at_161"]) <= 1 / n_users


def test_cli_sampled_dist_eval_only_reproduces(runs):
    _check_eval_only(runs, "sampled")


@pytest.mark.parametrize("name", list(REFUSALS))
def test_cli_dist_refusals(runs, name):
    ranks, _ = runs
    _, exc, says = REFUSALS[name]
    for r in ranks:
        assert name in r["refused"], f"{name} did not raise"
        kind, msg = r["refused"][name]
        assert kind == exc.__name__ and says in msg
