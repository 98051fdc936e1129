"""The benchmark's parts on the CPU: its generators, its work counts, its
isolation from JAX and the JAX package, that it finds a configuration, a
mix, a metric and a model family by name, and that the harness names no
model."""

import ast
import hashlib
import json
import os
import re
import shutil

import numpy as np
import pytest

from portbench import counts, harness, problems

BENCH = harness.BENCH_DIR


def test_geotext_generator_is_deterministic_by_seed():
    kw = dict(n_users=600, n_clusters=6, words_per_user=30, mentions_per_user=4,
              cluster_spread_deg=0.3, min_df=2, bucket=30)
    a, b, c = problems.geotext(5, **kw), problems.geotext(5, **kw), problems.geotext(6, **kw)
    assert (a.x != b.x).nnz == 0 and np.array_equal(a.y, b.y)
    assert all(np.array_equal(g, h) for g, h in zip(a.groups, b.groups))
    assert np.array_equal(a.direct_src, b.direct_src) and np.array_equal(a.lat, b.lat)
    assert a.x.shape != c.x.shape or (a.x != c.x).nnz > 0
    # every user's class is a leaf of at most `bucket` training users
    assert np.bincount(a.y[a.train_idx]).max() <= 30
    assert len(a.train_idx) + len(a.dev_idx) + len(a.test_idx) == 600


def test_geotext_data_seed_gives_one_corpus_in_another_order():
    kw = dict(n_users=600, n_clusters=6, words_per_user=30, mentions_per_user=4,
              cluster_spread_deg=0.3, min_df=2, bucket=30, data_seed=0)
    a, b = problems.geotext(1, **kw), problems.geotext(2, **kw)
    assert a.x.shape == b.x.shape and a.x.nnz == b.x.nnz
    assert sorted(map(len, a.groups)) == sorted(map(len, b.groups))
    assert np.array_equal(np.sort(a.y), np.sort(b.y)) and not np.array_equal(a.y, b.y)
    assert np.array_equal(np.sort(a.lat[a.train_idx]), np.sort(b.lat[b.train_idx]))


def test_world_generator_is_deterministic_by_seed_and_copies_the_groups():
    from graphconvgeo_torch.data.synthetic import random_mention_projection_graph

    kw = dict(n_users=3000, vocab=500, classes=16)
    a, b = problems.world(2**31 + 3, **kw), problems.world(2**31 + 3, **kw)
    assert (a.x != b.x).nnz == 0 and np.array_equal(a.y, b.y)
    _, want = random_mention_projection_graph(3000, 11, seed=9, return_structure=True)
    got = problems.mention_groups(3000, 11, seed=9)
    assert len(got) == len(want)
    assert all(np.array_equal(g, w) for g, w in zip(got, want.values()))


def test_counts_match_hand_counts():
    config = {"adjacency": "materialized",
              "model": {"hidden": [4, 4], "highway": True}}
    shapes = {"n": 10, "classes": 3, "x_nnz": 20, "adj_nnz": 30}
    # forward: input 2*20*4; a layer 2*10*4*4 (HW) + 2*30*4 (Â) + 2*10*4*4 (gate);
    # head 2*10*4*3. Epoch: 3 x input + 4 x the rest.
    layer = 320 + 240 + 320
    assert counts.epoch_flops(config, shapes) == 3 * 160 + 4 * (2 * layer + 240)
    b = counts.apply_bound(config, shapes)
    assert b["bytes"] == 8 * 30 + 4 * 11 + 4 * 4 * 10 + 4 * 4 * 10
    assert b["flops"] == 2 * 30 * 4
    fac = {"adjacency": "factorized", "model": {"hidden": [4], "gather_dtype": "bfloat16"}}
    fs = {"n": 10, "classes": 3, "x_nnz": 20, "groups": 2, "memberships": 7}
    fb = counts.apply_bound(fac, fs)
    assert fb["bytes"] == (8 * 7 + 4 * 3 + 2 * 4 * 10 + 4 * 4 * 2) + (
        8 * 7 + 4 * 11 + 2 * 4 * 2 + 4 * 4 * 10)
    assert counts.epoch_flops(fac, fs) == 3 * 160 + 4 * (2 * 10 * 16 + 2 * 14 * 4
                                                        + 2 * 10 * 16 + 2 * 10 * 4 * 3)


@pytest.mark.parametrize("generator", ["world", "geotext"])
def test_factored_reference_is_the_materialized_one_with_the_ports_tiles(generator):
    import torch

    from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency
    from portbench.reference.gcn import Adjacency, FactoredAdjacency

    if generator == "world":
        inp = problems.world(2**31 + 9, n_users=3000, vocab=500, classes=16)
    else:
        inp = problems.geotext(2**31 + 9, n_users=600, n_clusters=6, words_per_user=30,
                               mentions_per_user=4, cluster_spread_deg=0.3, min_df=2,
                               bucket=30)
    n, direct = inp.n, (inp.direct_src, inp.direct_dst)
    layout = harness.load_file(BENCH, "configs", "twitter-world-gcn")["layout"]
    fa = FactoredAdjacency(n, inp.groups, direct, "cpu", layout, None)
    h = torch.randn(n, 8, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(fa.apply(h), Adjacency(n, inp.groups, direct, "cpu").apply(h),
                               rtol=1e-5, atol=1e-6)
    stats = FactorizedAdjacency.from_groups(dict(enumerate(inp.groups)), n,
                                            direct=direct).stats()
    assert fa.tiles == {"bt": stats["bt_tiles"], "zr": stats["zr_tiles"]}
    assert generator == "geotext" or fa.tiles["bt"] > 0


def test_layout_faults_count_each_part_that_differs():
    layout_faults = harness.load_family(BENCH, {"family": "highway_gcn"}).layout_faults
    prog = {"slab_cols": np.arange(4), "hot_ids": None, "bt_tiles": 3, "zr_tiles": 5}
    assert layout_faults(prog, dict(prog)) == 0
    assert layout_faults(prog, {**prog, "slab_cols": np.arange(1, 5)}) == 1
    assert layout_faults(prog, {**prog, "hot_ids": np.arange(2), "zr_tiles": 6}) == 2
    assert layout_faults(prog, {**prog, "bt_tiles": None}) == 0


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_and_the_reference_imports_no_port():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            names = set(_imports(path))
            assert not names & {"jax", "jaxlib", "flax", "graphconvgeo_tpu"}, path
            if os.sep + "reference" + os.sep in path:
                assert "graphconvgeo_torch" not in names, path


def test_spec_names_existing_files():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        harness.load_file(BENCH, "configs", w["config"])
        harness.load_file(BENCH, "traffic", w["traffic"])
        harness.load_file(BENCH, "limits", w["name"])
    for m in spec["per_layer"]:
        assert callable(harness.load_reader(BENCH, m["name"]))
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for name in os.listdir(os.path.join(BENCH, "configs")):
        config = harness.load_file(BENCH, "configs", name[: -len(".json")])
        assert all(hasattr(harness.load_family(BENCH, config), a) for a in harness.FAMILY_API)


def test_the_harness_names_no_model():
    words = ("HighwayGCN", "GCNConfig", "GraphAttentionNet", "GATConfig", "reference.gcn",
             "gate_bias", "models.gcn", "models.gat")
    for f in ("harness.py", "calibrate.py"):
        text = open(os.path.join(BENCH, f)).read()
        assert not [w for w in words if w in text], f


@pytest.mark.parametrize("family", [None, "", "no_such_family", "../metrics/mfu"])
def test_a_configuration_without_its_family_is_refused(family):
    from portbench.tests.conftest import TINY_GEOTEXT

    config = harness.load_file(BENCH, "configs", "geotext-gcn")
    if family is None:
        del config["family"]
    else:
        config["family"] = family
    traffic = harness.load_file(BENCH, "traffic", "full_30")
    with pytest.raises(harness.RunError, match="family"):
        harness.build(config, traffic, 1, "cpu", TINY_GEOTEXT)


def _bench_files() -> dict:
    out = {}
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[path] = hashlib.sha256(fh.read()).hexdigest()
    return out


# a second family as a file alone: the Highway-GCN's functions, with one
# more shape (its parameter count) and one more count (their bytes), which
# the temporary bench's metric reads
WRAPPED_FAMILY = """
from portbench import harness

_base = harness.load_module(harness.BENCH_DIR, "families", "highway_gcn")
globals().update({k: v for k, v in vars(_base).items() if not k.startswith("__")})


def shapes(config, inputs, ds, model):
    n_params = sum(p.numel() for p in model.parameters())
    return {**_base.shapes(config, inputs, ds, model), "n_params": n_params}


def counts(config, shapes):
    return {**_base.counts(config, shapes), "param_bytes": 4 * shapes["n_params"]}
"""


@pytest.mark.parametrize("family", ["highway_gcn", "wrapped"])
def test_a_config_mix_and_metric_added_as_files_are_found_by_name(tmp_path, capsys, family):
    from portbench.tests.conftest import TINY_GEOTEXT

    before = _bench_files()
    bench = tmp_path / "bench"
    for kind in ("configs", "traffic", "limits", "metrics", "families"):
        (bench / kind).mkdir(parents=True)
    config = harness.load_file(BENCH, "configs", "geotext-gcn")
    config["family"] = family
    (bench / "configs" / "dummy-gcn.json").write_text(json.dumps(config))
    if family == "wrapped":
        (bench / "families" / "wrapped.py").write_text(WRAPPED_FAMILY)
        (bench / "metrics" / "param_bytes.py").write_text(
            "def read(rec):\n    return float(rec['param_bytes'])\n")
    else:
        shutil.copy(os.path.join(BENCH, "families", "highway_gcn.py"), bench / "families")
    (bench / "traffic" / "tiny.json").write_text(json.dumps(
        {"trainer": "full", "job_epochs": 4, "check_steps": 3}))
    shutil.copy(os.path.join(BENCH, "limits", "geotext-gcn.full.json"),
                bench / "limits" / "dummy-gcn.tiny.json")
    (bench / "metrics" / "dummy_epochs.py").write_text(
        "def read(rec):\n    return float(rec['traced']['epochs'])\n")
    (bench / "metrics" / "silent.py").write_text("def read(rec):\n    return None\n")
    spec = {"configs": [], "workloads": [{"name": "dummy-gcn.tiny", "config": "dummy-gcn", "traffic": "tiny",
                           "chips": 1, "why": "test"}],
            "end_to_end": [{"name": "setup_s", "unit": "s"}, {"name": "epoch_ms", "unit": "ms"}],
            "per_layer": [{"name": "dummy_epochs", "unit": "1"}, {"name": "silent", "unit": "1"}]}
    if family == "wrapped":
        spec["per_layer"].append({"name": "param_bytes", "unit": "B"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.run("dummy-gcn.tiny", 3, 0.1, True, device="cpu", root=str(tmp_path),
                      bench_dir=str(bench), override=TINY_GEOTEXT)
    assert out["metrics"]["dummy_epochs"]["value"] == 4.0
    assert "silent" not in out["metrics"]
    assert out["correct"] is True
    if family == "wrapped":
        n_params = int(re.search(r"'n_params': (\d+)", capsys.readouterr().err).group(1))
        assert out["metrics"]["param_bytes"]["value"] == 4.0 * n_params > 0
    assert _bench_files() == before
