"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
(nor scikit-learn, optax or orbax), networkx only where it is optional, and
its entry points refuse to run on a machine without CUDA unless asked for
the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    p for p in (ROOT / "graphconvgeo_torch").rglob("*.py") if "_build" not in p.parts
) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "graphconvgeo_tpu", "sklearn", "optax", "orbax")


def _imports(tree):
    """(module name, enclosing function name or None) for every import."""
    out = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            f = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Import):
                out.extend((a.name, f) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module or "", f))
            visit(child, f)

    visit(tree, None)
    return out


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod, func in _imports(tree):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"
        if top == "networkx":
            assert path.name == "reorder.py" and func == "louvain_reordering", (
                f"{path.name} imports networkx outside louvain_reordering"
            )


def test_port_has_the_slice_modules():
    for rel in (
        "data/loader.py", "data/graph.py", "data/kdtree.py", "data/synthetic.py",
        "data/features.py", "data/pipeline.py", "native/__init__.py",
        "native/projection.cpp", "native/clustering.cpp", "sparse/formats.py",
        "sparse/reorder.py", "sparse/factorized.py", "ops/dropout.py", "ops/spmm.py",
        "ops/spmm_bsr.py", "ops/ce_stream.py", "models/gcn.py", "models/convert.py",
        "train/trainer.py", "train/evaluate.py", "utils/logging.py", "cli.py",
        "csrc/bsr_flat.cu", "sparse/attention_tiles.py", "ops/attention.py",
        "ops/attention_tiled.py", "models/gat.py", "csrc/gat_tiled.cu",
        "ops/sddmm.py", "ops/sddmm_bsr.py", "ops/gather.py", "csrc/sddmm_bsr.cu",
        "csrc/gather.cu", "native/sampler.cpp", "data/sampling.py", "ops/scatter_gather.py",
        "models/sampled.py", "train/trainer_sampled.py", "parallel/__init__.py",
        "parallel/mesh.py", "parallel/partition.py", "parallel/spmm_dist.py",
        "parallel/model_dist.py", "parallel/trainer_dist.py", "parallel/gat_dist.py",
        "parallel/factorized_dist.py",
    ):
        path = ROOT / "graphconvgeo_torch" / rel
        assert path.is_file(), rel
        # every Python module of the slice is under test_no_forbidden_imports
        assert path.suffix != ".py" or path in PORT_FILES, rel


def test_entry_points_refuse_without_cuda(monkeypatch):
    from graphconvgeo_torch import cli
    from graphconvgeo_torch.models.gcn import GCNConfig, HighwayGCN
    from graphconvgeo_torch.sparse.formats import SparseGraph
    from graphconvgeo_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    x = sp.random(20, 8, density=0.3, format="csr", dtype=np.float32, random_state=0)
    adj = sp.identity(20, format="csr", dtype=np.float32)
    cfg = GCNConfig(n_features=8, n_classes=3, hidden=(4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        HighwayGCN(cfg, SparseGraph(csr=x), SparseGraph(csr=adj, symmetric=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--preset", "synthetic", "--epochs", "1", "--quiet"])
    for backend in ("ell", "bsr", "oracle"):
        bcfg = GCNConfig(n_features=8, n_classes=3, hidden=(4, 4), spmm_backend=backend)
        with pytest.raises(RuntimeError, match="CUDA"):
            HighwayGCN(bcfg, SparseGraph(csr=x), SparseGraph(csr=adj, symmetric=True))
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--preset", "synthetic", "--backend", backend, "--epochs", "1", "--quiet"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_gat_entry_points_refuse_without_cuda(monkeypatch):
    from graphconvgeo_torch import cli
    from graphconvgeo_torch.models.gat import GATConfig, GraphAttentionNet
    from graphconvgeo_torch.sparse.formats import SparseGraph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = sp.random(20, 8, density=0.3, format="csr", dtype=np.float32, random_state=0)
    adj = sp.identity(20, format="csr", dtype=np.float32)
    for backend in ("bucketed", "tiled"):
        cfg = GATConfig(n_features=8, n_classes=3, hidden=(4, 4), heads=2, att_backend=backend)
        with pytest.raises(RuntimeError, match="CUDA"):
            GraphAttentionNet(cfg, SparseGraph(csr=x), SparseGraph(csr=adj, symmetric=True))
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--preset", "synthetic", "--model", "gat", "--att-backend", backend,
                      "--epochs", "1", "--quiet"])


def test_louvain_skipped_without_networkx(monkeypatch):
    """best_reordering keeps its candidate order and skips Louvain when
    networkx is absent (it is not installed everywhere)."""
    import importlib.util

    from graphconvgeo_torch.sparse import reorder

    calls = []

    def fake_louvain(*a, **k):
        calls.append(1)
        raise RuntimeError("stub")

    def no_labelprop(*a, **k):
        raise RuntimeError("stub")

    monkeypatch.setattr(reorder, "louvain_reordering", fake_louvain)
    monkeypatch.setattr(reorder, "labelprop_reordering", no_labelprop)
    a = sp.random(4000, 4000, density=2e-4, format="csr", dtype=np.float32, random_state=0)
    adj = (a + a.T).tocsr()
    assert reorder.tile_coverage(adj) < 0.5
    assert reorder.best_reordering(adj).method in ("rcm", "identity")
    assert calls == [1]  # Louvain is the candidate after labelprop ...
    real_find_spec = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "networkx" else real_find_spec(name, *a),
    )
    assert reorder.best_reordering(adj).method in ("rcm", "identity")
    assert calls == [1]  # ... and is skipped without networkx
