"""What the GAT adds to the port's tracing, and the route of its Z product,
on the CPU (no JAX): ``gat_layer``'s Z = h_in·w through ``ops/dense.py ::
matmul`` equals the bare product bit for bit off the card, the
``operands.attention`` span of ``GraphAttentionNet``'s build, and the
``attn_rest_edges`` counter of the tiled layer's bucketed rest."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch.models.gat import GATConfig, GraphAttentionNet
from graphconvgeo_torch.ops.attention import gat_attention, gat_layer
from graphconvgeo_torch.ops.attention_tiled import gat_attention_tiled
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern
from graphconvgeo_torch.sparse.formats import BucketedAttention, SparseGraph, normalize_adjacency
from graphconvgeo_torch.utils import profiling

N = 300
# the pattern's edges outside 128² blocks of 64 or more: the diagonal's last
# 44 (rows 256..299) and three scattered ones
SCATTERED = [(0, 200), (5, 250), (130, 10)]
REST_EDGES = (N - 256) + len(SCATTERED)


def _pattern() -> sp.csr_matrix:
    rows, cols = zip(*SCATTERED)
    a = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(N, N)) + sp.identity(N)
    return sp.csr_matrix(a, dtype=np.float32)


def _graph(seed: int = 0):
    rng = np.random.default_rng(seed)
    a = sp.random(N, N, density=0.02, random_state=rng, format="csr")
    adj = normalize_adjacency(((a + a.T) > 0).astype(np.float32))
    x = sp.random(N, 40, density=0.1, random_state=rng, format="csr", dtype=np.float32)
    return SparseGraph(csr=x), SparseGraph(csr=adj, symmetric=True)


@pytest.mark.parametrize("backend", ["tiled", "bucketed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gat_layer_z_equals_the_bare_product_off_the_card(backend, dtype):
    _, adj = _graph()
    csr = adj.csr
    att = (TiledAttentionPattern.from_scipy(csr, min_tile_nnz=1) if backend == "tiled"
           else BucketedAttention.from_scipy(csr))
    g = torch.Generator().manual_seed(3)
    h_in = torch.randn(N, 24, generator=g).to(dtype)
    w = torch.randn(24, 16, generator=g).to(dtype)
    a_src, a_dst = (torch.randn(4, 4, generator=g).to(dtype) for _ in range(2))
    got = gat_layer(att, h_in, w, a_src, a_dst, attn_dropout=0.5, seed=11)
    want = gat_attention(att, h_in @ w, a_src, a_dst, attn_dropout=0.5, seed=11)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("backend", ["tiled", "bucketed"])
def test_the_attention_operand_build_is_a_span(backend):
    x, adj = _graph()
    cfg = GATConfig(n_features=40, n_classes=3, hidden=(8, 8), heads=2, att_backend=backend)
    profiling.reset_spans()
    GraphAttentionNet(cfg, x, adj, device="cpu")
    recs = profiling.span_records()
    assert [(r.name, r.parent, r.epoch) for r in recs] == [
        ("operands.input", None, None), ("operands.attention", None, None)]
    assert all(r.host_s > 0.0 and r.device_s is None for r in recs)


def test_attn_rest_edges_counts_each_sweep_of_the_rest():
    att = TiledAttentionPattern.from_scipy(_pattern())
    # the two diagonal tiles and a filler each for row block 2 and column block 2
    assert att.rest_nnz == REST_EDGES and att.n_tiles == 4
    g = torch.Generator().manual_seed(5)
    hw = torch.randn(N, 8, generator=g, requires_grad=True)
    a_src, a_dst = torch.randn(2, 4, generator=g), torch.randn(2, 4, generator=g)
    before = profiling.counters["attn_rest_edges"]
    out = gat_attention_tiled(att, hw, a_src, a_dst, attn_dropout=0.3, seed=9)
    assert profiling.counters["attn_rest_edges"] - before == REST_EDGES
    out.sum().backward()
    assert profiling.counters["attn_rest_edges"] - before == 2 * REST_EDGES
    # every edge in a tile: no rest, nothing counted
    full = TiledAttentionPattern.from_scipy(_pattern(), min_tile_nnz=1)
    assert full.rest is None and full.rest_nnz == 0
    gat_attention_tiled(full, hw, a_src, a_dst).sum().backward()
    assert profiling.counters["attn_rest_edges"] - before == 2 * REST_EDGES
