"""The tiled GAT pattern's whole-pattern edge lists and the layer that
walks them.

``TiledAttentionPattern.all_edges`` / ``all_edges_t`` (every edge, the
tiled ones and the bucketed rest's together, by row and by column) are
compared entry for entry with the CSR and the CSC of the pattern's source
matrix, with no rest, with a rest, and on a distributed block (a forced
rest schedule, all-invalid rest rows, ``pad_to``). The layer walks those
lists on every device: on the card with kernels 3-5, on the CPU with their
plain versions; the ``cuda`` test holds the one against the other (and
skips here):

    python -m pytest --noconftest tests/test_torch_gat_whole.py -m cuda

(this file imports no JAX, so it runs without the repository's conftest).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch.data.synthetic import random_mention_projection_graph
from graphconvgeo_torch.ops.attention_tiled import gat_attention_tiled, gat_tile_fwd
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern
from graphconvgeo_torch.sparse.formats import (
    attention_schedule,
    normalize_adjacency,
    split_dense_tiles,
    to_device,
)
from graphconvgeo_torch.sparse.reorder import best_reordering
from graphconvgeo_torch.utils import cuda_build, profiling

BLOCK, MIN_NNZ = 32, 50  # the small patterns' tiles


def _clique_pattern(n=80, n_cols=None, seed=7):
    """One dense 24-clique (tiles) over scattered symmetric edges and
    self-loops (the rest); ``n_cols`` > n appends empty columns (halo
    slots)."""
    a = sp.random(n, n, density=0.01, format="lil", random_state=seed)
    a[:24, :24] = 1.0
    a = a.tocsr()
    a = (a + a.T + sp.identity(n, format="csr")).tocsr()
    a.data[:] = 1.0
    if n_cols is not None:
        a = sp.hstack([a, sp.csr_matrix((n, n_cols - n))]).tocsr()
    a.sort_indices()
    return a


def _tiled_only_pattern(n=96):
    """Three dense 32-square diagonal blocks: every edge in a tile, no rest."""
    return sp.block_diag([np.ones((BLOCK, BLOCK))] * (n // BLOCK), format="csr")


def _rank_blocks():
    """Two blocks of a distributed GAT's extended pattern (80 rows, 96
    columns) as ``parallel.partition.build_attention_operands`` builds them:
    each rest on the schedule shared by both residuals, the tiles padded to
    one count. Block 1 is all tiles, so its rest holds only all-invalid
    rows; block 0's has padding rows in some buckets."""
    blocks = [_clique_pattern(n_cols=96),
              sp.hstack([_tiled_only_pattern(96)[:80, :80], sp.csr_matrix((80, 16))]).tocsr()]
    resids = [split_dense_tiles(b, block=BLOCK, min_tile_nnz=MIN_NNZ)[1] for b in blocks]
    sched = attention_schedule([np.diff(r.indptr) for r in resids])
    sched_t = attention_schedule([np.bincount(r.indices, minlength=96) for r in resids])
    ops = [TiledAttentionPattern.from_scipy(b, block=BLOCK, min_tile_nnz=MIN_NNZ,
                                            rest_schedule=sched, rest_schedule_t=sched_t)
           for b in blocks]
    t_max = max(o.n_tiles for o in ops) + 2
    return list(zip(blocks, [o.pad_to(t_max) for o in ops]))


def _cases(name):
    if name == "no-rest":
        a = _tiled_only_pattern()
        return [(a, TiledAttentionPattern.from_scipy(a, block=BLOCK, min_tile_nnz=MIN_NNZ))]
    if name == "rest":
        a = _clique_pattern()
        return [(a, TiledAttentionPattern.from_scipy(a, block=BLOCK, min_tile_nnz=MIN_NNZ))]
    return _rank_blocks()


def _compressed(mat, n_padded):
    """(ptr over n_padded rows, idx) of a scipy matrix's CSR."""
    csr = sp.csr_matrix(mat)
    csr.sort_indices()
    ptr = np.r_[csr.indptr, np.full(n_padded - csr.shape[0], csr.indptr[-1])]
    return ptr, csr.indices


@pytest.mark.parametrize("name", ["no-rest", "rest", "pad_to-schedule"])
def test_all_edges_are_the_patterns_csr_and_csc(name):
    for a, att in _cases(name):
        npad, mpad = att.n_row_blocks * att.block, att.n_col_blocks * att.block
        for got, want in ((att.all_edges, _compressed(a, npad)),
                          (att.all_edges_t, _compressed(sp.csr_matrix(a).T, mpad))):
            assert got.ptr.dtype == got.idx.dtype == torch.int32
            np.testing.assert_array_equal(got.ptr.numpy(), want[0])
            np.testing.assert_array_equal(got.idx.numpy(), want[1])
        # the tiled and the rest's edges: disjoint, and together every edge
        assert att.all_edges.nnz == att.edges.nnz + att.rest_nnz == a.nnz
        if att.rest is None:
            assert att.all_edges is att.edges and att.all_edges_t is att.edges_t
        else:
            assert att.all_edges is att.all_edges and att.all_edges_t is att.all_edges_t
    if name == "pad_to-schedule":
        blocks = _rank_blocks()
        assert blocks[1][1].rest is not None and blocks[1][1].rest_nnz == 0
        assert any((v == 0).all(1).any() for v in blocks[0][1].rest.valid)


def test_cpu_wrappers_walk_a_given_edge_list():
    """On the CPU ``edges=`` picks the list the plain walk sweeps: over
    ``all_edges`` the forward also covers the rows the tiles leave empty,
    and a row with no rest edge reads as over the tiled edges."""
    a, att = _cases("rest")[0]
    npad, mpad = att.n_row_blocks * att.block, att.n_col_blocks * att.block
    gen = torch.Generator().manual_seed(3)
    s, d = torch.randn(npad, 2, generator=gen), torch.randn(mpad, 2, generator=gen)
    z = torch.randn(mpad, 2, 128, generator=gen)
    kw = dict(slope=0.2, seed=0, rate=0.0)
    tiled = gat_tile_fwd(att, s, d, z, **kw)
    whole = gat_tile_fwd(att, s, d, z, edges=att.all_edges, **kw)
    n_tiled, n_all = (torch.diff(e.ptr.long()) for e in (att.edges, att.all_edges))
    for n_edges, (_, den, m) in ((n_tiled, tiled), (n_all, whole)):
        assert torch.equal(den[:, 0] > 0, n_edges > 0) and torch.equal(m > -5e29, den > 0)
    assert ((n_all > 0) & (n_tiled == 0)).any()
    same = n_all == n_tiled
    for x, y in zip(whole, tiled):
        assert torch.equal(x[same], y[same])


# ---------------------------------------------------------------- the card
HEADS, F = 4, 225  # the World configuration's heads: Fp 256, two passes a head
GEOTEXT = dict(n=9475, n_comm=37, seed=3)
P32K = dict(n=32768, n_comm=128, seed=7)
REL_TOL = 1e-4  # of each output's largest entry, as chip_smoke.py's kernel checks


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return "cuda"


def _mention_pattern(n, n_comm, seed):
    """A projected mention graph, normalized and reordered as the GAT's
    operand is (chip_smoke.py's 32k pattern at other sizes)."""
    adj = random_mention_projection_graph(n, n_comm, seed=seed)
    perm = np.random.default_rng(seed).permutation(n)
    a_hat = normalize_adjacency(adj[perm][:, perm].tocsr())
    return best_reordering(a_hat, seed=0).permute_graph(a_hat)


def _layer(att, inputs, *, rate):
    """The layer's output and gradients in z, a_src, a_dst, with the
    counters' and the launches' moves over one forward and backward."""
    z, a_src, a_dst, g = (t.detach().clone().requires_grad_(i < 3) for i, t in enumerate(inputs))
    before = dict(profiling.counters)
    launched = dict(cuda_build.launch_counts)
    out = gat_attention_tiled(att, z, a_src, a_dst, attn_dropout=rate, seed=2147483659)
    out.backward(g)
    moved = {k: v - before[k] for k, v in profiling.counters.items()}
    moved.update({k: v - launched.get(k, 0) for k, v in cuda_build.launch_counts.items()})
    return [out.detach(), z.grad, a_src.grad, a_dst.grad], moved


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("size", ["geotext", "32k"])
def test_card_layer_matches_the_cpu_layer(card, size, rate):
    a = _mention_pattern(**(GEOTEXT if size == "geotext" else P32K))
    cpu_att = TiledAttentionPattern.from_scipy(a)
    att = to_device(cpu_att, card)
    assert att.rest is not None and att.rest_nnz > 0
    gen = torch.Generator().manual_seed(11)
    n = a.shape[0]
    inputs = [torch.randn(n, HEADS * F, generator=gen) * 0.5,
              torch.randn(HEADS, F, generator=gen) * 0.1,
              torch.randn(HEADS, F, generator=gen) * 0.1,
              torch.randn(n, HEADS * F, generator=gen)]
    want, cpu_moved = _layer(cpu_att, inputs, rate=rate)
    got, moved = _layer(att, [t.to(card) for t in inputs], rate=rate)
    for name, x, y in zip(("out", "dz", "da_src", "da_dst"), got, want):
        x = x.cpu().double()
        assert torch.isfinite(x).all(), name
        err, scale = float((x - y.double()).abs().max()), float(y.double().abs().max())
        assert err <= REL_TOL * scale, (name, err, scale)
    assert moved["attn_rest_edges"] == cpu_moved["attn_rest_edges"] == 2 * cpu_att.rest_nnz
    assert [moved[k] for k in ("gat_tile_fwd", "gat_tile_bwd_row", "gat_tile_bwd_col")] == [1, 1, 1]
    # the whole-pattern lists only: the tile lists were never built
    assert "edges" not in vars(att) and "edges_t" not in vars(att)
    assert att.all_edges.nnz == a.nnz
