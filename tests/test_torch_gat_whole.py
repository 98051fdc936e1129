"""The tiled GAT pattern's whole-pattern edge lists and the layer that
walks them.

``TiledAttentionPattern.all_edges`` / ``all_edges_t`` (every edge, the
tiled ones and the bucketed rest's together, by row and by column) are
compared entry for entry with the CSR and the CSC of the pattern's source
matrix, with no rest, with a rest, and on a distributed block (a forced
rest schedule, all-invalid rest rows, ``pad_to``). The layer walks those
lists on every device, on the model's [rows, H·f] arrays with no padded
copy (it saves none): on the card with ``gat_scores`` and kernels 3-5, on
the CPU with their plain versions; the ``cuda`` tests hold the one against
the other, at the World heads and at heads of 3 x 5 columns, and pin where
the kernels' aligned path lets another head's Inf reach a head (they skip
here):

    python -m pytest --noconftest tests/test_torch_gat_whole.py -m cuda

(this file imports no JAX, so it runs without the repository's conftest).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch.data.synthetic import random_mention_projection_graph
from graphconvgeo_torch.ops import attention_tiled as at
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
    ``all_edges`` the forward also covers the rows the tiles leave empty
    (those give m = 0, den = 1, out = 0 over the tiled edges), and a row
    with no rest edge reads as over the tiled edges."""
    a, att = _cases("rest")[0]
    npad, mpad = att.n_row_blocks * att.block, att.n_col_blocks * att.block
    gen = torch.Generator().manual_seed(3)
    s, d = torch.randn(npad, 2, generator=gen), torch.randn(mpad, 2, generator=gen)
    z = torch.randn(a.shape[1], 2 * 75, generator=gen)
    kw = dict(slope=0.2, seed=0, rate=0.0)
    tiled = gat_tile_fwd(att, s, d, z, **kw)
    whole = gat_tile_fwd(att, s, d, z, edges=att.all_edges, **kw)
    n_tiled, n_all = (torch.diff(e.ptr.long()) for e in (att.edges, att.all_edges))
    for n_edges, (out, den, m) in ((n_tiled, tiled), (n_all, whole)):
        none = n_edges == 0
        assert (den[none] == 1).all() and not m[none].any() and not out[none[: att.n_rows]].any()
        assert out[~none[: att.n_rows]].any(1).all()
    assert ((n_all > 0) & (n_tiled == 0)).any()
    same = n_all == n_tiled
    for x, y, rows in zip(whole, tiled, (same[: att.n_rows], same, same)):
        assert torch.equal(x[rows], y[rows])


@pytest.mark.parametrize("heads,f", [(2, 8), (3, 5)])
def test_layer_saves_no_padded_array(heads, f):
    """``_TiledGatCore`` saves z, a_src, a_dst, out and the [rows, H]
    vectors s, d, m, den, and nothing of the head width padded: no [·, H,
    Fp] array, and no wide array but z and out."""
    a, att = _cases("pad_to-schedule")[0]
    n, m_cols = a.shape
    npad, mpad = att.n_row_blocks * att.block, att.n_col_blocks * att.block
    gen = torch.Generator().manual_seed(5)
    z = torch.randn(m_cols, heads * f, generator=gen, requires_grad=True)
    a_src, a_dst = (torch.randn(heads, f, generator=gen, requires_grad=True) for _ in range(2))
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = gat_attention_tiled(att, z, a_src, a_dst, attn_dropout=0.3, seed=7)
    assert sorted(shapes) == sorted([(m_cols, heads * f), (heads, f), (heads, f), (n, heads * f),
                                     (npad, heads), (mpad, heads), (npad, heads), (npad, heads)])
    out.sum().backward()
    assert z.grad.shape == z.shape and torch.isfinite(z.grad).all()


# ---------------------------------------------------------------- the card
# (heads, f): the World configuration's, and 3 x 5 (f and H·f off a multiple
# of 4: the kernels' column-by-column path)
WIDTHS = {"world": (4, 225), "3x5": (3, 5)}
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
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("size", ["geotext", "32k"])
def test_card_layer_matches_the_cpu_layer(card, size, rate, width):
    a = _mention_pattern(**(GEOTEXT if size == "geotext" else P32K))
    cpu_att = TiledAttentionPattern.from_scipy(a)
    att = to_device(cpu_att, card)
    assert att.rest is not None and att.rest_nnz > 0
    gen = torch.Generator().manual_seed(11)
    n = a.shape[0]
    heads, f = WIDTHS[width]
    inputs = [torch.randn(n, heads * f, generator=gen) * 0.5,
              torch.randn(heads, f, generator=gen) * 0.1,
              torch.randn(heads, f, generator=gen) * 0.1,
              torch.randn(n, heads * f, generator=gen)]
    want, cpu_moved = _layer(cpu_att, inputs, rate=rate)
    got, moved = _layer(att, [t.to(card) for t in inputs], rate=rate)
    for name, x, y in zip(("out", "dz", "da_src", "da_dst"), got, want):
        x = x.cpu().double()
        assert torch.isfinite(x).all(), name
        err, scale = float((x - y.double()).abs().max()), float(y.double().abs().max())
        assert err <= REL_TOL * scale, (name, err, scale)
    assert moved["attn_rest_edges"] == cpu_moved["attn_rest_edges"] == 2 * cpu_att.rest_nnz
    kernels = ("gat_scores", "gat_tile_fwd", "gat_tile_bwd_row", "gat_tile_bwd_col")
    assert [moved[k] for k in kernels] == [1, 1, 1, 1]
    # the whole-pattern lists only: the tile lists were never built
    assert "edges" not in vars(att) and "edges_t" not in vars(att)
    assert att.all_edges.nnz == a.nnz


# (heads, f) on the kernels' aligned (float4) path, H·f a multiple of 4: head
# 1 starts inside a quartet that holds head 0's last column
ALIGNED_WIDTHS = {"world": (4, 225), "4x5": (4, 5)}


@pytest.mark.cuda
@pytest.mark.parametrize("width", ALIGNED_WIDTHS)
@pytest.mark.parametrize("operand", ["z", "g"])
def test_card_sweeps_confine_a_neighbouring_heads_inf(card, operand, width):
    """The aligned path uses a row gathered per edge as loaded, its
    neighbouring heads' columns included, so an Inf in head 1's first column
    reaches head 0's dot products as 0·Inf = NaN: in ds on the rows whose
    edges gather that z row (kernel 4), in dd and dz on the columns whose
    edges gather that g row (kernel 5). The plain versions read each head
    alone. Nothing else moves: the forward, heads 2 and 3, and every other
    row and column match the plain versions."""
    a = _mention_pattern(**GEOTEXT)
    cpu_att = TiledAttentionPattern.from_scipy(a)
    att = to_device(cpu_att, card)
    heads, f = ALIGNED_WIDTHS[width]
    n = a.shape[0]
    gen = torch.Generator().manual_seed(13)
    z, g = torch.randn(n, heads * f, generator=gen) * 0.5, torch.randn(n, heads * f, generator=gen)
    a_src, a_dst = (torch.randn(heads, f, generator=gen) * 0.1 for _ in range(2))
    kw = dict(slope=0.2, seed=5, rate=0.0)
    by_row, by_col = dict(edges=cpu_att.all_edges), dict(edges=cpu_att.all_edges_t)
    # the sweeps' narrow inputs from finite operands
    s, d = at.gat_scores_plain(cpu_att, z, a_src, a_dst)
    out, den, m = at.gat_tile_fwd_plain(cpu_att, s, d, z, **by_row, **kw)
    ds, c = at.gat_tile_bwd_row_plain(cpu_att, s, d, m, den, z, g, out, **by_row, **kw)
    # the Inf in the row with the most edges
    csr = sp.csr_matrix(a)
    hub = int(np.argmax(np.diff(csr.indptr)))
    ops = {"z": z, "g": g}
    ops[operand] = ops[operand].clone()
    ops[operand][hub, f] = float("inf")
    zi, gi = ops["z"], ops["g"]
    fwd = (s, d, zi)
    row = (s, d, m, den, zi, gi, out)
    col = (s, d, m, den, c, ds, zi, gi, a_src, a_dst)
    want = {"fwd": at.gat_tile_fwd_plain(cpu_att, *fwd, **by_row, **kw)[0],
            "row": at.gat_tile_bwd_row_plain(cpu_att, *row, **by_row, **kw),
            "col": at.gat_tile_bwd_col_plain(cpu_att, *col, **by_col, **kw)}
    on = lambda args: [t.to(card) for t in args]
    got = {"fwd": at.gat_tile_fwd(att, *on(fwd), edges=att.all_edges, **kw)[0],
           "row": at.gat_tile_bwd_row(att, *on(row), edges=att.all_edges, **kw),
           "col": at.gat_tile_bwd_col(att, *on(col), edges=att.all_edges_t, **kw)}
    # where head 0 turns NaN: the rows whose edges gather z's hub row (ds),
    # the columns whose edges gather g's hub row (dd, dz)
    touched = torch.zeros(max(s.shape[0], d.shape[0]), dtype=torch.bool)
    touched[csr.T.tocsr()[hub].indices if operand == "z" else csr[hub].indices] = True
    nan_in = {"z": {"row.0"}, "g": {"col.0", "col.1"}}[operand]
    outputs = [("fwd", want["fwd"], got["fwd"])]
    outputs += [(f"{k}.{i}", want[k][i], got[k][i]) for k in ("row", "col") for i in (0, 1)]
    for name, y, x in outputs:
        y = y.view(y.shape[0], heads, -1).double()
        x = x.cpu().view(x.shape[0], heads, -1).double()
        nan = torch.zeros(y.shape[:2], dtype=torch.bool)
        if name in nan_in:
            nan[:, 0] = touched[: y.shape[0]]
            assert nan.any() and torch.isfinite(y[nan]).all(), name
            assert torch.isnan(x[nan]).all(), (name, "the documented 0·Inf did not show")
        keep = ~nan
        keep[:, 1] = False  # head 1 holds the Inf itself: non-finite in both
        y, x = y[keep], x[keep]
        assert torch.isfinite(x).all(), (name, "a non-finite value spread further")
        err, scale = float((x - y).abs().max()), float(y.abs().max())
        assert err <= REL_TOL * scale, (name, err, scale)
