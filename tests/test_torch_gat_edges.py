"""The tiled GAT's edge lists and the edge route of its three kernels,
against the JAX package.

``TiledAttentionPattern.edges`` / ``edges_t`` (what the CUDA kernels walk)
are compared exactly with the nonzeros of the JAX pattern's unpacked masks,
in row and in column order. The edge route — the kernels' algorithm in
torch ops, standing in for them on the CPU: a segment max, exp and
``index_add`` over ``edges`` for the forward and ds, over ``edges_t`` for dz
and dd, gathering only the head's first f columns — is held to the JAX
Pallas kernels ``_tile_fwd_fused``, ``_tile_bwd_row`` and ``_tile_bwd_col``
(interpret mode) at the tolerances of ``test_torch_gat_tiled.py``: m equal;
o and den at rtol 1e-5, atol 1e-6; ds, dz and dd at rtol 1e-4, atol 1e-5
(the same float32 products summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch.ops import attention_tiled as t_at
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern as TTiled
from graphconvgeo_torch.sparse.formats import to_device
from graphconvgeo_torch.utils import cuda_build, profiling
from graphconvgeo_tpu.ops import attention_tiled as j_at
from graphconvgeo_tpu.sparse.attention_tiles import TiledAttentionPattern as JTiled
from tests.test_attention_tiled import _mk
from tests.test_torch_gat_operands import _isolated_rows_pattern

SLOPE = 0.2
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
SEED = 1234567
HEADS, F, FP = 2, 8, 16  # FP: the padded head width; columns F.. are zero
HOT = 150.0  # column 0's d in the hot-column case: far above every edge's score
PATTERNS = ["tiles+rest", "isolated-rows", "empty-block", "hot-column"]


def _empty_block_pattern(n=100, b=32):
    """Self-loops outside block 1 plus one edge pair across blocks: row and
    column block 1 hold no edge (filler tiles only)."""
    keep = np.r_[0:b, 2 * b : n]
    rows, cols = np.r_[keep, 2, 80], np.r_[keep, 80, 2]
    return sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n)).tocsr()


def _hot_column_pattern(n=100):
    """A clique on nodes 1..40 (dense tiles) over sparse random edges; node
    0 has only its self-loop, so column 0 is masked in the clique's rows."""
    a = sp.random(n, n, density=0.01, format="lil", dtype=np.float32, random_state=3)
    a[1:41, 1:41] = 1.0
    a = (a.tocsr() + a.T.tocsr() + sp.identity(n, format="csr", dtype=np.float32)).tolil()
    a[0, 1:] = 0.0
    a[1:, 0] = 0.0
    a = a.tocsr()
    a.eliminate_zeros()
    a.data[:] = 1.0
    return a


def _pattern(name, rng):
    if name == "isolated-rows":
        return _isolated_rows_pattern(), dict(block=32, min_tile_nnz=2)
    if name == "empty-block":
        return _empty_block_pattern(), dict(block=32, min_tile_nnz=2)
    if name == "hot-column":
        return _hot_column_pattern(), dict(block=32, min_tile_nnz=50)
    return _mk(rng, n=80)[0], dict(block=32, min_tile_nnz=50)


def _jax_edges(bits, rowblk, colblk, block, n_padded, *, by_column):
    """(ptr, idx) from a JAX pattern's packed masks, unpacked in numpy."""
    bits = np.asarray(bits).view(np.uint32)
    w = block // 32
    i = np.arange(block)
    mask = (bits[:, i % w, :] >> (i // w).astype(np.uint32)[None, :, None]) & 1
    t, ti, tj = np.nonzero(mask)
    rows = np.asarray(rowblk)[t].astype(np.int64) * block + ti
    cols = np.asarray(colblk)[t].astype(np.int64) * block + tj
    major, minor = (cols, rows) if by_column else (rows, cols)
    order = np.lexsort((minor, major))
    ptr = np.r_[0, np.cumsum(np.bincount(major, minlength=n_padded))]
    return ptr, minor[order]


def _sweep_inputs(att, rng, *, hot=False):
    """s, d, z, c, g as the sweeps take them; z and g zero past column F."""
    npad, mpad = att.n_row_blocks * att.block, att.n_col_blocks * att.block
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    pad = lambda a: np.concatenate([a, np.zeros(a.shape[:2] + (FP - F,), np.float32)], 2)
    x = dict(s=f32(npad, HEADS), d=f32(mpad, HEADS), z=pad(f32(mpad, HEADS, F)),
             c=f32(npad, HEADS), g=pad(f32(npad, HEADS, F)))
    if hot:
        x["d"][0] = HOT
    return x


def _edge_keep(att, rows, cols, seed, rate):
    """[nnz, H] keep/(1−rate) of the edges (rows[k], cols[k])."""
    return t_at._rest_keep(rows, cols[:, None], seed, heads=HEADS, n_cols=att.n_cols,
                           head_stride=att.n_rows * att.n_cols, rate=rate)[..., 0].t()


def _segments(edges):
    """(major index of each entry, its minor index), int64."""
    n = edges.ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n), torch.diff(edges.ptr.long())), edges.idx.long()


def _route_fwd(att, s, d, z, *, f, seed, rate, edges=None):
    """What gat_edge_fwd_kernel computes, in torch ops over ``edges``
    (default ``att.edges``)."""
    rows, cols = _segments(att.edges if edges is None else edges)
    npad, fp = s.shape[0], z.shape[2]
    sc = t_at._leaky(s[rows] + d[cols], SLOPE)  # [nnz, H]
    m = torch.full((npad, HEADS), -1e30).scatter_reduce(0, rows[:, None].expand(-1, HEADS), sc, "amax")
    e = torch.exp(sc - m[rows])
    den = torch.zeros((npad, HEADS)).index_add_(0, rows, e)
    if rate > 0.0:
        e = e * _edge_keep(att, rows, cols, seed, rate)
    o = torch.zeros((npad, HEADS, fp))
    o[..., :f] = torch.zeros((npad, HEADS, f)).index_add_(0, rows, e[..., None] * z[cols, :, :f])
    return o, den, m


def _route_bwd_row(att, s, d, m, den, c, z, g, *, f, seed, rate, edges=None):
    """What gat_edge_bwd_row_kernel computes, in torch ops over ``edges``
    (default ``att.edges``)."""
    rows, cols = _segments(att.edges if edges is None else edges)
    raw = s[rows] + d[cols]
    alpha = torch.exp(t_at._leaky(raw, SLOPE) - m[rows]) / den[rows]
    dalpha = (g[rows, :, :f] * z[cols, :, :f]).sum(-1)
    kf = _edge_keep(att, rows, cols, seed, rate) if rate > 0.0 else torch.ones_like(alpha)
    draw = alpha * (kf * dalpha - c[rows]) * t_at._leaky_grad(raw, SLOPE)
    return torch.zeros_like(s).index_add_(0, rows, draw)


def _route_bwd_col(att, s, d, m, den, c, z, g, *, f, seed, rate, edges=None):
    """What gat_edge_bwd_col_kernel computes, in torch ops over ``edges``
    (default ``att.edges_t``)."""
    cols, rows = _segments(att.edges_t if edges is None else edges)
    mpad, fp = d.shape[0], z.shape[2]
    raw = s[rows] + d[cols]
    alpha = torch.exp(t_at._leaky(raw, SLOPE) - m[rows]) / den[rows]
    dalpha = (g[rows, :, :f] * z[cols, :, :f]).sum(-1)
    kf = _edge_keep(att, rows, cols, seed, rate) if rate > 0.0 else torch.ones_like(alpha)
    draw = alpha * (kf * dalpha - c[rows]) * t_at._leaky_grad(raw, SLOPE)
    dd = torch.zeros((mpad, HEADS)).index_add_(0, cols, draw)
    dz = torch.zeros((mpad, HEADS, fp))
    dz[..., :f] = torch.zeros((mpad, HEADS, f)).index_add_(
        0, cols, (kf * alpha)[..., None] * g[rows, :, :f])
    return dz, dd


@pytest.mark.parametrize("name", PATTERNS)
def test_edge_lists_match_jax_masks(rng, name):
    a, kw = _pattern(name, rng)
    j, t = JTiled.from_scipy(a, **kw), TTiled.from_scipy(a, **kw)
    b = t.block
    npad, mpad = t.n_row_blocks * b, t.n_col_blocks * b
    for got, want in (
        (t.edges, _jax_edges(j.mask_bits, j.rowblk, j.colblk, b, npad, by_column=False)),
        (t.edges_t, _jax_edges(j.mask_bits_t, j.rowblk_t, j.colblk_t, b, mpad, by_column=True)),
    ):
        assert got.ptr.dtype == got.idx.dtype == torch.int32
        np.testing.assert_array_equal(got.ptr.numpy(), want[0])
        np.testing.assert_array_equal(got.idx.numpy(), want[1])
    # filler tiles give no entry: the lists hold exactly the tiled edges
    assert t.edges.nnz == t.edges_t.nnz == t.stats()["tiled_edges"]
    if name == "empty-block":  # row and column block 1: filler tiles only
        assert not torch.diff(t.edges.ptr[b : 2 * b + 1]).any()
        assert not torch.diff(t.edges_t.ptr[b : 2 * b + 1]).any()
        assert ((t.rowblk == 1) | (t.colblk == 1)).any()


def test_edge_lists_cached_per_instance(rng):
    a, kw = _pattern("tiles+rest", rng)
    att = TTiled.from_scipy(a, **kw)
    assert att.edges is att.edges and att.edges_t is att.edges_t
    moved = to_device(att, "cpu")
    assert "edges" not in vars(moved) and "edges_t" not in vars(moved)
    assert moved.edges is not att.edges and torch.equal(moved.edges.idx, att.edges.idx)


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("name", PATTERNS)
def test_edge_route_matches_jax_kernels(rng, name, rate):
    a, kw = _pattern(name, rng)
    j_att, t_att = JTiled.from_scipy(a, **kw), TTiled.from_scipy(a, **kw)
    x = _sweep_inputs(j_att, rng, hot=name == "hot-column")
    T = {n: torch.from_numpy(v) for n, v in x.items()}
    k = dict(slope=SLOPE, rate=rate)
    jseed = jnp.asarray([SEED], jnp.int32)
    o_j, den_j, m_j = (np.asarray(v) for v in j_at._tile_fwd_fused(
        j_att, jnp.asarray(x["s"]), jnp.asarray(x["d"]), jnp.asarray(x["z"]), seed=jseed, **k))
    o_t, den_t, m_t = _route_fwd(t_att, T["s"], T["d"], T["z"], f=F, seed=SEED, rate=rate)
    np.testing.assert_array_equal(m_t.numpy(), m_j)
    np.testing.assert_allclose(den_t.numpy(), den_j, **FWD_TOL)
    np.testing.assert_allclose(o_t.numpy(), o_j, **FWD_TOL)
    assert not o_t[..., F:].any()
    # the backward sweep reads the merged (m, den): rows with no edge get 0, 1
    m = np.where(m_j > -5e29, m_j, 0.0).astype(np.float32)
    den = np.where(den_j > 0, den_j, 1.0).astype(np.float32)
    args = (x["s"], x["d"], m, den, x["c"], x["z"], x["g"])
    dz_j, dd_j = j_at._tile_bwd_col(j_att, *(jnp.asarray(v) for v in args), seed=jseed, **k)
    dz_t, dd_t = _route_bwd_col(t_att, *(torch.from_numpy(v) for v in args), f=F, seed=SEED,
                                rate=rate)
    np.testing.assert_allclose(dz_t.numpy(), np.asarray(dz_j), **BWD_TOL)
    np.testing.assert_allclose(dd_t.numpy(), np.asarray(dd_j), **BWD_TOL)
    for v in (o_t, den_t, dz_t, dd_t):
        assert torch.isfinite(v).all()
    if name == "empty-block":  # block 1's rows and columns: the neutral values
        blk = slice(32, 64)
        assert not o_t[blk].any() and not den_t[blk].any() and (m_t[blk] == -1e30).all()
        assert not dz_t[blk].any() and not dd_t[blk].any()


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("name", PATTERNS)
def test_edge_route_ds_matches_jax_kernel(rng, name, rate):
    """The ds route over ``edges`` against the JAX ``_tile_bwd_row``, on the
    merged (m, den) of the JAX forward."""
    a, kw = _pattern(name, rng)
    j_att, t_att = JTiled.from_scipy(a, **kw), TTiled.from_scipy(a, **kw)
    x = _sweep_inputs(j_att, rng, hot=name == "hot-column")
    k = dict(slope=SLOPE, rate=rate)
    jseed = jnp.asarray([SEED], jnp.int32)
    _, den_j, m_j = (np.asarray(v) for v in j_at._tile_fwd_fused(
        j_att, jnp.asarray(x["s"]), jnp.asarray(x["d"]), jnp.asarray(x["z"]), seed=jseed, **k))
    m = np.where(m_j > -5e29, m_j, 0.0).astype(np.float32)
    den = np.where(den_j > 0, den_j, 1.0).astype(np.float32)
    args = (x["s"], x["d"], m, den, x["c"], x["z"], x["g"])
    ds_j = np.asarray(j_at._tile_bwd_row(j_att, *(jnp.asarray(v) for v in args), seed=jseed, **k))
    ds_t = _route_bwd_row(t_att, *(torch.from_numpy(v) for v in args), f=F, seed=SEED, rate=rate)
    np.testing.assert_allclose(ds_t.numpy(), ds_j, **BWD_TOL)
    assert torch.isfinite(ds_t).all()
    rows = _segments(t_att.edges)[0]
    edgeless = torch.ones(ds_t.shape[0], dtype=torch.bool)
    edgeless[rows] = False
    assert edgeless.any() and (ds_t[edgeless] == 0).all()  # rows with no tiled edge: exactly 0
    if name == "empty-block":
        assert not ds_t[32:64].any()


def test_edge_route_gives_the_sparse_answer_on_inf(rng):
    """Inf in one column j0 of z: the edge route's rows without an edge to
    j0 stay finite (o and ds), where the dense twins multiply the Inf by the
    masked zeros of j0's tiles and give NaN there (the stated difference)."""
    a, kw = _pattern("tiles+rest", rng)
    att = TTiled.from_scipy(a, **kw)
    x = {n: torch.from_numpy(v) for n, v in _sweep_inputs(att, rng).items()}
    rows, cols = _segments(att.edges)
    j0 = int(cols[0])
    x["z"][j0, :, 0] = float("inf")
    o = _route_fwd(att, x["s"], x["d"], x["z"], f=F, seed=0, rate=0.0)[0]
    off = torch.ones(o.shape[0], dtype=torch.bool)
    off[rows[cols == j0]] = False
    assert torch.isfinite(o[off]).all() and not torch.isfinite(o[~off]).all()
    dense = t_at.gat_tile_fwd_plain(att, x["s"], x["d"], x["z"], slope=SLOPE, seed=0, rate=0.0)[0]
    assert torch.isnan(dense[off]).any()
    # ds under a finite (m, den): the row max of the finite scores, den 1
    m, den = torch.zeros_like(x["s"]), torch.ones_like(x["s"])
    args = (att, x["s"], x["d"], m, den, x["c"], x["z"], x["g"])
    ds = _route_bwd_row(*args, f=F, seed=0, rate=0.0)
    assert torch.isfinite(ds[off]).all() and not torch.isfinite(ds[~off]).all()
    dense_ds = t_at.gat_tile_bwd_row_plain(*args, slope=SLOPE, seed=0, rate=0.0)
    assert torch.isnan(dense_ds[off]).any()


def test_cpu_wrappers_take_the_dense_twins(rng):
    """On CPU tensors the three wrappers are the dense twins, with or
    without f; they launch nothing and build no edge list."""
    a, kw = _pattern("tiles+rest", rng)
    att = TTiled.from_scipy(a, **kw)
    x = {n: torch.from_numpy(v) for n, v in _sweep_inputs(att, rng).items()}
    k = dict(slope=SLOPE, seed=SEED, rate=0.35)
    cuda_build.reset_launch_counts()
    want = t_at.gat_tile_fwd_plain(att, x["s"], x["d"], x["z"], **k)
    for f in (None, F):
        for got, ref in zip(t_at.gat_tile_fwd(att, x["s"], x["d"], x["z"], f=f, **k), want):
            assert torch.equal(got, ref)
    m = torch.where(want[2] > -5e29, want[2], 0.0)
    den = torch.where(want[1] > 0, want[1], 1.0)
    args = (att, x["s"], x["d"], m, den, x["c"], x["z"], x["g"])
    want = t_at.gat_tile_bwd_row_plain(*args, **k)
    for f in (None, F):
        assert torch.equal(t_at.gat_tile_bwd_row(*args, f=f, **k), want)
    want = t_at.gat_tile_bwd_col_plain(*args, **k)
    for got, ref in zip(t_at.gat_tile_bwd_col(*args, f=F, **k), want):
        assert torch.equal(got, ref)
    assert all(v == 0 for v in cuda_build.launch_counts.values())
    assert "edges" not in vars(att) and "edges_t" not in vars(att)


def _route_kernels(monkeypatch):
    """The layer's card path on the CPU: :func:`_whole_sweeps` holds and
    the three wrappers are the edge route over the lists they are given."""
    def kernel(route):
        def call(att, *args, slope, seed, rate, f=None, mxu_precision=None, edges=None):
            assert slope == SLOPE and mxu_precision is None and edges is not None
            return route(att, *args, f=f, seed=seed, rate=rate, edges=edges)
        return call

    monkeypatch.setattr(t_at, "_whole_sweeps", lambda z, mxu_precision: True)
    monkeypatch.setattr(t_at, "gat_tile_fwd", kernel(_route_fwd))
    monkeypatch.setattr(t_at, "gat_tile_bwd_row", kernel(_route_bwd_row))
    monkeypatch.setattr(t_at, "gat_tile_bwd_col", kernel(_route_bwd_col))


def _layer_run(att, hw, a_src, a_dst, g, rate):
    """(out, d hw, d a_src, d a_dst) of the tiled layer, and the counters'
    moves."""
    ts = [t.clone().requires_grad_(True) for t in (hw, a_src, a_dst)]
    before = dict(profiling.counters)
    out = t_at.gat_attention_tiled(att, *ts, negative_slope=SLOPE, attn_dropout=rate, seed=SEED)
    out.backward(g)
    moved = {k: v - before[k] for k, v in profiling.counters.items()}
    return [out.detach()] + [t.grad for t in ts], moved


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("name", PATTERNS)
def test_whole_pattern_sweeps_equal_tiles_rest_and_merge(rng, monkeypatch, name, rate):
    """The layer's card path (kernels 3-5 over ``all_edges`` /
    ``all_edges_t``, no rest, no merge), with the edge route standing in
    for the kernels, against the CPU path (the dense twins over the tiles,
    the bucketed rest, the exp-rescale merge): output and every gradient,
    and the counters (the same rest edges; 3 sweeps over the whole lists)."""
    a, kw = _pattern(name, rng)
    att = TTiled.from_scipy(a, **kw)
    n, n_cols = a.shape
    hw = torch.from_numpy(rng.normal(size=(n_cols, HEADS * F)).astype(np.float32))
    a_src, a_dst = (torch.from_numpy(rng.normal(size=(HEADS, F)).astype(np.float32) * 0.3)
                    for _ in range(2))
    if name == "hot-column":
        a_dst[:] = hw[0].view(HEADS, F) * HOT / (hw[0].view(HEADS, F) ** 2).sum(1, keepdim=True)
    g = torch.from_numpy(rng.normal(size=(n, HEADS * F)).astype(np.float32))
    want, want_moved = _layer_run(att, hw, a_src, a_dst, g, rate)
    _route_kernels(monkeypatch)
    got, moved = _layer_run(att, hw, a_src, a_dst, g, rate)
    for x, y in zip(got, want):
        assert torch.isfinite(x).all()
        # BWD_TOL, its atol scaled by the output's largest entry: the hot
        # column's a_dst (entries ~ HOT) scales dz's float32 rounding
        atol = BWD_TOL["atol"] * max(1.0, float(y.abs().max()))
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=BWD_TOL["rtol"], atol=atol)
    assert moved["attn_rest_edges"] == want_moved["attn_rest_edges"] == 2 * att.rest_nnz
    assert (moved["attn_rest_in_sweeps"], want_moved["attn_rest_in_sweeps"]) == (3, 0)
