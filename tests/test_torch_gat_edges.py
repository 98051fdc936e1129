"""The tiled GAT's edge lists, the plain walks of its three kernels and
the one layer that walks the whole pattern, against the JAX package.

``TiledAttentionPattern.edges`` / ``edges_t`` (what the CUDA kernels walk)
are compared exactly with the nonzeros of the JAX pattern's unpacked masks,
in row and in column order. The plain walks — the kernels' algorithm in
torch ops, which the wrappers take on the CPU: a segment max, exp and
``index_add_`` over ``edges`` for the forward and ds, over ``edges_t`` for
dz and dd, gathering only the head's first f columns — are held to the JAX
Pallas kernels ``_tile_fwd_fused``, ``_tile_bwd_row`` and ``_tile_bwd_col``
(interpret mode) at the tolerances of ``test_torch_gat_tiled.py``: m equal;
o and den at rtol 1e-5, atol 1e-6; ds, dz and dd at rtol 1e-4, atol 1e-5
(the same float32 products summed in another order). The layer, whose
sweeps walk ``all_edges`` / ``all_edges_t``, is held to JAX's tiles, rest
and merge (``_tiled_gat_core``) at that file's layer tolerances.
"""

import jax
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
from tests.test_torch_gat_tiled import DROP_TOL, GRAD_TOL, LAYER_TOL

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


def _segments(edges):
    """(major index of each entry, its minor index), int64."""
    n = edges.ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n), torch.diff(edges.ptr.long())), edges.idx.long()


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
    o_t, den_t, m_t = t_at.gat_tile_fwd(t_att, T["s"], T["d"], T["z"], f=F, seed=SEED, **k)
    np.testing.assert_array_equal(m_t.numpy(), m_j)
    np.testing.assert_allclose(den_t.numpy(), den_j, **FWD_TOL)
    np.testing.assert_allclose(o_t.numpy(), o_j, **FWD_TOL)
    assert not o_t[..., F:].any()
    # the backward sweep reads the merged (m, den): rows with no edge get 0, 1
    m = np.where(m_j > -5e29, m_j, 0.0).astype(np.float32)
    den = np.where(den_j > 0, den_j, 1.0).astype(np.float32)
    args = (x["s"], x["d"], m, den, x["c"], x["z"], x["g"])
    dz_j, dd_j = j_at._tile_bwd_col(j_att, *(jnp.asarray(v) for v in args), seed=jseed, **k)
    dz_t, dd_t = t_at.gat_tile_bwd_col(t_att, *(torch.from_numpy(v) for v in args), f=F,
                                       seed=SEED, **k)
    np.testing.assert_allclose(dz_t.numpy(), np.asarray(dz_j), **BWD_TOL)
    np.testing.assert_allclose(dd_t.numpy(), np.asarray(dd_j), **BWD_TOL)
    assert not dz_t[..., F:].any()
    for v in (o_t, den_t, dz_t, dd_t):
        assert torch.isfinite(v).all()
    if name == "empty-block":  # block 1's rows and columns: the neutral values
        blk = slice(32, 64)
        assert not o_t[blk].any() and not den_t[blk].any() and (m_t[blk] == -1e30).all()
        assert not dz_t[blk].any() and not dd_t[blk].any()


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("name", PATTERNS)
def test_edge_route_ds_matches_jax_kernel(rng, name, rate):
    """The ds sweep's plain walk over ``edges`` against the JAX
    ``_tile_bwd_row``, on the merged (m, den) of the JAX forward."""
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
    ds_t = t_at.gat_tile_bwd_row(t_att, *(torch.from_numpy(v) for v in args), f=F, seed=SEED,
                                 **k)
    np.testing.assert_allclose(ds_t.numpy(), ds_j, **BWD_TOL)
    assert torch.isfinite(ds_t).all()
    rows = _segments(t_att.edges)[0]
    edgeless = torch.ones(ds_t.shape[0], dtype=torch.bool)
    edgeless[rows] = False
    assert edgeless.any() and (ds_t[edgeless] == 0).all()  # rows with no tiled edge: exactly 0
    if name == "empty-block":
        assert not ds_t[32:64].any()


def test_edge_route_gives_the_sparse_answer_on_inf(rng):
    """Inf in one column j0 of z: the plain walk's rows without an edge to
    j0 stay finite (o and ds), as the kernels' do (JAX's dense tiles
    multiply the Inf by the masked zeros of j0's tiles and give NaN
    there)."""
    a, kw = _pattern("tiles+rest", rng)
    att = TTiled.from_scipy(a, **kw)
    x = {n: torch.from_numpy(v) for n, v in _sweep_inputs(att, rng).items()}
    rows, cols = _segments(att.edges)
    j0 = int(cols[0])
    x["z"][j0, :, 0] = float("inf")
    o = t_at.gat_tile_fwd(att, x["s"], x["d"], x["z"], slope=SLOPE, f=F, seed=0, rate=0.0)[0]
    off = torch.ones(o.shape[0], dtype=torch.bool)
    off[rows[cols == j0]] = False
    assert torch.isfinite(o[off]).all() and not torch.isfinite(o[~off]).all()
    # ds under a finite (m, den): the row max of the finite scores, den 1
    m, den = torch.zeros_like(x["s"]), torch.ones_like(x["s"])
    args = (att, x["s"], x["d"], m, den, x["c"], x["z"], x["g"])
    ds = t_at.gat_tile_bwd_row(*args, slope=SLOPE, f=F, seed=0, rate=0.0)
    assert torch.isfinite(ds[off]).all() and not torch.isfinite(ds[~off]).all()


def test_cpu_wrappers_take_the_plain_walk(rng):
    """On CPU tensors the three wrappers are the plain walks, over the
    default lists (the tiled edges) and over ``all_edges`` /
    ``all_edges_t``, with or without f; they launch nothing."""
    a, kw = _pattern("tiles+rest", rng)
    att = TTiled.from_scipy(a, **kw)
    assert att.rest_nnz > 0
    x = {n: torch.from_numpy(v) for n, v in _sweep_inputs(att, rng).items()}
    k = dict(slope=SLOPE, seed=SEED, rate=0.35)
    cuda_build.reset_launch_counts()
    for by_row, by_col in ((None, None), (att.all_edges, att.all_edges_t)):
        want = t_at.gat_tile_fwd_plain(att, x["s"], x["d"], x["z"], edges=by_row, **k)
        for f in (None, F):
            got = t_at.gat_tile_fwd(att, x["s"], x["d"], x["z"], f=f, edges=by_row, **k)
            for g, ref in zip(got, want):
                assert torch.equal(g, ref)
        m = torch.where(want[2] > -5e29, want[2], 0.0)
        den = torch.where(want[1] > 0, want[1], 1.0)
        args = (att, x["s"], x["d"], m, den, x["c"], x["z"], x["g"])
        want = t_at.gat_tile_bwd_row_plain(*args, edges=by_row, **k)
        for f in (None, F):
            assert torch.equal(t_at.gat_tile_bwd_row(*args, f=f, edges=by_row, **k), want)
        want = t_at.gat_tile_bwd_col_plain(*args, edges=by_col, **k)
        for f in (None, F):
            for g, ref in zip(t_at.gat_tile_bwd_col(*args, f=f, edges=by_col, **k), want):
                assert torch.equal(g, ref)
    assert all(v == 0 for v in cuda_build.launch_counts.values())


def _torch_layer(att, arrays, g, rate):
    """(out, d hw, d a_src, d a_dst) of the port's tiled layer, and the
    counters' moves."""
    ts = [torch.from_numpy(v).requires_grad_(True) for v in arrays]
    before = dict(profiling.counters)
    out = t_at.gat_attention_tiled(att, *ts, negative_slope=SLOPE, attn_dropout=rate, seed=SEED)
    out.backward(torch.from_numpy(g))
    moved = {k: v - before[k] for k, v in profiling.counters.items()}
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts], moved


def _jax_layer(att, arrays, g, rate):
    """(out, d hw, d a_src, d a_dst) of JAX's ``_tiled_gat_core``: the tile
    sweeps, the bucketed rest and their exp-rescale merge."""
    def value_and_vjp(z, s_, d_, g_):
        core = lambda *a_: j_at._tiled_gat_core(att, *a_, jnp.asarray([SEED], jnp.int32), SLOPE,
                                                rate, jax.lax.Precision.HIGHEST)
        out, vjp = jax.vjp(core, z, s_, d_)
        return (out, *vjp(g_))

    return [np.asarray(v) for v in jax.jit(value_and_vjp)(*(jnp.asarray(v) for v in (*arrays, g)))]


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("name", PATTERNS)
def test_whole_pattern_sweeps_equal_tiles_rest_and_merge(rng, name, rate):
    """The port's one layer (the three sweeps over ``all_edges`` /
    ``all_edges_t``, no rest, no merge) against JAX's tiles + rest + merge:
    output and every gradient at the tolerances of
    ``test_torch_gat_tiled.py``, and the counter (the rest's edges, once a
    forward and once a backward)."""
    a, kw = _pattern(name, rng)
    j_att, t_att = JTiled.from_scipy(a, **kw), TTiled.from_scipy(a, **kw)
    n, n_cols = a.shape
    hw = rng.normal(size=(n_cols, HEADS * F)).astype(np.float32)
    a_src, a_dst = (rng.normal(size=(HEADS, F)).astype(np.float32) * 0.3 for _ in range(2))
    if name == "hot-column":
        h0 = hw[0].reshape(HEADS, F)
        a_dst = (h0 * HOT / (h0**2).sum(1, keepdims=True)).astype(np.float32)
    g = rng.normal(size=(n, HEADS * F)).astype(np.float32)
    got, moved = _torch_layer(t_att, (hw, a_src, a_dst), g, rate)
    want = _jax_layer(j_att, (hw, a_src, a_dst), g, rate)
    tols = [LAYER_TOL] + [GRAD_TOL] * 3 if rate == 0.0 else [DROP_TOL] * 4
    for x, y, tol in zip(got, want, tols):
        assert np.isfinite(x).all()
        # the atol scaled by the output's largest entry: the hot column's
        # a_dst (entries ~ HOT) scales dz's float32 rounding
        atol = tol["atol"] * max(1.0, float(np.abs(y).max()))
        np.testing.assert_allclose(x, y, rtol=tol["rtol"], atol=atol)
    assert moved["attn_rest_edges"] == 2 * t_att.rest_nnz
