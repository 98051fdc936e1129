"""The tiled GAT's edge lists, the plain versions of its four kernels and
the one layer that walks the whole pattern, against the JAX package.

``TiledAttentionPattern.edges`` / ``edges_t`` (what the CUDA kernels walk)
are compared exactly with the nonzeros of the JAX pattern's unpacked masks,
in row and in column order. The plain versions — the kernels' algorithm in
torch ops, which the wrappers take on the CPU: a segment max, exp and
``index_add_`` over ``edges`` for the forward and ds, over ``edges_t`` for
dz and dd, on the model's [rows, H·f] arrays — are held to the JAX Pallas
kernels ``_tile_fwd_fused``, ``_tile_bwd_row`` and ``_tile_bwd_col``
(interpret mode), fed the same inputs padded to their [rows, H, Fp]
layout, with what the port's sweeps add around them (the normalisation,
c = ⟨g, out⟩, the chain through s and d) done in numpy, at the tolerances
of ``test_torch_gat_tiled.py``: m equal; out and den at rtol 1e-5, atol
1e-6; c, ds, dz and dd at rtol 1e-4, atol 1e-5 (the same float32 products
summed in another order). ``gat_scores`` is held to JAX's ``_prep``. The
layer, whose sweeps walk ``all_edges`` / ``all_edges_t``, is held to JAX's
tiles, rest and merge (``_tiled_gat_core``) at that file's layer
tolerances. Heads of 2 × 8 and 3 × 5 columns (f and H·f off a multiple of
4).
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
HEADS, F = 2, 8
FP = 16  # the head width of JAX's kernels' layout: its columns past f are zero
# (H, f) of the sweeps' inputs; 3 × 5 puts heads off the 16-byte boundary and
# H·f off a multiple of 4 (the kernels' column-by-column path)
WIDTHS = {"2x8": (2, 8), "3x5": (3, 5)}
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


def _sweep_inputs(att, rng, *, hot=False, heads=HEADS, f=F):
    """The sweeps' inputs in the port's layout: s [Npad, H], d [Mpad, H];
    z [Mpad, H·f]; g, out [n, H·f]; a_src, a_dst [H, f]; and c = ⟨g, out⟩
    per head [Npad, H], 0 past row n."""
    npad, mpad = att.n_row_blocks * att.block, att.n_col_blocks * att.block
    n = att.n_rows
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    x = dict(s=f32(npad, heads), d=f32(mpad, heads), z=f32(mpad, heads * f),
             g=f32(n, heads * f), out=f32(n, heads * f), a_src=f32(heads, f) * np.float32(0.3),
             a_dst=f32(heads, f) * np.float32(0.3))
    if hot:
        x["d"][0] = HOT
    c = np.zeros((npad, heads), np.float32)
    c[:n] = np.einsum("nhf,nhf->nh", x["g"].reshape(n, heads, f), x["out"].reshape(n, heads, f))
    x["c"] = c
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


def _jax_wide(a, heads, f, rows):
    """[r, H·f] → [rows, H, FP], zero past column f and row r: the layout
    of JAX's kernels."""
    out = np.zeros((rows, heads, FP), np.float32)
    out[: a.shape[0], :, :f] = a.reshape(a.shape[0], heads, f)
    return out


def _jax_state(j_att, x, k, jseed):
    """JAX's forward sweep on the port's inputs, and its (m, den) as the
    port gives them: rows with no edge as m = 0, den = 1."""
    heads, f = x["a_src"].shape
    zp = _jax_wide(x["z"], heads, f, x["z"].shape[0])
    o, den, m = (np.asarray(v) for v in j_at._tile_fwd_fused(
        j_att, jnp.asarray(x["s"]), jnp.asarray(x["d"]), jnp.asarray(zp), seed=jseed, **k))
    m_in = np.where(m > -5e29, m, 0.0).astype(np.float32)
    den_in = np.where(den > 0, den, 1.0).astype(np.float32)
    return o, m_in, den_in


def _jax_bwd(kernel, j_att, x, m, den, k, jseed):
    """JAX's ``_tile_bwd_row`` or ``_tile_bwd_col`` on the port's inputs,
    padded to its layout (c from the port's g and out)."""
    heads, f = x["a_src"].shape
    npad = j_att.n_row_blocks * j_att.block
    args = (x["s"], x["d"], m, den, x["c"], _jax_wide(x["z"], heads, f, x["z"].shape[0]),
            _jax_wide(x["g"], heads, f, npad))
    return kernel(j_att, *(jnp.asarray(v) for v in args), seed=jseed, **k)


def _chain(dz, dd, ds, x):
    """JAX's column sweep dz [Mpad, H, FP] → the port's [M, H·f] with the
    chain through s and d: + dd·a_dst, and + ds·a_src on the first n rows."""
    heads, f = x["a_src"].shape
    rows, n = x["z"].shape[0], x["g"].shape[0]
    want = np.asarray(dz)[:rows, :, :f] + np.asarray(dd)[:rows, :, None] * x["a_dst"]
    want[:n] += ds[:n, :, None] * x["a_src"]
    return want.reshape(rows, heads * f)


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("name", PATTERNS)
def test_edge_route_matches_jax_kernels(rng, name, rate):
    """The forward sweep (out = o / den, with m = 0, den = 1 on rows with
    no edge) and the column sweep (dd, and dz with the chain) against JAX's
    ``_tile_fwd_fused`` and ``_tile_bwd_col`` on the same inputs."""
    _fwd_and_col_against_jax(rng, name, rate, HEADS, F)


@pytest.mark.parametrize("name", PATTERNS)
def test_edge_route_off_the_16_byte_boundary(rng, name):
    """As above with heads of 3 × 5 columns under dropout: heads that start
    off a 16-byte boundary in rows of 15 floats."""
    _fwd_and_col_against_jax(rng, name, 0.35, *WIDTHS["3x5"])


def _fwd_and_col_against_jax(rng, name, rate, heads, f):
    a, kw = _pattern(name, rng)
    j_att, t_att = JTiled.from_scipy(a, **kw), TTiled.from_scipy(a, **kw)
    x = _sweep_inputs(j_att, rng, hot=name == "hot-column", heads=heads, f=f)
    T = {n: torch.from_numpy(v) for n, v in x.items()}
    k = dict(slope=SLOPE, rate=rate)
    jseed = jnp.asarray([SEED], jnp.int32)
    n = t_att.n_rows
    o_j, m, den = _jax_state(j_att, x, k, jseed)
    out_t, den_t, m_t = t_at.gat_tile_fwd(t_att, T["s"], T["d"], T["z"], seed=SEED, **k)
    np.testing.assert_array_equal(m_t.numpy(), m)
    np.testing.assert_allclose(den_t.numpy(), den, **FWD_TOL)
    want = (o_j[:n, :, :f] / den[:n, :, None]).reshape(n, heads * f)
    np.testing.assert_allclose(out_t.numpy(), want, **FWD_TOL)
    ds = _jax_bwd(j_at._tile_bwd_row, j_att, x, m, den, k, jseed)
    dz_j, dd_j = _jax_bwd(j_at._tile_bwd_col, j_att, x, m, den, k, jseed)
    ds = np.array(ds)
    dz_t, dd_t = t_at.gat_tile_bwd_col(
        t_att, *(torch.from_numpy(v) for v in (x["s"], x["d"], m, den, x["c"], ds, x["z"], x["g"],
                                               x["a_src"], x["a_dst"])), seed=SEED, **k)
    assert dz_t.shape == T["z"].shape
    np.testing.assert_allclose(dz_t.numpy(), _chain(dz_j, dd_j, ds, x), **BWD_TOL)
    np.testing.assert_allclose(dd_t.numpy(), np.asarray(dd_j), **BWD_TOL)
    for v in (out_t, den_t, dz_t, dd_t):
        assert torch.isfinite(v).all()
    if name == "empty-block":  # block 1's rows and columns: the neutral values
        blk = slice(32, 64)
        assert not out_t[blk].any() and (den_t[blk] == 1).all() and not m_t[blk].any()
        assert not dz_t[blk].any() and not dd_t[blk].any()


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("name", PATTERNS)
def test_edge_route_ds_matches_jax_kernel(rng, name, rate):
    """The row sweep's c = ⟨g, out⟩ against numpy's and its ds against the
    JAX ``_tile_bwd_row``, on JAX's forward (m, den)."""
    _row_against_jax(rng, name, rate, HEADS, F)


@pytest.mark.parametrize("name", PATTERNS)
def test_edge_route_ds_off_the_16_byte_boundary(rng, name):
    """As above with heads of 3 × 5 columns under dropout."""
    _row_against_jax(rng, name, 0.35, *WIDTHS["3x5"])


def _row_against_jax(rng, name, rate, heads, f):
    a, kw = _pattern(name, rng)
    j_att, t_att = JTiled.from_scipy(a, **kw), TTiled.from_scipy(a, **kw)
    x = _sweep_inputs(j_att, rng, hot=name == "hot-column", heads=heads, f=f)
    k = dict(slope=SLOPE, rate=rate)
    jseed = jnp.asarray([SEED], jnp.int32)
    _, m, den = _jax_state(j_att, x, k, jseed)
    ds_j = np.asarray(_jax_bwd(j_at._tile_bwd_row, j_att, x, m, den, k, jseed))
    ds_t, c_t = t_at.gat_tile_bwd_row(
        t_att, *(torch.from_numpy(v) for v in (x["s"], x["d"], m, den, x["z"], x["g"], x["out"])),
        seed=SEED, **k)
    np.testing.assert_allclose(c_t.numpy(), x["c"], **BWD_TOL)
    np.testing.assert_allclose(ds_t.numpy(), ds_j, **BWD_TOL)
    assert torch.isfinite(ds_t).all()
    assert not c_t[t_att.n_rows :].any()
    rows = _segments(t_att.edges)[0]
    edgeless = torch.ones(ds_t.shape[0], dtype=torch.bool)
    edgeless[rows] = False
    assert edgeless.any() and (ds_t[edgeless] == 0).all()  # rows with no tiled edge: exactly 0
    if name == "empty-block":
        assert not ds_t[32:64].any()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("halo", [0, 16])
def test_scores_match_jax_prep(rng, width, halo):
    """s and d of the plain ``gat_scores`` (the wrapper's route on the CPU)
    against JAX's ``_prep`` (its einsums), on a square pattern and on one
    with ``halo`` empty columns past its rows (z covers them, as the
    distributed GAT's received halo): s on the first n_rows rows, d on all
    of z's, 0 on the padding rows."""
    heads, f = WIDTHS[width]
    a, kw = _pattern("tiles+rest", rng)
    a = sp.hstack([a, sp.csr_matrix((a.shape[0], halo))]).tocsr()
    j_att, t_att = JTiled.from_scipy(a, **kw), TTiled.from_scipy(a, **kw)
    z = rng.normal(size=(a.shape[1], heads * f)).astype(np.float32)
    a_src, a_dst = (rng.normal(size=(heads, f)).astype(np.float32) for _ in range(2))
    _, _, s_j, d_j, *_ = j_at._prep(j_att, jnp.asarray(z), jnp.asarray(a_src), jnp.asarray(a_dst))
    ts = [torch.from_numpy(v) for v in (z, a_src, a_dst)]
    s, d = t_at.gat_scores(t_att, *ts)
    for got, want in zip((s, d), t_at.gat_scores_plain(t_att, *ts)):
        assert torch.equal(got, want)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **FWD_TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), **FWD_TOL)
    assert not s[t_att.n_rows :].any() and not d[a.shape[1] :].any()


def test_edge_route_gives_the_sparse_answer_on_inf(rng):
    """Inf in one column j0 of z: the plain walk's rows without an edge to
    j0 stay finite (out and ds), as the kernels' do (JAX's dense tiles
    multiply the Inf by the masked zeros of j0's tiles and give NaN
    there)."""
    a, kw = _pattern("tiles+rest", rng)
    att = TTiled.from_scipy(a, **kw)
    x = {n: torch.from_numpy(v) for n, v in _sweep_inputs(att, rng).items()}
    rows, cols = _segments(att.edges)
    j0 = int(cols[0])
    x["z"][j0, 0] = float("inf")
    out = t_at.gat_tile_fwd(att, x["s"], x["d"], x["z"], slope=SLOPE, seed=0, rate=0.0)[0]
    off = torch.ones(att.n_rows, dtype=torch.bool)
    off[rows[cols == j0]] = False
    assert torch.isfinite(out[off]).all() and not torch.isfinite(out[~off]).all()
    # ds under a finite (m, den): the row max of the finite scores, den 1
    m, den = torch.zeros_like(x["s"]), torch.ones_like(x["s"])
    args = (att, x["s"], x["d"], m, den, x["z"], x["g"], x["out"])
    ds = t_at.gat_tile_bwd_row(*args, slope=SLOPE, seed=0, rate=0.0)[0][: att.n_rows]
    assert torch.isfinite(ds[off]).all() and not torch.isfinite(ds[~off]).all()


def test_cpu_wrappers_take_the_plain_walk(rng):
    """On CPU tensors the four wrappers are the plain versions, over the
    default lists (the tiled edges) and over ``all_edges`` /
    ``all_edges_t``; they launch nothing."""
    a, kw = _pattern("tiles+rest", rng)
    att = TTiled.from_scipy(a, **kw)
    assert att.rest_nnz > 0
    x = {n: torch.from_numpy(v) for n, v in _sweep_inputs(att, rng).items()}
    k = dict(slope=SLOPE, seed=SEED, rate=0.35)
    cuda_build.reset_launch_counts()
    scores = (att, x["z"], x["a_src"], x["a_dst"])
    for got, want in zip(t_at.gat_scores(*scores), t_at.gat_scores_plain(*scores)):
        assert torch.equal(got, want)
    for by_row, by_col in ((None, None), (att.all_edges, att.all_edges_t)):
        want = t_at.gat_tile_fwd_plain(att, x["s"], x["d"], x["z"], edges=by_row, **k)
        got = t_at.gat_tile_fwd(att, x["s"], x["d"], x["z"], edges=by_row, **k)
        for g, ref in zip(got, want):
            assert torch.equal(g, ref)
        m, den = want[2], want[1]
        args = (att, x["s"], x["d"], m, den, x["z"], x["g"], x["out"])
        want = t_at.gat_tile_bwd_row_plain(*args, edges=by_row, **k)
        for g, ref in zip(t_at.gat_tile_bwd_row(*args, edges=by_row, **k), want):
            assert torch.equal(g, ref)
        ds, c = want
        args = (att, x["s"], x["d"], m, den, c, ds, x["z"], x["g"], x["a_src"], x["a_dst"])
        want = t_at.gat_tile_bwd_col_plain(*args, edges=by_col, **k)
        for g, ref in zip(t_at.gat_tile_bwd_col(*args, edges=by_col, **k), want):
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
    """The port's one layer (the scores and the three sweeps over
    ``all_edges`` / ``all_edges_t``, no rest, no merge) against JAX's tiles
    + rest + merge: output and every gradient at the tolerances of
    ``test_torch_gat_tiled.py``, and the counter (the rest's edges, once a
    forward and once a backward)."""
    _layer_against_jax(rng, name, rate, HEADS, F)


@pytest.mark.parametrize("name", PATTERNS)
def test_whole_pattern_layer_off_the_16_byte_boundary(rng, name):
    """As above with heads of 3 × 5 columns under dropout."""
    _layer_against_jax(rng, name, 0.35, *WIDTHS["3x5"])


def _layer_against_jax(rng, name, rate, heads, f):
    a, kw = _pattern(name, rng)
    j_att, t_att = JTiled.from_scipy(a, **kw), TTiled.from_scipy(a, **kw)
    n, n_cols = a.shape
    hw = rng.normal(size=(n_cols, heads * f)).astype(np.float32)
    a_src, a_dst = (rng.normal(size=(heads, f)).astype(np.float32) * 0.3 for _ in range(2))
    if name == "hot-column":
        h0 = hw[0].reshape(heads, f)
        a_dst = (h0 * HOT / (h0**2).sum(1, keepdims=True)).astype(np.float32)
    g = rng.normal(size=(n, heads * f)).astype(np.float32)
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
