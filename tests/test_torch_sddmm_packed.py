"""The BSR SDDMM's nonzero route: the per-tile table of a pattern's nonzeros
(``BsrMatrix.tile_entries``, what the CUDA kernel reads) against the JAX
package's tiles, and the scores the route computes against the JAX Pallas
kernel ``sddmm_bsr`` in interpret mode.

The table is compared exactly. The route's scores (one dot product per
entry of the table, placed into a zeroed tile layout, here in torch ops
standing in for the kernel on the CPU) are held to JAX with the mask on at
rtol/atol 1e-5: float32 sums of the same products taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch.ops import sddmm_bsr as t_sddmm_bsr
from graphconvgeo_torch.sparse import formats as tf
from graphconvgeo_torch.utils import cuda_build
from graphconvgeo_tpu.ops.sddmm_pallas import sddmm_bsr as j_sddmm_bsr
from graphconvgeo_tpu.sparse import formats as jf
from tests.conftest import random_csr
from tests.test_torch_spmm import empty_row_block_matrix

TOL = dict(rtol=1e-5, atol=1e-5)  # as test_torch_spmm_backends.py


def padding_row_block_matrix(rng, block):
    """Entries in row blocks 0 and 1 only; row block 2 is padding slots
    only (its rows exist, they hold nothing), and the last row is empty."""
    n, c = 3 * block + 5, 2 * block + 7
    rows = rng.integers(0, 2 * block, 6 * block)
    cols = rng.integers(0, c, 6 * block)
    m = sp.coo_matrix((rng.normal(size=len(rows)).astype(np.float32), (rows, cols)), shape=(n, c))
    m = m.tocsr()
    m.sum_duplicates()
    return m


def _pattern(kind, rng, block):
    if kind == "rect":
        return random_csr(rng, 300, 280, 5)
    if kind == "empty_row_block":
        return empty_row_block_matrix(rng, block)
    return padding_row_block_matrix(rng, block)


def _numpy_table(j):
    """The per-tile table built in numpy from a JAX BsrMatrix's tiles and
    its per-row-block tile lists."""
    tiles = np.asarray(j.tiles)
    b2 = j.block * j.block
    nz = np.flatnonzero(tiles)  # row-major: tile, row, column
    per = np.bincount(nz // b2, minlength=tiles.shape[0])
    tile_ptr = np.r_[0, np.cumsum(per)]
    trow = np.zeros(tiles.shape[0], np.int32)
    tcol = np.zeros(tiles.shape[0], np.int32)
    tidx, tc = np.asarray(j.tile_idx), np.asarray(j.tile_col)
    for r in range(tidx.shape[0]):
        for k in range(tidx.shape[1]):
            if tidx[r, k]:
                trow[tidx[r, k]], tcol[tidx[r, k]] = r, tc[r, k]
    return tile_ptr, nz % b2, trow, tcol


def _route_scores(pattern, h1, h2):
    """What the kernel computes, in torch ops: for each entry of the table,
    <h1[trow·B + i], h2[tcol·B + j]> (rows past h1's or h2's read as zero),
    placed into a zeroed [n_tiles + 1, B, B] layout."""
    te, b = pattern.tile_entries, pattern.block
    n_t = pattern.tiles.shape[0]
    tile = torch.repeat_interleave(torch.arange(n_t), torch.diff(te.tile_ptr.long()))
    pos = te.pos.long()
    r1 = te.trow.long()[tile] * b + pos // b
    r2 = te.tcol.long()[tile] * b + pos % b
    ok = (r1 < h1.shape[0]) & (r2 < h2.shape[0])
    dots = (h1[r1.clamp(max=h1.shape[0] - 1)] * h2[r2.clamp(max=h2.shape[0] - 1)]).sum(1)
    out = torch.zeros(n_t * b * b)
    out[tile * b * b + pos] = torch.where(ok, dots, torch.zeros(()))
    return out.view(n_t, b, b)


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("kind", ["rect", "empty_row_block", "padding_row_block"])
def test_tile_entries_match_jax_tiles(rng, kind, block):
    m = _pattern(kind, rng, block)
    pat = tf.BsrMatrix.from_scipy(m, block=block)
    te = pat.tile_entries
    tile_ptr, pos, trow, tcol = _numpy_table(jf.BsrMatrix.from_scipy(m, block=block))
    for got, want, name in ((te.tile_ptr, tile_ptr, "tile_ptr"), (te.pos, pos, "pos"),
                            (te.trow, trow, "trow"), (te.tcol, tcol, "tcol")):
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert tuple(te.tile_ptr.shape) == (pat.n_tiles + 2,) and te.tile_ptr[1] == 0  # tile 0 owns none
    assert te.nnz == m.nnz == int((pat.tiles != 0).sum())
    if kind == "padding_row_block":  # row block 2: padding slots only, no tile
        assert not (pat.tile_idx[2] != 0).any() and not (te.trow == 2).any()


@pytest.mark.parametrize("kind,block,short_h1", [
    ("rect", 128, False), ("empty_row_block", 128, False), ("padding_row_block", 256, False),
    ("rect", 128, True),
])
def test_route_scores_match_jax(rng, kind, block, short_h1):
    """The route's scores equal the Pallas kernel's (interpret mode, mask
    on); with ``short_h1`` h1 stops short of the pattern's last rows, which
    both read as zero."""
    m = _pattern(kind, rng, block)
    f = 70
    n1 = m.shape[0] - 20 if short_h1 else m.shape[0]
    h1 = rng.normal(size=(n1, f)).astype(np.float32)
    h2 = rng.normal(size=(m.shape[1], f)).astype(np.float32)
    pat = tf.BsrMatrix.from_scipy(m, block=block)
    got = _route_scores(pat, torch.from_numpy(h1), torch.from_numpy(h2)).numpy()
    want = np.asarray(j_sddmm_bsr(jf.BsrMatrix.from_scipy(m, block=block), jnp.asarray(h1),
                                  jnp.asarray(h2), mask_pattern=True, interpret=True))
    assert got.shape == want.shape == (pat.n_tiles + 1, block, block)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any() and not got[pat.tiles.numpy() == 0].any()
    if short_h1:
        coo = m.tocoo()
        assert (coo.row >= n1).any()  # some nonzeros sit on the missing rows


def test_route_writes_zero_off_pattern_on_nonfinite_h(rng):
    """Where h2 holds an Inf, the route scores the pattern's entries as
    scipy does and writes exact zeros off the pattern; the dense twin (and
    JAX) multiplies the off-pattern Inf by 0 and gives NaN there."""
    m = empty_row_block_matrix(rng, 128)
    pat = tf.BsrMatrix.from_scipy(m, block=128)
    f = 6
    h1 = rng.normal(size=(m.shape[0], f)).astype(np.float32)
    h2 = rng.normal(size=(m.shape[1], f)).astype(np.float32)
    hit = int(m.indices[0])
    h2[hit, 0] = np.inf
    got = _route_scores(pat, torch.from_numpy(h1), torch.from_numpy(h2)).numpy()
    off = pat.tiles.numpy() == 0
    assert (got[off] == 0).all()
    coo = m.tocoo()
    with np.errstate(invalid="ignore", over="ignore"):
        want = (h1.astype(np.float64)[coo.row] * h2.astype(np.float64)[coo.col]).sum(1)
    b, te = pat.block, pat.tile_entries
    tile = np.repeat(np.arange(pat.tiles.shape[0]), np.diff(te.tile_ptr.numpy()))
    pos = te.pos.numpy()
    rows, cols = te.trow.numpy()[tile] * b + pos // b, te.tcol.numpy()[tile] * b + pos % b
    order = np.lexsort((coo.col, coo.row))
    order_got = np.lexsort((cols, rows))
    scores = got.reshape(-1)[tile * b * b + pos]
    np.testing.assert_allclose(scores[order_got], want[order], **TOL)
    assert not np.isfinite(scores[cols == hit]).any()
    dense = t_sddmm_bsr.sddmm_bsr_plain(pat, torch.from_numpy(h1), torch.from_numpy(h2)).numpy()
    assert np.isnan(dense[off]).any()


def test_cpu_wrapper_takes_the_dense_twin(rng):
    """On CPU tensors the wrapper is the dense twin, launches nothing and
    builds no tile table."""
    m = empty_row_block_matrix(rng, 128)
    pat = tf.BsrMatrix.from_scipy(m, block=128)
    h1 = torch.from_numpy(rng.normal(size=(m.shape[0], 40)).astype(np.float32))
    h2 = torch.from_numpy(rng.normal(size=(m.shape[1], 40)).astype(np.float32))
    cuda_build.reset_launch_counts()
    for mask in (True, False):
        got = t_sddmm_bsr.sddmm_bsr(pat, h1, h2, mask_pattern=mask)
        want = t_sddmm_bsr.sddmm_bsr_plain(pat, h1, h2, mask_pattern=mask)
        assert torch.equal(got, want)
    assert cuda_build.launch_counts["sddmm_bsr"] == 0
    assert "tile_entries" not in vars(pat)


def test_tile_entries_cached_per_instance(rng):
    pat = tf.BsrMatrix.from_scipy(random_csr(rng, 200, 200, 3), block=128)
    assert pat.tile_entries is pat.tile_entries
    moved = tf.to_device(pat, "cpu")
    assert "tile_entries" not in vars(moved) and moved.tile_entries is not pat.tile_entries


def test_tile_rowcol_cached_without_the_entries(rng):
    """The dense-tile route's (trow, tcol) are tile_blocks', built once, and
    reading them builds no nonzero table; the table then shares them."""
    pat = tf.BsrMatrix.from_scipy(empty_row_block_matrix(rng, 128), block=128)
    trow, tcol = pat.tile_rowcol
    want_r, want_c = tf.tile_blocks(pat)
    assert torch.equal(trow, want_r) and torch.equal(tcol, want_c)
    assert pat.tile_rowcol[0] is trow and "tile_entries" not in vars(pat)
    te = pat.tile_entries
    assert te.trow is trow and te.tcol is tcol


def test_cuda_argument_checks(rng):
    pat = tf.BsrMatrix.from_scipy(random_csr(rng, 50, 60, 3), block=128)
    h1, h2 = torch.zeros(50, 8), torch.zeros(60, 8)
    t_sddmm_bsr._check_cuda_args(pat, h1, h2)  # CPU tensors stand in for the card's
    with pytest.raises(ValueError, match="one F"):
        t_sddmm_bsr._check_cuda_args(pat, h1, torch.zeros(60, 9))
    with pytest.raises(TypeError, match="h2"):
        t_sddmm_bsr._check_cuda_args(pat, h1, h2.double())
    with pytest.raises(ValueError, match="block"):
        t_sddmm_bsr._check_cuda_args(tf.BsrMatrix.from_scipy(random_csr(rng, 50, 60, 3), block=64),
                                     h1, h2)
