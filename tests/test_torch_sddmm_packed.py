"""The BSR SDDMM's two CUDA routes against the JAX Pallas kernel
``sddmm_bsr`` in interpret mode.

Mask on (the nonzero route): the per-tile table of a pattern's nonzeros
(``BsrMatrix.tile_entries``, what the CUDA kernel reads) is compared exactly
with the JAX package's tiles, and the route's scores (one dot product per
entry of the table, placed into a zeroed tile layout, here in torch ops
standing in for the kernel on the CPU) are held to JAX at rtol/atol 1e-5:
float32 sums of the same products taken in another order.

Mask off (the dense-tile kernel, 3×TF32 on the tensor cores): the split
each operand value takes there — hi = TF32(x), lo = TF32(x − hi), rounded to
nearest with 10 mantissa bits, emulated here by int32 bit operations — and
the three products lo·hi + hi·lo + hi·hi summed in float32 are held to JAX
(``Precision.HIGHEST``) within ``KERNEL_REL_TOL`` × max|ref|, the limit
``chip_smoke.py`` holds the kernel to on the card; one TF32 product alone
misses that limit on rows scaled over 1e-3…1e3.
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
KERNEL_REL_TOL = 1e-4  # chip_smoke.py's: max|kernel − ref| ≤ this × max|ref|


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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits' unit to
    the magnitude, then clear them."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> tuple:
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_scores(pattern, h1, h2, *, products: int):
    """The dense-tile kernel's scores emulated on the CPU: per tile, three
    TF32 products (lo·hi, hi·lo, hi·hi) summed in float32 — or, with
    ``products=1``, hi·hi alone; tile 0 zero."""
    b = pattern.block
    h1p, h2p = t_sddmm_bsr._padded_inputs(pattern, h1, h2)
    trow, tcol = pattern.tile_rowcol
    a = h1p.view(-1, b, h1p.shape[1])[trow.long()]
    c = h2p.view(-1, b, h2p.shape[1])[tcol.long()]
    (a_hi, a_lo), (c_hi, c_lo) = _split(a), _split(c)
    out = torch.bmm(a_hi, c_hi.transpose(1, 2))
    if products == 3:
        out = torch.bmm(a_lo, c_hi.transpose(1, 2)) + torch.bmm(a_hi, c_lo.transpose(1, 2)) + out
    out[0] = 0.0
    return out


def _max_rel_err(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


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


def test_tf32_round_is_round_to_nearest_10_bits():
    """The emulated TF32 rounding keeps 10 mantissa bits, rounds to
    nearest (ties away from zero) and splits x into hi + lo to about
    float32's precision."""
    one = 1.0
    ulp = 2.0**-10  # TF32's unit at 1
    x = torch.tensor([one, one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4, -(one + ulp / 2),
                      3.0e-3, -7.5e2], dtype=torch.float32)
    got = _tf32(x)
    assert got[:5].tolist() == [1.0, 1.0, 1.0 + ulp, 1.0 + ulp, -(1.0 + ulp)]
    assert not (got.view(torch.int32) & 0x1FFF).any()
    hi, lo = _split(torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32)))
    x = hi + lo
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((hi.double() + lo.double()) - x.double()).abs().max() / x.abs().max()) < 2**-21


@pytest.mark.parametrize("kind,block,f", [
    ("rect", 128, 70), ("empty_row_block", 128, 300), ("padding_row_block", 256, 40),
])
def test_3xtf32_split_matches_jax_dense_sddmm(rng, kind, block, f):
    """Mask off: the kernel's three TF32 products against JAX's
    ``sddmm_bsr(mask_pattern=False)`` (interpret mode, float32) within the
    card's limit; tile 0 exactly zero."""
    m = _pattern(kind, rng, block)
    h1 = rng.normal(size=(m.shape[0], f)).astype(np.float32)
    h2 = rng.normal(size=(m.shape[1], f)).astype(np.float32)
    pat = tf.BsrMatrix.from_scipy(m, block=block)
    got = _tf32_scores(pat, torch.from_numpy(h1), torch.from_numpy(h2), products=3).numpy()
    want = np.asarray(j_sddmm_bsr(jf.BsrMatrix.from_scipy(m, block=block), jnp.asarray(h1),
                                  jnp.asarray(h2), mask_pattern=False, interpret=True))
    assert got.shape == want.shape == (pat.n_tiles + 1, block, block)
    assert _max_rel_err(got, want) <= KERNEL_REL_TOL
    assert not got[0].any()


def test_one_tf32_product_misses_the_limit_three_meet_it():
    """A full 128² tile at F 300 whose rows are scaled over 1e-3…1e3: hi·hi
    alone (about three digits) misses ``KERNEL_REL_TOL``; the three
    products meet it by two orders of magnitude. This is why the kernel
    does three."""
    rng = np.random.default_rng(42)
    b, f = 128, 300
    full = sp.csr_matrix(np.ones((b, b), np.float32))
    scale = lambda: 10.0 ** rng.uniform(-3.0, 3.0, (b, 1))
    h1 = (rng.normal(size=(b, f)) * scale()).astype(np.float32)
    h2 = (rng.normal(size=(b, f)) * scale()).astype(np.float32)
    pat = tf.BsrMatrix.from_scipy(full, block=b)
    want = np.asarray(j_sddmm_bsr(jf.BsrMatrix.from_scipy(full, block=b), jnp.asarray(h1),
                                  jnp.asarray(h2), mask_pattern=False, interpret=True))
    errs = {k: _max_rel_err(_tf32_scores(pat, torch.from_numpy(h1), torch.from_numpy(h2),
                                         products=k).numpy(), want) for k in (1, 3)}
    assert errs[1] > 2 * KERNEL_REL_TOL
    assert errs[3] < KERNEL_REL_TOL / 100


def test_dense_kernel_reads_h_in_place_where_it_can(rng):
    """Mask off, the CUDA route pads F only to a multiple of 4, and only
    where it must: contiguous, aligned rows of such a width go as they are;
    a misaligned start is copied at its width."""
    h = torch.from_numpy(rng.normal(size=(50, 300)).astype(np.float32))
    assert t_sddmm_bsr._dense_kernel_input(h) is h
    shifted = torch.zeros(50 * 300 + 1)[1:].view(50, 300)  # contiguous, 4 bytes off
    for odd in (torch.from_numpy(rng.normal(size=(50, 30)).astype(np.float32)), h[:, :298], h[:, 2:],
                shifted):
        got = t_sddmm_bsr._dense_kernel_input(odd)
        assert got.shape[1] % 4 == 0 and got.shape[1] - odd.shape[1] < 4 and got.is_contiguous()
        assert got.data_ptr() % 16 == 0
        assert torch.equal(got[:, : odd.shape[1]], odd) and not got[:, odd.shape[1]:].any()


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
