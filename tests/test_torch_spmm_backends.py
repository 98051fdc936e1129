"""The port's ``ell``, ``oracle`` and ``bsr`` SpMM backends, the SDDMMs and
the row gather against the JAX package's.

Operands are compared exactly. On CPU tensors the padded-list BSR product
and the BSR SDDMM run their plain PyTorch versions while the JAX side runs
the Pallas kernels in interpret mode; products at rtol/atol 1e-5 (both sum
the same float32 products in different orders). The row gather copies
bytes, so it is held bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch.ops import gather as t_gather
from graphconvgeo_torch.ops import sddmm_bsr as t_sddmm_bsr
from graphconvgeo_torch.ops import spmm as t_spmm
from graphconvgeo_torch.ops import spmm_bsr as t_bsr
from graphconvgeo_torch.ops.sddmm import sddmm_ell as t_sddmm_ell
from graphconvgeo_torch.sparse import formats as tf
from graphconvgeo_torch.utils import cuda_build
from graphconvgeo_tpu.ops.spmm import device_operands as j_device_operands
from graphconvgeo_tpu.ops.spmm import spmm as j_spmm
from graphconvgeo_tpu.ops.spmm import spmm_ell_trainable as j_spmm_ell_trainable
from graphconvgeo_tpu.ops.spmm import spmm_operands as j_spmm_operands
from graphconvgeo_tpu.ops.gather_pallas import gather_rows_pallas
from graphconvgeo_tpu.ops.sddmm import sddmm_ell as j_sddmm_ell
from graphconvgeo_tpu.ops.sddmm_pallas import sddmm_bsr as j_sddmm_bsr
from graphconvgeo_tpu.ops.spmm_pallas import spmm_bsr as j_spmm_bsr
from graphconvgeo_tpu.sparse import formats as jf
from tests.conftest import random_csr
from tests.test_torch_spmm import _jax_fwd_bwd, _torch_fwd_bwd, empty_row_block_matrix

TOL = dict(rtol=1e-5, atol=1e-5)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


def _matrix(kind, rng, block=128):
    """square (symmetric), rectangular, or with an empty row block."""
    if kind == "square":
        return random_csr(rng, 300, 300, 4, symmetric=True)
    if kind == "rect":
        return random_csr(rng, 200, 330, 5)
    return empty_row_block_matrix(rng, block)


@pytest.mark.parametrize("kind", ["square", "rect", "empty_row_block"])
@pytest.mark.parametrize("pad_rows_to", [1, 8])
def test_ell_matrix_matches_jax(rng, kind, pad_rows_to):
    m = _matrix(kind, rng)
    t = tf.EllMatrix.from_scipy(m, pad_rows_to=pad_rows_to)
    j = jf.EllMatrix.from_scipy(m, pad_rows_to=pad_rows_to)
    assert t.indices.dtype == torch.int32 and t.values.dtype == torch.float32
    _eq(t.indices, j.indices, "indices")
    _eq(t.values, j.values, "values")
    assert (t.n_rows, t.k, t.n_cols) == (j.n_rows, j.k, j.n_cols)


@pytest.mark.parametrize("kind", ["square", "rect", "empty_row_block"])
@pytest.mark.parametrize("block", [128, 256])
def test_bsr_matrix_matches_jax(rng, kind, block):
    m = _matrix(kind, rng, block)
    for mm in (m, m.T.tocsr()):
        t = tf.BsrMatrix.from_scipy(mm, block=block)
        j = jf.BsrMatrix.from_scipy(mm, block=block)
        assert t.tile_idx.dtype == t.tile_col.dtype == torch.int32
        for name in ("tiles", "tile_idx", "tile_col"):
            _eq(getattr(t, name), getattr(j, name), name)
        assert not t.tiles[0].any()
        for prop in ("n_rows", "n_cols", "block", "n_row_blocks", "k_max", "n_rows_padded",
                     "n_cols_padded"):
            assert getattr(t, prop) == getattr(j, prop), prop
        stats, want = t.density_stats(), j.density_stats()
        assert stats == pytest.approx(want)
        assert t.n_tiles == want["n_tiles"]
    if kind == "empty_row_block":  # row block 1: padding slots only
        fwd = tf.BsrMatrix.from_scipy(m, block=block)
        assert not fwd.tile_idx[1].any() and fwd.k_max > 1
    with pytest.raises(ValueError, match="too scattered"):
        tf.BsrMatrix.from_scipy(m, block=block, max_tiles=1)


def test_sparse_graph_ell_and_bsr_operands(rng):
    m = random_csr(rng, 100, 100, 3, symmetric=True)
    g = tf.SparseGraph(csr=m, symmetric=True)
    assert g.ell_t() is g.ell() and g.bsr_t() is g.bsr()
    assert g.bsr(256) is g.bsr(256) and g.bsr(256).block == 256
    a = tf.SparseGraph(csr=random_csr(rng, 60, 90, 3))
    assert a.ell_t() is not a.ell() and a.ell_t() is a.ell_t()
    assert (a.ell_t().n_rows, a.ell_t().n_cols) == (90, 60)
    assert (a.bsr_t().n_rows, a.bsr_t().n_cols) == (90, 60)


@pytest.mark.parametrize(
    "block,symmetric,f",
    [(128, True, 40), (128, False, 130), (256, True, 24), (256, False, 300)],
)
def test_spmm_bsr_matches_jax(rng, block, symmetric, f):
    m = random_csr(rng, 300, 300, 4, symmetric=True) if symmetric else empty_row_block_matrix(rng, block)
    mt = m if symmetric else m.T.tocsr()
    h = rng.normal(size=(m.shape[1], f)).astype(np.float32)
    w = rng.normal(size=(m.shape[0], f)).astype(np.float32)
    cuda_build.reset_launch_counts()
    t_mat, t_mat_t = tf.BsrMatrix.from_scipy(m, block=block), tf.BsrMatrix.from_scipy(mt, block=block)
    got, got_dh = _torch_fwd_bwd(lambda x: t_bsr.spmm_bsr(t_mat, t_mat_t, x), h, w)
    j_mat, j_mat_t = jf.BsrMatrix.from_scipy(m, block=block), jf.BsrMatrix.from_scipy(mt, block=block)
    want, want_dh = _jax_fwd_bwd(lambda x: j_spmm_bsr(j_mat, j_mat_t, x), h, w)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_dh, want_dh, **TOL)
    np.testing.assert_allclose(got, m @ h, rtol=1e-4, atol=1e-4)
    if not symmetric:  # the padding-only row block 1 comes out exactly zero
        assert not got[block : 2 * block].any()
    assert cuda_build.launch_counts["bsr_matmul"] == 0  # CPU: the plain version


def test_spmm_bsr_refuses_other_contractions_and_devices(rng):
    """float32 and bfloat16 contractions are ported (bf16: tests/
    test_torch_factorized.py); any other is refused."""
    mat = tf.BsrMatrix.from_scipy(random_csr(rng, 50, 50, 3), block=128)
    with pytest.raises(ValueError, match="mxu_dtype"):
        t_bsr.spmm_bsr(mat, mat, torch.zeros(50, 8), mxu_dtype=torch.float16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_bsr.bsr_matmul(mat, torch.zeros(mat.n_cols_padded, 128, device="meta"))


def test_hybrid_dispatch_with_bsr_matrix_part(rng):
    """A hybrid tuple whose dense part is a BsrMatrix runs spmm_bsr, as the
    JAX dispatch does."""
    n = 400
    blocks = sp.block_diag([random_csr(rng, 100, 100, 30) for _ in range(4)]).tocsr()
    m = (blocks + random_csr(rng, n, n, 2)).tocsr()
    m.sum_duplicates()
    dense, rest = tf.split_dense_tiles(m, block=128, min_tile_nnz=96)
    t_op = (tf.BsrMatrix.from_scipy(dense), tf.BucketedEll.from_scipy(rest))
    t_op_t = (tf.BsrMatrix.from_scipy(dense.T.tocsr()), tf.BucketedEll.from_scipy(rest.T.tocsr()))
    j_op = (jf.BsrMatrix.from_scipy(dense), jf.BucketedEll.from_scipy(rest))
    j_op_t = (jf.BsrMatrix.from_scipy(dense.T.tocsr()), jf.BucketedEll.from_scipy(rest.T.tocsr()))
    h = rng.normal(size=(n, 20)).astype(np.float32)
    w = rng.normal(size=(n, 20)).astype(np.float32)
    got, got_dh = _torch_fwd_bwd(lambda x: t_spmm.spmm_operands(t_op, t_op_t, x, n_rows=n), h, w)
    want, want_dh = _jax_fwd_bwd(lambda x: j_spmm_operands(j_op, j_op_t, x, n_rows=n), h, w)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_dh, want_dh, **TOL)
    np.testing.assert_allclose(got, m @ h, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["ell", "oracle", "bsr"])
@pytest.mark.parametrize("shape", [(120, 120), (90, 140)])
def test_spmm_backends_match_jax(rng, backend, shape):
    """The eager spmm and the operand dispatch, forward and backward."""
    m = random_csr(rng, *shape, 4, symmetric=shape[0] == shape[1])
    sym = shape[0] == shape[1]
    tg, jg = tf.SparseGraph(csr=m, symmetric=sym), jf.SparseGraph(csr=m, symmetric=sym)
    f = 12
    h = rng.normal(size=(shape[1], f)).astype(np.float32)
    w = rng.normal(size=(shape[0], f)).astype(np.float32)
    t_op, t_op_t = t_spmm.device_operands(tg, backend)
    # built outside jit: the JAX graph caches its operands on first use
    j_op, j_op_t = j_device_operands(jg, backend)
    jg.ell()
    got, got_dh = _torch_fwd_bwd(lambda x: t_spmm.spmm(tg, x, backend=backend), h, w)
    want, want_dh = _jax_fwd_bwd(lambda x: j_spmm(jg, x, backend=backend), h, w)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_dh, want_dh, **TOL)
    np.testing.assert_allclose(got, m @ h, rtol=1e-4, atol=1e-4)
    n = shape[0]
    got2, got2_dh = _torch_fwd_bwd(lambda x: t_spmm.spmm_operands(t_op, t_op_t, x, n_rows=n), h, w)
    want2, want2_dh = _jax_fwd_bwd(lambda x: j_spmm_operands(j_op, j_op_t, x, n_rows=n), h, w)
    np.testing.assert_allclose(got2, want2, **TOL)
    np.testing.assert_allclose(got2_dh, want2_dh, **TOL)


def test_spmm_ell_trainable_value_grads_match_jax(rng):
    """The value gradient of spmm_ell_trainable (SDDMM on the pattern), as
    tests/test_ops.py holds the JAX one; the default ELL product leaves the
    values constant."""
    m = random_csr(rng, 30, 24, 4)
    tg, jg = tf.SparseGraph(csr=m), jf.SparseGraph(csr=m)
    h = rng.normal(size=(24, 8)).astype(np.float32)
    w = rng.normal(size=(30, 8)).astype(np.float32)
    j_ell, j_ell_t = jg.ell(), jg.ell_t()

    def j_loss(values, hh):
        mat = dataclasses.replace(j_ell, values=values)
        return jnp.sum(j_spmm_ell_trainable(mat, j_ell_t, hh) * jnp.asarray(w))

    want_dv, want_dh = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(j_ell.values, jnp.asarray(h))
    t_ell, t_ell_t = tg.ell(), tg.ell_t()
    values = t_ell.values.clone().requires_grad_(True)
    ht = torch.tensor(h, requires_grad=True)
    mat = dataclasses.replace(t_ell, values=values)
    (t_spmm.spmm_ell_trainable(mat, t_ell_t, ht) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(values.grad.numpy(), np.asarray(want_dv), **TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_dh), **TOL)
    # against the dense reference at the nonzeros: dL/dA[i, j] = <w[i], h[j]>
    idx, val = t_ell.indices.long().numpy(), t_ell.values.numpy()
    want = np.where(val != 0, (w @ h.T)[np.arange(30)[:, None], idx], 0.0)
    np.testing.assert_allclose(np.where(val != 0, values.grad.numpy(), 0.0), want, rtol=1e-4, atol=1e-4)
    # the standard ELL product treats the values as constants
    v2 = t_ell.values.clone().requires_grad_(True)
    out = t_spmm.spmm_ell(dataclasses.replace(t_ell, values=v2), t_ell_t, torch.from_numpy(h))
    assert not out.requires_grad


def test_sddmm_ell_matches_jax(rng):
    m = random_csr(rng, 20, 25, 4)
    ell = tf.EllMatrix.from_scipy(m)
    a = rng.normal(size=(ell.n_rows, 13)).astype(np.float32)
    b = rng.normal(size=(25, 13)).astype(np.float32)
    got = t_sddmm_ell(ell.indices, torch.from_numpy(a), torch.from_numpy(b))
    want = jax.jit(j_sddmm_ell)(jnp.asarray(ell.indices.numpy()), jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (ell.n_rows, ell.k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mask_pattern", [True, False])
@pytest.mark.parametrize("kind", ["rect", "empty_row_block"])
def test_sddmm_bsr_matches_jax(rng, mask_pattern, kind):
    m = random_csr(rng, 300, 280, 5) if kind == "rect" else empty_row_block_matrix(rng, 128)
    f = 70
    h1 = rng.normal(size=(m.shape[0], f)).astype(np.float32)
    h2 = rng.normal(size=(m.shape[1], f)).astype(np.float32)
    cuda_build.reset_launch_counts()
    t_pat = tf.BsrMatrix.from_scipy(m, block=128)
    got = t_sddmm_bsr.sddmm_bsr(t_pat, torch.from_numpy(h1), torch.from_numpy(h2),
                                mask_pattern=mask_pattern).numpy()
    want = np.asarray(j_sddmm_bsr(jf.BsrMatrix.from_scipy(m, block=128), jnp.asarray(h1),
                                  jnp.asarray(h2), mask_pattern=mask_pattern))
    assert got.shape == (t_pat.n_tiles + 1, 128, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any()
    if mask_pattern:
        assert not got[t_pat.tiles.numpy() == 0].any()
    assert cuda_build.launch_counts["sddmm_bsr"] == 0


def test_sddmm_bsr_tile_blocks(rng):
    """Each tile's (row block, column block), built with torch ops, equals
    the JAX package's numpy tables; padding slots leave tile 0 at (0, 0)."""
    m = empty_row_block_matrix(rng, 128)
    pat = tf.BsrMatrix.from_scipy(m, block=128)
    trow, tcol = t_sddmm_bsr.tile_blocks(pat)
    tidx, tc = pat.tile_idx.numpy(), pat.tile_col.numpy()
    want_r = np.zeros(pat.n_tiles + 1, np.int32)
    want_c = np.zeros(pat.n_tiles + 1, np.int32)
    for r in range(pat.n_row_blocks):
        for k in range(pat.k_max):
            if tidx[r, k]:
                want_r[tidx[r, k]], want_c[tidx[r, k]] = r, tc[r, k]
    _eq(trow, want_r, "trow")
    _eq(tcol, want_c, "tcol")
    assert trow.dtype == tcol.dtype == torch.int32


@pytest.mark.parametrize("dtype,f", [("float32", 128), ("bfloat16", 256)])
def test_gather_rows_matches_jax(rng, dtype, f):
    n, m_rows = 90, 300  # 300 rows: not a multiple of the JAX kernel's block
    h = rng.normal(size=(n, f)).astype(np.float32)
    idx = rng.integers(0, n, m_rows).astype(np.int32)
    idx[:2], idx[-1] = 0, n - 1
    jh = jnp.asarray(h).astype(jnp.dtype(dtype))
    want = np.asarray(gather_rows_pallas(jh, jnp.asarray(idx), block_rows=128).astype(jnp.float32))
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    cuda_build.reset_launch_counts()
    got = t_gather.gather_rows(th, torch.from_numpy(idx))
    assert got.dtype == th.dtype and got.shape == (m_rows, f)
    _eq(got.float().numpy(), want)
    _eq(t_gather.gather_rows_plain(th, torch.from_numpy(idx)).float().numpy(), want)
    assert cuda_build.launch_counts["gather_rows"] == 0


def test_new_wrappers_reject_other_devices(rng):
    pat = tf.BsrMatrix.from_scipy(random_csr(rng, 50, 50, 3), block=128)
    meta = torch.zeros(50, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_sddmm_bsr.sddmm_bsr(pat, meta, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_gather.gather_rows(meta, torch.zeros(3, dtype=torch.int32, device="meta"))
