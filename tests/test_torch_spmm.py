"""The PyTorch port's SpMM against the JAX package's, forward and backward.

On CPU tensors the flat-tile BSR product runs its plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode. Tolerance rtol 1e-5,
atol 1e-5: both sum the same float32 products in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch.ops import spmm as t_spmm
from graphconvgeo_torch.ops import spmm_bsr as t_bsr
from graphconvgeo_torch.sparse import formats as tf
from graphconvgeo_torch.utils import cuda_build
from graphconvgeo_tpu.ops.spmm import spmm_operands as j_spmm_operands
from graphconvgeo_tpu.ops.spmm_pallas import spmm_bsr_flat as j_spmm_bsr_flat
from graphconvgeo_tpu.sparse import formats as jf
from tests.conftest import random_csr

TOL = dict(rtol=1e-5, atol=1e-5)


def empty_row_block_matrix(rng, block):
    """Row block 0: many tiles; row block 1: none; the rest about one each
    (the shape of tests/test_ops.py's flat-BSR case)."""
    n, c = 4 * block - 12, 3 * block + 16
    rows = np.r_[rng.integers(0, block, 20 * block), rng.integers(2 * block, n, 4 * block)]
    cols = np.r_[rng.integers(0, c, 20 * block), rng.integers(0, block, 4 * block)]
    m = sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(n, c)
    ).tocsr()
    m.sum_duplicates()
    return m


def _torch_fwd_bwd(fn, h, w):
    ht = torch.tensor(h, requires_grad=True)
    out = fn(ht)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), ht.grad.numpy()


def _jax_fwd_bwd(fn, h, w):
    """fn(h) and d<fn(h), w>/dh, each as one jitted program (one compile
    instead of one per op)."""
    out = jax.jit(fn)(jnp.asarray(h))
    dh = jax.jit(jax.grad(lambda x: jnp.sum(fn(x) * jnp.asarray(w))))(jnp.asarray(h))
    return np.asarray(out), np.asarray(dh)


@pytest.mark.parametrize("block", [128, 256])
def test_spmm_bsr_flat_matches_jax(rng, block):
    m = empty_row_block_matrix(rng, block)
    mt = m.T.tocsr()
    f = 40
    h = rng.normal(size=(m.shape[1], f)).astype(np.float32)
    w = rng.normal(size=(m.shape[0], f)).astype(np.float32)
    cuda_build.reset_launch_counts()
    t_mat, t_mat_t = tf.BsrFlat.from_scipy(m, block=block), tf.BsrFlat.from_scipy(mt, block=block)
    got, got_dh = _torch_fwd_bwd(lambda x: t_bsr.spmm_bsr_flat(t_mat, t_mat_t, x), h, w)
    j_mat, j_mat_t = jf.BsrFlat.from_scipy(m, block=block), jf.BsrFlat.from_scipy(mt, block=block)
    want, want_dh = _jax_fwd_bwd(lambda x: j_spmm_bsr_flat(j_mat, j_mat_t, x), h, w)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_dh, want_dh, **TOL)
    np.testing.assert_allclose(got, m @ h, rtol=1e-4, atol=1e-4)
    # the empty row block's rows are exactly zero
    assert not got[block : 2 * block].any()
    # CPU tensors take the plain version: the kernel never launched
    assert cuda_build.launch_counts["bsr_flat_matmul"] == 0


def test_bsr_flat_wrapper_rejects_other_devices(rng):
    m = empty_row_block_matrix(rng, 128)
    mat = tf.BsrFlat.from_scipy(m, block=128)
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_bsr.bsr_flat_matmul(mat, torch.zeros(mat.n_cols_padded, 128, device="meta"))


def _operands(kind, rng):
    """(port operand, port transpose, JAX operand, JAX transpose, n_rows, n_cols)."""
    if kind == "bell":
        m = random_csr(rng, 300, 300, 5, symmetric=True)
        return (tf.BucketedEll.from_scipy(m), tf.BucketedEll.from_scipy(m.T.tocsr()),
                jf.BucketedEll.from_scipy(m), jf.BucketedEll.from_scipy(m.T.tocsr()), m)
    if kind.startswith("hybrid"):
        # community blocks (dense tiles) + scattered residual edges
        n = 600
        blocks = sp.block_diag([random_csr(rng, 150, 150, 40) for _ in range(4)]).tocsr()
        noise = random_csr(rng, n, n, 2)
        if kind == "hybrid_cached":
            # column-skewed residual: 16 hub columns, too few edges per tile
            # to be densified
            noise = random_csr(rng, n, n, 0.5)
            hub_cols = rng.choice(n, 16, replace=False)
            hub = sp.coo_matrix(
                (np.ones(480, np.float32), (rng.integers(0, n, 480), rng.choice(hub_cols, 480))),
                shape=(n, n),
            ).tocsr()
            noise = noise + hub
        m = (blocks + noise).tocsr()
        m.sum_duplicates()
        mt = m.T.tocsr()
        t_parts, j_parts = [], []
        for mm in (m, mt):
            td_, tr_ = tf.split_dense_tiles(mm, block=128, min_tile_nnz=96)
            t_rest = j_rest = None
            if kind == "hybrid_cached":
                # the forward residual is column-skewed; a CachedBell rest is
                # self-contained, so the transpose's rest goes unused
                t_rest = tf.CachedBell.from_scipy(tr_, max_hot=16, min_fraction=0.25)
                j_rest = jf.CachedBell.from_scipy(tr_, max_hot=16, min_fraction=0.25)
                assert mm is mt or t_rest is not None
            if t_rest is None:
                t_rest, j_rest = tf.BucketedEll.from_scipy(tr_), jf.BucketedEll.from_scipy(tr_)
            t_parts.append((tf.BsrFlat.from_scipy(td_, block=128), t_rest))
            j_parts.append((jf.BsrFlat.from_scipy(td_, block=128), j_rest))
        return (*t_parts, *j_parts, m)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["bell", "hybrid", "hybrid_cached"])
def test_spmm_operands_matches_jax(rng, kind):
    t_op, t_op_t, j_op, j_op_t, m = _operands(kind, rng)
    f = 24
    h = rng.normal(size=(m.shape[1], f)).astype(np.float32)
    w = rng.normal(size=(m.shape[0], f)).astype(np.float32)
    n = m.shape[0]
    got, got_dh = _torch_fwd_bwd(lambda x: t_spmm.spmm_operands(t_op, t_op_t, x, n_rows=n), h, w)
    want, want_dh = _jax_fwd_bwd(lambda x: j_spmm_operands(j_op, j_op_t, x, n_rows=n), h, w)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_dh, want_dh, **TOL)
    np.testing.assert_allclose(got, m @ h, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rest", ["none", "bell"])
def test_spmm_slabbed_matches_jax(rng, rest):
    n, v = 1100, 1280 if rest == "none" else 1400
    x = random_csr(rng, n, v, 5)
    x.data = np.abs(x.data)
    slab_cols = 4096 if rest == "none" else 256
    t_op = tf.SlabbedBell.from_scipy(x, slab_cols=slab_cols, slab_dtype=torch.float32)
    j_op = jf.SlabbedBell.from_scipy(x, slab_cols=slab_cols, slab_dtype=jnp.float32)
    assert (t_op.rest is None) == (rest == "none")
    f = 32
    w0 = (rng.normal(size=(v, f)) * 0.1).astype(np.float32)
    g = rng.normal(size=(n, f)).astype(np.float32)
    got, got_dw = _torch_fwd_bwd(lambda x_: t_spmm.spmm_operands(t_op, None, x_, n_rows=n), w0, g)
    want, want_dw = _jax_fwd_bwd(lambda x_: j_spmm_operands(j_op, None, x_, n_rows=n), w0, g)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_dw, want_dw, **TOL)
