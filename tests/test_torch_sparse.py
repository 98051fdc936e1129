"""The PyTorch port's sparse operand builders against the JAX package's.

Every array a builder produces is compared exactly with the JAX builder's on
the same scipy input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch.ops import spmm as t_spmm
from graphconvgeo_torch.sparse import formats as tf
from graphconvgeo_tpu.data.synthetic import random_sbm_graph
from graphconvgeo_tpu.ops.spmm import device_operands as j_device_operands
from graphconvgeo_tpu.ops.spmm import resolve_backend as j_resolve_backend
from graphconvgeo_tpu.sparse import formats as jf
from tests.conftest import random_csr


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


def assert_bsr_flat_equal(t, j):
    for name in ("tiles", "rowblk", "colblk"):
        _eq(getattr(t, name), getattr(j, name), name)
    assert (t.n_rows, t.n_cols, t.block) == (j.n_rows, j.n_cols, j.block)
    rowblk = np.asarray(t.rowblk)
    want_ptr = np.searchsorted(rowblk, np.arange(t.n_row_blocks + 1))
    _eq(t.row_ptr, want_ptr, "row_ptr")
    # the JAX kernel's accumulator resets (``first``) are the port's run starts
    first = np.zeros(t.n_tiles, dtype=np.int32)
    first[np.asarray(t.row_ptr)[:-1]] = 1
    _eq(first, j.first, "first")


def assert_bell_equal(t, j):
    assert t.natural == j.natural and t.n_cols == j.n_cols
    assert len(t.indices) == len(j.indices)
    for a, b in zip(t.indices, j.indices):
        _eq(a, b, "indices")
    for a, b in zip(t.values, j.values):
        _eq(a, b, "values")
    for a, b in zip(t.row_ids, j.row_ids):
        _eq(a, b, "row_ids")
    _eq(t.perm, j.perm, "perm")
    _eq(t.inv_perm, j.inv_perm, "inv_perm")


def assert_cached_equal(t, j):
    _eq(t.hot_ids, j.hot_ids, "hot_ids")
    for part in ("hot", "hot_t", "cold", "cold_t"):
        assert_bell_equal(getattr(t, part), getattr(j, part))


def empty_row_block_matrix(rng, block):
    """Row block 0: many tiles; row block 1: none; the rest about one each."""
    n, c = 4 * block - 12, 3 * block + 16
    rows = np.r_[rng.integers(0, block, 20 * block), rng.integers(2 * block, n, 4 * block)]
    cols = np.r_[rng.integers(0, c, 20 * block), rng.integers(0, block, 4 * block)]
    m = sp.coo_matrix(
        (rng.normal(size=len(rows)).astype(np.float32), (rows, cols)), shape=(n, c)
    ).tocsr()
    m.sum_duplicates()
    return m


@pytest.mark.parametrize("block", [128, 256])
def test_bsr_flat_matches_with_empty_row_block(rng, block):
    m = empty_row_block_matrix(rng, block)
    t, j = tf.BsrFlat.from_scipy(m, block=block), jf.BsrFlat.from_scipy(m, block=block)
    assert_bsr_flat_equal(t, j)
    # the filler tile of row block 1 is all zero
    k = int(np.flatnonzero(np.asarray(t.rowblk) == 1)[0])
    assert not bool(t.tiles[k].any())
    mt = m.T.tocsr()
    assert_bsr_flat_equal(
        tf.BsrFlat.from_scipy(mt, block=block), jf.BsrFlat.from_scipy(mt, block=block)
    )


@pytest.mark.parametrize("layout", ["permuted", "natural"])
def test_bucketed_ell_matches(rng, layout):
    m = random_csr(rng, 300, 120, 5)
    if layout == "natural":
        deg = np.diff(m.indptr)
        kneed = np.power(2.0, np.ceil(np.log2(np.maximum(deg, 1))))
        m = m[np.argsort(-kneed, kind="stable")].tocsr()
    t, j = tf.BucketedEll.from_scipy(m), jf.BucketedEll.from_scipy(m)
    assert t.natural == (layout == "natural")
    assert_bell_equal(t, j)


def test_cached_bell_matches(rng):
    n = 2000
    m = random_csr(rng, n, n, 3)
    hubs = rng.integers(0, 16, 6000)
    m = m + sp.coo_matrix((np.ones(6000, np.float32), (rng.integers(0, n, 6000), hubs)),
                          shape=(n, n)).tocsr()
    m.sum_duplicates()
    t = tf.CachedBell.from_scipy(m, max_hot=16, min_fraction=0.3)
    j = jf.CachedBell.from_scipy(m, max_hot=16, min_fraction=0.3)
    assert t is not None and j is not None
    assert_cached_equal(t, j)
    assert tf.CachedBell.from_scipy(random_csr(rng, 4000, 4000, 2), max_hot=64) is None


@pytest.mark.parametrize("rest", ["none", "bell", "cached"])
def test_slabbed_bell_matches(rng, rest):
    n, v = 1200, 20000 if rest == "cached" else 1500
    m = random_csr(rng, n, v, 4)
    m.data = np.abs(m.data)
    # a Zipf head: the first 200 columns carry most of the mass
    head = sp.coo_matrix(
        (np.ones(12000, np.float32), (rng.integers(0, n, 12000), rng.integers(0, 200, 12000))),
        shape=(n, v),
    ).tocsr()
    m = (m + head).tocsr()
    m.sum_duplicates()
    kw = dict(slab_cols={"none": 4096, "bell": 128, "cached": 128}[rest])
    hot = rest == "cached"
    t = tf.SlabbedBell.from_scipy(m, slab_dtype=torch.float32, hot_cache=hot, **kw)
    j = jf.SlabbedBell.from_scipy(m, slab_dtype=jnp.float32, hot_cache=hot, **kw)
    _eq(t.cols, j.cols, "cols")
    _eq(t.slab, j.slab, "slab")
    assert t.n_cols == j.n_cols
    if j.rest is None:
        assert rest == "none" and t.rest is None and t.rest_t is None
    elif rest == "cached":
        assert isinstance(j.rest, jf.CachedBell) and t.rest_t is None
        assert_cached_equal(t.rest, j.rest)
    else:
        assert_bell_equal(t.rest, j.rest)
        assert_bell_equal(t.rest_t, j.rest_t)
    assert tf.SlabbedBell.from_scipy(random_csr(rng, 100, 2000, 3)) is None


def test_split_dense_tiles_and_coverage_match(rng):
    adj = random_sbm_graph(4096, 32, 8, seed=0)
    a_hat = tf.normalize_adjacency(adj)
    _eq(a_hat.toarray(), jf.normalize_adjacency(adj).toarray())
    for block, thr in ((128, 96), (256, 96), (256, 400)):
        (td, tr), (jd, jr) = (
            tf.split_dense_tiles(a_hat, block=block, min_tile_nnz=thr),
            jf.split_dense_tiles(a_hat, block=block, min_tile_nnz=thr),
        )
        for a, b in ((td, jd), (tr, jr)):
            _eq(a.indptr, b.indptr)
            _eq(a.indices, b.indices)
            _eq(a.data, b.data)
    tg = tf.SparseGraph(csr=a_hat, symmetric=True)
    jg = jf.SparseGraph(csr=a_hat, symmetric=True)
    assert tg.tile_coverage() == jg.tile_coverage()
    (tb, trest), (jb, jrest) = tg.hybrid(), jg.hybrid()
    assert_bsr_flat_equal(tb, jb)
    assert type(trest).__name__ == type(jrest).__name__
    assert_bell_equal(trest, jrest)


def test_resolve_backend_matches():
    n = 32768
    adj = random_sbm_graph(n, 128, 8, seed=0)
    perm = np.random.default_rng(1).permutation(n)
    for a in (adj, adj[perm][:, perm].tocsr()):
        a_hat = tf.normalize_adjacency(a)
        tg = tf.SparseGraph(csr=a_hat, symmetric=True)
        jg = jf.SparseGraph(csr=a_hat, symmetric=True)
        assert t_spmm.resolve_backend(tg) == j_resolve_backend(jg)
    assert t_spmm.resolve_backend(tg) == "bell"


def test_device_operands_not_ported_backends_raise(rng):
    """No backend is left unported. "factorized" is not a backend of a
    SparseGraph but an operand of its own (FactorizedAdjacency), so it is
    an unknown backend here, as in the JAX package."""
    g = tf.SparseGraph(csr=random_csr(rng, 50, 50, 3, symmetric=True), symmetric=True)
    with pytest.raises(ValueError, match="unknown backend"):
        t_spmm.device_operands(g, "factorized")
    with pytest.raises(ValueError):
        t_spmm.device_operands(g, "nope")


@pytest.mark.parametrize("backend", ["ell", "bsr", "oracle"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_device_operands_match_jax(rng, backend, symmetric):
    """The ell/oracle backends take the ELL operands (as the JAX model path
    does), bsr the padded-list BSR ones; arrays equal to JAX's."""
    m = random_csr(rng, 200, 200, 3, symmetric=symmetric)
    tg, jg = tf.SparseGraph(csr=m, symmetric=symmetric), jf.SparseGraph(csr=m, symmetric=symmetric)
    t_ops = t_spmm.device_operands(tg, backend)
    j_ops = j_device_operands(jg, backend)
    names = ("indices", "values") if backend != "bsr" else ("tiles", "tile_idx", "tile_col")
    for t, j in zip(t_ops, j_ops):
        assert type(t).__name__ == type(j).__name__
        for name in names:
            _eq(getattr(t, name), getattr(j, name), name)
        assert t.n_cols == j.n_cols
    fwd, tr = (tg.bsr, tg.bsr_t) if backend == "bsr" else (tg.ell, tg.ell_t)
    assert (tr() is fwd()) == symmetric


@pytest.mark.parametrize("slab_cols", [128, 4096])
def test_slabbed_bell_c_head_matches(rng, slab_cols):
    """c_head (the slab's column count) as JAX's, with the column count
    capped by slab_cols or set by the head (test_slabbed_bell_matches'
    operand)."""
    n, v = 1200, 1500
    m = random_csr(rng, n, v, 4)
    m.data = np.abs(m.data)
    head = sp.coo_matrix(
        (np.ones(12000, np.float32), (rng.integers(0, n, 12000), rng.integers(0, 200, 12000))),
        shape=(n, v),
    ).tocsr()
    m = (m + head).tocsr()
    m.sum_duplicates()
    t = tf.SlabbedBell.from_scipy(m, slab_cols=slab_cols, slab_dtype=torch.float32)
    j = jf.SlabbedBell.from_scipy(m, slab_cols=slab_cols, slab_dtype=jnp.float32)
    assert t.c_head == j.c_head == t.slab.shape[1] <= slab_cols


@pytest.mark.parametrize("isolated", [False, True], ids=["connected", "isolated_nodes"])
def test_normalized_adjacency_matches(rng, isolated):
    """SparseGraph.normalized_adjacency: JAX's Â (self-loops, symmetric
    degree scaling) as a symmetric graph, isolated nodes included."""
    a = random_csr(rng, 300, 300, 4, symmetric=True)
    a.data = np.abs(a.data)
    if isolated:
        a = a.tolil()
        a[:10, :] = 0
        a[:, :10] = 0
        a = a.tocsr()
        a.eliminate_zeros()
    t, j = tf.SparseGraph.normalized_adjacency(a), jf.SparseGraph.normalized_adjacency(a)
    assert t.symmetric and j.symmetric
    assert t.csr.dtype == j.csr.dtype
    np.testing.assert_array_equal(t.csr.indptr, j.csr.indptr)
    np.testing.assert_array_equal(t.csr.indices, j.csr.indices)
    np.testing.assert_array_equal(t.csr.data, j.csr.data)
