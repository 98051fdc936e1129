"""The packed-row form of the block-sparse operands (``PackedRows``, what
the packed-row CUDA kernel reads) against scipy and the JAX package.

The pack is compared exactly: its entries are the tiles' own float32
values. A CSR product over it (``index_add``, a helper standing in for the
kernel on the CPU) is held against the JAX Pallas kernels ``_bsr_flat_matmul``
and ``_bsr_matmul`` in interpret mode at rtol/atol 1e-5: the same float32
products, summed in another order.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch.models import gcn as t_gcn
from graphconvgeo_torch.ops import spmm_bsr as t_bsr
from graphconvgeo_torch.sparse import formats as tf
from graphconvgeo_tpu.ops.spmm_pallas import _bsr_flat_matmul, _bsr_matmul
from graphconvgeo_tpu.sparse import formats as jf
from tests.conftest import random_csr
from tests.test_torch_spmm import empty_row_block_matrix
from tests.test_torch_spmm_backends import _matrix

TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ["square", "rect", "empty_row_block"]
CLASSES = {"flat": (tf.BsrFlat, jf.BsrFlat), "padded": (tf.BsrMatrix, jf.BsrMatrix)}


def _row_ids(pk):
    return torch.repeat_interleave(
        torch.arange(pk.row_ptr.shape[0] - 1), torch.diff(pk.row_ptr.long())
    )


def _to_scipy(pk, shape):
    return sp.csr_matrix(
        (pk.val.numpy(), pk.col.numpy(), pk.row_ptr.numpy().astype(np.int64)), shape=shape
    )


def _csr_product(pk, h):
    """out[r] = Σ val·h[col] over row r's entries, as the kernel sums them."""
    out = torch.zeros(pk.row_ptr.shape[0] - 1, h.shape[1])
    return out.index_add_(0, _row_ids(pk), pk.val[:, None] * h[pk.col.long()])


def _padded_dense(m, shape):
    d = np.zeros(shape, np.float32)
    d[: m.shape[0], : m.shape[1]] = m.toarray()
    return d


def _jax_dense(j, cls_name):
    """The JAX operand's tiles scattered to one dense matrix by its own
    index map (padding slots name the zero tile 0)."""
    b = j.block
    tiles = np.asarray(j.tiles)
    if cls_name == "flat":
        slots = zip(np.asarray(j.rowblk), np.arange(tiles.shape[0]), np.asarray(j.colblk))
    else:
        rb, k_max = j.tile_idx.shape
        slots = zip(np.repeat(np.arange(rb), k_max), np.asarray(j.tile_idx).ravel(),
                    np.asarray(j.tile_col).ravel())
    d = np.zeros((j.n_rows_padded, j.n_cols_padded), np.float32)
    for r, t, c in slots:
        d[r * b : (r + 1) * b, c * b : (c + 1) * b] += tiles[t]
    return d


@pytest.mark.parametrize("cls_name", list(CLASSES))
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_pack_matches_scipy(rng, kind, block, cls_name):
    m = _matrix(kind, rng, block)
    op = CLASSES[cls_name][0].from_scipy(m, block=block)
    pk = op.packed
    assert pk.row_ptr.dtype == pk.col.dtype == torch.int32 and pk.val.dtype == torch.float32
    assert tuple(pk.row_ptr.shape) == (op.n_rows_padded + 1,)
    assert pk.nnz == m.nnz == int((op.tiles != 0).sum())
    shape = (op.n_rows_padded, op.n_cols_padded)
    np.testing.assert_array_equal(_to_scipy(pk, shape).toarray(), _padded_dense(m, shape))
    rp, col = pk.row_ptr.numpy(), pk.col.numpy()
    # from_scipy lists a row block's slots by column block, so each row's
    # columns rise strictly; padded rows and empty row blocks hold nothing
    for i in range(op.n_rows_padded):
        assert np.all(np.diff(col[rp[i] : rp[i + 1]]) > 0)
    assert rp[m.shape[0]] == rp[-1] == m.nnz
    if kind == "empty_row_block":
        assert rp[block] == rp[2 * block]


@pytest.mark.parametrize("cls_name", list(CLASSES))
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_pack_matches_jax_tiles(rng, kind, block, cls_name):
    m = _matrix(kind, rng, block)
    t_cls, j_cls = CLASSES[cls_name]
    for mm in (m, m.T.tocsr()):
        op, j = t_cls.from_scipy(mm, block=block), j_cls.from_scipy(mm, block=block)
        got = _to_scipy(op.packed, (op.n_rows_padded, op.n_cols_padded)).toarray()
        np.testing.assert_array_equal(got, _jax_dense(j, cls_name))


def _hand_built(cls_name, rng):
    """A B = 128 operand whose row block 0 lists its slots against column
    order (column blocks 2, 0, 1) and names tile 1 twice, beside a row block
    of padding only."""
    b = 128
    tiles = np.zeros((4, b, b), np.float32)
    for t in (1, 2, 3):  # two entries in every row of every tile
        r, c = np.repeat(np.arange(b), 2), rng.integers(0, b, 2 * b)
        tiles[t, r, c] = rng.uniform(0.5, 1.5, 2 * b).astype(np.float32)
    if cls_name == "flat":
        # row block 1 holds only a zero filler tile
        return tf.BsrFlat(
            tiles=torch.from_numpy(tiles[[1, 2, 3, 0, 1]]),
            rowblk=torch.tensor([0, 0, 0, 1, 2], dtype=torch.int32),
            colblk=torch.tensor([2, 0, 1, 0, 0], dtype=torch.int32),
            row_ptr=torch.tensor([0, 3, 4, 5], dtype=torch.int32),
            n_rows=3 * b, n_cols=3 * b, block=b,
        )
    return tf.BsrMatrix(
        tiles=torch.from_numpy(tiles),
        tile_idx=torch.tensor([[1, 2, 3], [0, 0, 0], [1, 0, 0]], dtype=torch.int32),
        tile_col=torch.tensor([[2, 0, 1], [0, 0, 0], [0, 0, 0]], dtype=torch.int32),
        n_rows=3 * b, n_cols=3 * b, block=b,
    )


@pytest.mark.parametrize("cls_name", list(CLASSES))
def test_pack_orders_rows_by_slot_then_column(rng, cls_name):
    op = _hand_built(cls_name, rng)
    b = op.block
    pk = op.packed
    rp, col = pk.row_ptr.numpy(), pk.col.numpy()
    for i in range(b):  # row block 0: its column blocks in slot order 2, 0, 1
        cols = col[rp[i] : rp[i + 1]]
        blocks = cols // b
        runs = blocks[np.r_[True, blocks[1:] != blocks[:-1]]]
        assert list(runs) == [x for x in (2, 0, 1) if x in set(blocks)]
        for blk in set(blocks):  # inside a tile, by column
            assert np.all(np.diff(cols[blocks == blk]) > 0)
    assert rp[b] == rp[2 * b]  # row block 1: padding / filler only
    h = torch.from_numpy(rng.normal(size=(op.n_cols_padded, 8)).astype(np.float32))
    plain = t_bsr.bsr_flat_matmul_plain if cls_name == "flat" else t_bsr.bsr_matmul_plain
    np.testing.assert_allclose(_csr_product(pk, h).numpy(), plain(op, h).numpy(), **TOL)


@pytest.mark.parametrize("cls_name", list(CLASSES))
def test_pack_is_cached_per_instance(rng, cls_name, monkeypatch):
    calls = []
    real = tf.pack_rows
    monkeypatch.setattr(tf, "pack_rows", lambda *a: calls.append(1) or real(*a))
    op = CLASSES[cls_name][0].from_scipy(random_csr(rng, 300, 300, 4, symmetric=True), block=128)
    # the CPU wrapper takes the dense plain version and never packs
    h = torch.zeros(op.n_cols_padded, 8)
    (t_bsr.bsr_flat_matmul if cls_name == "flat" else t_bsr.bsr_matmul)(op, h)
    assert "packed" not in vars(op) and not calls
    assert op.packed is op.packed and len(calls) == 1
    moved = tf.to_device(op, "cpu")
    assert moved is not op and "packed" not in vars(moved)
    assert moved.packed is not op.packed and len(calls) == 2
    # one operand passed as its own transpose moves once and stays one object
    a, a_t = tf.to_device((op, op), "cpu")
    assert a is a_t and a.tiles is a_t.tiles


@pytest.mark.parametrize("cls_name", list(CLASSES))
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("kind", ["rect", "empty_row_block"])
def test_packed_product_matches_jax_kernel(rng, kind, block, cls_name):
    """The CSR product over the pack against the Pallas kernel (interpret
    mode), on the operand and on its transpose (the backward's operand)."""
    m = _matrix(kind, rng, block)
    t_cls, j_cls = CLASSES[cls_name]
    f = 128
    for mm in (m, m.T.tocsr()):
        op, j = t_cls.from_scipy(mm, block=block), j_cls.from_scipy(mm, block=block)
        h = rng.normal(size=(op.n_cols_padded, f)).astype(np.float32)
        if cls_name == "flat":
            want = _bsr_flat_matmul(j.tiles, j.rowblk, j.colblk, j.first, h,
                                    n_row_blocks=j.n_row_blocks, interpret=True)
        else:
            want = _bsr_matmul(j.tiles, j.tile_idx, j.tile_col, h, interpret=True)
        got = _csr_product(op.packed, torch.from_numpy(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cls_name", list(CLASSES))
def test_packed_product_is_sparse_on_nonfinite_h(rng, cls_name):
    """Where h holds an Inf, the packed product gives the sparse answer
    (only rows with an entry in that column see it), as scipy does; the
    dense twin spreads 0·Inf = NaN over the whole row block."""
    m = empty_row_block_matrix(rng, 128)
    op = CLASSES[cls_name][0].from_scipy(m, block=128)
    h = rng.normal(size=(op.n_cols_padded, 4)).astype(np.float32)
    hit = int(m.indices[0])
    h[hit, 0] = np.inf
    got = _csr_product(op.packed, torch.from_numpy(h)).numpy()[: m.shape[0]]
    with np.errstate(invalid="ignore"):
        want = np.asarray(m @ h[: m.shape[1]])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    touched = np.asarray(m[:, hit].todense()).ravel() != 0
    assert np.isfinite(got[~touched]).all() and not np.isfinite(got[touched, 0]).any()
    plain = t_bsr.bsr_flat_matmul_plain if cls_name == "flat" else t_bsr.bsr_matmul_plain
    dense = plain(op, torch.from_numpy(h)).numpy()[: m.shape[0]]
    assert np.isnan(dense[~touched, 0]).any()


def test_packed_operand_checks(rng):
    op = tf.BsrMatrix.from_scipy(random_csr(rng, 300, 300, 4), block=128)
    pk = op.packed
    h = torch.zeros(op.n_cols_padded, 128)
    t_bsr._check_cuda_operands(op, pk, h)  # CPU tensors stand in for the card's
    short = tf.PackedRows(row_ptr=pk.row_ptr[:-1], col=pk.col, val=pk.val)
    with pytest.raises(ValueError, match="row_ptr"):
        t_bsr._check_cuda_operands(op, short, h)
    wide = tf.PackedRows(row_ptr=pk.row_ptr, col=pk.col.long(), val=pk.val)
    with pytest.raises(TypeError, match="col"):
        t_bsr._check_cuda_operands(op, wide, h)
    with pytest.raises(ValueError, match="h must be"):
        t_bsr._check_cuda_operands(op, pk, torch.zeros(op.n_cols_padded, 130))


@pytest.mark.parametrize("f", [3, 4, 300, 301])
def test_spmm_pads_width_to_f_align_only(rng, f):
    """The product sees h padded to the tile grid's rows and the next
    multiple of F_ALIGN columns, no wider: the kernel gathers every column it
    is given. The result is the unpadded product."""
    m = random_csr(rng, 300, 300, 4)
    op = tf.BsrMatrix.from_scipy(m, block=128)
    seen = []

    def matmul(mat, h_p):
        seen.append(tuple(h_p.shape))
        return t_bsr.bsr_matmul_plain(mat, h_p)

    h = rng.normal(size=(300, f)).astype(np.float32)
    got = t_bsr._spmm_tiles(matmul, op, op, torch.from_numpy(h))
    assert seen == [(op.n_cols_padded, -(-f // t_bsr.F_ALIGN) * t_bsr.F_ALIGN)]
    np.testing.assert_allclose(got.numpy(), m @ h, **TOL)


def test_gcn_symmetric_adjacency_is_one_operand(rng):
    """A symmetric Â is its own transpose: the model keeps one operand for
    both directions, so its tiles and its pack exist once."""
    a = random_csr(rng, 200, 200, 3, symmetric=True)
    a.data = np.abs(a.data)
    a_hat = tf.normalize_adjacency(a)
    x = random_csr(rng, 200, 64, 5)
    x.data = np.abs(x.data)
    cfg = t_gcn.GCNConfig(n_features=64, n_classes=4, hidden=(16, 16), spmm_backend="hybrid")
    net = t_gcn.HighwayGCN(cfg, tf.SparseGraph(csr=x), tf.SparseGraph(csr=a_hat, symmetric=True),
                           device="cpu")
    assert net.arrays["adj_t"] is net.arrays["adj"]
