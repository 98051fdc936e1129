"""The PyTorch port's GAT attention operands against the JAX package's:
``BucketedAttention`` and ``TiledAttentionPattern`` arrays are equal exactly
(the JAX ``first``/``first_t`` flags derived from the port's run bounds)."""

import numpy as np
import pytest
import scipy.sparse as sp

from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern as TTiled
from graphconvgeo_torch.sparse.formats import BucketedAttention as TBucketed
from graphconvgeo_tpu.sparse.attention_tiles import TiledAttentionPattern as JTiled
from graphconvgeo_tpu.sparse.formats import BucketedAttention as JBucketed
from tests.test_attention_tiled import _mk


def _isolated_rows_pattern(n=70):
    a = sp.identity(n, format="csr").tolil()
    a[2, 40] = 1.0
    a[40, 2] = 1.0
    return a.tocsr()


def _patterns():
    rng = np.random.default_rng(0)
    clique = _mk(rng)[0]
    return {
        "tiles+rest": (clique, dict(block=32, min_tile_nnz=50)),
        "all-rest": (clique, dict(block=32, min_tile_nnz=10_000)),
        "isolated-rows": (_isolated_rows_pattern(), dict(block=32, min_tile_nnz=2)),
    }


def _first_from_ptr(ptr: np.ndarray, n_tiles: int) -> np.ndarray:
    """JAX's ``first`` flags: 1 on the first tile of every non-empty run."""
    first = np.zeros(n_tiles, dtype=np.int32)
    starts = ptr[:-1][ptr[:-1] < ptr[1:]]
    first[starts] = 1
    return first


def _assert_bucketed_equal(t: TBucketed, j: JBucketed):
    assert t.n_cols == j.n_cols and t.n_rows == j.n_rows
    for field in ("indices", "valid", "row_ids", "indices_t", "valid_t", "perm_t"):
        got, want = getattr(t, field), getattr(j, field)
        assert len(got) == len(want), field
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_), err_msg=field)
    for field in ("perm", "inv_perm", "inv_perm_c"):
        np.testing.assert_array_equal(
            getattr(t, field).numpy(), np.asarray(getattr(j, field)), err_msg=field
        )


@pytest.mark.parametrize("name", ["tiles+rest", "all-rest", "isolated-rows"])
def test_tiled_pattern_matches_jax(name):
    a, kw = _patterns()[name]
    t = TTiled.from_scipy(a, **kw)
    j = JTiled.from_scipy(a, **kw)
    assert (t.n_rows, t.n_cols, t.block, t.n_tiles) == (j.n_rows, j.n_cols, j.block, j.n_tiles)
    for field in ("mask_bits", "mask_bits_t"):
        np.testing.assert_array_equal(
            getattr(t, field).numpy().view(np.uint32), np.asarray(getattr(j, field)), err_msg=field
        )
    for field in ("rowblk", "colblk", "rowblk_t", "colblk_t"):
        np.testing.assert_array_equal(
            getattr(t, field).numpy(), np.asarray(getattr(j, field)), err_msg=field
        )
    np.testing.assert_array_equal(_first_from_ptr(t.row_ptr.numpy(), t.n_tiles), np.asarray(j.first))
    np.testing.assert_array_equal(
        _first_from_ptr(t.col_ptr_t.numpy(), t.n_tiles), np.asarray(j.first_t)
    )
    assert t.row_ptr.shape[0] == t.n_row_blocks + 1 and t.col_ptr_t.shape[0] == t.n_col_blocks + 1
    assert (np.diff(t.row_ptr.numpy()) > 0).all() and (np.diff(t.col_ptr_t.numpy()) > 0).all()
    assert t.stats() == j.stats()
    if j.rest is None:
        assert t.rest is None
    else:
        _assert_bucketed_equal(t.rest, j.rest)
    if name == "tiles+rest":
        assert t.n_tiles > 0 and t.rest is not None
    if name == "all-rest":
        assert t.stats()["tiled_edges"] == 0


@pytest.mark.parametrize("name", ["tiles+rest", "isolated-rows"])
def test_bucketed_attention_matches_jax(name):
    a, _ = _patterns()[name]
    _assert_bucketed_equal(TBucketed.from_scipy(a), JBucketed.from_scipy(a))
