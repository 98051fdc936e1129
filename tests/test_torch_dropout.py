"""The PyTorch port's hashed dropout against the JAX package's, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphconvgeo_torch.ops import dropout as td
from graphconvgeo_torch.sparse import formats as tf
from graphconvgeo_tpu.ops import dropout as jd
from graphconvgeo_tpu.sparse import formats as jf
from tests.conftest import random_csr

SEEDS = [0, 1, 12345, 0x3779B97, 2**31 - 2]


@pytest.fixture(scope="module")
def ids():
    rng = np.random.default_rng(0)
    # 10^5 ids over the whole uint32 range, half of them >= 2^31
    lo = rng.integers(0, 2**31, 50_000, dtype=np.uint64)
    hi = rng.integers(2**31, 2**32, 50_000, dtype=np.uint64)
    return np.concatenate([lo, hi, np.array([0, 2**31 - 1, 2**31, 2**32 - 1], np.uint64)])


@pytest.mark.parametrize("seed", SEEDS)
def test_entry_uniform_and_keep_bit_equal(ids, seed):
    want_u = np.asarray(jd.entry_uniform(jnp.asarray(ids.astype(np.uint32)), seed))
    got_u = td.entry_uniform(torch.from_numpy(ids.astype(np.int64)), seed).numpy()
    assert got_u.dtype == np.float32
    np.testing.assert_array_equal(got_u.view(np.uint32), want_u.view(np.uint32))
    for rate in (0.1, 0.5, 0.9):
        want_k = np.asarray(
            jd.entry_keep(jnp.asarray(ids.astype(np.uint32)), jnp.int32(seed), rate)
        )
        got_k = td.entry_keep(torch.from_numpy(ids.astype(np.int64)), seed, rate).numpy()
        np.testing.assert_array_equal(got_k, want_k)


@pytest.mark.parametrize("transposed", [False, True])
def test_bell_dropout_identical(rng, transposed):
    m = random_csr(rng, 400, 250, 6)
    m.data = np.abs(m.data)
    src = m.T.tocsr() if transposed else m
    t = td.bell_dropout(
        tf.BucketedEll.from_scipy(src), rate=0.4, seed=777, n_cols_forward=m.shape[1],
        transposed=transposed,
    )
    # eager, as the JAX package's own tests run it: under jit XLA may turn
    # the division by (1 - rate) into a reciprocal multiply (1 ulp apart)
    j = jd.bell_dropout(
        jf.BucketedEll.from_scipy(src), rate=0.4, seed=jnp.int32(777),
        n_cols_forward=m.shape[1], transposed=transposed,
    )
    for a, b in zip(t.values, j.values):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # forward and transposed layouts drop the same entries
    if transposed:
        fwd = td.bell_dropout(
            tf.BucketedEll.from_scipy(m), rate=0.4, seed=777, n_cols_forward=m.shape[1],
            transposed=False,
        )
        assert _dense(fwd, m.shape) == pytest.approx(_dense(t, m.shape[::-1]).T)


def _dense(bell, shape):
    out = np.zeros(shape, np.float32)
    for idx, val, rid in zip(bell.indices, bell.values, bell.row_ids):
        np.add.at(out, (np.repeat(rid.numpy()[:, None], idx.shape[1], 1), idx.numpy()), val.numpy())
    return out


def test_slab_dropout_identical(rng):
    slab = rng.random((300, 256)).astype(np.float32)
    cols = np.sort(rng.choice(5000, 256, replace=False))
    for rate, seed in ((0.5, 3), (0.3, 2**31 - 2)):
        got = td.slab_dropout(
            torch.from_numpy(slab), torch.from_numpy(cols.astype(np.int64)),
            rate=rate, seed=seed, n_cols=5000,
        ).numpy()
        want = np.asarray(jd.slab_dropout(
            jnp.asarray(slab), jnp.asarray(cols.astype(np.int32)),
            rate=rate, seed=jnp.int32(seed), n_cols=5000,
        ))
        np.testing.assert_array_equal(got, want)


def test_dense_dropout_uses_generator():
    x = torch.ones(1000, 64)
    a = td.dropout(x, rate=0.5, generator=torch.Generator().manual_seed(4))
    b = td.dropout(x, rate=0.5, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert abs(float((a == 0).float().mean()) - 0.5) < 0.02
    assert td.dropout(x, rate=0.0, generator=None) is x
