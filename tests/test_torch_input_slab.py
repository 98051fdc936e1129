"""The input layer's operands in the PyTorch port against the JAX package:
the single-device cases of ``tests/test_input_slab.py`` (the Zipf-head slab
is a drop-in for the bucketed-ELL gathers: the same products, the same
dropout mask, the same gradients), the slab's columns and values in float32
and bf16 under a byte budget that binds, the bf16 slab's float32 product,
and the hot-column cache (``CachedBell``) input layer with dropout.

Tolerances: a float32 slab against the gathers, rtol 2e-5 / atol 2e-5
(forward) and rtol 1e-4 / atol 1e-5 (gradient), as in the JAX file; the
port against JAX, 1e-5 × max|ref| (both sum the same float32 terms in
another order); the dropout masks equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch.models import gcn as t_gcn
from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.ops import spmm as t_spmm
from graphconvgeo_torch.sparse import formats as tf
from graphconvgeo_tpu.models import gcn as j_gcn
from graphconvgeo_tpu.ops.spmm import spmm_slabbed as j_spmm_slabbed
from graphconvgeo_tpu.sparse import formats as jf
from graphconvgeo_tpu.sparse.formats import normalize_adjacency
from tests.test_input_slab import zipf_csr
from tests.test_torch_sparse import assert_bell_equal

REL = 1e-5  # port against JAX, × max|ref|


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max|diff| {err} > {rel} x {scale}"


def _bf16_bits(t) -> np.ndarray:
    """bf16 values (torch or JAX) as their 16-bit patterns."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _slab(x, **kw):
    kw.setdefault("slab_cols", 256)
    kw.setdefault("slab_dtype", torch.float32)
    kw.setdefault("hot_cache", False)
    sb = tf.SlabbedBell.from_scipy(x, **kw)
    assert sb is not None
    return sb


def _fwd_grad(fn, w0, g):
    w = torch.tensor(w0, requires_grad=True)
    out = fn(w)
    (out * torch.tensor(g)).sum().backward()
    return out.detach(), w.grad


@pytest.fixture
def x(rng):
    return zipf_csr(rng)


def test_slabbed_matches_bell_forward(rng, x):
    sb = _slab(x)
    g = tf.SparseGraph(csr=x)
    w0 = torch.tensor(rng.normal(size=(x.shape[1], 48)).astype(np.float32))
    want = t_spmm.spmm_bell(g.bell(), g.bell_t(), w0)
    got = t_spmm.spmm_slabbed(sb, w0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    j_sb = jf.SlabbedBell.from_scipy(x, slab_cols=256, slab_dtype=jnp.float32, hot_cache=False)
    _close(got, j_spmm_slabbed(j_sb, jnp.asarray(w0.numpy())), what="vs JAX")


def test_slabbed_covers_all_entries(x):
    """Slab + rest partition the nonzeros exactly (no loss, no duplicates)."""
    sb = _slab(x)
    n, v = x.shape
    recon = np.zeros((n, v), np.float64)
    recon[:, sb.cols.numpy()] += sb.slab.numpy().astype(np.float64)
    rest = sb.rest
    assert isinstance(rest, tf.BucketedEll)
    for idx, val, rid in zip(rest.indices, rest.values, rest.row_ids):
        np.add.at(recon, (rid.numpy()[:, None].repeat(idx.shape[1], 1), idx.numpy()),
                  val.numpy().astype(np.float64))
    np.testing.assert_allclose(recon, x.toarray(), rtol=1e-6, atol=1e-6)


def test_slabbed_grad_matches_bell(rng, x):
    sb = _slab(x)
    g = tf.SparseGraph(csr=x)
    bell, bell_t = g.bell(), g.bell_t()
    w0 = rng.normal(size=(x.shape[1], 32)).astype(np.float32)

    def grad(fn):
        w = torch.tensor(w0, requires_grad=True)
        torch.tanh(fn(w)).sum().backward()
        return w.grad.numpy()

    g_bell = grad(lambda w: t_spmm.spmm_bell(bell, bell_t, w))
    g_slab = grad(lambda w: t_spmm.spmm_slabbed(sb, w))
    np.testing.assert_allclose(g_slab, g_bell, rtol=1e-4, atol=1e-5)


def test_input_layer_dropout_mask_agrees_with_bell(rng, x):
    """Same seed: slab and bell paths drop the IDENTICAL entry set (both key
    the mask by global entry position row·V + col), in the port as in JAX."""
    sb = _slab(x)
    g = tf.SparseGraph(csr=x)
    w = rng.normal(size=(x.shape[1], 24)).astype(np.float32)
    params_in = t_gcn.Params(w=torch.tensor(w), b=torch.zeros(24))
    kw = dict(n_rows=x.shape[0], n_cols=x.shape[1], dropout_rate=0.4, activation=torch.tanh,
              train=True, seed=1234)
    with torch.no_grad():
        h_bell = t_gcn.sparse_input_layer(params_in, {"x": g.bell(), "x_t": g.bell_t()}, **kw)
        h_slab = t_gcn.sparse_input_layer(params_in, {"x": sb, "x_t": None}, **kw)
    np.testing.assert_allclose(h_slab.numpy(), h_bell.numpy(), rtol=2e-4, atol=2e-5)
    j_sb = jf.SlabbedBell.from_scipy(x, slab_cols=256, slab_dtype=jnp.float32, hot_cache=False)
    want = j_gcn.sparse_input_layer(
        {"w": jnp.asarray(w), "b": jnp.zeros((24,), jnp.float32)}, {"x": j_sb, "x_t": None},
        n_rows=x.shape[0], n_cols=x.shape[1], dropout_rate=0.4, activation=jnp.tanh,
        gather_dtype=None, out_dtype=jnp.float32, train=True, seed=jnp.int32(1234),
    )
    _close(h_slab, want, what="slab input layer vs JAX")


def test_from_scipy_gates(rng):
    small = zipf_csr(rng, n=200, v=500)
    assert tf.SlabbedBell.from_scipy(small) is None
    flat = sp.random(2048, 8192, density=0.002, format="csr", dtype=np.float32,
                     random_state=5)
    assert tf.SlabbedBell.from_scipy(flat, slab_cols=256, min_coverage=0.5) is None
    assert jf.SlabbedBell.from_scipy(flat, slab_cols=256, min_coverage=0.5) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slab_columns_under_binding_budget_match_jax(rng, dtype):
    """The budget counts the slab's own itemsize: at 2048 rows a budget of
    2048 × 512 × 4 bytes holds 512 float32 columns or 1024 bf16 ones. The
    columns equal JAX's and the values are bit-equal in either dtype."""
    big = zipf_csr(rng, n=2048, v=4096, l_avg=30)
    kw = dict(slab_cols=1024, byte_budget=2048 * 512 * 4, hot_cache=False)
    t = tf.SlabbedBell.from_scipy(big, slab_dtype=getattr(torch, dtype), **kw)
    j = jf.SlabbedBell.from_scipy(big, slab_dtype=jnp.dtype(dtype), **kw)
    assert t.cols.shape[0] == j.c_head == (512 if dtype == "float32" else 1024)
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
    assert t.slab.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_bf16_bits(t.slab), _bf16_bits(j.slab))
    else:
        np.testing.assert_array_equal(t.slab.numpy(), np.asarray(j.slab))
    assert_bell_equal(t.rest, j.rest)
    assert_bell_equal(t.rest_t, j.rest_t)


def test_spmm_slabbed_bf16_slab_matches_jax(rng, x):
    """A bf16 slab's product is summed in float32 (JAX's
    ``preferred_element_type``): the forward is float32 and within
    1e-5 × max|ref| of JAX's, where a bf16-rounded result would miss by
    ~2^-9. dW0's rows outside the slab are float32 gathers, within the same
    limit. JAX rounds the slab rows of dW0 to bf16 (the transpose of its
    cast of W0[cols]); the port rounds the same float32 sum, taken in
    another order, so those rows equal bf16(the port's own slabᵀ·G)
    exactly and are each JAX's value or its bf16 neighbour."""
    t = tf.SlabbedBell.from_scipy(x, slab_cols=256, slab_dtype=torch.bfloat16, hot_cache=False)
    j = jf.SlabbedBell.from_scipy(x, slab_cols=256, slab_dtype=jnp.bfloat16, hot_cache=False)
    w0 = rng.normal(size=(x.shape[1], 48)).astype(np.float32)
    g = rng.normal(size=(x.shape[0], 48)).astype(np.float32)
    got, got_dw = _fwd_grad(lambda w: t_spmm.spmm_slabbed(t, w), w0, g)
    want, vjp = jax.vjp(lambda w: j_spmm_slabbed(j, w), jnp.asarray(w0))
    (want_dw,) = vjp(jnp.asarray(g))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, what="forward")

    cols = t.cols.numpy()
    rest_rows = np.setdiff1d(np.arange(x.shape[1]), cols)
    got_dw, want_dw = got_dw.numpy(), np.asarray(want_dw)
    _close(got_dw[rest_rows], want_dw[rest_rows], what="dW0 rest rows")
    own = (t.slab.float().T @ torch.tensor(g)).bfloat16().float().numpy()
    np.testing.assert_array_equal(got_dw[cols], own)
    ref = want_dw[cols]
    ulp = np.ldexp(1.0, np.frexp(np.abs(ref))[1] - 8)  # one bf16 step at |ref|
    assert (np.abs(got_dw[cols] - ref) <= ulp).all()


def test_model_auto_picks_slab_and_matches_bell(rng):
    x = zipf_csr(rng, n=1280, v=2048, l_avg=25)
    adj = sp.random(1280, 1280, density=0.004, format="csr", dtype=np.float32,
                    random_state=7)
    a_hat = normalize_adjacency(((adj + adj.T) > 0).astype(np.float32))

    def mk(backend):
        cfg = t_gcn.GCNConfig(n_features=2048, n_classes=5, hidden=(32, 32), dropout=0.0,
                              input_backend=backend, slab_cols=256, slab_dtype="float32")
        return t_gcn.HighwayGCN(cfg, tf.SparseGraph(csr=x),
                                tf.SparseGraph(csr=a_hat, symmetric=True), device="cpu", seed=0)

    m_slab, m_bell = mk("auto"), mk("bell")
    assert isinstance(m_slab.arrays["x"], tf.SlabbedBell)
    assert isinstance(m_bell.arrays["x"], tf.BucketedEll)
    m_bell.load_state_dict(m_slab.state_dict())
    with torch.no_grad():
        out_s, out_b = m_slab.apply(train=False), m_bell.apply(train=False)
    np.testing.assert_allclose(out_s.numpy(), out_b.numpy(), rtol=2e-4, atol=2e-5)


def _hot_vocab_csr(rng, n=300, v=20000):
    """A vocabulary above CachedBell's 16,384 hot columns, too few rows for
    the slab's gate: the model's input falls to the hot-column cache."""
    lens = np.maximum(rng.poisson(20, n), 1)
    rows = np.repeat(np.arange(n), lens)
    cols = np.minimum(rng.zipf(1.2, int(lens.sum())) - 1, v - 1)
    m = sp.coo_matrix((np.abs(rng.normal(1, 0.2, len(rows))).astype(np.float32),
                       (rows, cols)), shape=(n, v)).tocsr()
    m.sum_duplicates()
    return m


def test_hot_cache_input_layer_matches_jax(rng):
    """The CachedBell input layer (64 hot columns of 2,000): with dropout on,
    the dropped hot and cold parts keep the same entries as JAX's (the same
    hash on the compact and global entry ids), and the layer's forward and
    dW0 are within 1e-5 × max|ref|."""
    x = _hot_vocab_csr(rng, v=2000)
    t_cb = tf.CachedBell.from_scipy(x, max_hot=64)
    j_cb = jf.CachedBell.from_scipy(x, max_hot=64)
    assert t_cb is not None and j_cb is not None
    np.testing.assert_array_equal(t_cb.hot_ids.numpy(), np.asarray(j_cb.hot_ids))
    t_ops, j_ops = {"x": t_cb, "x_t": None}, {"x": j_cb, "x_t": None}

    rate, seed, v = 0.4, 777, x.shape[1]
    t_drop = t_gcn._dropped_cached_bell(t_cb, rate, seed, v)
    j_drop = jax.jit(lambda cb: j_gcn._dropped_cached_bell(cb, rate, jnp.int32(seed), v))(j_cb)
    for part in ("hot", "hot_t", "cold", "cold_t"):
        for tv, jv in zip(getattr(t_drop, part).values, getattr(j_drop, part).values):
            tv, jv = tv.numpy(), np.asarray(jv)
            # the same entries kept (the inputs have no zeros); the kept
            # values' 1/(1 - rate) scale within one float32 rounding (XLA
            # may multiply by the reciprocal where the port divides)
            np.testing.assert_array_equal(tv != 0, jv != 0, err_msg=part)
            np.testing.assert_allclose(tv, jv, rtol=2.4e-7, atol=0, err_msg=part)

    f = 16
    w0 = (rng.normal(size=(v, f)) * 0.1).astype(np.float32)
    g = rng.normal(size=(x.shape[0], f)).astype(np.float32)
    kw = dict(n_rows=x.shape[0], n_cols=v, dropout_rate=rate, train=True)

    def t_layer(w):
        return t_gcn.sparse_input_layer(types.SimpleNamespace(w=w, b=torch.zeros(f)), t_ops,
                                        activation=torch.tanh, seed=seed, **kw)

    def j_layer(w):
        return j_gcn.sparse_input_layer({"w": w, "b": jnp.zeros((f,), jnp.float32)}, j_ops,
                                        activation=jnp.tanh, gather_dtype=None,
                                        out_dtype=jnp.float32, seed=jnp.int32(seed), **kw)

    got, got_dw = _fwd_grad(t_layer, w0, g)
    want, vjp = jax.vjp(jax.jit(j_layer), jnp.asarray(w0))
    (want_dw,) = vjp(jnp.asarray(g))
    _close(got, want, what="forward")
    _close(got_dw, want_dw, what="dW0")


def test_hot_cache_model_matches_jax(rng):
    """``input_hot_cache``: with a vocabulary above the cache's 16,384 hot
    columns and too few rows for the slab, both models build a CachedBell
    input; the GCN's loss and gradients against JAX at dropout 0 (rtol 1e-5
    on the loss, 1e-5 × max|ref| on each gradient)."""
    x = _hot_vocab_csr(rng, n=200, v=16500)
    n = x.shape[0]
    adj = sp.random(n, n, density=0.03, format="csr", dtype=np.float32, random_state=3)
    a_hat = normalize_adjacency(((adj + adj.T) > 0).astype(np.float32))
    common = dict(n_features=x.shape[1], n_classes=5, hidden=(16, 16), dropout=0.0,
                  input_hot_cache=True, spmm_backend="bell")
    jm = j_gcn.HighwayGCN(j_gcn.GCNConfig(**common), jf.SparseGraph(csr=x),
                          jf.SparseGraph(csr=a_hat, symmetric=True))
    tm = t_gcn.HighwayGCN(t_gcn.GCNConfig(**common), tf.SparseGraph(csr=x),
                          tf.SparseGraph(csr=a_hat, symmetric=True), device="cpu")
    assert isinstance(tm.arrays["x"], tf.CachedBell) and isinstance(jm.arrays["x"], jf.CachedBell)
    np.testing.assert_array_equal(tm.arrays["x"].hot_ids.numpy(), np.asarray(jm.arrays["x"].hot_ids))
    params = jm.init(jax.random.key(4))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    y = rng.integers(0, 5, n).astype(np.int32)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, a: jm.loss(p, jnp.asarray(y), jnp.asarray(mask), a, train=True)))(
        params, jm.arrays)
    t_loss = tm.loss(torch.from_numpy(y), torch.from_numpy(mask), train=True)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    for k, p in tm.named_parameters():
        _close(p.grad, want[k], what=k)
