"""The PyTorch port's Highway-GCN against the JAX package's, with the JAX
parameters carried across by ``params_from_jax``.

Per-layer activations match JAX ``hidden_states`` and the numpy oracle at
rtol 2e-4, atol 2e-5 (the oracle test's tolerance); loss and gradients with
dropout 0 at rtol 1e-5 (loss) and rtol 1e-4, atol 1e-6 (gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphconvgeo_torch.data import pipeline as t_pipeline
from graphconvgeo_torch.models import gcn as t_gcn
from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.ops import ce_stream as t_ce
from graphconvgeo_torch.sparse.formats import SparseGraph as TGraph
from graphconvgeo_tpu.data.synthetic import make_synthetic_dumps
from graphconvgeo_tpu.models import gcn as j_gcn
from graphconvgeo_tpu.ops import ce_stream as j_ce
from graphconvgeo_tpu.sparse.formats import SparseGraph as JGraph
from graphconvgeo_tpu.sparse.formats import normalize_adjacency
from tests.conftest import random_csr
from tests.test_model_oracle import numpy_forward

ACT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _random_problem(rng):
    n, v = 90, 40
    x = random_csr(rng, n, v, 6)
    x.data = np.abs(x.data).astype(np.float32)
    adj = random_csr(rng, n, n, 4, symmetric=True)
    adj.data = np.abs(adj.data)
    return x, normalize_adjacency(adj), n, 7


@pytest.fixture(scope="module")
def dataset_1100(tmp_path_factory):
    """1,100 users in 32 clusters: slab input layer + hybrid conv."""
    d = str(tmp_path_factory.mktemp("dumps1100"))
    make_synthetic_dumps(d, n_users=1100, n_clusters=32, seed=0)
    cfg = t_pipeline.PreprocessConfig(bucket_size=30, min_df=2, celebrity_threshold=10)
    ds, _ = t_pipeline.preprocess(d, cfg, use_cache=False).reorder()
    return ds.x, ds.adj, ds.n_nodes, ds.n_classes


def _pair(x, a_hat, n_classes, *, highway, backend, dropout=0.0, hidden=(32, 32)):
    common = dict(
        n_features=x.shape[1], n_classes=n_classes, hidden=hidden, highway=highway,
        dropout=dropout, spmm_backend=backend,
    )
    jm = j_gcn.HighwayGCN(
        j_gcn.GCNConfig(**common), JGraph(csr=x), JGraph(csr=a_hat, symmetric=True)
    )
    params = jm.init(jax.random.key(1))
    tm = t_gcn.HighwayGCN(
        t_gcn.GCNConfig(**common), TGraph(csr=x), TGraph(csr=a_hat, symmetric=True),
        device="cpu",
    )
    params_np = jax.tree.map(np.asarray, params)
    tm.load_state_dict(params_from_jax(params_np))
    return jm, params, params_np, tm


@pytest.mark.parametrize(
    "data,highway,backend",
    [
        ("random", False, "bell"),
        ("random", True, "bell"),
        ("random", True, "hybrid"),
        ("random", False, "hybrid"),
        ("d1100", True, "auto"),
        ("random", True, "bsr"),
        ("random", False, "ell"),
        ("random", True, "oracle"),
    ],
)
def test_hidden_states_match_jax_and_oracle(rng, dataset_1100, data, highway, backend):
    x, a_hat, n, c = _random_problem(rng) if data == "random" else dataset_1100
    jm, params, params_np, tm = _pair(x, a_hat, c, highway=highway, backend=backend)
    if data == "d1100":
        assert tm.backend == "hybrid"
        assert type(tm.arrays["x"]).__name__ == "SlabbedBell"
        assert tm.arrays["adj"][0].n_tiles == 25
    with torch.no_grad():
        got = tm.hidden_states(train=False)
    want = jax.jit(lambda p, a: jm.hidden_states(p, a, train=False))(params, jm.arrays)
    oracle = numpy_forward(params_np, x, a_hat, jm.cfg)
    assert len(got) == len(want) == len(oracle)
    for i, (g_, w_, o_) in enumerate(zip(got, want, oracle)):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **ACT_TOL, err_msg=f"layer {i}")
        np.testing.assert_allclose(g_.numpy(), o_, **ACT_TOL, err_msg=f"oracle layer {i}")


@pytest.mark.parametrize(
    "data,backend", [("random", "hybrid"), ("d1100", "auto"), ("random", "bsr")]
)
def test_loss_and_grads_match_jax(rng, dataset_1100, data, backend):
    x, a_hat, n, c = _random_problem(rng) if data == "random" else dataset_1100
    jm, params, params_np, tm = _pair(x, a_hat, c, highway=True, backend=backend)
    y = rng.integers(0, c, n).astype(np.int32)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, a: jm.loss(p, jnp.asarray(y), jnp.asarray(mask), a, train=True)
    ))(params, jm.arrays)
    t_loss = tm.loss(torch.from_numpy(y), torch.from_numpy(mask), train=True)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("data", ["random", "d1100"])
def test_input_layer_dropout_matches_jax(rng, dataset_1100, data):
    x, a_hat, n, c = _random_problem(rng) if data == "random" else dataset_1100
    jm, params, _, tm = _pair(x, a_hat, c, highway=True, backend="bell", dropout=0.5)
    j_layer = jax.jit(lambda p, a, s: j_gcn.sparse_input_layer(
        p, a, n_rows=n, n_cols=x.shape[1], dropout_rate=0.5, activation=jnp.tanh,
        gather_dtype=None, out_dtype=jnp.float32, train=True, seed=s,
    ))
    for seed in (0, 91, 2**31 - 2):
        want = j_layer(params["input"], jm.arrays, jnp.int32(seed))
        with torch.no_grad():
            got = t_gcn.sparse_input_layer(
                tm.input, tm.arrays, n_rows=n, n_cols=x.shape[1], dropout_rate=0.5,
                activation=torch.tanh, train=True, seed=seed,
            )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the hashed dropout is really on: train output differs from eval output
    with torch.no_grad():
        eval_out = t_gcn.sparse_input_layer(
            tm.input, tm.arrays, n_rows=n, n_cols=x.shape[1], dropout_rate=0.5,
            activation=torch.tanh, train=False, seed=0,
        )
    assert not torch.allclose(got, eval_out)


def test_streamed_ce_head_matches_jax(rng):
    n, hd, c = 100, 16, 9
    h = rng.normal(size=(n, hd)).astype(np.float32)
    w = rng.normal(size=(hd, c)).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    mask = (rng.random(n) < 0.6).astype(np.float32)

    def j_loss(h_, w_, b_):
        num, den = j_ce.masked_ce_sums(h_, w_, b_, jnp.asarray(y), jnp.asarray(mask), row_block=16)
        return num / den

    j_val, j_g = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2)))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b)
    )
    th, tw, tb = (torch.tensor(a, requires_grad=True) for a in (h, w, b))
    num, den = t_ce.masked_ce_sums(th, tw, tb, torch.from_numpy(y), torch.from_numpy(mask),
                                   row_block=16)
    (num / den).backward()
    np.testing.assert_allclose(float((num / den).detach()), float(j_val), rtol=1e-5)
    for got, want in zip((th.grad, tw.grad, tb.grad), j_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    got_arg = t_ce.streamed_argmax(torch.from_numpy(h), torch.from_numpy(w),
                                   torch.from_numpy(b), row_block=16)
    want_arg = j_ce.streamed_argmax(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), row_block=16)
    np.testing.assert_array_equal(got_arg.numpy(), np.asarray(want_arg))
