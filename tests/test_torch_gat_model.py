"""The PyTorch port's GraphAttentionNet against the JAX package's, with the JAX
parameters carried across by ``params_from_jax``.

Per-layer activations match JAX ``hidden_states`` at rtol 2e-4, atol 2e-5 on
both attention operands, with and without the residual; loss and gradients
with dropout 0 at rtol 1e-5 (loss) and rtol 1e-4, atol 1e-6 (gradients).
The bucketed attention layer matches JAX ``gat_attention_bucketed`` forward
and backward at attention-dropout rate 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphconvgeo_torch.data import pipeline as t_pipeline
from graphconvgeo_torch.models import gat as t_gat
from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.ops import attention as t_attention
from graphconvgeo_torch.sparse.formats import BucketedAttention as TBucketed
from graphconvgeo_torch.sparse.formats import SparseGraph as TGraph
from graphconvgeo_tpu.data.synthetic import make_synthetic_dumps
from graphconvgeo_tpu.models import gat as j_gat
from graphconvgeo_tpu.ops import attention as j_attention
from graphconvgeo_tpu.sparse.formats import BucketedAttention as JBucketed
from graphconvgeo_tpu.sparse.formats import SparseGraph as JGraph
from tests.test_attention_tiled import _mk

ACT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SLOPE = 0.2


def _dataset(path, n_users, n_clusters):
    make_synthetic_dumps(path, n_users=n_users, n_clusters=n_clusters, seed=0)
    cfg = t_pipeline.PreprocessConfig(bucket_size=30, min_df=2, celebrity_threshold=10)
    ds, _ = t_pipeline.preprocess(path, cfg, use_cache=False).reorder()
    return ds


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """400 users in 4 clusters (tiles + rest) and 600 in 6 (all tiled)."""
    return {
        "d400": _dataset(str(tmp_path_factory.mktemp("gat400")), 400, 4),
        "d600": _dataset(str(tmp_path_factory.mktemp("gat600")), 600, 6),
    }


def _pair(ds, *, att_backend, residual=True, dropout=0.0, attn_dropout=0.0):
    common = dict(
        n_features=ds.x.shape[1], n_classes=ds.n_classes, hidden=(32, 32), heads=2,
        dropout=dropout, attn_dropout=attn_dropout, residual=residual,
        att_backend=att_backend,
    )
    jm = j_gat.GraphAttentionNet(
        j_gat.GATConfig(**common), JGraph(csr=ds.x), JGraph(csr=ds.adj, symmetric=True)
    )
    params = jm.init(jax.random.key(1))
    tm = t_gat.GraphAttentionNet(
        t_gat.GATConfig(**common), TGraph(csr=ds.x), TGraph(csr=ds.adj, symmetric=True),
        device="cpu",
    )
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize(
    "data,att_backend,residual",
    [("d400", "tiled", True), ("d400", "bucketed", False),
     ("d600", "tiled", False), ("d600", "bucketed", True)],
)
def test_hidden_states_match_jax(datasets, data, att_backend, residual):
    ds = datasets[data]
    jm, params, tm = _pair(ds, att_backend=att_backend, residual=residual)
    if att_backend == "tiled":
        stats = tm.arrays["att"].stats()
        assert stats["n_tiles"] > 0
        assert (stats["rest_edges"] > 0) == (data == "d400")
    with torch.no_grad():
        got = tm.hidden_states(train=False)
    want = jax.jit(lambda p, a: jm.hidden_states(p, a, train=False))(params, jm.arrays)
    assert len(got) == len(want) == 4
    for i, (g_, w_) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **ACT_TOL, err_msg=f"layer {i}")


@pytest.mark.parametrize("att_backend", ["tiled", "bucketed"])
def test_loss_and_grads_match_jax(datasets, att_backend):
    ds = datasets["d400"]
    jm, params, tm = _pair(ds, att_backend=att_backend)
    rng = np.random.default_rng(3)
    n = ds.n_nodes
    y = rng.integers(0, ds.n_classes, n).astype(np.int32)
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


def test_attention_dropout_driven_by_jax_seeds(datasets):
    """Attention dropout 0.35 on the tiled operand, the dense dropouts off:
    driven through ``attn_seeds`` by the integer seeds JAX draws for each
    layer, the port's train-time activations are JAX's (rtol 1e-3, atol
    1e-4, the dropout tests' tolerance)."""
    ds = datasets["d400"]
    jm, params, tm = _pair(ds, att_backend="tiled", attn_dropout=0.35)
    key = jax.random.key(9)
    layer_keys = jax.random.split(key, 2 + 2 * len(params["layers"]))
    attn_seeds = [
        int(jax.random.randint(layer_keys[2 + 2 * i], (1,), 0, 2**31 - 1, dtype=jnp.int32)[0])
        for i in range(len(params["layers"]))
    ]
    want = jax.jit(lambda p, a: jm.hidden_states(p, a, train=True, rng=key))(params, jm.arrays)
    with torch.no_grad():
        got = tm.hidden_states(train=True, attn_seeds=attn_seeds)
        undropped = tm.hidden_states(train=False)
    for i, (g_, w_) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-3, atol=1e-4,
                                   err_msg=f"layer {i}")
    assert (got[1] - undropped[1]).abs().max() > 1e-3  # something was dropped
    # without attn_seeds the seeds come from x_seed by the module's rule
    with torch.no_grad():
        derived = tm.hidden_states(train=True, x_seed=77)
        again = tm.hidden_states(
            train=True, attn_seeds=[t_gat.attn_layer_seed(77, i) for i in range(2)], x_seed=77
        )
    assert all(torch.equal(a, b) for a, b in zip(derived, again))


def test_bucketed_attention_matches_jax(rng):
    a, *arrays = _mk(rng, n=60)
    z, a_src, a_dst = (np.array(v) for v in arrays)
    tgt = rng.normal(size=z.shape).astype(np.float32)
    j_att, t_att = JBucketed.from_scipy(a), TBucketed.from_scipy(a)

    def j_loss(z_, s_, d_):
        out = j_attention.gat_attention_bucketed(j_att, z_, s_, d_, negative_slope=SLOPE)
        return jnp.sum((out - tgt) ** 2), out

    (_, j_out), j_g = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(z), jnp.asarray(a_src), jnp.asarray(a_dst)
    )
    ts = [torch.tensor(v, requires_grad=True) for v in (z, a_src, a_dst)]
    t_out = t_attention.gat_attention(t_att, *ts, negative_slope=SLOPE)
    ((t_out - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **ACT_TOL)
    for t, want in zip(ts, j_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)
    # attention dropout on the bucketed operand draws from a torch.Generator:
    # the same integer seed gives the same mask, another seed another one
    ts0 = [torch.from_numpy(v) for v in (z, a_src, a_dst)]
    kw = dict(negative_slope=SLOPE, attn_dropout=0.35)
    d1 = t_attention.gat_attention(t_att, *ts0, seed=5, **kw)
    assert torch.equal(d1, t_attention.gat_attention(t_att, *ts0, seed=5, **kw))
    assert not torch.equal(d1, t_attention.gat_attention(t_att, *ts0, seed=6, **kw))
    with pytest.raises(TypeError, match="AttentionEll, got object"):
        t_attention.gat_attention(object(), *ts0)
