"""UniMP's graph transformer (``models/transformer.py``) and its dot-product
attention (``ops/attention_dot.py``) on the CPU, against a dense per-head
masked softmax written here: the three plain sweeps and the autograd
Function's gradients at tiny sizes, heads at unaligned columns, a row with
no edge, attention dropout on and off (the dense reference keeps an entry
exactly where ``entry_keep`` keeps its id); remat on and off; the CLI end
to end on tiny synthetic dumps, and its refusal of the bucketed operand.
The kernels themselves run only on the card (``chip_smoke.py`` phase 2).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphconvgeo_torch import cli
from graphconvgeo_torch.data import pipeline
from graphconvgeo_torch.data.synthetic import make_synthetic_dumps
from graphconvgeo_torch.models.transformer import GraphTransformerNet, TransformerConfig
from graphconvgeo_torch.ops import attention_dot as ad
from graphconvgeo_torch.ops.dropout import entry_keep
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern
from graphconvgeo_torch.sparse.formats import SparseGraph
from graphconvgeo_torch.utils import profiling

N, HEADS, F_HEAD = 150, 3, 5  # heads of 5 columns: q, k, v start off a 4-column boundary
WIDTH = HEADS * F_HEAD
EMPTY_ROW = 7


def _pattern():
    """A square pattern over N nodes: dense diagonal blocks (tiles), random
    edges (the bucketed rest), self-loops, and one row with no edge."""
    rng = np.random.default_rng(0)
    a = sp.random(N, N, density=0.03, random_state=rng, format="lil")
    for b0 in range(0, N, 50):
        a[b0:b0 + 12, b0:b0 + 12] = 1.0
    a.setdiag(1.0)
    a[EMPTY_ROW, :] = 0.0
    a = a.tocsr()
    a.eliminate_zeros()
    a.data[:] = 1.0
    return a, TiledAttentionPattern.from_scipy(a, block=32, min_tile_nnz=60)


def _dense_attention(adj, p, seed, rate):
    """The layer's attention from its equations, in float64 with dense
    [N, N] masked softmaxes a head at a time, κ from ``entry_keep`` over
    the GAT's entry ids."""
    mask = torch.from_numpy(adj.toarray() != 0)
    outs = []
    ids = torch.arange(N)[:, None] * N + torch.arange(N)[None, :]
    for h in range(HEADS):
        cols = slice(h * F_HEAD, (h + 1) * F_HEAD)
        q, k, v = (p[:, i * WIDTH:(i + 1) * WIDTH][:, cols] for i in range(3))
        sc = (q @ k.T) / np.sqrt(F_HEAD)
        alpha = torch.softmax(sc.masked_fill(~mask, -torch.inf), 1).nan_to_num(0.0)
        if rate > 0.0:
            keep = entry_keep(ids + h * N * N, seed, rate).double() / (1.0 - rate)
            alpha = alpha * keep
        outs.append(alpha @ v)
    return torch.cat(outs, 1)


@pytest.mark.parametrize("rate", [0.0, 0.3], ids=["no_dropout", "dropout"])
def test_sweeps_and_gradients_match_a_dense_masked_softmax(rate):
    adj, att = _pattern()
    assert att.rest is not None and att.n_tiles > 0
    assert att.all_edges.ptr[EMPTY_ROW + 1] == att.all_edges.ptr[EMPTY_ROW]
    seed = 2**31 + 11
    gen = torch.Generator().manual_seed(1)
    p = torch.randn(N, 4 * WIDTH, generator=gen)
    tgt = torch.randn(N, WIDTH, generator=gen)
    tgt_r = torch.randn(N, WIDTH, generator=gen)

    pd = p.double().requires_grad_()
    want = _dense_attention(adj, pd, seed, rate)
    (((want - tgt.double()) ** 2).sum() + (pd[:, 3 * WIDTH:] * tgt_r.double()).sum()).backward()

    # the plain forward: out, and the row maxima and sums of the undropped scores
    scale = ad.softmax_scale(F_HEAD)
    out, m, den = ad.dot_attn_fwd_plain(att, p, HEADS, WIDTH, scale=scale, seed=seed, rate=rate)
    np.testing.assert_allclose(out.numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6)
    assert torch.all(out[EMPTY_ROW] == 0) and torch.all(den[EMPTY_ROW] == 1)
    assert torch.all(m[EMPTY_ROW] == 0)

    # the Function: out, r passed through, and every column of dp
    before = profiling.counters["dot_attn_edges"]
    pt = p.clone().requires_grad_()
    got, r = ad.dot_attention_tiled(att, pt, HEADS, WIDTH, attn_dropout=rate, seed=seed)
    assert torch.equal(r, p[:, 3 * WIDTH:])
    (((got - tgt) ** 2).sum() + (r * tgt_r).sum()).backward()
    assert profiling.counters["dot_attn_edges"] - before == 2 * att.all_edges.nnz
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), pd.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_dropout_keeps_follow_entry_keep_and_the_seed():
    adj, att = _pattern()
    p = torch.randn(N, 3 * WIDTH, generator=torch.Generator().manual_seed(2))
    kw = dict(attn_dropout=0.4)
    a, _ = ad.dot_attention_tiled(att, p, HEADS, WIDTH, seed=5, **kw)
    assert torch.equal(a, ad.dot_attention_tiled(att, p, HEADS, WIDTH, seed=5, **kw)[0])
    assert not torch.equal(a, ad.dot_attention_tiled(att, p, HEADS, WIDTH, seed=6, **kw)[0])
    # the plain sweeps' factors are entry_keep's over the edges' GAT ids
    rows, cols = next(ad._edge_chunks(att.all_edges, WIDTH))
    kf = ad._keep(att, rows, cols, HEADS, 5, 0.4)
    ids = rows[:, None] * N + cols[:, None] + torch.arange(HEADS) * N * N
    assert torch.equal(kf > 0, entry_keep(ids, 5, 0.4))


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tx"))
    make_synthetic_dumps(path, n_users=400, n_clusters=4, seed=0)
    cfg = pipeline.PreprocessConfig(bucket_size=30, min_df=2, celebrity_threshold=10)
    out, _ = pipeline.preprocess(path, cfg, use_cache=False).reorder()
    return out


def _model(ds, **kw):
    cfg = TransformerConfig(n_features=ds.x.shape[1], n_classes=ds.n_classes, hidden=(24, 24),
                            heads=4, dropout=0.3, attn_dropout=0.2, **kw)
    return GraphTransformerNet(cfg, SparseGraph(csr=ds.x), SparseGraph(csr=ds.adj, symmetric=True),
                               device="cpu", seed=3)


def test_remat_gives_the_same_loss_and_gradients(ds):
    y = torch.as_tensor(np.asarray(ds.y), dtype=torch.int64)
    mask = torch.zeros(ds.n_nodes)
    mask[torch.as_tensor(np.asarray(ds.train_idx))] = 1.0
    results = []
    for remat in (False, True):
        model = _model(ds, remat=remat)
        gen = torch.Generator().manual_seed(4)
        loss = model.loss(y, mask, x_seed=123, generator=gen)
        loss.backward()
        results.append((loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert set(g0) == {"input.w", "input.b", "out.w", "out.b"} | {
        f"layers.{i}.{n}" for i in range(2)
        for n in ("wq", "bq", "wk", "bk", "wv", "bv", "wr", "br", "wg", "ln_w", "ln_b")}
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)


def test_cli_trains_the_transformer_on_the_cpu():
    out = cli.main(["--preset", "synthetic", "--model", "transformer", "--att-backend", "tiled",
                    "--heads", "2", "--hidden", "16", "16", "--epochs", "3", "--patience", "3",
                    "--device", "cpu", "--quiet", "--attn-dropout", "0.1"])
    run = out["run"]
    assert run["model"] == "transformer" and run["att_backend"] == "tiled"
    assert len(run["history"]) == 3 and run["n_tiles"] > 0
    assert all(h["counters"]["dot_attn_edges"] > 0 for h in run["history"])
    assert np.isfinite(run["history"][-1]["loss"]) and 0.0 <= out["dev"]["acc_at_161"] <= 1.0


def test_the_bucketed_operand_is_refused():
    with pytest.raises(SystemExit):
        cli.parse_args(["--model", "transformer", "--att-backend", "bucketed"])
    assert cli.parse_args(["--model", "transformer"]).att_backend == "tiled"
    assert cli.parse_args(["--model", "gat"]).att_backend == "bucketed"
