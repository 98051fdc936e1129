"""The World configuration (the twitter-world preset with the World program's
levers: the factorized Â with bf16 gathers and contraction, remat, the bf16
input slab under its byte budget, the streamed CE head and predict) against
the JAX package, at small sizes on the CPU.

- ``chip_smoke.world_problem`` is ``benchmarks/world_dryrun.py ::
  build_problem`` array for array.
- The model at N 2,048, V 2,048 (``zipf_head_cols`` makes no slab below
  1,024 rows or columns), C 64, hidden (32, 32), with a byte budget that cuts
  the slab to 512 columns and the streamed gate forced to 0 in both
  packages: loss rel 1e-3, every gradient at ``BF16_TOL`` (the bf16 paths
  apply JAX's roundings in another summation order, so a partial can land
  on the neighbouring bf16: ``tests/test_torch_factorized.py``), and the
  streamed predictions equal wherever JAX's top-2 logit margin is over
  ``MARGIN_REL`` × max|logit| (a flip below that is the same rounding).
- remat on against off in the port: the recompute is the same function on
  the same dropout draws, so float32's resolution.
- The hashed input dropouts at World ids: rows near 1.4M, 50,000 columns,
  so the entry ids pass 2³² and JAX's int32 ids wrap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks.world_dryrun import build_problem
from graphconvgeo_torch.models import gcn as t_gcn
from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.ops import ce_stream as t_ce
from graphconvgeo_torch.ops import dropout as t_dropout
from graphconvgeo_torch.sparse import factorized as t_fac
from graphconvgeo_torch.sparse import formats as tf
from graphconvgeo_tpu.models import gcn as j_gcn
from graphconvgeo_tpu.ops import ce_stream as j_ce
from graphconvgeo_tpu.ops import dropout as j_dropout
from graphconvgeo_tpu.sparse import factorized as j_fac
from graphconvgeo_tpu.sparse import formats as jf

BF16_TOL = dict(rtol=1e-2, atol=1e-2)
N, VOCAB, CLASSES, HIDDEN = 2048, 2048, 64, (32, 32)
SLAB_COLS = 512  # the byte budget below: 2,048 rows x 2 bytes x 512 columns
BUDGET = N * 2 * SLAB_COLS
MARGIN_REL = 2e-2


def test_world_problem_matches_jax_build_problem():
    got = chip_smoke.world_problem(4096, vocab=50_000, classes=930)
    want = build_problem(4096, vocab=50_000, classes=930)
    assert got[0].keys() == want[0].keys()
    for g in want[0]:
        np.testing.assert_array_equal(np.asarray(got[0][g]), np.asarray(want[0][g]), err_msg=str(g))
    x, x_want = got[1], want[1]
    assert x.shape == x_want.shape == (4096, 50_000)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(x, name), getattr(x_want, name), err_msg=name)
    assert x.data.dtype == x_want.data.dtype == np.float32
    for i, (a, b) in enumerate(zip(got[2:], want[2:])):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))


@pytest.fixture(scope="module")
def world_small():
    groups, x, y, mask, *_ = chip_smoke.world_problem(N, vocab=VOCAB, classes=CLASSES)
    fa_t = t_fac.FactorizedAdjacency.from_groups(groups, N)
    fa_j = j_fac.FactorizedAdjacency.from_groups(groups, N)
    return dict(x=x, y=y, mask=mask, fa_t=fa_t, fa_j=fa_j)


@pytest.fixture
def streamed(monkeypatch):
    """The streamed gate forced to 0 where each package reads it."""
    for mod in (t_gcn, t_ce, j_gcn, j_ce):
        monkeypatch.setattr(mod, "streamed_rows_threshold", lambda: 0)


def _port_model(w, **over):
    cfg = chip_smoke.world_config(n_features=VOCAB, n_classes=CLASSES, hidden=HIDDEN,
                                  slab_byte_budget=BUDGET, **over)
    return t_gcn.HighwayGCN(cfg, tf.SparseGraph(csr=w["x"]), w["fa_t"], device="cpu", seed=0)


def test_world_model_matches_jax(world_small, streamed):
    """Loss, every gradient and the streamed predictions of the World config
    at dropout 0, the JAX parameters carried across."""
    w = world_small
    tm = _port_model(w, dropout=0.0)
    cfg = tm.cfg
    jcfg = j_gcn.GCNConfig(
        n_features=VOCAB, n_classes=CLASSES, hidden=HIDDEN, highway=True, dropout=0.0, l2=cfg.l2,
        remat=True, gather_dtype="bfloat16", input_backend="slab", slab_cols=cfg.slab_cols,
        slab_dtype="bfloat16", slab_byte_budget=BUDGET)
    jm = j_gcn.HighwayGCN(jcfg, jf.SparseGraph(csr=w["x"]), w["fa_j"])
    assert (tm.backend, tm.cfg.remat, tm.cfg.gather_dtype) == ("factorized", True, "bfloat16")
    for op in (tm.arrays["x"], jm.arrays["x"]):
        assert type(op).__name__ == "SlabbedBell" and int(op.cols.shape[0]) == SLAB_COLS
    assert str(tm.arrays["x"].slab.dtype) == "torch.bfloat16"
    stats = w["fa_t"].stats()
    assert stats["bt_tiles"] == w["fa_j"].bt_tiles.n_tiles > 0
    assert stats["zr_tiles"] == w["fa_j"].zr_tiles.n_tiles > 0
    params = jm.init(jax.random.key(7))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))

    y, mask = w["y"], w["mask"]
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, a: jm.loss(p, jnp.asarray(y), jnp.asarray(mask), a, train=True)))(params, jm.arrays)
    t_loss = tm.loss(torch.from_numpy(y), torch.from_numpy(mask), train=True)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-3)
    want_g = params_from_jax(jax.tree.map(np.asarray, j_grads))
    for k, p in tm.named_parameters():
        scale = float(np.abs(want_g[k].numpy()).max())
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), rtol=BF16_TOL["rtol"],
                                   atol=max(BF16_TOL["atol"] * scale, 1e-6), err_msg=k)

    got = t_ce.predict_classes(tm).numpy()
    want = np.asarray(jax.jit(lambda p, a: j_ce.predict_classes(jm, p, a))(params, jm.arrays))
    logits = np.asarray(jax.jit(lambda p, a: jm.apply(p, a, train=False))(params, jm.arrays))
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN_REL * np.abs(logits).max()
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])
    assert (got != want).mean() < 0.05


def test_world_model_remat_matches_no_remat(world_small):
    """The port's World config with and without remat, at its dropout 0.5
    on the same draws: the same loss and gradients to float32's resolution
    (the recompute re-runs each conv layer on the saved dropped input)."""
    w = world_small
    y, mask = torch.from_numpy(w["y"]), torch.from_numpy(w["mask"])
    out, state = {}, None
    for remat in (False, True):
        tm = _port_model(w, remat=remat)
        assert tm.cfg.dropout == 0.5
        if state is None:
            state = {k: v.clone() for k, v in tm.state_dict().items()}
        tm.load_state_dict(state)
        loss = tm.loss(y, mask, train=True, x_seed=99, generator=torch.Generator().manual_seed(3))
        loss.backward()
        out[remat] = (float(loss.detach()), {k: p.grad.clone() for k, p in tm.named_parameters()})
    (l0, g0), (l1, g1) = out[False], out[True]
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for k in g0:
        scale = float(g0[k].abs().max())
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-5,
                                   atol=max(1e-6 * scale, 1e-12), err_msg=k)


@pytest.mark.parametrize("kind", ["slab", "ell", "ell_transposed"])
def test_input_dropout_at_world_ids(kind):
    """slab_dropout and ell_dropout_values keep exactly JAX's entries where
    the entry ids pass 2³² (a row offset near 1.4M, 50,000 columns)."""
    rng = np.random.default_rng(23)
    n_cols, offset, rows, seed, rate = 50_000, 1_399_000, 64, 77, 0.5
    assert offset * n_cols > 2**32
    if kind == "slab":
        slab = (rng.random((rows, 256)) + 0.5).astype(np.float32)
        cols = np.sort(rng.choice(n_cols, 256, replace=False))
        got = t_dropout.slab_dropout(torch.from_numpy(slab), torch.from_numpy(cols.astype(np.int64)),
                                     rate=rate, seed=seed, n_cols=n_cols, row_offset=offset).numpy()
        want = np.asarray(j_dropout.slab_dropout(
            jnp.asarray(slab), jnp.asarray(cols.astype(np.int32)), rate=rate,
            seed=jnp.int32(seed), n_cols=n_cols, row_offset=offset))
    else:
        transposed = kind == "ell_transposed"
        n, k, hi = (n_cols, 3, rows) if transposed else (rows, 20, n_cols)
        idx = rng.integers(0, hi, (n, k)).astype(np.int32)
        val = (rng.random((n, k)) + 0.5).astype(np.float32)
        kw = dict(rate=rate, n_cols=n_cols, transposed=transposed, row_offset=offset)
        got = t_dropout.ell_dropout_values(torch.from_numpy(idx), torch.from_numpy(val), seed=seed,
                                           **kw).numpy()
        want = np.asarray(j_dropout.ell_dropout_values(jnp.asarray(idx), jnp.asarray(val),
                                                       seed=jnp.int32(seed), **kw))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-7)
    assert 0.4 < (got != 0).mean() < 0.6
