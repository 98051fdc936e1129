"""The port's factorized projection adjacency and kernel 1's bf16
contraction against the JAX package (``tests/test_factorized.py`` at small
sizes).

Tolerances:
- ``F32_TOL`` (rtol 1e-5, atol 1e-6): the same float32 arithmetic, summed
  in another order.
- ``BF16_TOL`` (rtol 1e-2, atol 1e-2): the bf16 paths apply the same
  roundings as JAX, but in another summation order; a y (or a dh) that
  differs in its last float32 bit can round to a neighbouring bf16 in z
  (one bf16 step is 2^-8 ≈ 3.9e-3 relative), and that step then moves the
  outputs that read it. So the limit is bf16-level, not float32's.
- The bf16 tile products alone are held at ``F32_TOL``: a product of two
  bf16 values is exact in float32, so the port's plain twin and the JAX
  Pallas kernel (interpret mode) differ only in the order of float32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphconvgeo_torch import cli as t_cli
from graphconvgeo_torch.data import pipeline as t_pipeline
from graphconvgeo_torch.models import gat as t_gat
from graphconvgeo_torch.models import gcn as t_gcn
from graphconvgeo_torch.models.convert import params_from_jax
from graphconvgeo_torch.ops import spmm as t_spmm
from graphconvgeo_torch.ops import spmm_bsr as t_bsr
from graphconvgeo_torch.sparse import factorized as t_fac
from graphconvgeo_torch.sparse import formats as tf
from graphconvgeo_torch.utils import cuda_build
from graphconvgeo_tpu.data.synthetic import make_synthetic_dumps
from graphconvgeo_tpu.models import gcn as j_gcn
from graphconvgeo_tpu.ops.spmm import spmm_bell as j_spmm_bell
from graphconvgeo_tpu.ops.spmm_pallas import _bsr_flat_matmul, _bsr_matmul
from graphconvgeo_tpu.sparse import factorized as j_fac
from graphconvgeo_tpu.sparse import formats as jf
from tests.conftest import random_csr
from tests.test_factorized import random_structure

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
DTYPES = {"f32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _structure(kind: str):
    """(groups, n, direct, from_groups kwargs) of one test structure."""
    r = np.random.default_rng(13)
    if kind in ("merged", "combined_separate_tiles", "separate", "core"):
        # big cliques in contiguous id ranges: tiles on the B' and R' sides;
        # n 200 with block 64 gives z_pad 56
        n = 200
        groups = {f"big{c}": list(range(c * 50, c * 50 + 40)) for c in range(4)}
        groups.update({f"x{g}": r.choice(n, size=3, replace=False).tolist() for g in range(15)})
        direct = (r.integers(0, n, 10), r.integers(0, n, 10))
        kw = {
            "merged": {},
            "combined_separate_tiles": dict(merged_tiles=False),
            "separate": dict(combined_rest=False),
            "core": dict(hub_order="core"),
        }[kind]
        return groups, n, direct, dict(block=64, min_tile_nnz=16, **kw)
    if kind == "random_direct":  # the default 128² tiles: nothing tiles
        groups, direct = random_structure(np.random.default_rng(3), 60, 25)
        return groups, 60, direct, {}
    if kind == "isolated_size1":  # isolated nodes, a size-1 and an empty group
        return {"a": [0], "b": [], "c": [2, 3]}, 10, None, {}
    if kind == "no_groups":
        return {}, 5, None, {}
    raise ValueError(kind)


STRUCTURES = ["merged", "combined_separate_tiles", "separate", "core", "random_direct",
              "isolated_size1", "no_groups"]


def _both(kind: str):
    groups, n, direct, kw = _structure(kind)
    return (
        t_fac.FactorizedAdjacency.from_groups(groups, n, direct=direct, **kw),
        j_fac.FactorizedAdjacency.from_groups(groups, n, direct=direct, **kw),
        groups, n, direct,
    )


def _eq(t, j, what):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=what)


@pytest.mark.parametrize("with_direct", [False, True])
@pytest.mark.parametrize("hub_order", ["median", "core"])
def test_host_factors_match_jax(hub_order, with_direct):
    groups, direct = random_structure(np.random.default_rng(7), 80, 30)
    direct = direct if with_direct else None
    got = t_fac.host_factors(groups, 80, direct=direct, hub_order=hub_order)
    want = j_fac.host_factors(groups, 80, direct=direct, hub_order=hub_order)
    for g, w, what in zip(got[:2], want[:2], ("b_scaled", "r_csr")):
        assert g.shape == w.shape and (g != w).nnz == 0, what
    _eq(got[2], want[2], "diag")
    assert got[3] == want[3]


@pytest.mark.parametrize("kind", STRUCTURES)
def test_from_groups_matches_jax(kind):
    """Every field equal to the JAX operand's: each tile operand's tiles and
    index map, each rest's rows and buckets, the diag and the layout flags."""
    t, j, *_ = _both(kind)
    for name in ("n_rows", "n_groups", "z_pad", "diag_in_tiles", "nnz_factored"):
        assert getattr(t, name) == getattr(j, name), name
    _eq(t.diag, j.diag, "diag")
    for name in ("bt_tiles", "b_tiles", "r_tiles", "zr_tiles"):
        tt, jt = getattr(t, name), getattr(j, name)
        assert (tt is None) == (jt is None), name
        if tt is not None:
            assert tt.block == jt.block and (tt.n_rows, tt.n_cols) == (jt.n_rows, jt.n_cols)
            for field in ("tiles", "rowblk", "colblk"):
                _eq(getattr(tt, field), getattr(jt, field), f"{name}.{field}")
    for name in ("bt_rest", "b_rest", "r_rest", "br_rest"):
        tr, jr = getattr(t, name), getattr(j, name)
        assert (tr is None) == (jr is None), name
        if tr is not None:
            _eq(tr.rows, jr.rows, f"{name}.rows")
            assert tr.rows.dtype == torch.int64
            assert len(tr.bell.indices) == len(jr.bell.indices)
            for field in ("indices", "values", "row_ids"):
                for a, b in zip(getattr(tr.bell, field), getattr(jr.bell, field)):
                    _eq(a, b, f"{name}.bell.{field}")
            _eq(tr.bell.perm, jr.bell.perm, f"{name}.bell.perm")
    if kind == "merged":
        assert t.zr_tiles is not None and t.z_pad == 56 and t.diag_in_tiles
        assert t.stats()["zr_tiles"] == t.zr_tiles.n_tiles > 0
    if kind == "separate":
        assert t.zr_tiles is None and t.br_rest is None and not t.diag_in_tiles


def test_merged_tiles_requires_combined_rest():
    groups, n, _, _ = _structure("merged")
    with pytest.raises(ValueError, match="combined_rest"):
        t_fac.FactorizedAdjacency.from_groups(groups, n, combined_rest=False, merged_tiles=True)


def _torch_fwd_grad(fn, h, w):
    x = torch.tensor(h, requires_grad=True)
    out = fn(x)
    (torch.sin(out) * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def _jax_fwd_grad(fn, h, w):
    out, vjp = jax.vjp(fn, jnp.asarray(h))
    (dh,) = vjp(jnp.cos(out) * jnp.asarray(w))
    return np.asarray(out), np.asarray(dh)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", STRUCTURES)
def test_spmm_factorized_matches_jax(kind, dtype):
    """Forward and gradient of the port's autograd Function against JAX's
    custom VJP, with h given two padding rows (their dh is zero); in float32
    also against the materialized Â."""
    t, j, groups, n, direct = _both(kind)
    t_dt, j_dt = DTYPES[dtype]
    r = np.random.default_rng(5)
    h = r.normal(size=(n + 2, 8)).astype(np.float32)
    w = r.normal(size=(n, 8)).astype(np.float32)
    cuda_build.reset_launch_counts()
    got, got_dh = _torch_fwd_grad(
        lambda x: t_fac.spmm_factorized(t, x, gather_dtype=t_dt, mxu_dtype=t_dt), h, w)
    want, want_dh = _jax_fwd_grad(
        lambda x: j_fac.spmm_factorized(j, x, gather_dtype=j_dt, mxu_dtype=j_dt), h, w)
    assert got.dtype == got_dh.dtype == np.float32 and got.shape == (n, 8)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got_dh, want_dh, **tol)
    assert not got_dh[n:].any()
    assert set(cuda_build.launch_counts.values()) == {0}  # CPU: the plain twins
    if dtype == "f32":
        a_hat = tf.normalize_adjacency(t_fac.materialize_projection(groups, n, direct=direct))
        np.testing.assert_allclose(got, a_hat @ h[:n], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cls_name", ["flat", "padded"])
@pytest.mark.parametrize("block", [128, 256])
def test_bf16_contraction_matches_jax_kernels(rng, block, cls_name, h_dtype):
    """The plain twins under ``mxu_dtype=torch.bfloat16``, and the packed
    rows summed as the CUDA kernel sums them (val and h rounded to bf16,
    then float32 multiply-adds), against the JAX Pallas kernels
    ``_bsr_flat_matmul`` / ``_bsr_matmul`` with ``mxu_dtype=bfloat16`` in
    interpret mode, with h given in float32 or bfloat16."""
    m = random_csr(rng, 300, 420, 6)
    m.data *= 1.0 + 1e-3 * rng.random(m.nnz).astype(np.float32)  # not bf16-exact
    tcls, jcls = (tf.BsrFlat, jf.BsrFlat) if cls_name == "flat" else (tf.BsrMatrix, jf.BsrMatrix)
    t_mat, j_mat = tcls.from_scipy(m, block=block), jcls.from_scipy(m, block=block)
    h32 = rng.normal(size=(t_mat.n_cols_padded, 128)).astype(np.float32)
    h_t = torch.from_numpy(h32).to(getattr(torch, h_dtype))
    h_j = jnp.asarray(h32).astype(getattr(jnp, h_dtype))
    if cls_name == "flat":
        got = t_bsr.bsr_flat_matmul(t_mat, h_t, mxu_dtype=torch.bfloat16)
        want = _bsr_flat_matmul(
            j_mat.tiles, j_mat.rowblk, j_mat.colblk, j_mat.first, h_j,
            n_row_blocks=j_mat.n_row_blocks, interpret=True, mxu_dtype=jnp.bfloat16,
        )
    else:
        got = t_bsr.bsr_matmul(t_mat, h_t, mxu_dtype=torch.bfloat16)
        want = _bsr_matmul(j_mat.tiles, j_mat.tile_idx, j_mat.tile_col, h_j, interpret=True,
                           mxu_dtype=jnp.bfloat16)
    want = np.asarray(want)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    pk = t_mat.packed
    rows = torch.repeat_interleave(torch.arange(t_mat.n_rows_padded), torch.diff(pk.row_ptr.long()))
    val = pk.val.bfloat16().float()
    emulated = torch.zeros(t_mat.n_rows_padded, 128).index_add_(
        0, rows, val[:, None] * h_t.bfloat16().float()[pk.col.long()])
    np.testing.assert_allclose(emulated.numpy(), want, **F32_TOL)
    # the float32 contraction differs from the bf16 one on these values
    f32 = (t_bsr.bsr_flat_matmul if cls_name == "flat" else t_bsr.bsr_matmul)(t_mat, h_t)
    assert not np.allclose(f32.numpy(), want, **F32_TOL) or h_dtype == "bfloat16"


@pytest.mark.parametrize("mxu", ["f32", "bf16"])
def test_spmm_bsr_flat_h_dtype_and_contraction_match_jax(rng, mxu):
    """``spmm_bsr_flat``'s ``mxu_dtype`` and ``h_dtype`` (a bf16 h sent as
    it is) against JAX's, forward and backward, on a non-square operand
    shaped like the merged ``zr_tiles`` (N × (N + pad + G))."""
    m = random_csr(rng, 200, 330, 5)
    t_mat = tf.BsrFlat.from_scipy(m, block=128)
    t_mat_t = tf.BsrFlat.from_scipy(m.T.tocsr(), block=128)
    j_mat = jf.BsrFlat.from_scipy(m, block=128)
    j_mat_t = jf.BsrFlat.from_scipy(m.T.tocsr(), block=128)
    t_dt, j_dt = DTYPES[mxu]
    h = rng.normal(size=(330, 24)).astype(np.float32)
    w = rng.normal(size=(200, 24)).astype(np.float32)
    got, got_dh = _torch_fwd_grad(lambda x: t_bsr.spmm_bsr_flat(
        t_mat, t_mat_t, x, mxu_dtype=t_dt or torch.float32, h_dtype=torch.bfloat16), h, w)
    from graphconvgeo_tpu.ops.spmm_pallas import spmm_bsr_flat as j_spmm_bsr_flat

    want, want_dh = _jax_fwd_grad(lambda x: j_spmm_bsr_flat(
        j_mat, j_mat_t, x, mxu_dtype=j_dt or jnp.float32, h_dtype=jnp.bfloat16), h, w)
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got_dh, want_dh, **BF16_TOL)  # dh is cast to bf16's h


def test_spmm_bell_gather_dtype_matches_jax(rng):
    """``gather_dtype=bfloat16`` on the bucketed product: float32 output and
    dh, the same roundings as JAX (h before the gathers, the cotangent
    before the backward's)."""
    m = random_csr(rng, 80, 80, 4, symmetric=True)
    tg = tf.SparseGraph(csr=m, symmetric=True)
    jg = jf.SparseGraph(csr=m, symmetric=True)
    h = rng.normal(size=(80, 16)).astype(np.float32)
    w = rng.normal(size=(80, 16)).astype(np.float32)
    x = torch.tensor(h, requires_grad=True)
    out = t_spmm.spmm_bell(tg.bell(), tg.bell_t(), x, gather_dtype=torch.bfloat16)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.dtype == x.grad.dtype == torch.float32
    want = j_spmm_bell(jg.bell(), jg.bell_t(), jnp.asarray(h), gather_dtype=jnp.bfloat16)
    want_dh = jax.grad(lambda v: jnp.sum(j_spmm_bell(
        jg.bell(), jg.bell_t(), v, gather_dtype=jnp.bfloat16) * jnp.asarray(w)))(jnp.asarray(h))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dh), **BF16_TOL)
    np.testing.assert_allclose(out.detach().numpy(), m @ h, rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def dataset_1100(tmp_path_factory):
    """1,100 users in 32 clusters: slab input layer, mention structure."""
    d = str(tmp_path_factory.mktemp("dumps1100_fac"))
    make_synthetic_dumps(d, n_users=1100, n_clusters=32, seed=0)
    cfg = t_pipeline.PreprocessConfig(bucket_size=30, min_df=2, celebrity_threshold=10)
    ds, _ = t_pipeline.preprocess(d, cfg, use_cache=False).reorder()
    return ds


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_model_on_factorized_operand_matches_jax(dataset_1100, dtype):
    """A HighwayGCN on the factorized operand of a preprocessed dataset, the
    JAX parameters carried across: per-layer activations, loss and every
    gradient (dropout 0), with gather_dtype None or "bfloat16"."""
    ds = dataset_1100
    gd = None if dtype == "f32" else "bfloat16"
    off, mem = ds.groups_offsets, ds.groups_members
    groups = {g: mem[off[g] : off[g + 1]] for g in range(len(off) - 1)}
    fa_t = ds.factorized_adjacency()
    fa_j = j_fac.FactorizedAdjacency.from_groups(
        groups, ds.n_nodes, direct=(ds.direct_src, ds.direct_dst))
    assert fa_t.stats()["zr_tiles"] == fa_j.zr_tiles.n_tiles > 0
    assert fa_t.stats()["bt_tiles"] == fa_j.bt_tiles.n_tiles > 0
    common = dict(n_features=ds.x.shape[1], n_classes=ds.n_classes, hidden=(32, 32),
                  dropout=0.0, gather_dtype=gd)
    jm = j_gcn.HighwayGCN(j_gcn.GCNConfig(**common), jf.SparseGraph(csr=ds.x), fa_j)
    params = jm.init(jax.random.key(4))
    tm = t_gcn.HighwayGCN(t_gcn.GCNConfig(**common), tf.SparseGraph(csr=ds.x), fa_t, device="cpu")
    assert tm.backend == "factorized" and tm.arrays["adj"] is tm.arrays["adj_t"]
    assert type(tm.arrays["x"]).__name__ == "SlabbedBell"
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tol = F32_TOL if gd is None else BF16_TOL
    with torch.no_grad():
        got = tm.hidden_states(train=False)
    want = jax.jit(lambda p, a: jm.hidden_states(p, a, train=False))(params, jm.arrays)
    for i, (g_, w_) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=tol["rtol"],
                                   atol=max(tol["atol"], 2e-5), err_msg=f"layer {i}")
    y = ds.y.astype(np.int32)
    mask = np.zeros(ds.n_nodes, np.float32)
    mask[ds.train_idx] = 1.0
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, a: jm.loss(p, jnp.asarray(y), jnp.asarray(mask), a, train=True)))(params, jm.arrays)
    t_loss = tm.loss(torch.from_numpy(y), torch.from_numpy(mask), train=True)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-5 if gd is None else 1e-3)
    want_g = params_from_jax(jax.tree.map(np.asarray, j_grads))
    for k, p in tm.named_parameters():
        scale = float(np.abs(want_g[k].numpy()).max())
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), rtol=tol["rtol"],
                                   atol=max(tol["atol"] * scale, 1e-6), err_msg=k)


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
def test_cli_factorized_healthy_band(gather_dtype):
    """``--adjacency factorized`` (with and without ``--gather-dtype
    bfloat16``) trains the synthetic preset on the CPU: the plain twins,
    no kernel launched; the run names the adjacency and its operand."""
    extra = [] if gather_dtype is None else ["--gather-dtype", gather_dtype]
    report = t_cli.main([
        "--preset", "synthetic", "--adjacency", "factorized", "--epochs", "20",
        "--patience", "20", "--hidden", "32", "32", "--device", "cpu", "--json",
        "--no-cache", "--quiet", *extra,
    ])
    assert report["dev"]["acc_at_161"] >= 0.9
    run = report["run"]
    assert (run["backend"], run["adjacency"], run["gather_dtype"]) == (
        "factorized", "factorized", gather_dtype)
    assert run["n_tiles"] == run["bt_tiles"] + run["zr_tiles"] > 0
    assert run["bt_rest_rows"] + run["br_rest_rows"] > 0
    losses = [h["loss"] for h in run["history"]]
    assert losses[-1] < 0.7 * losses[0]
    assert all(set(h["launches"].values()) == {0} for h in run["history"])
    assert "bsr_flat_matmul_bf16" in run["history"][0]["launches"]


def test_gather_dtype_refused_for_gat():
    """The GAT takes --gather-dtype bfloat16 (its input layer's gathers) and
    refuses a gather dtype outside bfloat16 and float32, as the GCN does."""
    g = t_cli.parse_args(["--model", "gat", "--gather-dtype", "bfloat16"])
    assert (g.model, g.gather_dtype) == ("gat", "bfloat16")
    with pytest.raises(SystemExit):
        t_cli.parse_args(["--model", "gat", "--gather-dtype", "float16"])
    with pytest.raises(ValueError, match="gather_dtype"):
        t_gat.GATConfig(n_features=3, n_classes=2, hidden=(4,), heads=2, gather_dtype="float16")
    a = t_cli.parse_args(["--adjacency", "factorized", "--gather-dtype", "bfloat16"])
    assert (a.adjacency, a.gather_dtype) == ("factorized", "bfloat16")
    with pytest.raises(ValueError, match="gather_dtype"):
        t_gcn.GCNConfig(n_features=3, n_classes=2, gather_dtype="float16")
