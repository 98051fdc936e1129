"""The tiled GAT layer of the PyTorch port against the JAX package's.

Each kernel's plain twin is held against the JAX kernel function itself
(``_tile_fwd_fused``, ``_tile_bwd_row``, ``_tile_bwd_col``, Pallas in
interpret mode) on the same pattern and inputs: m equal; o and den at
rtol 1e-5, atol 1e-6; ds, dz and dd at rtol 1e-4, atol 1e-5 (the twins sum
the same products in another order). The whole layer — forward and the
gradients in z, a_src and a_dst — is held against JAX's
``gat_attention_tiled`` / ``_tiled_gat_core`` at the JAX tests' tolerances.

The bf16 tile contractions (``mxu_precision="default"``, JAX's
``Precision.DEFAULT``): XLA on the CPU ignores DEFAULT and computes the
products in float32, bit for bit as HIGHEST, so JAX's kernels in interpret
mode cannot show the rounding. The plain versions are therefore held first
against a numpy reference that spells out the rounding of the same operands
(bf16 nearest-even by bit operations, float32 tolerance ``FWD_TOL`` /
``BWD_TOL``), and only then against JAX's kernels at DEFAULT at a bf16
tolerance (``BF16_REL``: each term carries up to 2⁻⁸ relative error from its
two roundings). ``den`` stays unrounded, and ``"highest"`` is bit-equal to
the float32 path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphconvgeo_torch.ops import attention_tiled as t_at
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern as TTiled
from graphconvgeo_torch.utils import cuda_build
from graphconvgeo_tpu.ops import attention_tiled as j_at
from graphconvgeo_tpu.ops.dropout import entry_keep as j_entry_keep
from graphconvgeo_tpu.sparse.attention_tiles import TiledAttentionPattern as JTiled
from tests.test_attention_tiled import _mk
from tests.test_torch_gat_operands import _isolated_rows_pattern

SLOPE = 0.2
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
LAYER_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
DROP_TOL = dict(rtol=1e-3, atol=1e-4)
BF16_REL = 2e-2  # × max|reference|: bf16-rounded operands against float32 products
SEED = 1234567


def _operands(name, rng, n=80):
    if name == "isolated-rows":
        a = _isolated_rows_pattern()
        return a, dict(block=32, min_tile_nnz=2)
    a = _mk(rng, n=n)[0]
    return a, dict(block=32, min_tile_nnz=50 if name == "tiles+rest" else 10_000)


def _sweep_inputs(att, rng, heads=2, fp=16):
    npad, mpad = att.n_row_blocks * att.block, att.n_col_blocks * att.block
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(s=f32(npad, heads), d=f32(mpad, heads), z=f32(mpad, heads, fp),
                c=f32(npad, heads), g=f32(npad, heads, fp))


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("name", ["tiles+rest", "isolated-rows"])
def test_kernel_twins_match_jax_kernels(rng, name, rate):
    a, kw = _operands(name, rng)
    j_att, t_att = JTiled.from_scipy(a, **kw), TTiled.from_scipy(a, **kw)
    x = _sweep_inputs(j_att, rng)
    k = dict(slope=SLOPE, rate=rate)
    jseed = jnp.asarray([SEED], jnp.int32)
    o_j, den_j, m_j = j_at._tile_fwd_fused(
        j_att, jnp.asarray(x["s"]), jnp.asarray(x["d"]), jnp.asarray(x["z"]), seed=jseed, **k
    )
    T = {n: torch.from_numpy(v) for n, v in x.items()}
    o_t, den_t, m_t = t_at.gat_tile_fwd(t_att, T["s"], T["d"], T["z"], seed=SEED, **k)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(den_t.numpy(), np.asarray(den_j), **FWD_TOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **FWD_TOL)
    # the backward sweeps read the merged (m, den): rows with no edge get 0, 1
    m = np.where(np.asarray(m_j) > -5e29, np.asarray(m_j), 0.0).astype(np.float32)
    den = np.where(np.asarray(den_j) > 0, np.asarray(den_j), 1.0).astype(np.float32)
    j_args = [jnp.asarray(v) for v in (x["s"], x["d"], m, den, x["c"], x["z"], x["g"])]
    t_args = [torch.from_numpy(v) for v in (x["s"], x["d"], m, den, x["c"], x["z"], x["g"])]
    ds_j = j_at._tile_bwd_row(j_att, *j_args, seed=jseed, **k)
    dz_j, dd_j = j_at._tile_bwd_col(j_att, *j_args, seed=jseed, **k)
    ds_t = t_at.gat_tile_bwd_row(t_att, *t_args, seed=SEED, **k)
    dz_t, dd_t = t_at.gat_tile_bwd_col(t_att, *t_args, seed=SEED, **k)
    np.testing.assert_allclose(ds_t.numpy(), np.asarray(ds_j), **BWD_TOL)
    np.testing.assert_allclose(dz_t.numpy(), np.asarray(dz_j), **BWD_TOL)
    np.testing.assert_allclose(dd_t.numpy(), np.asarray(dd_j), **BWD_TOL)
    if name == "isolated-rows":  # empty row blocks: the neutral values
        empty = np.asarray(m_j)[:, 0] < -5e29
        assert empty.any()
        assert (o_t.numpy()[empty] == 0).all() and (den_t.numpy()[empty] == 0).all()


def _layer_pair(a, kw, rng, heads=2, f=8, hot=False):
    n = a.shape[0]
    z = rng.normal(size=(n, heads * f)).astype(np.float32) * 0.5
    if hot:
        z[0, :] = 200.0  # hot column 0: masked raw scores far above the edge max
    a_src = rng.normal(size=(heads, f)).astype(np.float32) * 0.3
    a_dst = rng.normal(size=(heads, f)).astype(np.float32) * 0.3
    tgt = rng.normal(size=(n, heads * f)).astype(np.float32)
    return JTiled.from_scipy(a, **kw), TTiled.from_scipy(a, **kw), (z, a_src, a_dst), tgt


def _torch_value_and_grads(fn, arrays, tgt):
    ts = [torch.tensor(v, requires_grad=True) for v in arrays]
    out = fn(*ts)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_value_and_grads(fn, arrays, tgt):
    def loss(*a_):
        out = fn(*a_)
        return jnp.sum((out - tgt) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(v) for v in arrays)
    )
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize(
    "name,hot", [("tiles+rest", False), ("all-rest", False), ("isolated-rows", False),
                 ("tiles+rest", True), ("all-rest", True)],
)
def test_tiled_layer_matches_jax(rng, name, hot):
    a, kw = _operands(name, rng, n=72)
    j_att, t_att, arrays, tgt = _layer_pair(a, kw, rng, hot=hot)
    cuda_build.reset_launch_counts()
    out_t, g_t = _torch_value_and_grads(
        lambda z, s_, d_: t_at.gat_attention_tiled(t_att, z, s_, d_, negative_slope=SLOPE),
        arrays, tgt,
    )
    out_j, g_j = _jax_value_and_grads(
        lambda z, s_, d_: j_at.gat_attention_tiled(j_att, z, s_, d_, negative_slope=SLOPE),
        arrays, tgt,
    )
    np.testing.assert_allclose(out_t, out_j, **LAYER_TOL)
    for got, want in zip(g_t, g_j):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **GRAD_TOL)
    # CPU tensors take the plain twins: no kernel was launched
    assert all(v == 0 for v in cuda_build.launch_counts.values())


def test_tiled_layer_attn_dropout_matches_jax(rng):
    rate = 0.35
    a = _mk(rng, n=64)[0]
    kw = dict(block=32, min_tile_nnz=40)
    j_att, t_att, arrays, tgt = _layer_pair(a, kw, rng)
    assert t_att.n_tiles > 0 and t_att.rest is not None
    jseed = jnp.asarray([SEED], jnp.int32)
    out_t, g_t = _torch_value_and_grads(
        lambda z, s_, d_: t_at.gat_attention_tiled(
            t_att, z, s_, d_, negative_slope=SLOPE, attn_dropout=rate, seed=SEED),
        arrays, tgt,
    )
    out_j, g_j = _jax_value_and_grads(
        lambda z, s_, d_: j_at._tiled_gat_core(
            j_att, z, s_, d_, jseed, SLOPE, rate, jax.lax.Precision.HIGHEST),
        arrays, tgt,
    )
    np.testing.assert_allclose(out_t, out_j, **DROP_TOL)
    for got, want in zip(g_t, g_j):
        np.testing.assert_allclose(got, want, **DROP_TOL)
    with torch.no_grad():
        undropped = t_at.gat_attention_tiled(
            t_att, *(torch.from_numpy(v) for v in arrays), negative_slope=SLOPE
        ).numpy()
    assert np.abs(out_t - undropped).max() > 1e-3  # something was dropped


def test_keep_masks_wrap_like_jax():
    """Entry ids ≥ 2³¹ and a head stride ≥ 2³² (so h·stride wraps) give the
    JAX package's keep masks: ``_edge_keep`` over every entry of a tile
    against JAX's tile masks, over a rest bucket's slots against its rest
    masks."""
    block, heads, rate, seed = 32, 3, 0.35, 987654
    n_rows, n_cols = 70_000, 90_001  # ids up to ~6.3e9, stride 6.3e9
    keep = lambda rows, cols: t_at._edge_keep(
        torch.from_numpy(rows.ravel()), torch.from_numpy(cols.ravel()), heads=heads,
        n_cols=n_cols, head_stride=n_rows * n_cols, seed=seed, rate=rate).numpy()
    ar = np.arange(block, dtype=np.int64)
    for rb, cb in ((0, 5), (2000, 2812), (2187, 1)):
        rows, cols = np.meshgrid(rb * block + ar, cb * block + ar, indexing="ij")
        want = j_at._tile_keep3(jnp.int32(rb), jnp.int32(cb), jnp.int32(seed), block=block,
                                heads=heads, n_cols=n_cols, head_stride=n_rows * n_cols, rate=rate)
        np.testing.assert_array_equal(keep(rows, cols).reshape(block, block, heads),
                                      np.asarray(want).transpose(0, 2, 1))
    row_ids = np.array([3, 40_000, 69_999], np.int64)
    idx = np.array([[0, 7], [90_000, 5], [12, 45_000]], np.int64)
    want_r = j_at._rest_keep(jnp.asarray(row_ids.astype(np.int32)), jnp.asarray(idx.astype(np.int32)),
                             jnp.int32(seed), heads=heads, n_cols=n_cols, head_stride=n_rows * n_cols,
                             rate=rate)
    got_r = keep(np.broadcast_to(row_ids[:, None], idx.shape).copy(), idx)
    np.testing.assert_array_equal(got_r.reshape(*idx.shape, heads).transpose(2, 0, 1),
                                  np.asarray(want_r))
    eid = np.array([2**31, 2**32 - 1, 3 * 2**31 + 5], np.int64)
    from graphconvgeo_torch.ops.dropout import entry_keep as t_entry_keep

    np.testing.assert_array_equal(
        t_entry_keep(torch.from_numpy(eid), seed, rate).numpy(),
        np.asarray(j_entry_keep(jnp.asarray((eid & 0xFFFFFFFF).astype(np.uint32)), jnp.int32(seed), rate)),
    )


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(rng):
    """A tensor on neither the CPU nor CUDA raises; the kernels' operand
    checks refuse block ≠ 128, head widths off the 128-column chunk, wrong
    dtypes and shapes, a real width f outside (0, Fp] and Fp past 512 (they
    run before any launch, so they are checked here)."""
    a, kw = _operands("tiles+rest", rng)
    att32 = TTiled.from_scipy(a, **kw)
    x = {k: torch.from_numpy(v) for k, v in _sweep_inputs(att32, rng).items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_at.gat_tile_fwd(att32, x["s"], x["d"], x["z"].to("meta"), slope=SLOPE, seed=0, rate=0.0)
    idx = [("mask_bits", att32.mask_bits), ("colblk", att32.colblk), ("row_ptr", att32.row_ptr)]
    with pytest.raises(ValueError, match="block 128"):
        t_at._check_cuda_operands(att32, idx, [("s", x["s"])], [("z", x["z"])], 128)
    att = TTiled.from_scipy(a, block=128, min_tile_nnz=50)
    idx = [("mask_bits", att.mask_bits), ("colblk", att.colblk), ("row_ptr", att.row_ptr)]
    z = torch.zeros((att.n_col_blocks * 128, 2, 128))
    s = torch.zeros((att.n_row_blocks * 128, 2))
    t_at._check_cuda_operands(att, idx, [("s", s)], [("z", z)], 128)  # accepted
    with pytest.raises(ValueError, match="multiple of 128"):
        t_at._check_cuda_operands(att, idx, [("s", s)], [("z", z[..., :64])], 64)
    with pytest.raises(TypeError, match="float32"):
        t_at._check_cuda_operands(att, idx, [("s", s.double())], [("z", z)], 128)
    with pytest.raises(ValueError, match="shape"):
        t_at._check_cuda_operands(att, idx, [("s", s[:-1])], [("z", z)], 128)
    edges = [("row_ptr", att.edges.ptr), ("col", att.edges.idx)]
    t_at._check_cuda_operands(att, edges, [("s", s)], [("z", z)], 128, 75)  # accepted
    for f in (0, 129):
        with pytest.raises(ValueError, match="0 < f <= Fp"):
            t_at._check_cuda_operands(att, edges, [("s", s)], [("z", z)], 128, f)
    wide, s1 = torch.zeros((att.n_col_blocks * 128, 1, 640)), s[:, :1].contiguous()
    for f in (None, 600):  # all three sweeps refuse it, the ds sweep (f = Fp) too
        with pytest.raises(ValueError, match="Fp <= 512"):
            t_at._check_cuda_operands(att, edges, [("s", s1)], [("z", wide)], 640, f)


# ---- the bf16 tile contractions (mxu_precision="default") ---------------------
def _bf16_np(x):
    """float32 → bf16 (round to nearest even) → float32, by bit operations."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _edge_sweeps_np(att, x, m_in, den_in, *, rate, seed):
    """The three sweeps with bf16-rounded contraction operands, edge by edge
    in numpy over the pattern's tiled edges: (o, den, m) of the forward and
    ds, dz, dd of the backward from the given merged (m_in, den_in). The
    exps and weights are float32 as in the port; the sums are float64."""
    from graphconvgeo_torch.ops.dropout import entry_keep

    ptr, col = att.edges.ptr.numpy().astype(np.int64), att.edges.idx.numpy().astype(np.int64)
    rows = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    s, d, z, c, g = (x[k] for k in ("s", "d", "z", "c", "g"))
    heads = s.shape[1]
    raw = s[rows] + d[col]
    sc = np.where(raw >= 0, raw, np.float32(SLOPE) * raw).astype(np.float32)
    lg = np.where(raw >= 0, 1.0, SLOPE)
    kf = np.ones_like(sc)
    if rate > 0.0:
        hs = np.arange(heads, dtype=np.int64) * ((att.n_rows * att.n_cols) & 0xFFFFFFFF)
        eid = rows[:, None] * att.n_cols + col[:, None] + hs[None]
        keep = entry_keep(torch.from_numpy(eid), seed, rate).numpy()
        kf = (keep.astype(np.float32) / np.float32(1.0 - rate)).astype(np.float32)
    m = np.full(s.shape, -1e30, np.float32)
    np.maximum.at(m, rows, sc)
    e = np.exp(sc - m[rows]).astype(np.float32)
    den = np.zeros(s.shape, np.float64)
    np.add.at(den, rows, e)  # the unrounded e
    zb, gb = _bf16_np(z), _bf16_np(g)
    o = np.zeros((s.shape[0],) + z.shape[1:], np.float64)
    np.add.at(o, rows, _bf16_np(e * kf)[..., None].astype(np.float64) * zb[col])
    alpha = (np.exp(sc - m_in[rows]).astype(np.float32) / den_in[rows]).astype(np.float32)
    dalpha = np.einsum("ehf,ehf->eh", gb[rows].astype(np.float64), zb[col])
    draw = alpha * (kf * dalpha - c[rows]) * lg
    ds, dd = np.zeros(s.shape), np.zeros(d.shape)
    np.add.at(ds, rows, draw)
    np.add.at(dd, col, draw)
    dz = np.zeros(z.shape)
    np.add.at(dz, col, _bf16_np(kf * alpha)[..., None].astype(np.float64) * gb[rows])
    return dict(o=o, den=den, m=m, ds=ds, dz=dz, dd=dd)


def _port_sweeps(t_att, x, *, rate, prec):
    """The port's three plain sweeps at ``prec``; the backward reads the
    forward's merged (m, den) as the layer does."""
    T = {n: torch.from_numpy(v) for n, v in x.items()}
    k = dict(slope=SLOPE, rate=rate, seed=SEED, mxu_precision=prec)
    o, den, m = t_at.gat_tile_fwd(t_att, T["s"], T["d"], T["z"], **k)
    m_in = torch.where(m > -5e29, m, 0.0)
    den_in = torch.where(den > 0, den, 1.0)
    args = (t_att, T["s"], T["d"], m_in, den_in, T["c"], T["z"], T["g"])
    ds = t_at.gat_tile_bwd_row(*args, **k)
    dz, dd = t_at.gat_tile_bwd_col(*args, **k)
    out = dict(o=o, den=den, m=m, ds=ds, dz=dz, dd=dd, m_in=m_in, den_in=den_in)
    return {n: v.numpy() for n, v in out.items()}


@pytest.mark.parametrize("rate", [0.0, 0.35])
def test_bf16_plain_versions_round_like_the_numpy_reference(rng, rate):
    """At mxu_precision="default" the plain versions equal an edge-by-edge
    numpy reference that rounds the same operands to bf16, at float32
    tolerance, while they differ from the float32 sweeps by far more:
    the rounding is there, and only there."""
    a, kw = _operands("tiles+rest", rng)
    t_att = TTiled.from_scipy(a, **kw)
    x = _sweep_inputs(t_att, rng)
    got = _port_sweeps(t_att, x, rate=rate, prec="default")
    f32 = _port_sweeps(t_att, x, rate=rate, prec=None)
    want = _edge_sweeps_np(t_att, x, got["m_in"], got["den_in"], rate=rate, seed=SEED)
    np.testing.assert_array_equal(got["m"], want["m"])
    np.testing.assert_allclose(got["den"], want["den"], **FWD_TOL)
    np.testing.assert_allclose(got["o"], want["o"], **FWD_TOL)
    for name in ("ds", "dz", "dd"):
        np.testing.assert_allclose(got[name], want[name], **BWD_TOL, err_msg=name)
    for name in ("o", "ds", "dz", "dd"):  # the float32 sweeps differ well past FWD_TOL
        scale = np.abs(f32[name]).max()
        assert np.abs(got[name] - f32[name]).max() > 1e-4 * scale, name


@pytest.mark.parametrize("rate", [0.0, 0.35])
def test_bf16_plain_versions_match_jax_kernels_at_default(rng, rate):
    """The plain versions at "default" against JAX's three Pallas kernels at
    Precision.DEFAULT (interpret mode) within BF16_REL of the largest value.
    On the CPU JAX's DEFAULT products are float32: its outputs at DEFAULT
    equal its outputs at HIGHEST bit for bit (asserted), which is why the
    rounding itself is held by the numpy reference above. m and den are
    unrounded in both packages: equal to their float32 values exactly."""
    a, kw = _operands("tiles+rest", rng)
    j_att, t_att = JTiled.from_scipy(a, **kw), TTiled.from_scipy(a, **kw)
    x = _sweep_inputs(j_att, rng)
    got = _port_sweeps(t_att, x, rate=rate, prec="default")
    f32 = _port_sweeps(t_att, x, rate=rate, prec="highest")
    np.testing.assert_array_equal(got["den"], f32["den"])
    np.testing.assert_array_equal(got["m"], f32["m"])
    jseed = jnp.asarray([SEED], jnp.int32)
    j_in = {n: jnp.asarray(v) for n, v in x.items()}
    bwd = [j_in["s"], j_in["d"], jnp.asarray(got["m_in"]), jnp.asarray(got["den_in"]), j_in["c"],
           j_in["z"], j_in["g"]]
    jax_out = {}
    for prec in (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST):
        k = dict(slope=SLOPE, rate=rate, seed=jseed, precision=prec)
        o, den, m = j_at._tile_fwd_fused(j_att, j_in["s"], j_in["d"], j_in["z"], **k)
        ds = j_at._tile_bwd_row(j_att, *bwd, **k)
        dz, dd = j_at._tile_bwd_col(j_att, *bwd, **k)
        jax_out[prec] = {n: np.asarray(v) for n, v in
                         dict(o=o, den=den, m=m, ds=ds, dz=dz, dd=dd).items()}
    want = jax_out[jax.lax.Precision.DEFAULT]
    for name, v in want.items():  # XLA:CPU: DEFAULT is HIGHEST
        np.testing.assert_array_equal(v, jax_out[jax.lax.Precision.HIGHEST][name], err_msg=name)
    np.testing.assert_array_equal(got["m"], want["m"])
    np.testing.assert_allclose(got["den"], want["den"], **FWD_TOL)
    for name in ("o", "ds", "dz", "dd"):
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=BF16_REL * np.abs(want[name]).max(), err_msg=name)


def test_bf16_layer_matches_jax_at_default(rng):
    """The whole layer at mxu_precision="default" (forward and the three
    gradients) against JAX's gat_attention_tiled at Precision.DEFAULT within
    BF16_REL; "highest" is bit-equal to the float32 layer; an unknown
    precision is refused; the CPU launches no kernel."""
    a, kw = _operands("tiles+rest", rng, n=72)
    j_att, t_att, arrays, tgt = _layer_pair(a, kw, rng)
    cuda_build.reset_launch_counts()
    run = lambda prec: _torch_value_and_grads(
        lambda z, s_, d_: t_at.gat_attention_tiled(t_att, z, s_, d_, negative_slope=SLOPE,
                                                   mxu_precision=prec), arrays, tgt)
    out_b, g_b = run("default")
    out_h, g_h = run("highest")
    out_f, g_f = run(None)
    np.testing.assert_array_equal(out_h, out_f)
    for got, want in zip(g_h, g_f):
        np.testing.assert_array_equal(got, want)
    out_j, g_j = _jax_value_and_grads(
        lambda z, s_, d_: j_at.gat_attention_tiled(j_att, z, s_, d_, negative_slope=SLOPE,
                                                   mxu_precision=jax.lax.Precision.DEFAULT),
        arrays, tgt,
    )
    np.testing.assert_allclose(out_b, out_j, rtol=0, atol=BF16_REL * np.abs(out_j).max())
    for got, want in zip(g_b, g_j):
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_REL * np.abs(want).max())
    assert np.abs(out_b - out_f).max() > 0  # the rounding reached the layer
    assert all(v == 0 for v in cuda_build.launch_counts.values())
    with pytest.raises(ValueError, match="mxu_precision"):
        t_at.gat_attention_tiled(t_att, *(torch.from_numpy(v) for v in arrays),
                                 mxu_precision="float32")
