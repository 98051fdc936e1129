"""Edge softmax and attention-weighted aggregation (the GAT model family).

Port of ``graphconvgeo_tpu/ops/attention.py`` for its three operands (the
bucketed and the tiled pattern, and the distributed GAT's fixed-K
:class:`AttentionEll`):

- Per-edge scores are GATv1-decomposable: e_ij = LeakyReLU(s_i + d_j) with
  s = (HW)·a_src and d = (HW)·a_dst, so the per-edge work is one gather of a
  narrow [heads, N] table plus elementwise math.
- The softmax runs over the dense slot axis of each degree bucket.
- The aggregation (:class:`_AttnBucketedSpmm`, and :func:`attention_spmm`
  on an ``AttentionEll``) is differentiable in both the attention weights
  (a per-slot multi-head SDDMM) and the features (the transpose layout
  gathers the cotangent, never a scatter-add).

Per-edge tensors are heads-major ([H, n, K]). The gathers run in row chunks
so that no chunk materializes more than :data:`_CHUNK_FLOATS` floats.
:func:`gat_layer`'s Z = H W goes through ``ops/dense.py :: matmul``: the
3×TF32 kernel on the card from ``dense.MIN_ROWS`` rows, ``torch.matmul``
elsewhere.
"""

from __future__ import annotations

import torch

from graphconvgeo_torch.ops import dense
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern
from graphconvgeo_torch.sparse.formats import AttentionEll, BucketedAttention

_NEG = -1e30
# one chunk's gather materializes at most this many floats (512 MB)
_CHUNK_FLOATS = 1 << 27


def edge_softmax(scores: torch.Tensor, valid: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Masked softmax over the slot axis ``dim``; padding slots get 0, and
    all-padding rows are all zero (no NaN). The shift is a constant for
    autograd, as in the JAX package (``stop_gradient``)."""
    s = torch.where(valid > 0, scores, torch.full_like(scores, _NEG))
    m = s.amax(dim=dim, keepdim=True).detach()
    e = torch.exp(s - m) * valid
    return e / torch.clamp(e.sum(dim=dim, keepdim=True), min=1e-30)


def _drop(alpha: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """Attention dropout: keep each weight with probability 1 − rate (drawn
    from ``gen``) and scale the kept ones by 1/(1 − rate)."""
    keep = torch.rand(alpha.shape, generator=gen, device=alpha.device) < (1.0 - rate)
    return torch.where(keep, alpha / (1.0 - rate), torch.zeros_like(alpha))


def _row_chunk(n: int, k: int, width: int) -> int:
    return max(1, min(n, _CHUNK_FLOATS // max(k * width, 1)))


def _ell_matvec_heads(indices: torch.Tensor, values: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out[i, h·f:(h+1)·f] = Σ_k values[h, i, k] · h[indices[i, k], h·f:(h+1)·f].

    indices [n, K]; values [H, n, K]; h [M, H·f] → [n, H·f]. One row gather
    serves all heads; the sum is in the promoted dtype of values and h."""
    heads, n, k = values.shape
    f = h.shape[1] // heads
    dt = torch.promote_types(values.dtype, h.dtype)
    step = _row_chunk(n, k, h.shape[1])
    outs = []
    for r0 in range(0, n, step):
        g = h[indices[r0 : r0 + step]].view(-1, k, heads, f).to(dt)
        outs.append(torch.einsum("hnk,nkhf->nhf", values[:, r0 : r0 + step].to(dt), g))
    return torch.cat(outs).reshape(n, heads * f)


def _ell_sddmm_heads(
    indices: torch.Tensor, g_rows: torch.Tensor, h: torch.Tensor, heads: int
) -> torch.Tensor:
    """out[h, i, k] = ⟨g_rows[i, h·f:(h+1)·f], h[indices[i, k], h·f:(h+1)·f]⟩.

    indices [n, K]; g_rows [n, H·f]; h [M, H·f] → [H, n, K], in the
    promoted dtype of g_rows and h."""
    n, k = indices.shape
    f = h.shape[1] // heads
    dt = torch.promote_types(g_rows.dtype, h.dtype)
    step = _row_chunk(n, k, h.shape[1])
    outs = []
    for r0 in range(0, n, step):
        nbr = h[indices[r0 : r0 + step]].view(-1, k, heads, f).to(dt)
        g_b = g_rows[r0 : r0 + step].view(-1, heads, f).to(dt)
        outs.append(torch.einsum("nhf,nkhf->hnk", g_b, nbr))
    return torch.cat(outs, dim=1)


class _AttnBucketedSpmm(torch.autograd.Function):
    """Multi-head aggregation over the bucketed pattern: ``alphas`` are
    per-bucket [H, n_b, K_b]; ``h`` is [M, H·f]; returns [n_rows, H·f].
    The backward is the JAX package's: dα by a per-bucket SDDMM, dh through
    the transpose buckets (``perm_t`` gathers the values)."""

    @staticmethod
    def forward(ctx, att, h, *alphas):
        ctx.att = att
        ctx.save_for_backward(h, *alphas)
        outs = [_ell_matvec_heads(idx, a, h) for idx, a in zip(att.indices, alphas)]
        return torch.cat(outs)[att.inv_perm]

    @staticmethod
    def backward(ctx, g):
        att = ctx.att
        h, *alphas = ctx.saved_tensors
        heads = alphas[0].shape[0]
        g = g.contiguous()
        g_sorted = g[att.perm]
        dalphas, start = [], 0
        for idx, valid in zip(att.indices, att.valid):
            n_b = idx.shape[0]
            dalphas.append(_ell_sddmm_heads(idx, g_sorted[start : start + n_b], h, heads) * valid)
            start += n_b
        alpha_flat = torch.cat([a.reshape(heads, -1) for a in alphas], dim=1)
        dh_parts = []
        for idx_t, valid_t, pt in zip(att.indices_t, att.valid_t, att.perm_t):
            a_t = alpha_flat[:, pt.reshape(-1)].view(heads, *pt.shape) * valid_t
            dh_parts.append(_ell_matvec_heads(idx_t, a_t, g))
        return (None, _full_rows(torch.cat(dh_parts)[att.inv_perm_c], h), *dalphas)


def _full_rows(dh_rows: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The cotangent of h from the pattern's column rows: zero on the rows
    of h past the pattern's columns."""
    if dh_rows.shape[0] == h.shape[0]:
        return dh_rows
    dh = torch.zeros_like(h)
    dh[: dh_rows.shape[0]] = dh_rows
    return dh


class _AttnEllSpmm(torch.autograd.Function):
    """Multi-head aggregation over the fixed-K pattern: ``alpha`` [H, N, K],
    ``h`` [M, H·f] → [N, H·f]. The backward is JAX's ``attention_spmm``
    (``_spmm_ell_train_core``): dα by the per-slot SDDMM, dh through the
    transpose layout (``perm_t`` gathers the values)."""

    @staticmethod
    def forward(ctx, att, h, alpha):
        ctx.att = att
        ctx.save_for_backward(h, alpha)
        return _ell_matvec_heads(att.indices, alpha, h)

    @staticmethod
    def backward(ctx, g):
        att = ctx.att
        h, alpha = ctx.saved_tensors
        heads = alpha.shape[0]
        g = g.contiguous()
        dalpha = _ell_sddmm_heads(att.indices, g, h, heads) * att.valid
        a_t = alpha.reshape(heads, -1)[:, att.perm_t].view(heads, *att.indices_t.shape)
        dh = _ell_matvec_heads(att.indices_t, a_t * att.valid_t, g)
        return None, _full_rows(dh, h), dalpha


def attention_spmm(att: AttentionEll, alpha: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out[i, h·f:(h+1)·f] = Σ_k alpha[h, i, k] · h[att.indices[i, k], h·f:(h+1)·f],
    differentiable in alpha and h; alpha [H, N, K] over the forward layout
    with its padding slots already 0 (:func:`edge_softmax` sees to it)."""
    return _AttnEllSpmm.apply(att, h, alpha)


def gat_attention_ell(
    att: AttentionEll,
    hw: torch.Tensor,
    a_src: torch.Tensor,
    a_dst: torch.Tensor,
    *,
    negative_slope: float = 0.2,
    attn_dropout: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """Multi-head attention over a fixed-K pattern (JAX's ``AttentionEll``
    branch of ``gat_attention``): one softmax over the [H, N, K] slots, one
    aggregation. The attention-dropout mask draws from a ``torch.Generator``
    seeded with ``seed``, as on the bucketed operand."""
    heads, f = a_src.shape
    hw_heads = hw.view(hw.shape[0], heads, f)
    s_t = torch.einsum("nhf,hf->hn", hw_heads[: att.n_rows], a_src)
    d_t = torch.einsum("nhf,hf->hn", hw_heads, a_dst)
    scores = s_t[:, :, None] + d_t[:, att.indices]  # [H, N, K]
    scores = torch.where(scores >= 0, scores, negative_slope * scores)
    alpha = edge_softmax(scores, att.valid)
    if attn_dropout > 0.0:
        gen = torch.Generator(device=hw.device).manual_seed(int(seed))
        alpha = _drop(alpha, attn_dropout, gen)
    return attention_spmm(att, alpha, hw)


def gat_attention_bucketed(
    att: BucketedAttention,
    hw: torch.Tensor,
    a_src: torch.Tensor,
    a_dst: torch.Tensor,
    *,
    negative_slope: float = 0.2,
    attn_dropout: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """Multi-head attention over a degree-bucketed pattern: scores, softmax
    and aggregation run per bucket. With ``attn_dropout > 0`` the keep mask
    comes from a ``torch.Generator`` seeded with ``seed`` on ``hw``'s device
    (not bit-comparable with the JAX package's ``jax.random`` draw)."""
    heads, f = a_src.shape
    hw_heads = hw.view(hw.shape[0], heads, f)
    s_t = torch.einsum("nhf,hf->hn", hw_heads[: att.n_rows], a_src)
    d_t = torch.einsum("nhf,hf->hn", hw_heads, a_dst)
    s_sorted = s_t[:, att.perm]
    gen = None
    if attn_dropout > 0.0:
        gen = torch.Generator(device=hw.device).manual_seed(int(seed))
    alphas, start = [], 0
    for idx, valid in zip(att.indices, att.valid):
        n_b = idx.shape[0]
        scores = s_sorted[:, start : start + n_b, None] + d_t[:, idx]  # [H, n_b, K_b]
        scores = torch.where(scores >= 0, scores, negative_slope * scores)
        alpha = edge_softmax(scores, valid)
        if gen is not None:
            alpha = _drop(alpha, attn_dropout, gen)
        alphas.append(alpha)
        start += n_b
    return _AttnBucketedSpmm.apply(att, hw, *alphas)


def gat_attention(
    att,
    hw: torch.Tensor,
    a_src: torch.Tensor,
    a_dst: torch.Tensor,
    *,
    negative_slope: float = 0.2,
    attn_dropout: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """Multi-head attention scoring and aggregation over precomputed
    features ``hw`` [M, heads·f] covering the pattern's column space (M ≥
    att.n_rows: in the distributed GAT rows [n_rows, M) are the received
    halo). Destination scores read the first ``att.n_rows`` rows; neighbour
    scores and the aggregation read all of hw. Returns [att.n_rows, heads·f]
    (pre-bias, pre-activation). ``seed`` keys the attention dropout of every
    operand."""
    kw = dict(negative_slope=negative_slope, attn_dropout=attn_dropout, seed=seed)
    if isinstance(att, TiledAttentionPattern):
        from graphconvgeo_torch.ops.attention_tiled import gat_attention_tiled

        return gat_attention_tiled(att, hw, a_src, a_dst, **kw)
    if isinstance(att, BucketedAttention):
        return gat_attention_bucketed(att, hw, a_src, a_dst, **kw)
    if isinstance(att, AttentionEll):
        return gat_attention_ell(att, hw, a_src, a_dst, **kw)
    raise TypeError(
        f"gat_attention takes a TiledAttentionPattern, a BucketedAttention or an "
        f"AttentionEll, got {type(att).__name__}"
    )


def gat_layer(
    att,
    h_in: torch.Tensor,
    w: torch.Tensor,
    a_src: torch.Tensor,
    a_dst: torch.Tensor,
    *,
    negative_slope: float = 0.2,
    attn_dropout: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """One multi-head GAT propagation (heads concatenated): h_in [N, d_in],
    w [d_in, heads·f], a_src/a_dst [heads, f] → [N, heads·f]. Z = h_in · w
    in the promoted dtype of the two, on the dense kernel where
    ``dense.matmul`` engages it."""
    z = dense.matmul(h_in, w, torch.promote_types(h_in.dtype, w.dtype))
    return gat_attention(
        att, z, a_src, a_dst,
        negative_slope=negative_slope, attn_dropout=attn_dropout, seed=seed,
    )
