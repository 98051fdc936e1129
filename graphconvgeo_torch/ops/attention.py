"""Edge softmax and attention-weighted aggregation (the GAT model family).

Port of ``graphconvgeo_tpu/ops/attention.py`` for the two single-device
operands:

- Per-edge scores are GATv1-decomposable: e_ij = LeakyReLU(s_i + d_j) with
  s = (HW)·a_src and d = (HW)·a_dst, so the per-edge work is one gather of a
  narrow [heads, N] table plus elementwise math.
- The softmax runs over the dense slot axis of each degree bucket.
- The aggregation (:class:`_AttnBucketedSpmm`) is differentiable in both the
  attention weights (a per-slot multi-head SDDMM) and the features (the
  transpose buckets gather the cotangent, never a scatter-add).

Per-edge tensors are heads-major ([H, n, K]). The gathers run in row chunks
so that no chunk materializes more than :data:`_CHUNK_FLOATS` floats.
"""

from __future__ import annotations

import torch

from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern
from graphconvgeo_torch.sparse.formats import BucketedAttention

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
        dh_rows = torch.cat(dh_parts)[att.inv_perm_c]
        if dh_rows.shape[0] != h.shape[0]:  # the pattern's columns may undercover h
            dh = torch.zeros_like(h)
            dh[: dh_rows.shape[0]] = dh_rows
        else:
            dh = dh_rows
        return (None, dh, *dalphas)


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
            keep = torch.rand(alpha.shape, generator=gen, device=alpha.device) < (1.0 - attn_dropout)
            alpha = torch.where(keep, alpha / (1.0 - attn_dropout), torch.zeros_like(alpha))
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
    features ``hw`` [M, heads·f] covering the pattern's column space.
    Returns [att.n_rows, heads·f] (pre-bias, pre-activation). ``seed`` keys
    the attention dropout of either operand."""
    kw = dict(negative_slope=negative_slope, attn_dropout=attn_dropout, seed=seed)
    if isinstance(att, TiledAttentionPattern):
        from graphconvgeo_torch.ops.attention_tiled import gat_attention_tiled

        return gat_attention_tiled(att, hw, a_src, a_dst, **kw)
    if isinstance(att, BucketedAttention):
        return gat_attention_bucketed(att, hw, a_src, a_dst, **kw)
    raise NotImplementedError(
        f"gat_attention takes a TiledAttentionPattern or a BucketedAttention, got "
        f"{type(att).__name__}; the AttentionEll operand comes with the distributed slice"
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
    w [d_in, heads·f], a_src/a_dst [heads, f] → [N, heads·f]."""
    return gat_attention(
        att, h_in @ w, a_src, a_dst,
        negative_slope=negative_slope, attn_dropout=attn_dropout, seed=seed,
    )
