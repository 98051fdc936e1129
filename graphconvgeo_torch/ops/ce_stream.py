"""Streamed masked cross-entropy head — [N, C] logits never materialize.

At Twitter-World scale the [N, C] logits and the log-softmax residual the
cross-entropy backward keeps are the largest buffers of a step. The loss
only needs per-row ``logsumexp`` and the label logit, and the backward can
recompute each row block's logits: ``masked_ce_sums`` walks the rows in
blocks under ``torch.utils.checkpoint``, so forward transients are
[block, C] and the backward re-runs each block (one extra [block, H] @
[H, C] product per block — FLOPs for memory).

Each block's product adds 1 to ``profiling.counters["head_blocks"]``: the
loss's blocks, their recompute and the streamed predict's blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from graphconvgeo_torch.ops import dense
from graphconvgeo_torch.utils import profiling


def _head(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h @ w + b, the product in the promoted dtype of h and w (as JAX
    promotes a float32 h against bf16 weights), on the 3×TF32 kernel where
    ``ops/dense.py`` engages it."""
    profiling.counters["head_blocks"] += 1
    return dense.matmul(h, w, torch.promote_types(h.dtype, w.dtype)) + b


def _block_ce(h_i, w, b, y_i, m_i):
    logits = _head(h_i, w, b)
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(1, y_i[:, None])[:, 0]
    return torch.sum(ce * m_i)


def masked_ce_sums(
    h: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    *,
    row_block: int = 65536,
) -> tuple:
    """(Σ mask·CE(softmax(h@w+b), y), Σ mask) over row blocks, as float32
    scalars."""
    n = h.shape[0]
    row_block = max(8, min(row_block, n))
    y = y.long()
    mask = mask.to(torch.float32)
    num = h.new_zeros((), dtype=torch.float32)
    # One split, not a slice a block: the split's backward concatenates the
    # blocks' cotangents once, where each slice's backward would fill a
    # zeroed [N, H] buffer of its own.
    for h_i, y_i, m_i in zip(h.split(row_block), y.split(row_block), mask.split(row_block)):
        num = num + checkpoint(_block_ce, h_i, w, b, y_i, m_i, use_reentrant=False)
    return num, mask.sum()


@torch.no_grad()
def streamed_argmax(
    h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, row_block: int = 65536
) -> torch.Tensor:
    """argmax(h@w+b, -1) per row WITHOUT materializing [N, C] logits."""
    n = h.shape[0]
    row_block = max(8, min(row_block, n))
    return torch.cat(
        [torch.argmax(_head(h[r0 : r0 + row_block], w, b), dim=-1) for r0 in range(0, n, row_block)]
    )


@torch.no_grad()
def predict_classes(model) -> torch.Tensor:
    """argmax class per node, streaming the head above the logits-size gate."""
    if int(model.x.shape[0]) * model.cfg.n_classes > streamed_rows_threshold():
        h = model.hidden_states(train=False, with_logits=False)[-1]
        return streamed_argmax(h, model.out.w, model.out.b)
    return torch.argmax(model.apply(train=False), dim=-1)


def streamed_rows_threshold() -> int:
    """Gate: stream the head when N × C exceeds this many entries (≈1 GB of
    float32 logits — below it the plain head is cheaper)."""
    return 1 << 28
