"""Gather and segment reductions for the neighbor-sampled mini-batch path
(port of ``graphconvgeo_tpu/ops/scatter_gather.py``).

The JAX package delegates these to XLA (``jnp.take``,
``jax.ops.segment_sum``) on purpose, not to a Pallas kernel; here they are
plain PyTorch ops: ``index_select`` and ``index_add`` into zeros. On the card
``index_add`` sums each segment with atomics, so its order, and a float32
sum's last bit, may vary from run to run.

``gather_rows`` here is not kernel 7's wrapper (``ops/gather.py ::
gather_rows``); import this module by its path, since re-exporting either
from ``graphconvgeo_torch.ops`` would shadow the other.
"""

from __future__ import annotations

import torch


def gather_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[idx]`` with a static output shape; idx may contain padding (=0)."""
    return h.index_select(0, idx)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """out[s] = Σ data[i] over i with segment_ids[i] == s, [num_segments, ...]."""
    return data.new_zeros((num_segments, *data.shape[1:])).index_add(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones((data.shape[0],)), segment_ids, num_segments)
    return s / torch.clamp(cnt, min=1.0)[:, None]
