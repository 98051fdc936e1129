"""SDDMM — sampled dense-dense matmul over an ELL pattern.

Port of ``graphconvgeo_tpu/ops/sddmm.py``: per-slot scores
``s[i, k] = ⟨a[i], b[indices[i, k]]⟩`` over the pattern of an
:class:`EllMatrix` — the gradient of SpMM in the edge values
(``ops/spmm.py :: spmm_ell_trainable``). Plain PyTorch, chunked over slots
so the gather high-water is [N, chunk, F].
"""

from __future__ import annotations

import torch

_CHUNK = 8


def sddmm_ell(indices: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s[i, k] = dot(a[i], b[indices[i, k]]).  indices: [N, K] → s: [N, K]."""
    n, k = indices.shape
    f = b.shape[1]
    chunk = min(_CHUNK, k)
    parts = []
    for c0 in range(0, k, chunk):
        idx = indices[:, c0 : c0 + chunk]
        g = b.index_select(0, idx.reshape(-1)).view(n, idx.shape[1], f)
        parts.append(torch.einsum("nf,ncf->nc", a, g))
    return torch.cat(parts, dim=1)
