"""Sparse products, SDDMM, row gathers, dropout and the streamed loss head.

The hand-written CUDA kernels' wrappers live in ``spmm_bsr`` (flat-tile and
padded-list BSR SpMM), ``sddmm_bsr`` (BSR SDDMM), ``gather`` (row gather)
and ``attention_tiled`` (the tiled GAT sweeps). The eager ``spmm`` stays in
``ops.spmm`` (re-exported here it would shadow that module's name), and
``scatter_gather`` (the sampled path's plain gathers and segment sums) is
imported by its path: its ``gather_rows`` would clash with kernel 7's."""

from graphconvgeo_torch.ops.sddmm import sddmm_ell  # noqa: F401
from graphconvgeo_torch.ops.spmm import spmm_ell, spmm_oracle  # noqa: F401
