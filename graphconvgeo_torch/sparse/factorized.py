"""The mention projection, materialized (host, numpy and scipy).

The factorized adjacency operator of the JAX package (Â kept as B'B'ᵀ plus
corrections over the user × hub incidence) is not ported yet; this module
holds the one function the preprocessing pipeline needs from it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _group_pairs(member_lists: list, n: int):
    """All unordered pairs per group, duplicates across groups preserved
    (they ARE the multiplicities). Native clique expansion when available."""
    if not member_lists:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    try:
        from graphconvgeo_torch.native import project_cliques

        return project_cliques(dict(enumerate(member_lists)), n)
    except Exception:
        srcs, dsts = [], []
        for m in member_lists:
            iu = np.triu_indices(len(m), 1)
            srcs.append(m[iu[0]])
            dsts.append(m[iu[1]])
        return np.concatenate(srcs), np.concatenate(dsts)


def materialize_projection(
    groups: dict, n: int, *, direct: tuple | None = None
) -> sp.csr_matrix:
    """The unfactored adjacency A (binary, symmetric, no self-loops) — the
    exact matrix ``data/graph.py :: build_mention_adjacency`` produces from
    the same structure."""
    member_lists = [np.unique(np.asarray(list(m), dtype=np.int64)) for m in groups.values()]
    member_lists = [m for m in member_lists if len(m) >= 2]
    src, dst = _group_pairs(member_lists, n)
    if direct is not None and len(direct[0]):
        src = np.concatenate([src, np.asarray(direct[0], dtype=np.int64)])
        dst = np.concatenate([dst, np.asarray(direct[1], dtype=np.int64)])
    a = sp.coo_matrix((np.ones(len(src), np.float32), (src, dst)), shape=(n, n)).tocsr()
    a = a + a.T
    a.data[:] = 1.0
    a.setdiag(0)
    a.eliminate_zeros()
    a.sort_indices()
    return a.astype(np.float32)
