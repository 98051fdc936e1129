"""@-mention graph construction (reference: ``data.py :: DataLoader.get_graph``
and ``efficient_collaboration_weighted_projected_graph2``).

Pipeline:
1. regex ``@[a-zA-Z0-9_]+`` over each user's concatenated tweet text →
   bipartite user/mention multigraph (mentions lowercased, like usernames);
2. **celebrity removal**: mentioned accounts that are *not* dataset users and
   whose degree exceeds ``celebrity_threshold`` are dropped;
3. **projection** onto dataset users: two users are connected iff one mentions
   the other, or both share a (surviving) common neighbor in the mention
   graph — an external account both mention, or a dataset user adjacent to
   both (mentioning or mentioned) — the reference's
   ``efficient_collaboration_weighted_projected_graph2`` clique expansion,
   O(Σ deg²) over shared-neighbor groups.

Node order in the returned adjacency is the caller's user order (train, dev,
test contiguous — SURVEY.md C4), so index ranges slice the matrix directly.

A C++ fast path (``graphconvgeo_torch/native``) accelerates step 3 for
Twitter-World-scale graphs; this module falls back to pure Python/numpy when
the extension is unavailable.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

import numpy as np
import scipy.sparse as sp

MENTION_RE = re.compile(r"@[a-zA-Z0-9_]+")


def extract_mentions(text: str) -> list:
    """Lowercased mentioned usernames (without the '@')."""
    return [m[1:].lower() for m in MENTION_RE.findall(text)]


def mention_structure(
    users: Sequence[str],
    texts: Iterable[str],
    *,
    celebrity_threshold: int = 5,
    include_direct_mentions: bool = True,
) -> tuple:
    """The bipartite mention structure BEFORE projection.

    Returns ``(groups, direct_src, direct_dst)`` — the shared-neighbor groups
    (hub → dataset-user ids, celebrities removed) and the direct user→user
    mention edges. ``build_mention_adjacency`` materializes the projection of
    this structure; :class:`~graphconvgeo_torch.sparse.factorized.
    FactorizedAdjacency` consumes it directly, skipping materialization on
    the device entirely.
    """
    n = len(users)
    uid = {u: i for i, u in enumerate(users)}

    # External account -> list of dataset users mentioning it. Direct
    # user->user mentions recorded separately.
    ext_neighbors: dict = {}
    direct_src: list = []
    direct_dst: list = []
    ext_degree: dict = {}
    per_user_mentions: list = []
    for i, text in enumerate(texts):
        ms = set(extract_mentions(text))
        per_user_mentions.append(ms)
        for m in ms:
            j = uid.get(m)
            if j is not None:
                if include_direct_mentions and j != i:
                    direct_src.append(i)
                    direct_dst.append(j)
            else:
                ext_degree[m] = ext_degree.get(m, 0) + 1

    # celebrity removal: drop external accounts with degree > threshold
    for i, ms in enumerate(per_user_mentions):
        for m in ms:
            if m in ext_degree and ext_degree[m] <= celebrity_threshold:
                ext_neighbors.setdefault(m, []).append(i)

    # dataset users are shared neighbors too: user c's mention-graph
    # neighborhood (users c mentions + users mentioning c) forms a clique
    # group, exactly like an external account's audience
    user_neighbors: dict = {}
    for s, t in zip(direct_src, direct_dst):
        user_neighbors.setdefault(s, set()).add(t)
        user_neighbors.setdefault(t, set()).add(s)
    groups = dict(ext_neighbors)
    for c, nbrs in user_neighbors.items():
        if len(nbrs) >= 2:
            groups[("u", c)] = sorted(nbrs)
    return (
        groups,
        np.asarray(direct_src, np.int64),
        np.asarray(direct_dst, np.int64),
    )


def build_mention_adjacency(
    users: Sequence[str],
    texts: Iterable[str],
    *,
    celebrity_threshold: int = 5,
    include_direct_mentions: bool = True,
) -> sp.csr_matrix:
    """Symmetric unweighted adjacency over ``users`` (in the given order)."""
    n = len(users)
    groups, direct_src, direct_dst = mention_structure(
        users,
        texts,
        celebrity_threshold=celebrity_threshold,
        include_direct_mentions=include_direct_mentions,
    )

    # projection: clique over users sharing a mention-graph neighbor
    try:
        from graphconvgeo_torch.native import project_cliques  # C++ fast path

        proj_src, proj_dst = project_cliques(groups, n)
    except Exception:
        proj_src, proj_dst = _project_py(groups)

    src = np.concatenate([direct_src, proj_src])
    dst = np.concatenate([direct_dst, proj_dst])
    data = np.ones(src.shape[0], dtype=np.float32)
    a = sp.coo_matrix((data, (src, dst)), shape=(n, n)).tocsr()
    a = a + a.T  # symmetrize
    a.data[:] = 1.0  # unweighted
    a.setdiag(0)
    a.eliminate_zeros()
    a.sort_indices()
    return a.astype(np.float32)


def _project_py(ext_neighbors: dict):
    src: list = []
    dst: list = []
    for nbrs in ext_neighbors.values():
        k = len(nbrs)
        if k < 2:
            continue
        for ai in range(k):
            u = nbrs[ai]
            for bi in range(ai + 1, k):
                src.append(u)
                dst.append(nbrs[bi])
    return np.asarray(src, np.int64), np.asarray(dst, np.int64)
