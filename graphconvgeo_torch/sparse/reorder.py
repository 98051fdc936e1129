"""Graph reordering: concentrate edges into dense 128×128 tiles.

The hybrid SpMM's fast path (dense-tile MXU matmuls, ~0.6 ns/edge) only
catches edges that fall in dense tiles; scattered edges pay the ~20 ns/edge
random-gather cost. Real @-mention graphs have strong community structure,
but the node order (train/dev/test concatenation) scatters it. A bandwidth-
reducing permutation (reverse Cuthill-McKee) re-concentrates communities
onto the diagonal, typically moving the bulk of edges into dense tiles.

The permutation is a pure relabeling: Â → P Â Pᵀ, features/labels/masks are
row-permuted, predictions are mapped back with the inverse.
"""

from __future__ import annotations

import dataclasses
import importlib.util

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


@dataclasses.dataclass
class Reordering:
    perm: np.ndarray  # new position -> old id   (row i of new = old perm[i])
    inv: np.ndarray  # old id -> new position
    method: str = "identity"  # which candidate produced this permutation

    def permute_graph(self, adj: sp.csr_matrix) -> sp.csr_matrix:
        out = adj[self.perm][:, self.perm].tocsr()
        out.sort_indices()
        return out

    def permute_rows(self, x):
        return x[self.perm]

    def to_new(self, idx: np.ndarray) -> np.ndarray:
        return self.inv[idx]

    def to_old(self, idx: np.ndarray) -> np.ndarray:
        return self.perm[idx]


def rcm_reordering(adj: sp.spmatrix) -> Reordering:
    perm = np.asarray(reverse_cuthill_mckee(sp.csr_matrix(adj), symmetric_mode=True))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return Reordering(perm=perm.astype(np.int64), inv=inv.astype(np.int64), method="rcm")


def louvain_reordering(
    adj: sp.spmatrix, *, seed: int = 0, resolution: float = 1.0
) -> Reordering:
    """Community-clustered ordering via Louvain: nodes of one community get
    consecutive ids, so intra-community edges land in diagonal tile blocks.
    Recovers ~the sorted-SBM optimum on shuffled community graphs (vs ~⅓ for
    RCM banding). One-time host cost ≈ O(M log N) via networkx, which is
    imported here only: it is optional, and :func:`best_reordering` skips
    this candidate where it is not installed."""
    import networkx as nx

    g = nx.from_scipy_sparse_array(sp.csr_matrix(adj))
    comms = nx.community.louvain_communities(g, seed=seed, resolution=resolution)
    comms = sorted(comms, key=len, reverse=True)
    perm = np.concatenate([np.fromiter(c, dtype=np.int64) for c in comms])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return Reordering(perm=perm, inv=inv, method="louvain")


def labelprop_reordering(adj: sp.spmatrix, *, iters: int = 10) -> Reordering:
    """Community ordering from the native C++ label-propagation pass —
    O(iters·M) with a tiny constant; the Twitter-World-scale default."""
    from graphconvgeo_torch.native import label_propagation

    csr = sp.csr_matrix(adj)
    labels = label_propagation(csr.indptr.astype(np.int64), csr.indices, iters=iters)
    perm = np.argsort(labels, kind="stable").astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return Reordering(perm=perm, inv=inv, method="labelprop")


def _grouped_mode(group_ids, labels, n_groups, *, default=None):
    """Majority label per group, vectorized (ties → smallest label).

    group_ids/labels: parallel int64 arrays (one entry per incidence);
    groups with no entries get ``default[g]`` (or g itself if None)."""
    out = np.arange(n_groups, dtype=np.int64) if default is None else default.copy()
    if len(group_ids) == 0:
        return out
    # count (group, label) pairs, then pick per group the (count DESC,
    # label ASC) winner via one lexsort over the unique pairs
    pairs, counts = np.unique(
        np.stack([group_ids, labels], axis=1), axis=0, return_counts=True
    )
    order = np.lexsort((pairs[:, 1], -counts, pairs[:, 0]))
    pairs_s = pairs[order]
    first = np.ones(len(pairs_s), dtype=bool)
    first[1:] = pairs_s[1:, 0] != pairs_s[:-1, 0]
    out[pairs_s[first, 0]] = pairs_s[first, 1]
    return out


def bipartite_reordering(
    groups: dict, n: int, *, iters: int = 10, clique_group: bool = False
) -> Reordering:
    """Community-contiguous USER ordering computed from the mention structure
    alone — no projected adjacency needed (the point of the factorized path:
    the projection is never materialized). Label propagation runs on the
    user∪hub bipartite graph (nnz = 2·Σ|audience|, tens of times smaller than
    the projection); users sharing hubs converge to one label and become
    contiguous, which makes the scaled incidence B' near block-diagonal.

    ``clique_group`` adds a within-community secondary sort by each user's
    PRIMARY hub (its largest-audience group): one clique per user becomes a
    contiguous row-run, so B' columns get dense vertical strips and R'
    entries (pairs sharing ≥2 hubs) concentrate — higher 128² tile fill,
    fewer tiles and fewer rest slots for the same edge mass."""
    member_lists = [np.asarray(list(m), dtype=np.int64) for m in groups.values()]
    member_lists = [m for m in member_lists if len(m) >= 2]
    g_count = len(member_lists)
    if g_count == 0:
        ident = np.arange(n, dtype=np.int64)
        return Reordering(perm=ident, inv=ident.copy(), method="bipartite")
    users = np.concatenate(member_lists)
    hubs = np.repeat(np.arange(g_count, dtype=np.int64), [len(m) for m in member_lists])

    # two-PHASE majority propagation (hub labels from members, then user
    # labels from hubs): synchronous one-phase LP oscillates on bipartite
    # graphs, so the phases alternate instead
    user_labels = np.arange(n, dtype=np.int64)
    for _ in range(iters):
        hub_labels = _grouped_mode(hubs, user_labels[users], g_count)
        new_user = _grouped_mode(users, hub_labels[hubs], n, default=user_labels)
        if np.array_equal(new_user, user_labels):
            break
        user_labels = new_user
    # users in no group have no incidence rows — sink them to the end so they
    # never split a community's tile span
    touched = np.zeros(n, dtype=bool)
    touched[users] = True
    sort_key = np.where(touched, user_labels, n + np.arange(n, dtype=np.int64))
    if clique_group:
        # primary hub per user = its largest-audience group (break ties by
        # hub id); members of one big clique become one contiguous row-run
        aud = np.asarray([len(m) for m in member_lists], dtype=np.int64)
        order = np.lexsort((hubs, -aud[hubs], users))
        u_sorted = users[order]
        first = np.ones(len(u_sorted), dtype=bool)
        first[1:] = u_sorted[1:] != u_sorted[:-1]
        primary = np.zeros(n, dtype=np.int64)
        primary[u_sorted[first]] = hubs[order][first]
        perm = np.lexsort((np.arange(n, dtype=np.int64), primary, sort_key))
    else:
        perm = np.argsort(sort_key, kind="stable")
    perm = perm.astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    return Reordering(perm=perm, inv=inv, method="bipartite")


def best_reordering(
    adj: sp.spmatrix,
    *,
    seed: int = 0,
    target_coverage: float = 0.5,
    louvain_max_nodes: int = 300_000,
    groups: dict | None = None,
) -> Reordering:
    """Pick the best of {identity, bipartite-clique (when ``groups`` is
    given), labelprop, louvain, rcm} by tile coverage. Louvain is skipped
    above ``louvain_max_nodes`` (O(minutes) there; the native label
    propagation covers that regime) and where networkx is not installed.
    The winner's ``method`` names the candidate."""
    adj = sp.csr_matrix(adj)
    n = adj.shape[0]
    ident = Reordering(perm=np.arange(n, dtype=np.int64), inv=np.arange(n, dtype=np.int64))
    best, best_cov = ident, tile_coverage(adj)
    if best_cov >= target_coverage:
        return ident
    def candidates():
        if groups is not None:
            # mention-structure ordering: clique-grouped communities from the
            # bipartite incidence (also the best order for the factorized
            # operand's B'/R' fill — measured in PERF.md round 3)
            try:
                yield bipartite_reordering(groups, n, clique_group=True)
            except Exception:
                pass
        try:
            yield labelprop_reordering(adj)
        except Exception:
            pass
        if n <= louvain_max_nodes and importlib.util.find_spec("networkx") is not None:
            try:
                yield louvain_reordering(adj, seed=seed)
            except Exception:
                pass
        yield rcm_reordering(adj)

    for ro in candidates():
        cov = tile_coverage(ro.permute_graph(adj))
        if cov > best_cov:
            best, best_cov = ro, cov
        if best_cov >= max(target_coverage, 0.8):
            break  # good enough — don't pay for slower candidates
    return best


def tile_coverage(adj: sp.csr_matrix, *, block: int = 256, min_tile_nnz: int = 96) -> float:
    """Fraction of edges living in dense tiles (the BSR-path share)."""
    coo = adj.tocoo()
    cb = -(-adj.shape[1] // block)
    key = (coo.row // block).astype(np.int64) * cb + coo.col // block
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    return float((counts[inv] >= min_tile_nnz).mean())
