"""Synthetic geolocation datasets.

Two uses:
1. unit/e2e tests — the real GeoText / Twitter-* dumps are not shipped with
   the repo, so the test suite exercises the *entire* pipeline (TSV parsing,
   mention-graph projection, TF-IDF, kd-tree, training, geo_eval) on
   generated data with known structure;
2. benchmarking — power-law graphs at Twitter-US/World scale for SpMM and
   end-to-end throughput runs.

The generator places users in ``n_clusters`` geographic clusters; tweet text
mixes cluster-specific words with global noise words, and @-mentions are
mostly intra-cluster — so a working Highway-GCN must reach high Acc@161 while
a text-free or graph-free model does measurably worse.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp


def make_synthetic_dumps(
    out_dir: str,
    *,
    n_users: int = 600,
    n_clusters: int = 6,
    seed: int = 0,
    words_per_user: int = 30,
    mentions_per_user: int = 4,
    intra_mention_prob: float = 0.9,
    cluster_spread_deg: float = 0.3,
) -> dict:
    """Write user_info.{train,dev,test} TSVs in the reference format."""
    rng = np.random.default_rng(seed)
    # cluster centers spread across the map, > 600km apart
    centers_lat = rng.uniform(25, 48, n_clusters)
    centers_lon = np.linspace(-120, -70, n_clusters) + rng.uniform(-2, 2, n_clusters)

    cluster = rng.integers(0, n_clusters, n_users)
    lat = centers_lat[cluster] + rng.normal(0, cluster_spread_deg, n_users)
    lon = centers_lon[cluster] + rng.normal(0, cluster_spread_deg, n_users)

    cluster_vocab = [[f"w{c}_{i}" for i in range(40)] for c in range(n_clusters)]
    noise_vocab = [f"noise{i}" for i in range(100)]
    usernames = np.asarray([f"user{i}" for i in range(n_users)], dtype=object)
    # external accounts: per-cluster hubs (shared mentions) + celebrities
    ext_accounts = [[f"hub{c}_{i}" for i in range(max(4, n_users // n_clusters // 6))] for c in range(n_clusters)]
    celebrity = "bieber"

    texts = []
    for i in range(n_users):
        c = cluster[i]
        words = list(rng.choice(cluster_vocab[c], size=words_per_user // 2))
        words += list(rng.choice(noise_vocab, size=words_per_user // 2))
        for _ in range(mentions_per_user):
            if rng.random() < intra_mention_prob:
                if rng.random() < 0.5:
                    words.append("@" + str(rng.choice(ext_accounts[c])))
                else:
                    words.append("@" + str(usernames[rng.choice(np.where(cluster == c)[0])]))
            else:
                words.append("@" + celebrity)  # everyone mentions the celebrity
        rng.shuffle(words)
        texts.append(" ".join(words))

    # split: 60/20/20 shuffled
    order = rng.permutation(n_users)
    n_tr = int(n_users * 0.6)
    n_dv = int(n_users * 0.2)
    splits = {
        "train": order[:n_tr],
        "dev": order[n_tr : n_tr + n_dv],
        "test": order[n_tr + n_dv :],
    }
    os.makedirs(out_dir, exist_ok=True)
    for name, idx in splits.items():
        with open(os.path.join(out_dir, f"user_info.{name}"), "w", encoding="latin1") as f:
            for i in idx:
                f.write(f"{usernames[i]}\t{lat[i]:.6f}\t{lon[i]:.6f}\t{texts[i]}\n")
    return {
        "cluster": cluster,
        "centers": (centers_lat, centers_lon),
        "splits": splits,
        "usernames": usernames,
    }


def random_sbm_graph(
    n: int,
    n_comm: int,
    avg_deg: float,
    *,
    p_intra: float = 0.9,
    seed: int = 0,
) -> sp.csr_matrix:
    """Stochastic-block-model graph, nodes ordered by community — the
    realistic stand-in for an @-mention graph (strong community structure),
    and the favorable case for the block-sparse (BSR) SpMM path."""
    rng = np.random.default_rng(seed)
    comm_size = n // n_comm
    comm = np.arange(n) // comm_size
    deg = rng.poisson(avg_deg, n)
    src = np.repeat(np.arange(n), deg)
    intra = rng.random(src.shape[0]) < p_intra
    dst = np.empty_like(src)
    base = comm[src] * comm_size
    dst[intra] = base[intra] + rng.integers(0, comm_size, int(intra.sum()))
    dst[~intra] = rng.integers(0, n, int((~intra).sum()))
    keep = src != dst
    a = sp.coo_matrix(
        (np.ones(int(keep.sum()), np.float32), (src[keep], dst[keep])), shape=(n, n)
    ).tocsr()
    a = a + a.T
    a.data[:] = 1.0
    a.sort_indices()
    return a


def random_mention_projection_graph(
    n: int,
    n_comm: int,
    *,
    hubs_per_comm: int = 24,
    hubs_per_user: int = 2,
    crossover_prob: float = 0.05,
    seed: int = 0,
    return_structure: bool = False,
):
    """Synthetic graph built THE WAY the reference builds its graph
    (``data.py :: efficient_collaboration_weighted_projected_graph2``): users
    mention external hub accounts, and the projected graph connects every
    pair of users sharing a hub — a union of cliques. Mostly intra-community
    hubs with a small crossover probability, so the structure (clique blocks
    on the community diagonal + sparse crossover) mirrors a real projected
    @-mention graph far more faithfully than an SBM's uniform scatter."""
    rng = np.random.default_rng(seed)
    comm_size = n // n_comm
    comm = np.arange(n) // comm_size
    total_hubs = n_comm * hubs_per_comm
    # each user picks hubs: own community's hubs, with crossover to a random one
    picks = rng.integers(0, hubs_per_comm, (n, hubs_per_user))
    hub_comm = np.repeat(comm[:, None], hubs_per_user, axis=1)
    cross = rng.random((n, hubs_per_user)) < crossover_prob
    hub_comm[cross] = rng.integers(0, n_comm, int(cross.sum()))
    hub_of = hub_comm * hubs_per_comm + picks  # [n, hubs_per_user]

    users = np.repeat(np.arange(n), hubs_per_user)
    hubs = hub_of.ravel()
    order = np.argsort(hubs, kind="stable")
    users_s, hubs_s = users[order], hubs[order]
    starts = np.searchsorted(hubs_s, np.arange(total_hubs + 1))
    groups = [users_s[starts[g] : starts[g + 1]] for g in range(total_hubs)]
    from graphconvgeo_torch.data.graph import _project_py

    try:
        from graphconvgeo_torch.native import project_cliques

        src, dst = project_cliques({g: m.tolist() for g, m in enumerate(groups)}, n)
    except Exception:
        src, dst = _project_py({g: m for g, m in enumerate(groups)})
    a = sp.coo_matrix((np.ones(len(src), np.float32), (src, dst)), shape=(n, n)).tocsr()
    a = a + a.T
    a.data[:] = 1.0
    a.setdiag(0)
    a.eliminate_zeros()
    a.sort_indices()
    if return_structure:
        return a, {g: m for g, m in enumerate(groups) if len(m) >= 2}
    return a


def random_powerlaw_graph(
    n: int, avg_deg: float, *, alpha: float = 2.1, seed: int = 0
) -> sp.csr_matrix:
    """Symmetric power-law graph for benchmarking (configuration-model-ish)."""
    rng = np.random.default_rng(seed)
    # degrees ~ zipf, clipped
    raw = rng.zipf(alpha, n).astype(np.float64)
    deg = np.minimum(raw, np.sqrt(n))
    deg = deg * (avg_deg * n / deg.sum())
    stubs = np.repeat(np.arange(n), rng.poisson(np.maximum(deg, 0.2)))
    rng.shuffle(stubs)
    m = len(stubs) // 2
    src, dst = stubs[:m], stubs[m : 2 * m]
    keep = src != dst
    a = sp.coo_matrix(
        (np.ones(keep.sum(), np.float32), (src[keep], dst[keep])), shape=(n, n)
    ).tocsr()
    a = a + a.T
    a.data[:] = 1.0
    a.sort_indices()
    return a
