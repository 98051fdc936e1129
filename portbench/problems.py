"""The benchmark's input generators: arrays made from ``--seed``, handed to
the port at the level ``graphconvgeo_torch/data/pipeline.py :: Dataset``
holds them (X as CSR, the mention groups and direct edges, labels, splits,
coordinates and class medians). A configuration file names its generator
under ``"generator"`` and gives its parameters under ``"generator_params"``.

Both generators are frozen copies, so that a change to the port's own
synthetic data cannot move the benchmark:

- :func:`geotext` follows ``graphconvgeo_torch/data/synthetic.py ::
  make_synthetic_dumps`` at ``chip_smoke.py :: GEOTEXT_DUMPS`` (users in
  geographic clusters, cluster words and noise words, @-mentions of
  per-cluster hub accounts, of users of the same cluster and of one
  celebrity) and the preprocessing the port runs on such dumps
  (``data/graph.py :: mention_structure`` with its celebrity cut,
  ``data/features.py``'s TF-IDF with ``min_df`` / ``max_df``,
  ``data/kdtree.py``'s median k-d tree), at array level and vectorized, so
  its random draws come in another order than the text generator's.
- :func:`world` is ``chip_smoke.py :: world_problem`` (itself
  ``benchmarks/world_dryrun.py :: build_problem``) with the groups of
  ``graphconvgeo_torch/data/synthetic.py :: random_mention_projection_graph``
  copied in, draw for draw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class Inputs:
    """One problem, in the benchmark's node order."""

    x: sp.csr_matrix  # [n, vocab] float32
    groups: list  # member arrays (int64, sorted, unique), one per group of >= 2 users
    direct_src: np.ndarray  # int64 direct user -> user mentions
    direct_dst: np.ndarray
    y: np.ndarray  # [n] int32 class labels
    train_idx: np.ndarray
    dev_idx: np.ndarray
    test_idx: np.ndarray
    lat: np.ndarray
    lon: np.ndarray
    class_lat_median: np.ndarray
    class_lon_median: np.ndarray

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def n_classes(self) -> int:
        return len(self.class_lat_median)

    def groups_csr(self) -> tuple:
        """(offsets, members) of the groups, as ``Dataset`` holds them."""
        offsets = np.zeros(len(self.groups) + 1, np.int64)
        np.cumsum([len(g) for g in self.groups], out=offsets[1:])
        members = np.concatenate(self.groups) if self.groups else np.zeros(0, np.int64)
        return offsets, members.astype(np.int64)


def _kd_classes(lat, lon, train, bucket: int):
    """Median k-d tree over the training coordinates, alternating axes, split
    until a leaf holds at most ``bucket`` users. Returns (class of every
    user, class median latitudes, class median longitudes); non-training
    users take the leaf their coordinates fall in."""
    coords = np.stack([lat, lon], axis=1)
    cls = np.full(len(lat), -1, np.int64)
    med_lat, med_lon = [], []
    # stack of (train ids in the node, all ids routed to the node, axis)
    stack = [(train, np.arange(len(lat)), 0)]
    while stack:
        tr, routed, axis = stack.pop()
        if len(tr) <= bucket:
            cls[routed] = len(med_lat)
            med_lat.append(float(np.median(lat[tr])))
            med_lon.append(float(np.median(lon[tr])))
            continue
        cut = np.median(coords[tr, axis])
        left_tr = coords[tr, axis] <= cut
        left = coords[routed, axis] <= cut
        stack.append((tr[~left_tr], routed[~left], 1 - axis))
        stack.append((tr[left_tr], routed[left], 1 - axis))
    return cls.astype(np.int32), np.asarray(med_lat), np.asarray(med_lon)


def geotext(seed: int, *, n_users: int, n_clusters: int, words_per_user: int,
            mentions_per_user: int, cluster_spread_deg: float, intra_mention_prob: float = 0.9,
            cluster_words: int = 40, noise_words: int = 100, celebrity_threshold: int = 5,
            min_df: int = 10, max_df: float = 0.2, bucket: int = 50,
            split: tuple = (0.6, 0.2), data_seed: Optional[int] = None) -> Inputs:
    """GeoText-shaped arrays (see the module docstring). Users come in the
    loader's order: train, then dev, then test. With ``data_seed`` the
    corpus is drawn from it and ``seed`` only shuffles the users inside each
    split, so every seed gives the same work in another order."""
    if data_seed is not None:
        return shuffled(geotext(data_seed, n_users=n_users, n_clusters=n_clusters,
                                words_per_user=words_per_user,
                                mentions_per_user=mentions_per_user,
                                cluster_spread_deg=cluster_spread_deg,
                                intra_mention_prob=intra_mention_prob,
                                cluster_words=cluster_words, noise_words=noise_words,
                                celebrity_threshold=celebrity_threshold, min_df=min_df,
                                max_df=max_df, bucket=bucket, split=split), seed)
    rng = np.random.default_rng(seed)
    n, k = n_users, n_clusters
    centers_lat = rng.uniform(25, 48, k)
    centers_lon = np.linspace(-120, -70, k) + rng.uniform(-2, 2, k)
    cluster = rng.integers(0, k, n)
    lat = centers_lat[cluster] + rng.normal(0, cluster_spread_deg, n)
    lon = centers_lon[cluster] + rng.normal(0, cluster_spread_deg, n)
    half = words_per_user // 2
    words = rng.integers(0, cluster_words, (n, half)) + cluster[:, None] * cluster_words
    noise = cluster_words * k + rng.integers(0, noise_words, (n, half))
    # mentions: intra-cluster (half a hub account, half a user of the cluster)
    # or the celebrity
    intra = rng.random((n, mentions_per_user)) < intra_mention_prob
    to_hub = rng.random((n, mentions_per_user)) < 0.5
    hubs_per_cluster = max(4, n // k // 6)
    hub = cluster[:, None] * hubs_per_cluster + rng.integers(0, hubs_per_cluster,
                                                             (n, mentions_per_user))
    celebrity = k * hubs_per_cluster
    by_cluster = np.argsort(cluster, kind="stable")
    starts = np.searchsorted(cluster[by_cluster], np.arange(k + 1))
    sizes = np.diff(starts)
    pick = (rng.random((n, mentions_per_user)) * sizes[cluster][:, None]).astype(np.int64)
    target = by_cluster[starts[cluster][:, None] + pick]
    order = rng.permutation(n)

    # the loader's order: train | dev | test
    n_tr, n_dv = int(n * split[0]), int(n * split[1])
    new_of = np.empty(n, np.int64)
    new_of[order] = np.arange(n)
    user = np.repeat(np.arange(n), mentions_per_user)

    # mention structure: external accounts mentioned by at most
    # celebrity_threshold distinct users form groups; direct user mentions are
    # edges, and each user's direct-mention neighbourhood is a group too
    ext = ~(intra & ~to_hub)
    acct = np.where(intra, hub, celebrity)[ext]
    pairs = np.unique(acct * n + user.reshape(n, -1)[ext])
    acct_u, acct_user = pairs // n, pairs % n
    deg = np.bincount(acct_u, minlength=celebrity + 1)
    keep = deg[acct_u] <= celebrity_threshold
    acct_u, acct_user = acct_u[keep], new_of[acct_user[keep]]
    d_mask = (intra & ~to_hub).ravel()
    d_src, d_dst = user[d_mask], target.ravel()[d_mask]
    d_keep = d_src != d_dst
    dpairs = np.unique(new_of[d_src[d_keep]] * n + new_of[d_dst[d_keep]])
    direct_src, direct_dst = dpairs // n, dpairs % n
    groups = []
    for a in np.unique(acct_u):
        members = np.unique(acct_user[acct_u == a])
        if len(members) >= 2:
            groups.append(members.astype(np.int64))
    und = np.unique(np.concatenate([direct_src * n + direct_dst, direct_dst * n + direct_src]))
    c_of, nb = und // n, und % n
    bounds = np.flatnonzero(np.diff(np.concatenate([[-1], c_of, [-1]])))
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi - lo >= 2:
            groups.append(nb[lo:hi].astype(np.int64))

    # TF-IDF over the words, its vocabulary and document frequencies from the
    # training users (sublinear-free tf, smooth idf, rows l2-normalized)
    tok = np.concatenate([words, noise], axis=1)
    rows = np.repeat(new_of, tok.shape[1])
    counts = sp.coo_matrix((np.ones(rows.shape[0], np.float64), (rows, tok.ravel())),
                           shape=(n, cluster_words * k + noise_words)).tocsr()
    counts.sum_duplicates()
    df = np.bincount(counts[:n_tr].indices, minlength=counts.shape[1])
    vocab = np.flatnonzero((df >= min_df) & (df <= max_df * n_tr))
    x = counts[:, vocab].tocsr()
    idf = np.log((1.0 + n_tr) / (1.0 + df[vocab])) + 1.0
    x = x.multiply(idf[None, :]).tocsr()
    norms = np.sqrt(np.asarray(x.multiply(x).sum(axis=1)).ravel())
    x = sp.diags(1.0 / np.maximum(norms, 1e-12)) @ x
    x = sp.csr_matrix(x, dtype=np.float32)
    x.sort_indices()

    lat_n, lon_n = lat[order], lon[order]
    train_idx = np.arange(n_tr)
    y, med_lat, med_lon = _kd_classes(lat_n, lon_n, train_idx, bucket)
    return Inputs(x=x, groups=groups, direct_src=direct_src.astype(np.int64),
                  direct_dst=direct_dst.astype(np.int64), y=y, train_idx=train_idx,
                  dev_idx=np.arange(n_tr, n_tr + n_dv), test_idx=np.arange(n_tr + n_dv, n),
                  lat=lat_n, lon=lon_n, class_lat_median=med_lat, class_lon_median=med_lon)


def shuffled(inp: Inputs, seed: int) -> Inputs:
    """``inp`` with its users shuffled inside each split (a relabeling)."""
    rng = np.random.default_rng(seed)
    perm = np.concatenate([rng.permutation(idx) for idx in
                           (inp.train_idx, inp.dev_idx, inp.test_idx)]).astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    x = inp.x[perm].tocsr()
    x.sort_indices()
    return dataclasses.replace(
        inp, x=x, groups=[np.sort(inv[g]) for g in inp.groups],
        direct_src=inv[inp.direct_src], direct_dst=inv[inp.direct_dst],
        y=inp.y[perm], lat=inp.lat[perm], lon=inp.lon[perm])


def mention_groups(n: int, n_comm: int, *, hubs_per_comm: int = 24, hubs_per_user: int = 2,
                   crossover_prob: float = 0.05, seed: int = 0) -> list:
    """The groups of ``graphconvgeo_torch/data/synthetic.py ::
    random_mention_projection_graph(..., return_structure=True)``, draw for
    draw: users mention hubs of their own community, with a crossover to a
    random community; each hub's audience of two or more users is a group."""
    rng = np.random.default_rng(seed)
    comm_size = n // n_comm
    comm = np.arange(n) // comm_size
    total_hubs = n_comm * hubs_per_comm
    picks = rng.integers(0, hubs_per_comm, (n, hubs_per_user))
    hub_comm = np.repeat(comm[:, None], hubs_per_user, axis=1)
    cross = rng.random((n, hubs_per_user)) < crossover_prob
    hub_comm[cross] = rng.integers(0, n_comm, int(cross.sum()))
    hub_of = hub_comm * hubs_per_comm + picks
    users = np.repeat(np.arange(n), hubs_per_user)
    order = np.argsort(hub_of.ravel(), kind="stable")
    users_s, hubs_s = users[order], hub_of.ravel()[order]
    starts = np.searchsorted(hubs_s, np.arange(total_hubs + 1))
    return [users_s[starts[g]:starts[g + 1]].astype(np.int64)
            for g in range(total_hubs) if starts[g + 1] - starts[g] >= 2]


def world(seed: int, *, n_users: int, vocab: int, classes: int, tokens_per_user: int = 20,
          zipf_a: float = 1.25, train_share: float = 0.95, dev_rows: int = 10_000) -> Inputs:
    """``chip_smoke.py :: world_problem`` (``benchmarks/world_dryrun.py ::
    build_problem``): the mention groups of ``mention_groups(n, max(n // 256,
    8))``, ``tokens_per_user`` tokens a user over Zipf(``zipf_a``) columns
    clipped to ``vocab - 1`` with |N(0, 1)| values, uniform labels, the first
    ``train_share`` of the rows for training, up to ``dev_rows`` dev rows
    after them, uniform coordinates and class medians. Its X is unsorted
    until ``sum_duplicates``, as in the original; the test split is empty."""
    n = n_users
    rng = np.random.default_rng(seed)
    groups = [np.unique(g) for g in mention_groups(n, max(n // 256, 8), seed=seed)]
    rows = np.repeat(np.arange(n), tokens_per_user)
    cols = np.minimum(rng.zipf(zipf_a, rows.shape[0]) - 1, vocab - 1)
    x = sp.coo_matrix(
        (np.abs(rng.normal(size=rows.shape[0])).astype(np.float32), (rows, cols)),
        shape=(n, vocab),
    ).tocsr()
    x.sum_duplicates()
    y = rng.integers(0, classes, n).astype(np.int32)
    train_n = int(n * train_share)
    lat = rng.uniform(-60, 70, n)
    lon = rng.uniform(-180, 180, n)
    med_lat = rng.uniform(-60, 70, classes)
    med_lon = rng.uniform(-180, 180, classes)
    empty = np.zeros(0, np.int64)
    return Inputs(x=x, groups=groups, direct_src=empty, direct_dst=empty, y=y,
                  train_idx=np.arange(train_n),
                  dev_idx=np.arange(train_n, min(train_n + dev_rows, n)), test_idx=empty,
                  lat=lat, lon=lon, class_lat_median=med_lat, class_lon_median=med_lon)


GENERATORS = {"geotext": geotext, "world": world}


def make_inputs(config: dict, seed: int, override: Optional[dict] = None) -> Inputs:
    """The inputs of ``config`` (a configuration file's contents) at
    ``seed``; ``override`` replaces generator parameters (the tests' small
    sizes)."""
    params = {**config["generator_params"], **(override or {})}
    return GENERATORS[config["generator"]](seed, **params)
