"""Preprocessing orchestration + versioned artifact cache.

Reference parity: ``gcnmain.py :: preprocess_data`` builds
(X, Â, Y, splits, class medians, userLocation) and gzip-pickles it
(``utils.py :: dump_obj/load_obj``). Here the artifact is an ``.npz`` keyed
by a content hash of the preprocessing config + dump file stats — reruns with
identical inputs skip the expensive graph projection / TF-IDF.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np
import scipy.sparse as sp

from graphconvgeo_torch.data.features import TfidfConfig, build_features
from graphconvgeo_torch.data.graph import mention_structure
from graphconvgeo_torch.data.kdtree import KDTreeDiscretizer
from graphconvgeo_torch.data.loader import RawDataset, load_dumps
from graphconvgeo_torch.sparse.factorized import materialize_projection
from graphconvgeo_torch.sparse.formats import normalize_adjacency

# kept in step with the JAX package's artifact version; the cache directory
# differs, so the two packages never read each other's artifacts
CACHE_VERSION = 3


@dataclasses.dataclass
class PreprocessConfig:
    bucket_size: int = 50
    celebrity_threshold: int = 5
    min_df: int = 10
    max_df: float = 0.2
    encoding: str = "latin1"

    def cache_key(self, data_home: str) -> str:
        stat = []
        for name in ("train", "dev", "test"):
            p = os.path.join(data_home, f"user_info.{name}")
            if os.path.exists(p):
                s = os.stat(p)
                stat.append((name, s.st_size, int(s.st_mtime)))
        payload = json.dumps(
            [CACHE_VERSION, dataclasses.asdict(self), stat], sort_keys=True
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclasses.dataclass
class Dataset:
    """The preprocessed tuple the model trains on."""

    x: sp.csr_matrix  # [n, vocab] tf-idf features
    adj: sp.csr_matrix  # [n, n] normalized adjacency Â
    y: np.ndarray  # [n] int32 class labels (dev/test assigned through the tree)
    train_idx: np.ndarray
    dev_idx: np.ndarray
    test_idx: np.ndarray
    lat: np.ndarray  # [n] true latitude (userLocation equivalent)
    lon: np.ndarray
    class_lat_median: np.ndarray
    class_lon_median: np.ndarray
    # the pre-projection mention structure (ragged groups flattened to
    # offsets/members + direct-mention edges) — lets consumers build the
    # FACTORIZED adjacency operator instead of the materialized Â
    groups_offsets: Optional[np.ndarray] = None  # [n_groups + 1] int64
    groups_members: Optional[np.ndarray] = None  # [sum sizes] int64
    direct_src: Optional[np.ndarray] = None  # [n_direct] int64
    direct_dst: Optional[np.ndarray] = None
    # which reordering candidate produced the current node order (set by
    # :meth:`reorder`; None for the loader's order)
    reorder_method: Optional[str] = None

    @property
    def n_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def n_classes(self) -> int:
        return len(self.class_lat_median)

    def reorder(self):
        """Community-reorder the whole problem: Â → PÂPᵀ, X/labels/coords
        row-permuted, index sets and mention structure relabeled.

        The reference's node order (train/dev/test concatenation,
        ``data.py :: DataLoader.get_graph``) scatters community structure,
        which starves every tile-based operand — the hybrid BSR SpMM, the
        tiled attention pattern, and the factorized incidence all need edge
        mass concentrated in diagonal 128×128 blocks (PERF.md). A pure
        relabeling: predictions/metrics stay consistent because labels,
        coords and index sets are permuted together. Returns
        ``(reordered_dataset, Reordering)``.
        """
        from graphconvgeo_torch.sparse.reorder import best_reordering

        groups = None
        if self.groups_offsets is not None and len(self.groups_offsets) > 1:
            off, mem = self.groups_offsets, self.groups_members
            groups = {g: mem[off[g] : off[g + 1]] for g in range(len(off) - 1)}
        ro = best_reordering(self.adj, groups=groups)
        remap_ids = lambda a: None if a is None else ro.to_new(a).astype(a.dtype)
        ds = dataclasses.replace(
            self,
            x=self.x[ro.perm].tocsr(),
            adj=ro.permute_graph(self.adj),
            y=self.y[ro.perm],
            train_idx=remap_ids(self.train_idx),
            dev_idx=remap_ids(self.dev_idx),
            test_idx=remap_ids(self.test_idx),
            lat=self.lat[ro.perm],
            lon=self.lon[ro.perm],
            groups_members=remap_ids(self.groups_members),
            direct_src=remap_ids(self.direct_src),
            direct_dst=remap_ids(self.direct_dst),
            reorder_method=ro.method,
        )
        return ds, ro

    def factorized_adjacency(self):
        """Â as a :class:`~graphconvgeo_torch.sparse.factorized.FactorizedAdjacency`
        (cost ∝ #mentions, not #projected edges), from the mention structure
        (present for pipeline-preprocessed datasets; None for hand-built
        ones)."""
        from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency

        if self.groups_offsets is None or len(self.groups_offsets) == 0:
            raise ValueError("dataset lacks the mention structure; re-preprocess")
        off, mem = self.groups_offsets, self.groups_members
        groups = {g: mem[off[g] : off[g + 1]] for g in range(len(off) - 1)}
        return FactorizedAdjacency.from_groups(
            groups, self.n_nodes, direct=(self.direct_src, self.direct_dst)
        )


def preprocess_raw(raw: RawDataset, cfg: PreprocessConfig) -> Dataset:
    users = raw.all_users
    texts = raw.all_text
    (tr0, tr1), (dv0, dv1), (te0, te1) = raw.splits_ranges

    groups, direct_src, direct_dst = mention_structure(
        list(users), list(texts), celebrity_threshold=cfg.celebrity_threshold
    )
    adj_raw = materialize_projection(
        groups, len(users), direct=(direct_src, direct_dst)
    )
    adj = normalize_adjacency(adj_raw)
    member_lists = [np.asarray(sorted(m), dtype=np.int64) for m in groups.values()]
    groups_offsets = np.zeros(len(member_lists) + 1, dtype=np.int64)
    np.cumsum([len(m) for m in member_lists], out=groups_offsets[1:])
    groups_members = (
        np.concatenate(member_lists) if member_lists else np.zeros(0, np.int64)
    )

    x, _ = build_features(
        raw.train.text,
        raw.dev.text,
        raw.test.text,
        TfidfConfig(min_df=cfg.min_df, max_df=cfg.max_df),
    )

    disc = KDTreeDiscretizer(bucket_size=cfg.bucket_size).fit(raw.train.lat, raw.train.lon)
    lat = np.concatenate([raw.train.lat, raw.dev.lat, raw.test.lat])
    lon = np.concatenate([raw.train.lon, raw.dev.lon, raw.test.lon])
    y = np.empty(len(users), dtype=np.int32)
    y[tr0:tr1] = disc.class_of_train
    y[dv0:dv1] = disc.assign(raw.dev.lat, raw.dev.lon)
    y[te0:te1] = disc.assign(raw.test.lat, raw.test.lon)

    return Dataset(
        x=x,
        adj=adj,
        y=y,
        train_idx=np.arange(tr0, tr1),
        dev_idx=np.arange(dv0, dv1),
        test_idx=np.arange(te0, te1),
        lat=lat,
        lon=lon,
        class_lat_median=disc.class_lat_median,
        class_lon_median=disc.class_lon_median,
        groups_offsets=groups_offsets,
        groups_members=groups_members,
        direct_src=direct_src,
        direct_dst=direct_dst,
    )


def _save_dataset(path: str, ds: Dataset) -> None:
    z64 = np.zeros(0, np.int64)
    np.savez_compressed(
        path,
        groups_offsets=z64 if ds.groups_offsets is None else ds.groups_offsets,
        groups_members=z64 if ds.groups_members is None else ds.groups_members,
        direct_src=z64 if ds.direct_src is None else ds.direct_src,
        direct_dst=z64 if ds.direct_dst is None else ds.direct_dst,
        x_data=ds.x.data,
        x_indices=ds.x.indices,
        x_indptr=ds.x.indptr,
        x_shape=np.asarray(ds.x.shape),
        a_data=ds.adj.data,
        a_indices=ds.adj.indices,
        a_indptr=ds.adj.indptr,
        a_shape=np.asarray(ds.adj.shape),
        y=ds.y,
        train_idx=ds.train_idx,
        dev_idx=ds.dev_idx,
        test_idx=ds.test_idx,
        lat=ds.lat,
        lon=ds.lon,
        class_lat_median=ds.class_lat_median,
        class_lon_median=ds.class_lon_median,
    )


def _load_dataset(path: str) -> Dataset:
    z = np.load(path)
    x = sp.csr_matrix((z["x_data"], z["x_indices"], z["x_indptr"]), shape=tuple(z["x_shape"]))
    a = sp.csr_matrix((z["a_data"], z["a_indices"], z["a_indptr"]), shape=tuple(z["a_shape"]))
    return Dataset(
        x=x,
        adj=a,
        y=z["y"],
        train_idx=z["train_idx"],
        dev_idx=z["dev_idx"],
        test_idx=z["test_idx"],
        lat=z["lat"],
        lon=z["lon"],
        class_lat_median=z["class_lat_median"],
        class_lon_median=z["class_lon_median"],
        groups_offsets=z["groups_offsets"] if "groups_offsets" in z else None,
        groups_members=z["groups_members"] if "groups_members" in z else None,
        direct_src=z["direct_src"] if "direct_src" in z else None,
        direct_dst=z["direct_dst"] if "direct_dst" in z else None,
    )


def preprocess(
    data_home: str,
    cfg: PreprocessConfig = PreprocessConfig(),
    *,
    cache_dir: Optional[str] = None,
    use_cache: bool = True,
) -> Dataset:
    """Load dumps → graph → features → labels, with artifact caching."""
    cache_path = None
    if use_cache:
        cache_dir = cache_dir or os.path.join(data_home, ".gcg_torch_cache")
        cache_path = os.path.join(cache_dir, f"preprocessed_{cfg.cache_key(data_home)}.npz")
        if os.path.exists(cache_path):
            return _load_dataset(cache_path)
    raw = load_dumps(data_home, encoding=cfg.encoding)
    ds = preprocess_raw(raw, cfg)
    if cache_path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        _save_dataset(cache_path, ds)
    return ds
