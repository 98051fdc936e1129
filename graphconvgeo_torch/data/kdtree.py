"""k-d-tree label discretization (reference: ``kdtree.py`` +
``data.py :: DataLoader.assignClasses``).

Median-split 2-d tree over the *training* (lat, lon) pairs, alternating the
split axis, stopping when a node holds ≤ ``bucket_size`` points. Each leaf is
one class; the per-class *median* latitude/longitude is recorded and used as
the predicted coordinate at evaluation time (load-bearing for the Acc@161 /
error-km metrics — SURVEY.md §3.3).

Dev/test users keep their true coordinates and are only assigned classes for
(optional) masked losses; evaluation always uses true coords vs class median.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class KDTreeDiscretizer:
    bucket_size: int
    # filled by fit():
    class_of_train: np.ndarray | None = None
    class_lat_median: np.ndarray | None = None
    class_lon_median: np.ndarray | None = None
    _split_axis: list | None = None
    _split_val: list | None = None
    _split_strict: list | None = None  # True → left child is `< val`, not `<= val`
    _children: list | None = None
    _leaf_class: list | None = None

    @property
    def n_classes(self) -> int:
        return len(self.class_lat_median)

    def fit(self, lat: np.ndarray, lon: np.ndarray) -> "KDTreeDiscretizer":
        coords = np.stack([np.asarray(lat, np.float64), np.asarray(lon, np.float64)], axis=1)
        n = coords.shape[0]
        self._split_axis, self._split_val, self._children, self._leaf_class = [], [], [], []
        self._split_strict = []
        leaves: list[np.ndarray] = []

        def build(idx: np.ndarray, axis: int) -> int:
            node = len(self._split_axis)
            self._split_axis.append(axis)
            self._split_val.append(0.0)
            self._split_strict.append(False)
            self._children.append((-1, -1))
            self._leaf_class.append(-1)
            if len(idx) <= self.bucket_size or len(np.unique(coords[idx, axis])) == 1:
                # try the other axis before giving up on splitting ties
                if len(idx) > self.bucket_size and len(np.unique(coords[idx, 1 - axis])) > 1:
                    axis = 1 - axis
                    self._split_axis[node] = axis
                else:
                    self._leaf_class[node] = len(leaves)
                    leaves.append(idx)
                    return node
            vals = coords[idx, axis]
            med = np.median(vals)
            left_mask = vals <= med
            # guard: median equal to max ⇒ move strict (recorded so assign()
            # routes boundary-valued points to the same side fit() did)
            if left_mask.all():
                left_mask = vals < med
                self._split_strict[node] = True
            if left_mask.all() or not left_mask.any():
                self._leaf_class[node] = len(leaves)
                leaves.append(idx)
                return node
            self._split_val[node] = float(med)
            l = build(idx[left_mask], 1 - axis)
            r = build(idx[~left_mask], 1 - axis)
            self._children[node] = (l, r)
            return node

        import sys

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 10000 + 2 * int(np.log2(max(n, 2)) * 64)))
        try:
            build(np.arange(n), axis=0)
        finally:
            sys.setrecursionlimit(old_limit)

        n_classes = len(leaves)
        self.class_of_train = np.empty(n, dtype=np.int32)
        self.class_lat_median = np.empty(n_classes, dtype=np.float64)
        self.class_lon_median = np.empty(n_classes, dtype=np.float64)
        for c, idx in enumerate(leaves):
            self.class_of_train[idx] = c
            self.class_lat_median[c] = np.median(coords[idx, 0])
            self.class_lon_median[c] = np.median(coords[idx, 1])
        return self

    def assign(self, lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
        """Route arbitrary coordinates down the fitted tree to a class id.

        Level-synchronous and fully vectorized: every point carries its
        current node id and all non-leaf points advance one level per
        iteration (≤ tree depth iterations total — a per-point Python walk
        measured minutes at Twitter-World's 1.4M nodes)."""
        coords = np.stack([np.asarray(lat, np.float64), np.asarray(lon, np.float64)], axis=1)
        axis = np.asarray(self._split_axis, dtype=np.int64)
        val = np.asarray(self._split_val, dtype=np.float64)
        strict = np.asarray(self._split_strict, dtype=bool)
        leaf = np.asarray(self._leaf_class, dtype=np.int64)
        children = np.asarray(self._children, dtype=np.int64)  # [nodes, 2]
        node = np.zeros(coords.shape[0], dtype=np.int64)
        idx = np.flatnonzero(leaf[node] < 0)
        while idx.size:
            nd = node[idx]
            vals = coords[idx, axis[nd]]
            go_left = np.where(strict[nd], vals < val[nd], vals <= val[nd])
            node[idx] = np.where(go_left, children[nd, 0], children[nd, 1])
            idx = idx[leaf[node[idx]] < 0]
        return leaf[node].astype(np.int32)
