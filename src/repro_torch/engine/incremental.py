"""Object->path inverted index (host-side CSR).

Under every shipped routing policy h(p, r, rho) depends only on rho
restricted to the objects *on p*, so the exact set of paths whose latency
a scheme delta can change is the union of an object->path index's rows
over the changed objects.  The greedy's revalidation rounds and the prune
sweep's per-candidate re-walks read this index.
"""
from __future__ import annotations

import numpy as np


class PathIndex:
    """CSR object->path inverted index of a padded path matrix.

    ``rows[starts[v] : starts[v + 1]]`` are the path rows containing
    object ``v`` (with multiplicity when a path visits ``v`` twice).
    Built once per PathSet in O(nnz log nnz); both the prune sweep's
    per-candidate ``affected`` lookups and the cache's dirty-set unions
    read it.
    """

    def __init__(self, objects: np.ndarray, n_objects: int):
        objects = np.asarray(objects)
        self.n_objects = int(n_objects)
        self.n_paths = int(objects.shape[0])
        valid = objects >= 0
        flat_v = objects[valid].astype(np.int64)
        flat_p = np.repeat(
            np.arange(self.n_paths), objects.shape[1]
        )[valid.ravel()]
        order = np.argsort(flat_v, kind="stable")
        self.rows = flat_p[order].astype(np.int32)
        self.starts = np.searchsorted(
            flat_v[order], np.arange(self.n_objects + 1)
        )

    @classmethod
    def from_pathset(cls, pathset, n_objects: int) -> "PathIndex":
        return cls(np.asarray(pathset.objects), n_objects)

    def paths_of(self, v: int) -> np.ndarray:
        """Unique path rows containing object ``v`` (sorted)."""
        return np.unique(self.rows[self.starts[v] : self.starts[v + 1]])

    def dirty_paths(self, changed_objects) -> np.ndarray:
        """Unique path rows touching ANY changed object (sorted int64).

        The exact dirty set of a scheme delta: a path absent from every
        changed object's row slice reads none of the flipped replica
        bits, so its walk — under any shipped policy — is unchanged.
        Object ids outside ``[0, n_objects)`` are ignored (the engines'
        negative-pair masking).
        """
        v = np.unique(np.asarray(changed_objects, np.int64).ravel())
        v = v[(v >= 0) & (v < self.n_objects)]
        if v.size == 0:
            return np.zeros(0, np.int64)
        cnt = self.starts[v + 1] - self.starts[v]
        total = int(cnt.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        # multi-slice gather: absolute position of each slice element
        base = np.repeat(
            self.starts[v] - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt
        )
        return np.unique(self.rows[base + np.arange(total)]).astype(np.int64)
