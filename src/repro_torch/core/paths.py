"""Causal access paths (paper §3.1, Def 4.1).

A *causal access path* is a sequence of object ids whose accesses are
causally ordered (each access happens-before the next).  A *query* is a set
of root-to-leaf paths; its latency is the max latency over its paths
(Def 4.3).  We store a whole workload's paths as one padded int32 matrix so
that latency evaluation and the greedy replication algorithm are plain
vectorized array programs.

Layout
------
``objects``   int32 [n_paths, max_len]   object ids, ``-1`` padding
``lengths``   int32 [n_paths]            number of valid entries per row
``query_ids`` int32 [n_paths]            owning query (for per-query latency)

All builders are host-side (numpy); the arrays are then used from torch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

PAD = -1


@dataclasses.dataclass(frozen=True)
class PathSet:
    """A padded batch of causal access paths."""

    objects: np.ndarray   # int32 [P, L]
    lengths: np.ndarray   # int32 [P]
    query_ids: np.ndarray  # int32 [P]

    def __post_init__(self):
        assert self.objects.ndim == 2
        assert self.lengths.shape == (self.objects.shape[0],)
        assert self.query_ids.shape == (self.objects.shape[0],)

    @property
    def n_paths(self) -> int:
        return int(self.objects.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.objects.shape[1])

    @property
    def n_queries(self) -> int:
        return int(self.query_ids.max()) + 1 if self.n_paths else 0

    def __len__(self) -> int:
        return self.n_paths

    def path(self, i: int) -> list[int]:
        return self.objects[i, : self.lengths[i]].tolist()

    def select(self, idx: np.ndarray) -> "PathSet":
        return PathSet(self.objects[idx], self.lengths[idx], self.query_ids[idx])

    def select_queries(self, lo: int, hi: int) -> "PathSet":
        """Paths of queries with id in [lo, hi), query ids rebased to 0.

        The serving layer uses this to feed a workload to the simulator /
        controller in arrival-order batches.
        """
        keep = (self.query_ids >= lo) & (self.query_ids < hi)
        idx = np.nonzero(keep)[0]
        return PathSet(
            self.objects[idx],
            self.lengths[idx],
            (self.query_ids[idx] - lo).astype(np.int32),
        )

    def max_objects_touched(self) -> int:
        return int(self.objects.max()) + 1

    @staticmethod
    def from_lists(
        paths: Sequence[Sequence[int]],
        query_ids: Sequence[int] | None = None,
        max_len: int | None = None,
    ) -> "PathSet":
        """Build a PathSet from python lists of object-id sequences."""
        n = len(paths)
        lengths = np.asarray([len(p) for p in paths], dtype=np.int32)
        L = int(max_len if max_len is not None else (lengths.max() if n else 1))
        L = max(L, 1)
        objects = np.full((n, L), PAD, dtype=np.int32)
        for i, p in enumerate(paths):
            objects[i, : len(p)] = np.asarray(p, dtype=np.int32)
        if query_ids is None:
            qids = np.arange(n, dtype=np.int32)
        else:
            qids = np.asarray(query_ids, dtype=np.int32)
        return PathSet(objects, lengths, qids)

    @staticmethod
    def concatenate(sets: Iterable["PathSet"]) -> "PathSet":
        sets = list(sets)
        L = max(s.max_len for s in sets)
        objs, lens, qids = [], [], []
        qoff = 0
        for s in sets:
            o = np.full((s.n_paths, L), PAD, dtype=np.int32)
            o[:, : s.max_len] = s.objects
            objs.append(o)
            lens.append(s.lengths)
            qids.append(s.query_ids + qoff)
            qoff += s.n_queries
        return PathSet(
            np.concatenate(objs, 0),
            np.concatenate(lens, 0),
            np.concatenate(qids, 0),
        )

    # ------------------------------------------------------------------
    # §5.3 pruning: "If two paths have root accesses occurring at the same
    # server and are identical except from their root, then any replication
    # scheme that is feasible for one path is feasible also for the other".
    # ------------------------------------------------------------------
    def prune_redundant(
        self,
        shard: np.ndarray,
        extra_key: np.ndarray | None = None,
        return_index: bool = False,
    ):
        """Drop paths equivalent under the paper's §5.3 pruning rule.

        ``shard`` is the sharding function d as an int array [n_objects].
        Two paths are redundant iff the server of the root matches and the
        tails (``objects[1:]``) are identical.  NOTE: pruning is sound for
        *feasibility*; we keep query_ids of survivors for latency reporting.

        ``extra_key`` (int [n_paths]) joins the dedup key: paths that only
        differ in it are NOT merged.  The vector-t greedy passes each
        path's latency budget here — merging a tight-budget path into a
        loose-budget duplicate would silently drop the tighter constraint.
        A constant ``extra_key`` (the scalar-t case) prunes identically to
        no key at all.  ``return_index=True`` additionally returns the
        surviving row indices (for slicing per-path side arrays).
        """
        if self.n_paths == 0:
            idx0 = np.zeros(0, np.int64)
            return (self, idx0) if return_index else self
        root_srv = shard[np.maximum(self.objects[:, 0], 0)].astype(np.int64)
        # Build a dedup key: root server + tail bytes.
        tails = self.objects[:, 1:].copy()
        cols = [root_srv[:, None], self.lengths[:, None].astype(np.int64), tails]
        if extra_key is not None:
            cols.append(np.asarray(extra_key, np.int64)[:, None])
        key = np.concatenate(cols, axis=1)
        _, first_idx = np.unique(key, axis=0, return_index=True)
        first_idx = np.sort(first_idx)
        pruned = self.select(first_idx)
        return (pruned, first_idx) if return_index else pruned

    def pad_to(self, n_paths: int | None = None, max_len: int | None = None) -> "PathSet":
        """Pad path count / length (padding paths have length 0)."""
        P = n_paths if n_paths is not None else self.n_paths
        L = max_len if max_len is not None else self.max_len
        objects = np.full((P, L), PAD, dtype=np.int32)
        objects[: self.n_paths, : self.max_len] = self.objects
        lengths = np.zeros((P,), dtype=np.int32)
        lengths[: self.n_paths] = self.lengths
        qids = np.zeros((P,), dtype=np.int32)
        qids[: self.n_paths] = self.query_ids
        return PathSet(objects, lengths, qids)


def paths_from_tree(root: int, adjacency: dict[int, list[int]], max_depth: int) -> list[list[int]]:
    """Enumerate root-to-leaf paths of a (small) access tree — test helper."""
    out: list[list[int]] = []

    def rec(node: int, prefix: list[int], depth: int):
        children = adjacency.get(node, []) if depth < max_depth else []
        if not children:
            out.append(prefix + [node])
            return
        for c in children:
            rec(c, prefix + [node], depth + 1)

    rec(root, [], 0)
    return out
