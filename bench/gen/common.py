"""Shared pieces of the benchmark's data generators: CSR storage, the
graph a generator hands on, and the padded path matrix.

These are frozen copies of the rules the program's own generators follow
(the CSR construction and the padded ``PathSet`` layout), kept here so
that the yardstick does not move when the program changes.  Everything is
numpy on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PAD = -1


@dataclasses.dataclass(frozen=True)
class CSR:
    """Out-adjacency: ``indptr`` int64 [n + 1], ``indices`` int32 [m]."""

    indptr: np.ndarray
    indices: np.ndarray

    @property
    def n_nodes(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def n_entries(self) -> int:
        return int(self.indices.shape[0])

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]


def csr_from_edges(n_nodes: int, src, dst) -> CSR:
    """Rows sorted by (src, dst), parallel edges dropped."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    keep = np.ones(len(src), bool)
    if len(src):
        keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    src, dst = src[keep], dst[keep]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    return CSR(np.cumsum(indptr), dst.astype(np.int32))


def csr_from_groups(n_groups: int, group: np.ndarray, members: np.ndarray) -> CSR:
    """The members of each group, in the order given: ``members[i]``
    belongs to ``group[i]``."""
    order = np.argsort(group, kind="stable")
    indptr = np.zeros(n_groups + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(group, minlength=n_groups))
    return CSR(indptr, np.asarray(members)[order].astype(np.int32))


@dataclasses.dataclass(frozen=True)
class Graph:
    """What a graph generator hands on: the object count, each object's
    stored edge count (its adjacency list, for the storage function), the
    structure its traffic walks (``data``) and facts for the log."""

    n_nodes: int
    degree: np.ndarray
    data: object
    facts: dict


@dataclasses.dataclass(frozen=True)
class Paths:
    """A workload's causal access paths: ``objects`` int32 [P, L] (-1
    pad), ``lengths`` int32 [P], ``query_ids`` int32 [P] and ``groups``
    int32 [P], the sequence of queries each path's query arrives in (a
    query is its own sequence where ``groups`` is None)."""

    objects: np.ndarray
    lengths: np.ndarray
    query_ids: np.ndarray
    groups: np.ndarray | None = None

    @property
    def n_paths(self) -> int:
        return int(self.objects.shape[0])


def paths_from_lists(paths: list, query_ids: list, groups: list | None = None) -> Paths:
    n = len(paths)
    lengths = np.fromiter((len(p) for p in paths), np.int32, n)
    L = max(int(lengths.max()) if n else 1, 1)
    objects = np.full((n, L), PAD, np.int32)
    for i, p in enumerate(paths):
        objects[i, : len(p)] = p
    return Paths(objects, lengths, np.asarray(query_ids, np.int32),
                 None if groups is None else np.asarray(groups, np.int32))


def shuffle_queries(paths: Paths, seed) -> Paths:
    """The same paths with their sequences in an order drawn from
    ``seed``: each sequence's queries, and each query's paths, stay
    together in their own order, and the query ids are renumbered in the
    new order."""
    key = paths.query_ids if paths.groups is None else paths.groups
    n_g = int(key.max()) + 1 if paths.n_paths else 0
    perm = np.random.default_rng(seed).permutation(n_g)
    rank = np.empty(n_g, np.int64)
    rank[perm] = np.arange(n_g)
    order = np.argsort(rank[key], kind="stable")
    q = paths.query_ids[order]
    new_q = np.zeros(len(q), np.int32)
    if len(q):
        new_q[1:] = np.cumsum(q[1:] != q[:-1])
    return Paths(paths.objects[order], paths.lengths[order], new_q,
                 None if paths.groups is None else paths.groups[order])
