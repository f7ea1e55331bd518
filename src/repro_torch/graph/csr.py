"""CSR graph storage (numpy, host-side).

The dataset objects of the paper (§3.1) are "a vertex and its adjacency
list"; this module is the storage substrate those objects live in.  The
same CSR arrays feed the partitioners, the workload analyzers, the
distributed executor and the GNN models (via edge-index views), so there is
exactly one definition of the data graph in the framework.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed-sparse-row adjacency with optional typed edges.

    Attributes:
      indptr:     int64 [n+1]
      indices:    int32 [m]      out-neighbors, sorted per row
      edge_types: int16 [m] | None   label of each edge (SNB-like graphs)
      node_types: int16 [n] | None   label of each vertex
    """

    indptr: np.ndarray
    indices: np.ndarray
    edge_types: np.ndarray | None = None
    node_types: np.ndarray | None = None

    @property
    def n_nodes(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def degree(self, v: int | np.ndarray | None = None) -> np.ndarray:
        deg = np.diff(self.indptr)
        return deg if v is None else deg[v]

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def neighbors_typed(self, v: int, etype: int) -> np.ndarray:
        lo, hi = self.indptr[v], self.indptr[v + 1]
        nbr = self.indices[lo:hi]
        if self.edge_types is None:
            return nbr
        return nbr[self.edge_types[lo:hi] == etype]

    def edge_list(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) int arrays — the edge-index view used by GNN models."""
        src = np.repeat(
            np.arange(self.n_nodes, dtype=np.int32), np.diff(self.indptr)
        )
        return src, self.indices.astype(np.int32)

    def object_sizes(self, unit: float = 1.0, per_edge: float = 0.1) -> np.ndarray:
        """Paper's storage function f(v): vertex record + adjacency list."""
        return (unit + per_edge * np.diff(self.indptr)).astype(np.float64)

    @staticmethod
    def from_edges(
        n_nodes: int,
        src: np.ndarray,
        dst: np.ndarray,
        edge_types: np.ndarray | None = None,
        node_types: np.ndarray | None = None,
        symmetrize: bool = False,
    ) -> "CSRGraph":
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            if edge_types is not None:
                edge_types = np.concatenate([edge_types, edge_types])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        if edge_types is not None:
            edge_types = np.asarray(edge_types)[order]
        # dedup parallel edges
        keep = np.ones(len(src), dtype=bool)
        if len(src):
            keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        src, dst = src[keep], dst[keep]
        if edge_types is not None:
            edge_types = edge_types[keep].astype(np.int16)
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRGraph(
            indptr=indptr,
            indices=dst.astype(np.int32),
            edge_types=edge_types,
            node_types=(
                None if node_types is None else np.asarray(node_types, np.int16)
            ),
        )

    def subgraph_stats(self, part: np.ndarray) -> dict:
        """Edge-cut statistics for a partition assignment (used by tests)."""
        src, dst = self.edge_list()
        cut = part[src] != part[dst]
        return {
            "edge_cut": int(cut.sum()),
            "cut_fraction": float(cut.mean()) if len(src) else 0.0,
            "part_sizes": np.bincount(part).tolist(),
        }
