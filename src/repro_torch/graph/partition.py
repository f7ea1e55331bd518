"""Sharding functions d(v) (paper §3.1 'system model', §6 'Q4').

The paper treats the sharding function as an *input* and stacks replication
on top of three families (Fig 7): hash, min-cut graph partitioning (Metis),
and workload-aware hypergraph partitioning (hmetis).  Metis/hmetis binaries
are unavailable offline, so we implement in-role substitutes:

* ``hash_partition``       — the common in-memory-graph-DB default.
* ``ldg_partition``        — Linear Deterministic Greedy streaming min-cut
                             [Stanton & Kliot, KDD'12]; data-aware.
* ``hypergraph_partition`` — place co-accessed objects together using a
                             sampled workload trace (hyperedges), refined
                             with label propagation; workload-aware.

All return an int32 server assignment [n_nodes] and respect a capacity
slack factor, matching how the paper balances partitions.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def hash_partition(n_nodes: int, n_servers: int, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-random hash sharding (splittable mix)."""
    v = np.arange(n_nodes, dtype=np.uint64)
    z = v + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(1)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(n_servers)).astype(np.int32)


def ldg_partition(
    graph: CSRGraph,
    n_servers: int,
    slack: float = 1.05,
    seed: int = 0,
    passes: int = 2,
) -> np.ndarray:
    """Linear Deterministic Greedy streaming partitioning (min-cut role).

    Each vertex goes to the partition maximizing
    |N(v) ∩ P_s| * (1 - |P_s| / C) with capacity C = slack * n / k.
    A second pass re-streams with the previous assignment as neighbor
    evidence, which substantially improves cut (~Metis-trend quality).
    """
    n = graph.n_nodes
    cap = slack * n / n_servers
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    part = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(n_servers, dtype=np.int64)

    for pass_i in range(passes):
        for v in order:
            nbrs = graph.neighbors(v)
            scores = np.zeros(n_servers, dtype=np.float64)
            if len(nbrs):
                assigned = part[nbrs]
                assigned = assigned[assigned >= 0]
                if len(assigned):
                    scores += np.bincount(assigned, minlength=n_servers)
            penalty = 1.0 - sizes / cap
            scores = scores * np.maximum(penalty, 0.0)
            if pass_i == 0 and part[v] == -1 and not scores.any():
                s = int(np.argmin(sizes))
            else:
                s = int(np.argmax(scores + 1e-9 * penalty))
            if part[v] >= 0:
                sizes[part[v]] -= 1
            part[v] = s
            sizes[s] += 1
    return part


def hypergraph_partition(
    traces: list[np.ndarray],
    n_nodes: int,
    n_servers: int,
    slack: float = 1.05,
    seed: int = 0,
    iters: int = 8,
) -> np.ndarray:
    """Workload-aware placement from co-access hyperedges (hmetis role).

    ``traces`` is a list of object-id arrays — the objects touched by each
    sampled query (the hyperedges of [11, 32]).  Vertices are first seeded
    by hashing, then label propagation moves each vertex to the server where
    most of its co-accessed partners live, subject to capacity.
    Vertices never observed in the trace keep their hash placement — this
    is exactly the incompleteness the paper points out for workload-aware
    schemes (§6.2 Q4).
    """
    part = hash_partition(n_nodes, n_servers, seed)
    cap = int(slack * n_nodes / n_servers) + 1

    # bipartite incidence: object -> hyperedge ids
    obj_edges: dict[int, list[int]] = {}
    for e, tr in enumerate(traces):
        for v in np.unique(tr):
            obj_edges.setdefault(int(v), []).append(e)

    edge_members = [np.unique(tr).astype(np.int64) for tr in traces]
    rng = np.random.default_rng(seed + 1)
    touched = np.fromiter(obj_edges.keys(), dtype=np.int64)
    sizes = np.bincount(part, minlength=n_servers).astype(np.int64)

    for _ in range(iters):
        moved = 0
        for v in rng.permutation(touched):
            votes = np.zeros(n_servers, dtype=np.float64)
            for e in obj_edges[int(v)]:
                members = edge_members[e]
                ps = part[members[members != v]]
                if len(ps):
                    votes += np.bincount(ps, minlength=n_servers) / len(ps)
            s_new = int(np.argmax(votes))
            s_old = int(part[v])
            if votes[s_new] > votes[s_old] and sizes[s_new] < cap:
                part[v] = s_new
                sizes[s_new] += 1
                sizes[s_old] -= 1
                moved += 1
        if moved == 0:
            break
    return part


def make_sharding(
    kind: str,
    graph: CSRGraph,
    n_servers: int,
    traces: list[np.ndarray] | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Uniform entry point used by benchmarks (paper Q4 schemes)."""
    if kind == "hash":
        return hash_partition(graph.n_nodes, n_servers, seed)
    if kind in ("mincut", "metis", "ldg"):
        return ldg_partition(graph, n_servers, seed=seed)
    if kind in ("hypergraph", "hmetis"):
        assert traces is not None, "hypergraph sharding needs a workload trace"
        return hypergraph_partition(traces, graph.n_nodes, n_servers, seed=seed)
    raise ValueError(f"unknown sharding kind: {kind}")
