"""GNN node-wise neighborhood-sampling workload analyzer (paper §6.1).

"Sampling queries require no more than 2 hops since the vertices in the
3rd-hop can be sampled from the adjacency list of the 2nd-hop vertex."

The causal access tree of one sampling query rooted at seed s with fan-outs
(f1, f2, f3):  s -> v1 (25 of them) -> v2 (10 each); the 3rd hop reads v2's
adjacency list which is part of v2's object.  Root-to-leaf causal access
paths are the chains s -> v1 -> v2.

The analyzer enumerates an overapproximation: for each seed it emits paths
through *all* neighbors up to a cap (replication must cover any random
draw), or through sampled draws when ``exact_draws`` is set (matching one
concrete epoch as the paper's trace-based analyzer does).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.paths import PathSet
from repro_torch.core.slo import TenantSpec
from repro_torch.graph.csr import CSRGraph
from repro_torch.workload.analyzer import batched, materialize

# serving tenant: sampling feeds training throughput, not an interactive
# user — loosest default budget of the three families
TENANT = TenantSpec("gnn", t_q=2)


def gnn_query_paths(
    g: CSRGraph,
    seed_node: int,
    fanouts: tuple[int, ...] = (25, 10),
    rng: np.random.Generator | None = None,
    cap_per_hop: tuple[int, ...] | None = None,
) -> list[list[int]]:
    """Paths of one sampling query (2 causal hops, per the paper)."""
    caps = cap_per_hop or fanouts
    paths: list[list[int]] = []
    nbr1 = g.neighbors(seed_node)
    if rng is not None and len(nbr1) > fanouts[0]:
        nbr1 = rng.choice(nbr1, size=fanouts[0], replace=False)
    else:
        nbr1 = nbr1[: caps[0]]
    if len(nbr1) == 0:
        return [[seed_node]]
    if len(fanouts) == 1:
        return [[seed_node, int(v)] for v in nbr1]
    for v1 in nbr1:
        nbr2 = g.neighbors(int(v1))
        if rng is not None and len(nbr2) > fanouts[1]:
            nbr2 = rng.choice(nbr2, size=fanouts[1], replace=False)
        else:
            nbr2 = nbr2[: caps[1]]
        if len(nbr2) == 0:
            paths.append([seed_node, int(v1)])
        else:
            paths.extend([seed_node, int(v1), int(v2)] for v2 in nbr2)
    return paths


def gnn_workload(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...] = (25, 10),
    seed: int = 0,
    exact_draws: bool = True,
    batch_queries: int = 256,
):
    """Stream PathSet batches for node-wise sampling rooted at ``seeds``."""
    rng = np.random.default_rng(seed) if exact_draws else None

    def paths_fn(root: int) -> list[list[int]]:
        return gnn_query_paths(g, root, fanouts, rng)

    return batched(paths_fn, np.asarray(seeds), batch_queries)


def gnn_workload_materialized(
    g: CSRGraph, seeds: np.ndarray, fanouts=(25, 10), **kw
) -> PathSet:
    return materialize(gnn_workload(g, seeds, fanouts, **kw))
