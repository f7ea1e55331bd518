"""Node-wise neighborhood sampling (paper §6.1 GNN workload; GraphSAGE [16]).

Samples L-hop neighborhoods with per-hop fan-outs (the paper uses 25-10-10
and notes queries need <= 2 distributed hops because the 3rd hop reads the
2nd hop's adjacency list).  Two front-ends:

* ``sample_neighborhood``      — host-side numpy sampler used by the
  workload analyzer and the distributed executor simulation;
* ``minibatch_sampler``        — batched sampler producing padded device
  arrays (seeds, per-hop neighbor blocks) feeding GNN training, i.e. the
  real neighbor sampler required by the ``minibatch_lg`` shape.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph


def sample_neighborhood(
    graph: CSRGraph,
    seed_node: int,
    fanouts: tuple[int, ...],
    rng: np.random.Generator,
) -> list[np.ndarray]:
    """One node-wise sample: returns the frontier per hop (hop 0 = seed)."""
    frontiers = [np.asarray([seed_node], dtype=np.int64)]
    for f in fanouts:
        nxt = []
        for v in frontiers[-1]:
            nbr = graph.neighbors(int(v))
            if len(nbr) == 0:
                continue
            take = min(f, len(nbr))
            nxt.append(rng.choice(nbr, size=take, replace=False))
        frontiers.append(
            np.unique(np.concatenate(nxt)) if nxt else np.zeros(0, np.int64)
        )
    return frontiers


@dataclasses.dataclass(frozen=True)
class MiniBatch:
    """Padded sampled sub-neighborhood for GNN training.

    seeds:       int32 [B]
    layer_nodes: list over hops of int32 [B, prod(fanouts[:h])] node ids
                 (-1 padding where a vertex had fewer neighbors)
    """

    seeds: np.ndarray
    layer_nodes: list[np.ndarray]

    def all_nodes(self) -> np.ndarray:
        parts = [self.seeds] + [l.reshape(-1) for l in self.layer_nodes]
        cat = np.concatenate(parts)
        return np.unique(cat[cat >= 0])


def minibatch_sampler(
    graph: CSRGraph,
    batch_nodes: np.ndarray,
    fanouts: tuple[int, ...],
    seed: int = 0,
) -> MiniBatch:
    """Fixed-shape fan-out sampling for a batch of seed nodes.

    Per-hop the frontier multiplies by the fan-out; missing neighbors pad
    with -1 so downstream segment-sum models can mask them.  Sampling uses
    independent per-(node, slot) draws — with replacement when the degree
    is below the fan-out, mirroring DistDGL's padded sampling.
    """
    rng = np.random.default_rng(seed)
    B = len(batch_nodes)
    frontier = np.asarray(batch_nodes, dtype=np.int64)
    layers: list[np.ndarray] = []
    width = 1
    for f in fanouts:
        width *= f
        flat = frontier.reshape(-1)
        deg = np.where(flat >= 0, graph.degree(np.maximum(flat, 0)), 0)
        draw = rng.integers(0, 2**31, size=(len(flat), f))
        take = np.where(deg[:, None] > 0, draw % np.maximum(deg[:, None], 1), -1)
        base = np.where(flat >= 0, graph.indptr[np.maximum(flat, 0)], 0)
        idx = base[:, None] + np.maximum(take, 0)
        nbrs = np.where(take >= 0, graph.indices[idx], -1)
        layer = nbrs.reshape(B, width).astype(np.int32)
        layers.append(layer)
        frontier = layer.astype(np.int64)
    return MiniBatch(seeds=np.asarray(batch_nodes, np.int32), layer_nodes=layers)


def distributed_hops(
    frontiers: list[np.ndarray], shard: np.ndarray
) -> int:
    """#distributed traversals on the critical path of one sampling query.

    The access tree is seed -> hop1 nodes -> hop2 nodes; a root-to-leaf
    path hops servers when the next frontier vertex's owner differs from
    where the current access runs (no replicas).  Worst case over leaves =
    query latency (Def 4.3) under d.
    """
    if len(frontiers) <= 1:
        return 0
    worst = 0
    # paths are seed -> v1 -> v2 ...; evaluate greedily per leaf chain.
    # For fan-out trees the worst path is bounded by hops where *some*
    # frontier vertex lives remotely from *its parent's* server.
    # Exact per-leaf evaluation:
    def rec(server: int, hop: int, node: int, acc: int):
        nonlocal worst
        if hop + 1 >= len(frontiers):
            worst = max(worst, acc)
            return
        for nxt in frontiers[hop + 1]:
            s = int(shard[nxt])
            cost = acc + (1 if s != server else 0)
            rec(s if s != server else server, hop + 1, int(nxt), cost)

    seed = int(frontiers[0][0])
    rec(int(shard[seed]), 0, seed, 0)
    return worst
