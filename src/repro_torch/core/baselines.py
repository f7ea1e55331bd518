"""Baseline replication schemes from the paper's evaluation (§2, §6.2).

Two baselines:

* **Single-site oracle** (Fig 2d): replays the workload with perfect
  knowledge and, for each query, replicates exactly the objects it accesses
  to the server its root is routed to, so every query executes locally
  (t = 0 with minimal oracle replication).  Equivalent to running our
  greedy algorithm with t = 0 but stated independently as the paper does.

* **Dangling-edge replication** (Table 3 / Fig 7d): structure-only scheme
  used by Wukong [34] and DistDGL [42] — replicate the immediate remote
  neighbors of every vertex (k = 0), optionally including the neighbor's
  adjacency list (k = 1), which enforces t = floor(n/2) for n-hop queries.
  It is workload-UNaware: it replicates along every cut edge whether or
  not any query traverses it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.paths import PathSet
from repro_torch.core.replication import ReplicationScheme
from repro_torch.engine import LatencyEngine


def evaluate_baseline(
    pathset: PathSet,
    scheme: ReplicationScheme,
    f: np.ndarray | None = None,
    backend: str | None = None,
    device=None,
) -> dict:
    """Engine-backed evaluation of a baseline scheme (Fig 2/Table 3 rows).

    One packed upload on ``device`` (default ``"cuda"``; ``backend``
    defaults from the device); returns the per-query latency distribution
    plus the storage metrics the paper reports for every baseline.
    """
    eng = LatencyEngine(scheme, backend=backend, device=device)
    pl = eng.path_latencies(pathset)
    lq = eng.query_latencies(pathset, pl)
    return {
        "path_latencies": pl,
        "query_latencies": lq,
        "max_latency": int(lq.max(initial=0)),
        "mean_latency": float(lq.mean()) if len(lq) else 0.0,
        "replicas": scheme.replica_count(),
        "overhead": scheme.replication_overhead(f),
    }


def single_site_oracle(
    pathset: PathSet, shard: np.ndarray, n_servers: int
) -> ReplicationScheme:
    """Perfect-knowledge single-site replication (paper Fig 2d).

    Each query is routed to the home server of the root of its first path;
    every object accessed by any path of the query is replicated there.
    """
    scheme = ReplicationScheme.from_sharding(shard, n_servers)
    if pathset.n_paths == 0:
        return scheme
    # Route each query to the home server of its (first path's) root.
    nq = pathset.n_queries
    route = np.full((nq,), -1, dtype=np.int64)
    roots = shard[np.maximum(pathset.objects[:, 0], 0)]
    # first path of each query wins
    for i in range(pathset.n_paths - 1, -1, -1):
        route[pathset.query_ids[i]] = roots[i]
    # Replicate all accessed objects of the query at the routed server.
    objs = pathset.objects  # [P, L]
    valid = objs >= 0
    srv_per_path = route[pathset.query_ids]  # [P]
    vv = objs[valid]
    ss = np.broadcast_to(srv_per_path[:, None], objs.shape)[valid]
    scheme.mask[vv, ss] = True
    return scheme


def dangling_edge_replication(
    indptr: np.ndarray,
    indices: np.ndarray,
    shard: np.ndarray,
    n_servers: int,
    k: int = 1,
) -> ReplicationScheme:
    """Structure-based halo replication (paper Table 3; [34, 42]).

    k = 0: for every cut edge (u, w) replicate w's *vertex object* at
    d(u) (removes the dangling edge but a further hop from w is remote).
    k = 1: additionally treat the replica as holding w's adjacency list,
    and replicate w's neighbors' vertex objects at d(u) as well, enforcing
    t = floor(n/2) on n-hop traversals (the variant we compare against,
    as the paper does).
    """
    scheme = ReplicationScheme.from_sharding(shard, n_servers)
    n = shard.shape[0]
    src = np.repeat(np.arange(n), np.diff(indptr))
    dst = indices
    cut = shard[src] != shard[dst]
    scheme.mask[dst[cut], shard[src[cut]]] = True
    if k >= 1:
        # neighbors of the replicated vertex also land at d(u)
        cut_dst = dst[cut]
        cut_home = shard[src[cut]]
        counts = (indptr[cut_dst + 1] - indptr[cut_dst]).astype(np.int64)
        rep_home = np.repeat(cut_home, counts)
        gather = np.concatenate(
            [indices[indptr[v] : indptr[v + 1]] for v in cut_dst]
        ) if len(cut_dst) else np.zeros((0,), dtype=indices.dtype)
        if len(gather):
            scheme.mask[gather, rep_home] = True
    return scheme
