"""NP-hardness gadget (paper Thm 4.5 / Appendix A.1).

The reduction builds, from a graph G with 2n vertices, an instance LS(G) of
the latency-storage feasible problem such that LS(G) is feasible iff G has
a *min-bridge bisection* with at most K bridge vertices per side.  We
implement the construction so tests can verify the equivalence by brute
force on small 3-regular graphs — executable evidence for the paper's
hardness proof.

Construction (Appendix A.1, step 1):
  * objects: for each vertex v of G, a marker object v_m (cost 1) and a
    regular object v_o (cost 1/(2n));
  * queries:  for each v, paths  v_m -> v_o -> u_o  for every u in N(v)
    (and the bare path v_m -> v_o when N(v) is empty);
  * servers:  s1, s2 hold the markers (half each); s1 holds the regular
    objects whose markers are on s2 and vice versa (so marker and regular
    copies of the same vertex always start on different servers);
  * capacities: M_{s1} = M_{s2} = n + 1/2 (already full),
    M_{s3} = M_{s4} = n + 1/2 + K/(2n);
  * latency bound t = 0 for all queries; epsilon = +inf.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.paths import PathSet
from repro_torch.core.replication import ReplicationScheme
from repro_torch.engine import LatencyEngine


@dataclasses.dataclass(frozen=True)
class LSInstance:
    """A latency-storage feasibility instance produced by the reduction."""

    pathset: PathSet
    shard: np.ndarray          # d
    f: np.ndarray              # storage cost function
    capacity: np.ndarray       # M_s per server
    n_servers: int
    t: int
    # bookkeeping for tests
    marker_of: np.ndarray      # vertex -> marker object id
    regular_of: np.ndarray     # vertex -> regular object id


def build_ls_instance(adjacency: list[list[int]], K: int) -> LSInstance:
    """Build LS(G) for a graph given as adjacency lists over 2n vertices."""
    n2 = len(adjacency)
    assert n2 % 2 == 0, "G must have an even number of vertices"
    n = n2 // 2
    marker_of = np.arange(n2, dtype=np.int32)            # objects 0..2n-1
    regular_of = np.arange(n2, 2 * n2, dtype=np.int32)   # objects 2n..4n-1

    f = np.concatenate(
        [np.ones((n2,), np.float64), np.full((n2,), 1.0 / n2, np.float64)]
    )

    # Sharding: markers of first half -> s0; second half -> s1.
    # Regular objects go to the *opposite* marker server.
    shard = np.zeros((2 * n2,), dtype=np.int32)
    shard[marker_of[:n]] = 0
    shard[marker_of[n:]] = 1
    shard[regular_of[:n]] = 1
    shard[regular_of[n:]] = 0

    paths: list[list[int]] = []
    qids: list[int] = []
    for v in range(n2):
        nbrs = adjacency[v]
        if not nbrs:
            paths.append([int(marker_of[v]), int(regular_of[v])])
            qids.append(v)
        for u in nbrs:
            paths.append(
                [int(marker_of[v]), int(regular_of[v]), int(regular_of[u])]
            )
            qids.append(v)

    capacity = np.asarray(
        [n + 0.5, n + 0.5, n + 0.5 + K / n2, n + 0.5 + K / n2], np.float64
    )
    return LSInstance(
        pathset=PathSet.from_lists(paths, qids),
        shard=shard,
        f=f,
        capacity=capacity,
        n_servers=4,
        t=0,
        marker_of=marker_of,
        regular_of=regular_of,
    )


def scheme_from_bisection(
    inst: LSInstance, adjacency: list[list[int]], side: np.ndarray
) -> ReplicationScheme:
    """The feasible scheme from a bisection (Appendix A.1, 'if' direction).

    ``side[v]`` in {0, 1}: vertices with side 0 replicate to s3, side 1 to
    s4.  Markers + regular objects of each side move to its server; regular
    objects of *neighbors* too; bridge vertices' regular objects are
    replicated on both sides.
    """
    scheme = ReplicationScheme.from_sharding(inst.shard, inst.n_servers)
    for v in range(len(adjacency)):
        s = 2 + int(side[v])
        scheme.mask[inst.marker_of[v], s] = True
        scheme.mask[inst.regular_of[v], s] = True
        for u in adjacency[v]:
            scheme.mask[inst.regular_of[u], s] = True
    return scheme


def is_feasible_ls(
    inst: LSInstance,
    scheme: ReplicationScheme,
    device=None,
    backend: str | None = None,
) -> bool:
    """Latency bound t=0 on all queries + storage capacities respected.

    Queries are routed to the server of their (replicated) marker: the
    reduction argues markers must be replicated to s3/s4 and queries start
    there.  We check feasibility the way the definition does: the latency
    under the access function must be 0 for every path, where the root is
    routed to any server holding a copy of the root marker (best case).

    The walks run on the engine (``device``, default ``"cuda"``;
    ``backend`` from the device): every path is walked home-first from
    every server at once, and a path passes when some holder of its root
    walks it within ``t``.
    """
    ps = inst.pathset
    S = scheme.n_servers
    objs = np.asarray(ps.objects)
    lens = np.asarray(ps.lengths)
    P = ps.n_paths
    # row s * P + i walks path i from server s
    tiled = PathSet(np.tile(objs, (S, 1)), np.tile(lens, S), np.arange(S * P, dtype=np.int32))
    start = np.repeat(np.arange(S, dtype=np.int32), P)
    eng = LatencyEngine(scheme, backend=backend, device=device)
    _, local = eng.access_trace(tiled, start=start, policy="home_first")
    valid = np.arange(objs.shape[1])[None, :] < tiled.lengths[:, None]
    cost = (valid & ~local).sum(axis=1).reshape(S, P)
    holds = scheme.mask[np.maximum(objs[:, 0], 0)].T  # [S, P]
    if not bool(((cost <= inst.t) & holds).any(axis=0).all()):
        return False
    load = scheme.storage_per_server(inst.f)
    return bool(np.all(load <= inst.capacity + 1e-9))


def brute_force_min_bridge_bisection(adjacency: list[list[int]]) -> int:
    """Min over bisections of the max #bridge vertices per side (small G)."""
    n2 = len(adjacency)
    n = n2 // 2
    best = n2
    for half in itertools.combinations(range(n2), n):
        side = np.ones((n2,), np.int8)
        side[list(half)] = 0
        bridges = [0, 0]
        for v in range(n2):
            if any(side[u] != side[v] for u in adjacency[v]):
                bridges[side[v]] += 1
        best = min(best, max(bridges))
    return best


def brute_force_feasible(inst: LSInstance, adjacency: list[list[int]]) -> bool:
    """Existence of a feasible scheme, via the bisection characterization."""
    n2 = len(adjacency)
    K_budget = round((inst.capacity[2] - (n2 / 2 + 0.5)) * n2)
    return brute_force_min_bridge_bisection(adjacency) <= K_budget
