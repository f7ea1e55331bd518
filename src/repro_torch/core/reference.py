"""Exact sequential implementation of Alg 1 + Alg 2 (paper §5.3).

This is the line-by-line faithful transcription of the paper's pseudocode,
including the two-pass cost-then-feasibility iteration order described in
"Performance optimizations".  It is the correctness oracle for the
vectorized implementation in ``repro_torch.core.greedy`` and is used directly for
small workloads in tests/benchmarks.

It also hosts the pure-python path-latency oracle that backs
``repro_torch.engine.LatencyEngine(backend="reference")``
(:func:`path_latencies_reference`).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.paths import PathSet
from repro_torch.core.replication import ReplicationScheme


@dataclasses.dataclass
class UpdateResult:
    feasible: bool
    cost: float
    additions: list[tuple[int, int]]            # (object, server) pairs added
    rm_entries: list[tuple[int, int, int]]      # (u, v, server) resharding map


def path_latencies_reference(
    objects: np.ndarray, lengths: np.ndarray, mask: np.ndarray, shard: np.ndarray
) -> np.ndarray:
    """Engine ``reference`` backend: the Eqn 1-2 walk, one path at a time.

    ``objects`` int32 [P, L] (-1 padded), ``lengths`` int32 [P]; returns
    int32 [P] distributed-traversal counts.  Deliberately scalar python —
    this is the oracle the vectorized backends are proven against.
    """
    from repro_torch.core.replication import path_latency_reference

    P = objects.shape[0]
    out = np.zeros((P,), dtype=np.int32)
    for i in range(P):
        path = objects[i, : lengths[i]].tolist()
        out[i] = path_latency_reference(path, mask, shard)
    return out


def routed_trace_reference(
    objects: np.ndarray,
    lengths: np.ndarray,
    mask: np.ndarray,
    home: np.ndarray,
    start: np.ndarray | None = None,
    policy="home_first",
    load: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Policy-routed access-walk oracle (``repro_torch.engine.routing``).

    One path at a time, one access at a time: a hop is local when the
    current server holds a copy (Eqn 1); a remote hop's target comes from
    the policy — ``home[obj]`` under ``home_first``, the
    :func:`~repro_torch.engine.routing.pick_holder_host` holder pick under
    ``nearest_copy``/``queue_aware`` (``load`` ranks holders for the
    latter).  Returns (servers int32 [P, L], local bool [P, L]) with
    position 0 local when the path is non-empty — exactly the contract of
    ``repro_torch.engine.backends.access_trace``, which is parity-tested
    against this function.
    """
    from repro_torch.engine.routing import (
        dp_suffix_scores,
        pick_holder_host,
        pick_holder_scored,
        resolve_policy,
    )

    pol = resolve_policy(policy)
    lv = load if pol.uses_load else None
    P, L = objects.shape
    servers = np.zeros((P, L), np.int32)
    local = np.zeros((P, L), bool)
    home = np.asarray(home, np.int64)
    for i in range(P):
        n = int(lengths[i])
        if n == 0:
            continue
        dp = (
            dp_suffix_scores(objects[i, :n], mask, pol.depth)
            if pol.name == "nearest_copy_dp"
            else None
        )
        cur = int(start[i]) if start is not None else int(home[objects[i, 0]])
        servers[i, 0] = cur
        local[i, 0] = True
        for x in range(1, n):
            v = int(objects[i, x])
            if cur >= 0 and mask[v, cur]:
                local[i, x] = True
            elif pol.name == "home_first":
                cur = int(home[v])
            elif dp is not None:
                # score each holder by the optimal cost-to-go over the
                # next `depth` accesses when the hop lands there
                cur = pick_holder_scored(mask[v], int(home[v]), dp[x, :-1])
            else:
                la = None
                if pol.lookahead and x + 1 < n:
                    la = mask[int(objects[i, x + 1])]
                cur = pick_holder_host(mask[v], int(home[v]), lv, la)
            servers[i, x] = cur
        servers[i, n:] = cur
    return servers, local


def routed_path_latencies_reference(
    objects, lengths, mask, home, policy="nearest_copy", load=None
) -> np.ndarray:
    """Distributed-traversal counts under a routing policy (oracle)."""
    _, local = routed_trace_reference(
        objects, lengths, mask, home, policy=policy, load=load
    )
    valid = np.arange(objects.shape[1])[None, :] < np.asarray(lengths)[:, None]
    return (valid & ~local).sum(axis=1).astype(np.int32)


def server_local_subpaths(path: list[int], shard: np.ndarray) -> list[list[int]]:
    """G_{p,d}: maximal runs of the path local to one server under d."""
    if not path:
        return []
    groups: list[list[int]] = [[path[0]]]
    for v in path[1:]:
        if shard[v] == shard[groups[-1][-1]]:
            groups[-1].append(v)
        else:
            groups.append([v])
    return groups


def update_exact(
    scheme: ReplicationScheme,
    path: list[int],
    t: int,
    f: np.ndarray | None = None,
    capacity: np.ndarray | float | None = None,
    epsilon: float | None = None,
    apply: bool = True,
    policy=None,
    load: np.ndarray | None = None,
) -> UpdateResult:
    """Alg 2: one UPDATE(r, p) call.  Mutates ``scheme`` in place if feasible.

    Follows the pseudocode exactly: enumerate candidate retained-subpath
    sets, merge every non-selected subpath into the preceding selected one
    with upward replication + latency-robustness, cost it against the
    current scheme, filter by storage capacity / load balance, and apply the
    cheapest feasible candidate.

    ``policy`` (str | ``repro_torch.engine.routing.RoutingPolicy``) prices the
    path under that *routed* walk first: when the path's routed latency
    against the current scheme is already within ``t`` — the serving path
    can reach existing replicas the home-first closed form cannot — the
    UPDATE is a free no-op (the policy-aware greedy's skip, oracle form).
    ``load`` is the forecast per-server load profile a ``queue_aware``
    policy ranks holders with (ignored by load-blind policies).
    """
    shard = scheme.shard
    fv = (lambda v: 1.0) if f is None else (lambda v: float(f[v]))
    groups = server_local_subpaths(path, shard)
    h = len(groups) - 1
    if h <= t:
        return UpdateResult(True, 0.0, [], [])
    if policy is not None:
        from repro_torch.engine.routing import resolve_policy  # lazy: no cycle

        pol = resolve_policy(policy)
        if pol.name != "home_first":
            h_rt = int(
                routed_path_latencies_reference(
                    np.asarray([path], np.int32),
                    np.asarray([len(path)], np.int32),
                    scheme.mask,
                    scheme.shard,
                    policy=pol,
                    load=load,
                )[0]
            )
            if h_rt <= t:
                return UpdateResult(True, 0.0, [], [])

    group_server = [int(shard[g[0]]) for g in groups]
    base_load = scheme.storage_per_server(f)

    best: tuple[float, list[tuple[int, int]], list[tuple[int, int, int]]] | None = None
    # Pass 1 computes costs; pass 2 (sorted by cost) checks feasibility and
    # stops at the first feasible candidate (paper "Performance
    # optimizations").  We fuse both passes by collecting candidates and
    # sorting, which is equivalent.
    candidates = []
    for subset in itertools.combinations(range(1, h + 1), t):
        delta = {0, *subset}
        added: list[tuple[int, int]] = []
        rm: list[tuple[int, int, int]] = []
        added_set: set[tuple[int, int]] = set()
        cost = 0.0
        for i in range(1, h + 1):
            if i in delta:
                continue
            j = max(x for x in delta if x < i)
            for v in groups[i]:
                for k in range(j, i):
                    s = group_server[k]
                    if scheme.mask[v, s] or (v, s) in added_set:
                        continue
                    added_set.add((v, s))
                    added.append((v, s))
                    # the representative u for the resharding map (§5.4):
                    # first original object of subpath k hosted at s.
                    rm.append((groups[k][0], v, s))
                    cost += fv(v)
        candidates.append((cost, added, rm))

    for cost, added, rm in sorted(candidates, key=lambda c: c[0]):
        if capacity is not None or epsilon is not None:
            load = base_load.copy()
            for v, s in added:
                load[s] += fv(v)
            if capacity is not None:
                cap = np.broadcast_to(
                    np.asarray(capacity, dtype=np.float64), load.shape
                )
                if np.any(load > cap + 1e-9):
                    continue
            if epsilon is not None:
                mean = load.mean()
                if mean > 0 and load.max() > (1.0 + epsilon) * mean + 1e-9:
                    continue
        if apply and added:
            vs = np.asarray([a[0] for a in added])
            ss = np.asarray([a[1] for a in added])
            scheme.add(vs, ss)
        return UpdateResult(True, cost, added, rm)

    return UpdateResult(False, float("inf"), [], [])


def replicate_workload_exact(
    pathset: PathSet,
    shard: np.ndarray,
    n_servers: int,
    t: int,
    f: np.ndarray | None = None,
    capacity: np.ndarray | float | None = None,
    epsilon: float | None = None,
    prune: bool = True,
    policy=None,
    load: np.ndarray | None = None,
) -> tuple[ReplicationScheme, dict]:
    """Alg 1 with the exact UPDATE; returns (scheme, stats).

    ``policy`` makes every UPDATE price its path under the routed walk
    first (see :func:`update_exact`) — the sequential oracle of
    ``repro_torch.core.greedy.replicate_workload(policy=...)``.  Because the
    receding-horizon walks are not strictly monotone under foreign
    replica additions, a skipped path can regress by the end of the
    sweep; like the batched greedy, bounded re-validation sweeps re-run
    UPDATE on any path the routed walk no longer serves.
    """
    if policy is not None:
        from repro_torch.engine.routing import resolve_policy  # lazy: no cycle

        pol = resolve_policy(policy)
        policy = None if pol.name == "home_first" else pol
    ps = pathset.prune_redundant(shard) if prune else pathset
    scheme = ReplicationScheme.from_sharding(shard, n_servers)
    total_cost = 0.0
    failed = 0
    rm: list[tuple[int, int, int]] = []

    def sweep(indices) -> list[int]:
        nonlocal total_cost, failed
        for i in indices:
            res = update_exact(
                scheme, ps.path(int(i)), t, f, capacity, epsilon,
                policy=policy, load=load,
            )
            if res.feasible:
                total_cost += res.cost
                rm.extend(res.rm_entries)
            else:
                failed += 1
        if policy is None:
            return []
        h_rt = routed_path_latencies_reference(
            np.asarray(ps.objects), np.asarray(ps.lengths),
            scheme.mask, scheme.shard, policy=policy, load=load,
        )
        return np.nonzero(h_rt > t)[0].tolist()

    viol = sweep(range(ps.n_paths))
    if policy is not None:
        from repro_torch.core.greedy import _POLICY_REVALIDATE  # lazy: no cycle

        for _ in range(_POLICY_REVALIDATE):
            if not viol:
                break
            viol = sweep(viol)
    stats = {
        "total_cost": total_cost,
        "failed_paths": failed,
        "replicas": scheme.replica_count(),
        "paths_processed": ps.n_paths,
        "rm": rm,
        # paths still over budget under the routed policy after the
        # bounded revalidation sweeps (0 whenever policy is None)
        "routed_violations": len(viol),
    }
    return scheme, stats
