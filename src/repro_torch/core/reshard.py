"""Incremental replication-scheme updates under resharding (paper §5.4).

The UPDATE function records, for every replica it adds, a *resharding map*
entry RM: (u, v) meaning "a replica of v was co-located with the original
copy of u".  A *reference count* RC(v, s) counts how many distinct original
objects sharded to s the replica v is associated with.

When the system reshards (elastic scaling, server loss, sharding change)
and moves the original copy of u from s to s', the incremental algorithm:
  * places a copy of every v with (u, v) in RM at s' (unless present),
  * increments RC(v, s'), decrements RC(v, s),
  * deletes the replica v from s when its count drops below one (and no
    other association keeps it there), keeping storage bounded.

The resulting scheme remains latency-feasible and latency-robust because
Alg 2 co-locates replicas with *original copies of specific objects*,
independently of where the sharding function places those originals
(paper §5.4 closing argument).  Tests verify feasibility end-to-end.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from repro_torch.core.replication import ReplicationScheme


@dataclasses.dataclass
class ReshardingMap:
    """RM + RC bookkeeping produced alongside a replication scheme."""

    # u -> set of v replica-objects co-located with u's original copy
    rm: dict[int, set[int]]
    # (v, s) -> count of distinct originals at s that v is associated with
    rc: dict[tuple[int, int], int]

    @staticmethod
    def from_entries(
        entries: list[tuple[int, int, int]], shard: np.ndarray
    ) -> "ReshardingMap":
        """Build from the (u, v, s) triples emitted by the UPDATE functions.

        Each triple says: replica of v added at s because the original copy
        of u lives at s (Alg 2 line 18 instrumented).  Entries whose server
        disagrees with d(u) are still counted at the recorded server — the
        paper ties the replica to the *original object* u, so on reshard
        the replica follows u.
        """
        rm: dict[int, set[int]] = defaultdict(set)
        rc: dict[tuple[int, int], int] = defaultdict(int)
        seen: set[tuple[int, int, int]] = set()
        for u, v, s in entries:
            key = (int(u), int(v), int(s))
            if key in seen:
                continue
            seen.add(key)
            if int(v) not in rm[int(u)]:
                rm[int(u)].add(int(v))
            rc[(int(v), int(s))] += 1
        return ReshardingMap(dict(rm), dict(rc))

    def n_entries(self) -> int:
        return sum(len(vs) for vs in self.rm.values())


@dataclasses.dataclass
class ReshardReport:
    moved_originals: int = 0
    replicas_transferred: int = 0
    replicas_deleted: int = 0
    bytes_transferred: float = 0.0


def apply_reshard(
    scheme: ReplicationScheme,
    rmap: ReshardingMap,
    moves: dict[int, int],
    f: np.ndarray | None = None,
) -> ReshardReport:
    """Apply original-object moves {u: new_server} incrementally (§5.4).

    Mutates ``scheme`` (mask + shard) and ``rmap`` (RC counts) in place;
    returns transfer statistics.  The replica set of each moved original
    follows it; replicas whose refcount at the old server reaches zero are
    dropped there (unless that server still holds the object's original).
    """
    rep = ReshardReport()
    fv = (lambda v: 1.0) if f is None else (lambda v: float(f[v]))
    for u, s_new in moves.items():
        s_old = int(scheme.shard[u])
        if s_old == s_new:
            continue
        rep.moved_originals += 1
        # Move the original copy itself.
        scheme.mask[u, s_old] = False
        scheme.mask[u, s_new] = True
        scheme.shard[u] = s_new
        rep.bytes_transferred += fv(u)
        for v in rmap.rm.get(int(u), ()):
            # Transfer the associated replica to s_new if absent.
            if not scheme.mask[v, s_new]:
                scheme.mask[v, s_new] = True
                rep.replicas_transferred += 1
                rep.bytes_transferred += fv(v)
            rmap.rc[(v, s_new)] = rmap.rc.get((v, s_new), 0) + 1
            # Decrement at the old server; delete if no association left.
            old = rmap.rc.get((v, s_old), 0) - 1
            rmap.rc[(v, s_old)] = max(old, 0)
            if old < 1 and scheme.shard[v] != s_old and scheme.mask[v, s_old]:
                scheme.mask[v, s_old] = False
                rep.replicas_deleted += 1
    return rep


def drain_server(
    scheme: ReplicationScheme,
    rmap: ReshardingMap,
    server: int,
    f: np.ndarray | None = None,
    strategy: str = "single",
) -> tuple[dict[int, int], ReshardReport]:
    """Plan + apply the moves that evacuate ``server`` (fault handling).

    Strategies:
      * ``single``      — move the whole partition to the least-loaded
        survivor.  This is *partition-preserving*: server-local subpaths
        under d can only merge, never split, so the §5.4 RM-transfer alone
        keeps every path feasible (the setting the paper's closing
        argument covers).
      * ``round_robin`` — scatter originals over survivors.  This can
        SPLIT previously server-local subpaths (objects that were co-homed
        are separated), which RM entries cannot anticipate — the caller
        must follow with :func:`repair_paths` to restore the bound.  We
        surface this distinction because the paper's §5.4 claim implicitly
        assumes partition-preserving reshards.
    Returns (moves, report).
    """
    remaining = [s for s in range(scheme.n_servers) if s != server]
    assert remaining, "cannot drain the last server"
    load = scheme.storage_per_server(f)
    order = sorted(remaining, key=lambda s: load[s])
    victims = np.nonzero(scheme.shard == server)[0]
    moves: dict[int, int] = {}
    if strategy == "single":
        tgt = order[0]
        moves = {int(u): tgt for u in victims}
    elif strategy == "round_robin":
        for i, u in enumerate(victims):
            moves[int(u)] = order[i % len(order)]
    else:
        raise ValueError(strategy)
    report = apply_reshard(scheme, rmap, moves, f)
    # The drained server keeps no copies.
    dropped = int(scheme.mask[:, server].sum())
    scheme.mask[:, server] = False
    report.replicas_deleted += dropped
    return moves, report


def repair_paths(
    scheme: ReplicationScheme,
    rmap: ReshardingMap,
    pathset,
    t: int,
    f: np.ndarray | None = None,
    capacity: np.ndarray | float | None = None,
    epsilon: float | None = None,
    device=None,
    backend: str | None = None,
) -> dict:
    """Incrementally re-establish the latency bound after a scatter reshard.

    Finds the paths that violate the bound under the *new* sharding (one
    vectorized latency scan — no workload re-analysis) and re-runs the
    exact UPDATE on just those.  The additions are recorded into ``rmap``
    so subsequent reshards keep working.  Returns repair statistics; this
    is the quantity the paper's §6 'incremental update with a moderate
    replication cost' evaluation reports.  The latency scan runs on
    ``device`` (default ``"cuda"``) with ``backend`` (default from the
    device); the UPDATE per violating path is the host oracle.
    """
    from repro_torch.core.reference import update_exact  # local import (cycle)
    from repro_torch.core.replication import path_latencies

    lat = path_latencies(pathset, scheme, backend=backend, device=device)
    bad = np.nonzero(lat > t)[0]
    cost = 0.0
    failed = 0
    for i in bad:
        res = update_exact(scheme, pathset.path(int(i)), t, f, capacity, epsilon)
        if res.feasible:
            cost += res.cost
            for u, v, s in res.rm_entries:
                rmap.rm.setdefault(int(u), set()).add(int(v))
                rmap.rc[(int(v), int(s))] = rmap.rc.get((int(v), int(s)), 0) + 1
        else:
            failed += 1
    return {
        "repaired_paths": int(len(bad)) - failed,
        "failed_paths": failed,
        "repair_cost": cost,
    }
