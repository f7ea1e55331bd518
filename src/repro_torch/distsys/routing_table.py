"""Client-side routing tables: direct-to-shard dispatch without the root
coordinator hop.

Every query in the baseline serving path enters through the root
coordinator (``LatencyModel.coordinator_us`` — the barrier of Def 4.3),
which also resolves where the root object lives.  A client that caches a
snapshot of the scheme + liveness can skip that hop and open the query
directly at the root's server — the standard "smart client" optimization
(HBase meta cache, Cassandra token-aware drivers).

The price is staleness: the snapshot ages while servers die, recover, and
replicas move.  :class:`RoutingTable` bounds it two ways:

* **staleness-bounded refresh** — :meth:`maybe_refresh` re-snapshots from
  the authoritative cluster state once the copy is older than
  ``max_age_us`` (a pull model: no invalidation fan-out on the write
  path, exactly because scheme deltas are monotone 0->1 flips — a stale
  table routes to a *valid but maybe suboptimal* holder, never to a
  server that lost the object, unless that server died);
* **fallback-to-coordinator on miss** — :meth:`route_root` returns the
  snapshot's pick; the serving layer checks it against live truth and,
  on a miss (target dead, or no longer holding the object), falls back
  to the coordinator path *and* force-refreshes the table, so one miss
  repairs all subsequent queries of that client.

``simulate(routing_table=...)`` threads this through the serving
simulator: a direct hit skips the coordinator barrier, a miss pays it.
The hit/fallback/refresh counters are the benchmark headline —
direct-hit rate under chaos quantifies how much coordinator capacity the
tables save while liveness churns.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.distsys.cluster import Cluster


@dataclasses.dataclass
class RoutingTable:
    """One client's cached snapshot of (scheme, liveness).

    ``max_age_us`` bounds staleness: a lookup first refreshes when the
    snapshot is older.  ``version`` counts refreshes (exposed so tests
    and benchmarks can assert refresh behavior); the counters make the
    direct-vs-fallback split observable.
    """

    cluster: Cluster
    max_age_us: float = 50_000.0
    # snapshot state (filled by refresh)
    mask: np.ndarray | None = None
    shard: np.ndarray | None = None
    alive: np.ndarray | None = None
    fetched_at_us: float = -np.inf
    version: int = 0
    # counters
    lookups: int = 0
    direct_hits: int = 0
    fallbacks: int = 0
    refreshes: int = 0

    def __post_init__(self):
        self.refresh(0.0)

    def refresh(self, now_us: float) -> None:
        """Pull a fresh snapshot from the authoritative cluster state."""
        self.mask = np.asarray(self.cluster.scheme.mask, bool).copy()
        self.shard = np.asarray(self.cluster.scheme.shard, np.int64).copy()
        self.alive = np.asarray(
            [s.alive for s in self.cluster.servers], bool
        )
        self.fetched_at_us = float(now_us)
        self.version += 1
        self.refreshes += 1

    def maybe_refresh(self, now_us: float) -> bool:
        """Staleness-bounded refresh; True if the snapshot was re-pulled."""
        if now_us - self.fetched_at_us > self.max_age_us:
            self.refresh(now_us)
            return True
        return False

    def route_root(self, obj: int) -> int:
        """The snapshot's server pick for a query rooted at ``obj``.

        Snapshot-failover semantics (mirrors the executor's
        ``failover_home`` against the *cached* view): the home server
        when the snapshot believes it alive, else the lowest-id
        snapshot-alive holder, else -1 (the snapshot knows of no live
        copy — the caller must take the coordinator path).
        """
        home = int(self.shard[obj])
        if home < len(self.alive) and self.alive[home]:
            return home
        # a snapshot taken before a scale-out is narrower than the live
        # cluster: only the width both views share can be consulted
        w = min(self.mask.shape[1], len(self.alive))
        holders = np.nonzero(self.mask[obj, :w] & self.alive[:w])[0]
        return int(holders[0]) if len(holders) else -1

    def lookup(self, obj: int, now_us: float) -> tuple[int, bool]:
        """Route a query root; validate against live truth.

        Returns ``(server, direct)``: with ``direct=True`` the snapshot's
        pick is live-valid (alive and actually holding the object) and
        the query goes direct-to-shard, skipping the coordinator hop.
        Otherwise the snapshot missed — the miss is counted, the table
        force-refreshed (one miss repairs the client's future lookups),
        and the caller routes through the coordinator.
        """
        self.maybe_refresh(now_us)
        self.lookups += 1
        target = self.route_root(int(obj))
        if target >= 0 and self.cluster.servers[target].alive and bool(
            self.cluster.scheme.mask[obj, target]
        ):
            self.direct_hits += 1
            return target, True
        self.fallbacks += 1
        self.refresh(now_us)
        return target, False

    def summary(self) -> dict:
        return {
            "lookups": self.lookups,
            "direct_hits": self.direct_hits,
            "fallbacks": self.fallbacks,
            "refreshes": self.refreshes,
            "direct_hit_rate": (
                self.direct_hits / self.lookups if self.lookups else 0.0
            ),
            "version": self.version,
        }
