"""Replica-aware request routing (paper Fig 4 'sharding-based routing').

The router decides which server coordinates a query (where its root access
runs) and which server serves each remote hop.  Policies:

* ``home``        — original copy per the sharding function (paper default;
                    Alg 2 assumes root routing by d).
* ``replica_lb``  — among servers holding a copy of the root, pick the one
                    with the least outstanding load (uses replicas produced
                    by the replication scheme as routing targets; a benefit
                    the paper notes for t=0 single-site schemes).
* ``hedged``      — primary + backup pick for straggler mitigation: the
                    primary is the least-loaded copy holder, the backup the
                    least-loaded *other* holder (-1 when the root has a
                    single alive copy).  The executor issues both and takes
                    the min-latency completion.

All load-balanced policies accept an optional external ``load`` vector —
the live per-server queue depths of ``Cluster.queue_depths()`` — so
routing is queue-aware under traffic rather than balancing only the
routing counts of the current batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.replication import ReplicationScheme


@dataclasses.dataclass
class Router:
    scheme: ReplicationScheme
    policy: str = "home"

    def _lb_pick(
        self,
        roots: np.ndarray,
        alive: np.ndarray,
        seed: int,
        load: np.ndarray | None,
        backup: bool = False,
    ) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
        """Least-loaded copy-holder per root (optionally with a backup)."""
        S = self.scheme.n_servers
        rng = np.random.default_rng(seed)
        mask = self.scheme.mask[roots] & alive[None, :]
        run_load = (
            np.zeros(S, np.int64)
            if load is None
            else np.asarray(load, np.int64).copy()
        )
        out = np.empty(len(roots), np.int32)
        out2 = np.full(len(roots), -1, np.int32)
        order = rng.permutation(len(roots))
        for i in order:
            cands = np.nonzero(mask[i])[0]
            if len(cands) == 0:
                out[i] = -1
                continue
            by_load = cands[np.argsort(run_load[cands], kind="stable")]
            pick = by_load[0]
            out[i] = pick
            run_load[pick] += 1
            if backup and len(by_load) > 1:
                out2[i] = by_load[1]
        if backup:
            return out, out2
        return out

    def route_roots(
        self,
        roots: np.ndarray,
        alive: np.ndarray | None = None,
        seed: int = 0,
        load: np.ndarray | None = None,
    ) -> np.ndarray:
        """Coordinator server per query root (primary pick only).

        ``load`` seeds the balancing with live queue depths (queue-aware
        routing); without it only the routing counts of this call balance.
        """
        S = self.scheme.n_servers
        alive = np.ones(S, bool) if alive is None else alive
        home = self.scheme.shard[roots]
        if self.policy == "home":
            ok = alive[home]
            if ok.all():
                return home.astype(np.int32)
            # fail-over to first alive replica; -1 when no copy survives
            mask = self.scheme.mask[roots] & alive[None, :]
            fb = np.where(mask.any(1), mask.argmax(1), -1)
            return np.where(ok, home, fb).astype(np.int32)
        if self.policy == "replica_lb":
            return self._lb_pick(roots, alive, seed, load)
        if self.policy == "hedged":
            primary, _ = self._lb_pick(roots, alive, seed, load, backup=True)
            return primary
        raise ValueError(self.policy)

    def route_roots_hedged(
        self,
        roots: np.ndarray,
        alive: np.ndarray | None = None,
        seed: int = 0,
        load: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(primary, backup) coordinator picks for straggler hedging.

        The backup is the least-loaded alive copy holder distinct from the
        primary, or -1 when the root has at most one alive copy (nothing to
        hedge against).  The executor races both and keeps the faster
        completion.
        """
        S = self.scheme.n_servers
        alive = np.ones(S, bool) if alive is None else alive
        return self._lb_pick(roots, alive, seed, load, backup=True)

    def route_hop(
        self,
        obj: int,
        current: int,
        alive: np.ndarray | None = None,
        load: np.ndarray | None = None,
    ) -> tuple[int, bool]:
        """(server, is_remote) for one access from ``current`` (Eqn 1).

        Without ``load`` a remote hop goes to the object's home server
        (Eqn 1's second case), falling back to the lowest-id alive copy
        holder when the home is dead.  With ``load`` (live per-server
        queue depths, ``Cluster.queue_depths()``) the remote-hop replica
        tie-break is *queue-aware*: among alive copy holders the
        least-loaded one serves the hop, the home server winning ties —
        so a hot replica with a deep queue gets skipped even though Eqn 1
        would nominally route there.  Locality is unchanged either way: a
        copy at ``current`` always short-circuits the hop.

        This is the scalar twin of the batched ``queue_aware`` policy
        walk (``repro_torch.engine.routing``): the loaded pick delegates to the
        same :func:`~repro_torch.engine.routing.pick_holder_host` oracle the
        engine backends are parity-tested against.
        """
        from repro_torch.engine.routing import pick_holder_host

        alive_ok = True if alive is None else alive[current]
        if alive_ok and self.scheme.mask[obj, current]:
            return current, False
        home = int(self.scheme.shard[obj])
        holders = self.scheme.mask[obj].copy()
        if alive is not None:
            holders &= alive
        if load is not None:
            return pick_holder_host(holders, home, load), True
        if alive is None or alive[home]:
            return home, True
        copies = np.nonzero(holders)[0]
        return (int(copies[0]) if len(copies) else -1), True
