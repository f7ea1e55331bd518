"""Simulated distributed query-execution cluster (paper §3.1 system model).

Each server has a data store (which objects it holds: originals per the
sharding function + replicas per the replication scheme) and a query
executor.  The simulation tracks storage consumption against capacities
M_s and exposes the state the router/executor need.  It is the stand-in
for the paper's six r5d.4xlarge servers; all quantities the paper measures
(traversal counts, storage overheads, load imbalance) are exact, and
wall-clock latency comes from the calibrated RPC model in ``executor``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.replication import ReplicationScheme


@dataclasses.dataclass
class ServerState:
    server_id: int
    alive: bool = True
    # counters maintained by the executor
    local_accesses: int = 0
    remote_rpcs_in: int = 0
    queries_coordinated: int = 0
    # live queueing state maintained by the serving simulator:
    # outstanding requests + in-service count.
    queue_depth: int = 0
    busy: int = 0


@dataclasses.dataclass
class Cluster:
    """A set of servers + the current replication scheme."""

    scheme: ReplicationScheme
    f: np.ndarray | None = None
    capacity: np.ndarray | None = None
    servers: list[ServerState] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.servers:
            self.servers = [
                ServerState(s) for s in range(self.scheme.n_servers)
            ]

    @property
    def n_servers(self) -> int:
        return self.scheme.n_servers

    def alive_servers(self) -> np.ndarray:
        return np.asarray([s.server_id for s in self.servers if s.alive])

    def holds(self, obj: int, server: int) -> bool:
        return bool(self.scheme.mask[obj, server]) and self.servers[server].alive

    def storage_report(self) -> dict:
        load = self.scheme.storage_per_server(self.f)
        mean = load.mean() if load.size else 0.0
        return {
            "per_server": load.tolist(),
            "total": float(load.sum()),
            "imbalance": float(load.max() / mean - 1.0) if mean > 0 else 0.0,
            "overhead": self.scheme.replication_overhead(self.f),
            "capacity_ok": (
                bool(np.all(load <= self.capacity + 1e-9))
                if self.capacity is not None
                else True
            ),
        }

    def queue_depths(self) -> np.ndarray:
        """Live outstanding work per server (queue-aware routing input)."""
        return np.asarray(
            [s.queue_depth + s.busy for s in self.servers], np.int64
        )

    def apply_scheme_delta(self, objects, servers) -> None:
        """Apply a monotone replica-addition delta to the live scheme.

        This is the controller's hot path: an incremental replication
        delta lands on the serving cluster as plain 0->1 mask flips — no
        scheme rebuild, no re-routing pause.
        Negative pairs (failed routing sentinels) are ignored.
        """
        obj = np.asarray(objects)
        srv = np.asarray(servers)
        ok = (obj >= 0) & (srv >= 0)
        if ok.any():
            self.scheme.add(obj[ok], srv[ok])

    def fail_server(self, server: int) -> None:
        self.servers[server].alive = False

    def recover_server(self, server: int) -> None:
        self.servers[server].alive = True

    def reset_counters(self) -> None:
        for s in self.servers:
            s.local_accesses = 0
            s.remote_rpcs_in = 0
            s.queries_coordinated = 0
            s.queue_depth = 0
            s.busy = 0
