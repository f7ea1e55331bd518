"""Simulated distributed query-execution system + fault tolerance substrate
(torch: the executor's walk runs on the engine's kernels)."""
from repro_torch.distsys.cluster import Cluster, ServerState
from repro_torch.distsys.executor import (
    ExecutionReport,
    LatencyModel,
    execute_workload,
    failover_home,
    trace_paths,
)
from repro_torch.distsys.router import Router
from repro_torch.distsys.routing_table import RoutingTable
from repro_torch.distsys.checkpoint import CheckpointManager
from repro_torch.distsys.faults import (
    ChaosEvent,
    Event,
    apply_event,
    chaos_schedule,
    event_schedule,
    run_schedule,
    time_to_repair,
    violation_windows,
)

__all__ = [
    "Cluster",
    "ServerState",
    "ExecutionReport",
    "LatencyModel",
    "execute_workload",
    "failover_home",
    "trace_paths",
    "Router",
    "RoutingTable",
    "CheckpointManager",
    "ChaosEvent",
    "Event",
    "apply_event",
    "chaos_schedule",
    "event_schedule",
    "run_schedule",
    "time_to_repair",
    "violation_windows",
]
