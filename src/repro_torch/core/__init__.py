"""The paper's primary contribution: latency-bound replication (torch).

Public API:
  PathSet                     — causal access paths (padded batches)
  ReplicationScheme           — replication scheme r with storage accounting
  SLOSpec / TenantSpec        — per-query / per-tenant latency constraints
  path_latencies / query_latencies / query_slacks / is_latency_feasible
        — Eqns 1-3, thin wrappers over ``repro_torch.engine.LatencyEngine``
  prune_scheme_replicas       — the policy prune sweep (serial, or batched
                                into independent groups with fused=True)
  replicate_workload          — vectorized greedy Alg 1 + Alg 2
  replicate_workload_exact    — faithful sequential Alg 1 + Alg 2
"""
from repro_torch.core.paths import PathSet, paths_from_tree
from repro_torch.core.replication import (
    ReplicationScheme,
    is_latency_feasible,
    path_latencies,
    path_latency_reference,
    prune_scheme_replicas,
    query_latencies,
    query_slacks,
    subpath_structure,
)
from repro_torch.core.slo import SLOSpec, TenantSpec
from repro_torch.core.greedy import (
    GreedyStats,
    replicate_delta,
    replicate_stream,
    replicate_workload,
)
from repro_torch.core.reference import (
    path_latencies_reference,
    replicate_workload_exact,
    server_local_subpaths,
    update_exact,
)

__all__ = [
    "PathSet",
    "paths_from_tree",
    "ReplicationScheme",
    "SLOSpec",
    "TenantSpec",
    "is_latency_feasible",
    "path_latencies",
    "path_latency_reference",
    "query_latencies",
    "query_slacks",
    "prune_scheme_replicas",
    "subpath_structure",
    "GreedyStats",
    "replicate_delta",
    "replicate_stream",
    "replicate_workload",
    "replicate_workload_exact",
    "path_latencies_reference",
    "server_local_subpaths",
    "update_exact",
]
