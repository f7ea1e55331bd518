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
  single_site_oracle          — Fig 2d baseline
  dangling_edge_replication   — Table 3 baseline
  evaluate_baseline           — engine-backed baseline metrics
  ReshardingMap / apply_reshard / drain_server / repair_paths
                              — §5.4 incremental updates
  build_ls_instance           — Thm 4.5 hardness gadget
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
from repro_torch.core.baselines import (
    dangling_edge_replication,
    evaluate_baseline,
    single_site_oracle,
)
from repro_torch.core.reshard import (
    ReshardingMap,
    ReshardReport,
    apply_reshard,
    drain_server,
    repair_paths,
)
from repro_torch.core.hardness import (
    LSInstance,
    brute_force_feasible,
    brute_force_min_bridge_bisection,
    build_ls_instance,
    is_feasible_ls,
    scheme_from_bisection,
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
    "dangling_edge_replication",
    "evaluate_baseline",
    "single_site_oracle",
    "ReshardingMap",
    "ReshardReport",
    "apply_reshard",
    "drain_server",
    "repair_paths",
    "LSInstance",
    "brute_force_feasible",
    "brute_force_min_bridge_bisection",
    "build_ls_instance",
    "is_feasible_ls",
    "scheme_from_bisection",
]
