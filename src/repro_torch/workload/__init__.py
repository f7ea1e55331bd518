"""Workload analyzers: causal-access-path enumeration per query family."""
from repro_torch.workload.analyzer import (
    batched,
    materialize,
    stream_latencies,
    trace_objects,
    workload_latency_summary,
)
from repro_torch.workload.snb import snb_query_paths, snb_workload, snb_workload_materialized
from repro_torch.workload.gnn import gnn_query_paths, gnn_workload, gnn_workload_materialized
from repro_torch.workload.recsys import recsys_workload, recsys_workload_materialized
from repro_torch.workload.moe import expert_shard, moe_workload, moe_workload_materialized
from repro_torch.workload.tenants import (
    FAMILY_TENANTS,
    multi_tenant_workload,
    tenant_spec,
)

__all__ = [
    "FAMILY_TENANTS",
    "multi_tenant_workload",
    "tenant_spec",
    "batched",
    "materialize",
    "trace_objects",
    "stream_latencies",
    "workload_latency_summary",
    "snb_workload",
    "snb_workload_materialized",
    "snb_query_paths",
    "gnn_workload",
    "gnn_workload_materialized",
    "gnn_query_paths",
    "recsys_workload",
    "recsys_workload_materialized",
    "expert_shard",
    "moe_workload",
    "moe_workload_materialized",
]
