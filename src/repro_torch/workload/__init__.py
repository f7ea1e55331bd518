"""Workload analyzers: causal-access-path enumeration per query family."""
from repro_torch.workload.analyzer import batched, materialize, trace_objects
from repro_torch.workload.snb import snb_query_paths, snb_workload, snb_workload_materialized

__all__ = [
    "batched",
    "materialize",
    "trace_objects",
    "snb_workload",
    "snb_workload_materialized",
    "snb_query_paths",
]
