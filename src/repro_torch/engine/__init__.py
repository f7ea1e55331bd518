"""Device-resident latency-evaluation engine (torch).

  LatencyEngine  — path_latencies / access_trace / query_latencies /
                   query_slack / is_feasible / margin_costs /
                   resilient_path_latencies behind
                   "reference" | "torch" | "kernel"
  RawScheme      — minimal mask+shard scheme carrier
  PackedScheme   — the device-resident packed int32 bitmask state
  RoutingPolicy  — remote-hop target selection for the access walk
                   (home_first | nearest_copy | queue_aware |
                   nearest_copy_dp)
  TRANSFER       — host<->device transfer accounting
  PathStream     — streamed PathSet ingestion with peak-residency
                   accounting; consumed by
                   ``repro_torch.core.greedy.replicate_stream``
  PathIndex      — CSR object->path inverted index; backs the engine's
                   persistent dirty-set latency cache
                   (``path_latencies(..., incremental=True)``)
  KResilient     — k-resilience constraint (loss cases over servers or
                   fault domains); consumed by
                   ``LatencyEngine.resilient_path_latencies`` /
                   ``is_resilient_feasible`` and the greedy gate
                   (``replicate_workload(resilience=...)``)
"""
from repro_torch.engine.backends import BACKENDS, resolve_backend
from repro_torch.engine.engine import DevicePaths, LatencyEngine, RawScheme
from repro_torch.engine.incremental import IncrementalEval, PathIndex
from repro_torch.engine.packed import PackedScheme, pack_bool_mask, unpack_words
from repro_torch.engine.resilience import (
    KResilient,
    case_word_mask,
    failover_shard,
    resolve_resilience,
)
from repro_torch.engine.routing import (
    POLICIES,
    HomeFirst,
    NearestCopy,
    NearestCopyDP,
    QueueAware,
    RoutingPolicy,
    nearest_copy_dp,
    resolve_policy,
)
from repro_torch.engine.sharding import round_up_rows
from repro_torch.engine.streaming import (
    TRANSFER,
    PathStream,
    StreamStats,
    double_buffer,
    resolve_device,
    to_device,
)

__all__ = [
    "BACKENDS",
    "DevicePaths",
    "HomeFirst",
    "IncrementalEval",
    "KResilient",
    "LatencyEngine",
    "NearestCopy",
    "NearestCopyDP",
    "POLICIES",
    "PackedScheme",
    "PathIndex",
    "PathStream",
    "QueueAware",
    "RawScheme",
    "RoutingPolicy",
    "StreamStats",
    "TRANSFER",
    "case_word_mask",
    "double_buffer",
    "failover_shard",
    "nearest_copy_dp",
    "pack_bool_mask",
    "resolve_backend",
    "resolve_device",
    "resolve_policy",
    "resolve_resilience",
    "round_up_rows",
    "to_device",
    "unpack_words",
]
