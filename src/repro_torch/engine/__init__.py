"""Device-resident latency-evaluation engine (torch).

  LatencyEngine  — path_latencies / access_trace / query_latencies /
                   query_slack / is_feasible / margin_costs behind
                   "reference" | "torch" | "kernel"
  RawScheme      — minimal mask+shard scheme carrier
  PackedScheme   — the device-resident packed int32 bitmask state
  RoutingPolicy  — remote-hop target selection for the access walk
                   (home_first | nearest_copy | queue_aware |
                   nearest_copy_dp)
  TRANSFER       — host<->device transfer accounting
  PathIndex      — CSR object->path inverted index
"""
from repro_torch.engine.backends import BACKENDS, resolve_backend
from repro_torch.engine.engine import DevicePaths, LatencyEngine, RawScheme
from repro_torch.engine.incremental import PathIndex
from repro_torch.engine.packed import PackedScheme, pack_bool_mask, unpack_words
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
from repro_torch.engine.streaming import TRANSFER, resolve_device, to_device

__all__ = [
    "BACKENDS",
    "DevicePaths",
    "HomeFirst",
    "LatencyEngine",
    "NearestCopy",
    "NearestCopyDP",
    "POLICIES",
    "PackedScheme",
    "PathIndex",
    "QueueAware",
    "RawScheme",
    "RoutingPolicy",
    "TRANSFER",
    "nearest_copy_dp",
    "pack_bool_mask",
    "resolve_backend",
    "resolve_device",
    "resolve_policy",
    "to_device",
    "unpack_words",
]
