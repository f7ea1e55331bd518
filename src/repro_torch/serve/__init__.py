"""Online serving layer of the port: simulator, drifting workloads, control.

  batching    — the batched dispatch plane's policies: batch ladders,
                deadline-aware admission, SLO-driven hedging
  simulator   — discrete-event serving simulator: open-loop Poisson/trace
                arrivals or a closed-loop client pool, per-server FIFO
                queues, queries as routed hop sequences from the engine's
                access trace (one ``routed_walk`` / ``scored_walk`` launch
                per routing variant on the card); p50/p99/p999,
                per-server utilization, throughput-vs-offered-load
  harness     — the same routed access trees served on a real asyncio
                clock (``harness_simulate``)
  drift       — time-phased query mixes + rotating root hotspots over the
                SNB/GNN/recsys workloads, emitting PathSet deltas
  controller  — per-tenant sliding-window monitor + incremental repair:
                each query judged against its own t_Q (``SLOSpec``),
                warm-started vector-budget greedy (``replicate_delta``)
                against the engine's packed words on the card,
                capacity-headroom arbitration between competing tenant
                repairs, scheme deltas applied to the live Cluster,
                RM-aware cold-replica eviction with demotion hysteresis

``simulate``, ``harness_simulate`` and ``AdaptiveController`` take
``device`` (default ``"cuda"``; without a card they raise unless
``device="cpu"``) and ``backend`` (``kernel`` on CUDA, ``torch`` on the
CPU by default).
"""
from repro_torch.serve.batching import (
    AdmissionConfig,
    BatchLadder,
    BatchStats,
    BatchingConfig,
    HedgePolicy,
    derive_deadlines,
)
from repro_torch.serve.simulator import SimReport, simulate
from repro_torch.serve.harness import harness_simulate
from repro_torch.serve.drift import (
    DriftPhase,
    PhaseDelta,
    drift_stream,
    gnn_drift,
    hotspot_phases,
    path_delta,
    recsys_drift,
    snb_drift,
)
from repro_torch.serve.controller import (
    AdaptationReport,
    AdaptiveController,
    ControllerConfig,
    evict_cold_replicas,
)

__all__ = [
    "AdmissionConfig",
    "BatchLadder",
    "BatchStats",
    "BatchingConfig",
    "HedgePolicy",
    "derive_deadlines",
    "SimReport",
    "simulate",
    "harness_simulate",
    "DriftPhase",
    "PhaseDelta",
    "drift_stream",
    "path_delta",
    "hotspot_phases",
    "snb_drift",
    "gnn_drift",
    "recsys_drift",
    "AdaptationReport",
    "AdaptiveController",
    "ControllerConfig",
    "evict_cold_replicas",
]
