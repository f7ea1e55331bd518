"""Online serving layer of the port: for now the drifting workloads.

  drift — time-phased query mixes + rotating root hotspots over the SNB,
          GNN and recsys analyzers, and the per-transition PathSet delta
          that :func:`repro_torch.core.replicate_delta` consumes

The serving simulator, the batching harness and the adaptive controller
are still to port (ROADMAP queue 1 item 4).
"""
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

__all__ = [
    "DriftPhase",
    "PhaseDelta",
    "path_delta",
    "drift_stream",
    "hotspot_phases",
    "snb_drift",
    "gnn_drift",
    "recsys_drift",
]
