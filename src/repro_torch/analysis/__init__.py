"""Roofline and op-census analysis of a step counted on one card (torch
port of ``repro.analysis``; one card has no ICI or DCN link, so
``ICI_BW`` / ``DCN_BW`` are not carried over)."""
from repro_torch.analysis.hlo import CollectiveStats, collective_stats, op_census
from repro_torch.analysis.roofline import (
    HBM_BW,
    PEAK_FLOPS_BF16,
    Roofline,
    analyze,
    gnn_model_flops,
    lm_model_flops,
    lm_param_count,
    mind_model_flops,
)

__all__ = [
    "CollectiveStats",
    "collective_stats",
    "op_census",
    "Roofline",
    "analyze",
    "lm_model_flops",
    "lm_param_count",
    "gnn_model_flops",
    "mind_model_flops",
    "PEAK_FLOPS_BF16",
    "HBM_BW",
]
