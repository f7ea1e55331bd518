"""Synthetic data pipelines (torch port of ``repro.data``)."""
from repro_torch.data.pipeline import Prefetcher, gnn_batch_fn, lm_batch_fn, shard_batch

__all__ = ["Prefetcher", "lm_batch_fn", "gnn_batch_fn", "shard_batch"]
