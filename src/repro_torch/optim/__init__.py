"""Optimizers and distributed-optimization utilities (torch port of
``repro.optim``)."""
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule, global_norm
from repro_torch.optim.compress import (
    Compressed,
    compress,
    compressed_psum,
    decompress,
)

__all__ = [
    "AdamW",
    "AdamWState",
    "cosine_schedule",
    "global_norm",
    "Compressed",
    "compress",
    "decompress",
    "compressed_psum",
]
