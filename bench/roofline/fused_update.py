"""Bytes of the fused UPDATE's class launch (``fused_update_class``, one
launch per budget-class pass), frozen from the program's chip smoke
script's ``fused_batch_bytes`` and summed over the launch's 256-path
batches."""
from __future__ import annotations

import numpy as np

KERNEL = "fused_update_class_kernel"
BATCH = 256


def batch_bytes(o: np.ndarray, ln: np.ndarray, W: int, tables: tuple, additions: int,
                gate: str = "routed") -> int:
    """Bytes one fused UPDATE round over rows ``o`` must move, each read
    once: the objects, lengths and budgets, each touched object's home,
    size and words, the tables (``tables`` is their shape ``(Hc, C,
    Hp1)``), the rank vector (routed gate), the chosen plane, the subpath
    servers, the per-row outputs and one word per addition."""
    B, L = o.shape
    Hc, C, Hp1 = tables
    valid = np.arange(L)[None, :] < ln[:, None]
    touched = int(np.unique(o[valid]).size)
    return (4 * B * L + 8 * B + (8 + 4 * W) * touched + Hc * C * Hp1 + 4 * Hc
            + (4 * W * 32 if gate == "routed" else 0)
            + B * L * Hp1 + 4 * B * Hp1 + 6 * B + 4 * additions)


def drive_bytes(reference: dict, W: int) -> int | None:
    """The bytes of every class launch of a drive the reference followed
    (None when it launches none)."""
    total = 0
    for cls in reference["classes"]:
        Hp1 = min(cls["tables"][2], cls["objects"].shape[1])
        shape = (min(cls["tables"][0], cls["objects"].shape[1]), cls["tables"][1], Hp1)
        for i, adds in enumerate(cls["additions"]):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            total += batch_bytes(cls["objects"][sl], cls["lengths"][sl], W, shape, adds)
    return total or None
