"""Bytes of one ``prune_walk`` sweep (the serial prune, one launch per
drive), frozen from the program's chip smoke script's ``prune_bytes``."""
from __future__ import annotations

import numpy as np

KERNEL = "prune_walk_kernel"


def sweep_bytes(cand_v: np.ndarray, cand_s: np.ndarray, starts: np.ndarray, rows: np.ndarray,
                objects: np.ndarray, W: int, rank: bool = True) -> int:
    """Bytes the sweep must move, each read once: the candidates and their
    keep flags, their objects' CSR ranges and row entries, each touched
    path's objects, length and budget, each object on those paths' home
    and words, one word written per edited cell, and the rank vector (not
    read by the scored sweep, ``rank=False``)."""
    uv = np.unique(cand_v)
    lo, hi = starts[uv].astype(np.int64), starts[uv + 1].astype(np.int64)
    entries = int((hi - lo).sum())
    idx = np.repeat(lo - np.concatenate([[0], np.cumsum(hi - lo)[:-1]]), hi - lo)
    paths = np.unique(rows[idx + np.arange(entries)])
    objs = objects[paths]
    touched = np.unique(objs[objs >= 0]).size
    cells = np.unique(cand_v.astype(np.int64) * W + cand_s // 32).size
    return (9 * len(cand_v) + 8 * len(uv) + 4 * entries
            + int((objs >= 0).sum()) * 4 + 8 * len(paths)
            + (4 + 4 * W) * touched + 4 * cells + (4 * W * 32 if rank else 0))


def drive_bytes(reference: dict, objects: np.ndarray, W: int) -> int | None:
    """The sweep's bytes in a drive the reference followed (None when the
    drive runs no prune)."""
    pr = reference["prune"]
    if pr is None or len(pr["cand_v"]) == 0:
        return None
    return sweep_bytes(pr["cand_v"], pr["cand_s"], pr["starts"], pr["rows"], objects, W)
