"""Candidate-set enumeration tables for Alg 2 (paper §5.3).

Alg 2 enumerates all C(h, t) subsets of the h non-root server-local
subpaths of which t are *retained*; subpath 0 is always retained (the first
access is routed by the sharding function).  For vectorization we precompute,
for every h in [0, H], the candidate selection table as a boolean matrix and
stack them padded to the max candidate count.  Low-latency queries have short
paths, so C(h, t) stays small (paper: "relatively small for low-latency
queries"); longer paths fall back to the exact sequential implementation.
"""
from __future__ import annotations

import functools
import itertools
import math

import numpy as np


@functools.lru_cache(maxsize=None)
def comb_table(h: int, t: int) -> np.ndarray:
    """Selection table bool [C, h+1]; column 0 (root subpath) always True.

    For h <= t there is a single all-selected candidate (no replication
    needed; Alg 2 line 4 gate).  For h > t, rows enumerate the subsets of
    {1..h} of size t (Alg 2 line 5), each augmented with subpath 0.
    """
    if h <= t:
        return np.ones((1, h + 1), dtype=bool)
    rows = []
    for subset in itertools.combinations(range(1, h + 1), t):
        sel = np.zeros((h + 1,), dtype=bool)
        sel[0] = True
        sel[list(subset)] = True
        rows.append(sel)
    return np.stack(rows, axis=0)


@functools.lru_cache(maxsize=None)
def stacked_tables(H: int, t: int) -> tuple[np.ndarray, np.ndarray]:
    """Stack comb_table(h, t) for h = 0..H.

    Returns:
      tables: bool [H+1, C_max, H+1]; invalid candidate rows are all-True
        (all-selected => no additions => they are also harmless if selected,
        but they are additionally masked out by ``counts``).
      counts: int32 [H+1]; number of valid candidates for each h.
    """
    per_h = [comb_table(h, t) for h in range(H + 1)]
    c_max = max(tbl.shape[0] for tbl in per_h)
    tables = np.ones((H + 1, c_max, H + 1), dtype=bool)
    counts = np.zeros((H + 1,), dtype=np.int32)
    for h, tbl in enumerate(per_h):
        c = tbl.shape[0]
        tables[h, :c, : h + 1] = tbl
        # pad selection over subpaths > h with True (inert)
        counts[h] = c
    return tables, counts


def iter_comb_rows(h: int, t: int, chunk_rows: int):
    """Yield :func:`comb_table`'s rows in bounded chunks, lazily.

    Same rows in the same order as ``comb_table(h, t)``, but the host only
    ever materializes ``chunk_rows`` of them at once — the streamed table
    construction for deep-path provisioning, where C(h, t) alone would
    dwarf the per-chunk path residency a streamed greedy otherwise bounds.  The combinations iterator is consumed on demand, so
    producing chunk ``i + 1`` only starts after chunk ``i`` is handed off
    (and, on device, scattered into the padded table and droppable).
    """
    if chunk_rows < 1:
        raise ValueError("chunk_rows must be >= 1")
    if h <= t:
        yield np.ones((1, h + 1), dtype=bool)
        return
    it = itertools.combinations(range(1, h + 1), t)
    while True:
        block = list(itertools.islice(it, chunk_rows))
        if not block:
            return
        chunk = np.zeros((len(block), h + 1), dtype=bool)
        chunk[:, 0] = True
        for r, subset in enumerate(block):
            chunk[r, list(subset)] = True
        yield chunk


def n_candidates(h: int, t: int) -> int:
    if h <= t:
        return 1
    return math.comb(h, t)


def max_h_within_budget(t: int, max_candidates: int, h_needed: int) -> int:
    """Largest H <= h_needed with C(H, t) <= max_candidates."""
    H = 0
    for h in range(h_needed + 1):
        if n_candidates(h, t) <= max_candidates:
            H = h
        else:
            break
    return H
