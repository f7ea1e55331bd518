"""Workload analyzers (paper §5.3 'Workload analysis').

"We implemented workload analyzers that take a dataset and a set of query
types as input and enumerate all the paths in the workload.  Its output can
be an overapproximation: it only has to include all the paths that actually
occur in the workload.  The greedy algorithm materializes only the paths
currently processed by the UPDATE function."

We mirror that contract: an analyzer is an iterator of ``PathSet`` batches
so workloads far larger than memory stream through the greedy algorithm.
``materialize`` concatenates for small benchmark workloads.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator

import numpy as np

from repro_torch.core.paths import PathSet

PathBatchIter = Iterator[PathSet]


def materialize(batches: Iterable[PathSet]) -> PathSet:
    sets = list(batches)
    if not sets:
        return PathSet.from_lists([])
    return PathSet.concatenate(sets)


def batched(
    paths_fn: Callable[[int], list[list[int]]],
    roots: np.ndarray,
    batch_queries: int = 1024,
) -> PathBatchIter:
    """Stream PathSet batches; query ids are globally consistent."""
    buf_paths: list[list[int]] = []
    buf_qids: list[int] = []

    def flush(local_paths, local_qids, qbase):
        return PathSet.from_lists(
            local_paths, [q - qbase for q in local_qids]
        )

    qbase = 0
    for qi, root in enumerate(roots):
        ps = paths_fn(int(root))
        buf_paths.extend(ps)
        buf_qids.extend([qi] * len(ps))
        if qi - qbase + 1 >= batch_queries:
            yield flush(buf_paths, buf_qids, qbase)
            buf_paths, buf_qids = [], []
            qbase = qi + 1
    if buf_paths or qbase == 0:
        yield flush(buf_paths, buf_qids, qbase)


def trace_objects(pathset: PathSet) -> list[np.ndarray]:
    """Co-access traces (hyperedges) per query — hypergraph sharding input."""
    out: dict[int, list[int]] = {}
    for i in range(pathset.n_paths):
        q = int(pathset.query_ids[i])
        out.setdefault(q, []).extend(pathset.path(i))
    return [np.unique(np.asarray(v, np.int64)) for v in out.values()]
