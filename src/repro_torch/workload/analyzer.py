"""Workload analyzers (paper §5.3 'Workload analysis').

"We implemented workload analyzers that take a dataset and a set of query
types as input and enumerate all the paths in the workload.  Its output can
be an overapproximation: it only has to include all the paths that actually
occur in the workload.  The greedy algorithm materializes only the paths
currently processed by the UPDATE function."

We mirror that contract: an analyzer is an iterator of ``PathSet`` batches
so workloads far larger than memory stream through the greedy algorithm.
``materialize`` concatenates for small benchmark workloads, and
``stream_latencies`` / ``workload_latency_summary`` push the batches
through one device-resident ``LatencyEngine`` — the scheme is packed and
uploaded exactly once no matter how many batches stream by.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator

import numpy as np

from repro_torch import obs
from repro_torch.core.paths import PathSet

PathBatchIter = Iterator[PathSet]


def stream_latencies(
    batches: Iterable[PathSet], scheme, backend: str | None = None, policy=None,
    device=None,
) -> Iterator[tuple[PathSet, np.ndarray]]:
    """Yield (batch, per-path h(p, r, rho)) for each streamed batch.

    ``scheme`` is a ``ReplicationScheme`` or an already-built
    ``LatencyEngine`` (reused as-is, keeping the scheme on its device).
    ``policy`` optionally scores the walk under a routing policy;
    ``backend`` and ``device`` build the engine when a scheme is given
    (``device`` defaults to ``"cuda"``).
    """
    from repro_torch.engine import LatencyEngine

    eng = scheme if isinstance(scheme, LatencyEngine) else LatencyEngine(
        scheme, backend=backend, device=device
    )
    for ps in batches:
        yield ps, eng.path_latencies(ps, policy=policy)


def workload_latency_summary(
    batches: Iterable[PathSet], scheme, t: int | None = None,
    backend: str | None = None, slo=None, policy=None, device=None,
) -> dict:
    """Streamed workload analysis: latency histogram + feasibility.

    With the scalar ``t`` this is the plain report (histogram + ``worst <=
    t``).  With ``slo`` (an :class:`repro_torch.core.slo.SLOSpec` covering
    the stream's queries in order) the report is also *per tenant*: each
    streamed batch consumes the next ``batch.n_queries`` budgets of the
    spec, every query is judged against its own t_Q, and the summary
    carries per-tenant slack / violation fractions — without ever
    materializing the workload.  ``policy`` scores h under a routing
    policy for both reports.
    """
    counts: dict[int, int] = {}
    n_paths = 0
    n_queries = 0
    worst = 0
    per_tenant: dict[str, dict] = {}
    if slo is not None:
        for ts in slo.tenants:
            per_tenant[ts.name] = {
                "queries": 0, "violations": 0,
                "min_slack": None, "slack_sum": 0,
            }
    offset = 0
    for ps, pl in stream_latencies(batches, scheme, backend, policy, device):
        n_paths += len(pl)
        vals, cnt = np.unique(pl, return_counts=True)
        for v, c in zip(vals.tolist(), cnt.tolist()):
            counts[int(v)] = counts.get(int(v), 0) + int(c)
        if len(pl):
            worst = max(worst, int(pl.max()))
            if obs.enabled():
                # mirror the exact int histogram into the shared plane
                obs.REGISTRY.histogram("repro.workload.path_traversals").record_many(pl)
        nq = ps.n_queries
        n_queries += nq
        if slo is not None and nq:
            bslo = slo.select_queries(offset, offset + nq)
            qids = np.asarray(ps.query_ids)
            ql = np.zeros((nq,), np.int32)
            np.maximum.at(ql, qids, pl)
            slack = bslo.t_q - ql
            for tid, ts in enumerate(bslo.tenants):
                sel = bslo.tenant_of == tid
                if not sel.any():
                    continue
                acc = per_tenant[ts.name]
                acc["queries"] += int(sel.sum())
                acc["violations"] += int((slack[sel] < 0).sum())
                lo = int(slack[sel].min())
                acc["min_slack"] = lo if acc["min_slack"] is None else min(acc["min_slack"], lo)
                acc["slack_sum"] += int(slack[sel].sum())
        offset += nq
    out = {
        "n_paths": n_paths,
        "max_traversals": worst,
        "histogram": dict(sorted(counts.items())),
        "feasible": (worst <= t) if t is not None else None,
    }
    if slo is not None:
        total_viol = 0
        for acc in per_tenant.values():
            q = acc.pop("slack_sum")
            acc["mean_slack"] = q / acc["queries"] if acc["queries"] else None
            acc["violation_frac"] = acc["violations"] / acc["queries"] if acc["queries"] else 0.0
            total_viol += acc["violations"]
        out["per_tenant"] = per_tenant
        out["feasible"] = total_viol == 0
    return out


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
