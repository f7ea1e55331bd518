"""Distributed query executor with a calibrated RPC latency model (§2, §3.1).

Execution follows the paper's subquery-shipping model: a query is routed to
the home server of its root (or to a replica holder picked by a
``Router`` policy); each subsequent access is local when a copy exists at
the current server (Eqn 1), otherwise a nested RPC ships the subquery to
the home server of the next object.  Parallel sibling paths overlap; the
query completes when its slowest root-to-leaf path completes (Def 4.3),
plus a result-gathering barrier at the coordinator.

Latency model.  The paper's measurements (Fig 2a, Fig 6b) show latency
linear in the number of distributed traversals on the critical path, with
local accesses 20-100x faster than remote ones.  We model

    latency(path) = a * n_local_accesses + b * n_distributed_traversals

with defaults a = 2 microseconds (in-memory lookup + marshalling) and
b = 60 microseconds (Gigabit RTT + handler), b/a = 30x, matching the
paper's "2-hop local is 30X faster than 8-node distributed" citation.
Both parameters are configurable; a small lognormal jitter produces the
tail the paper plots (p99).

The access-function walk itself is ``repro_torch.engine``'s: the executor
packs the liveness-filtered mask into the kernels' int32 word layout,
uploads it with the fail-over homes, asks the engine for the per-position
access trace (visited server + locality under Eqn 1), and merely decorates
those outputs with the RPC latency model and per-server load counters.
The walk runs on ``device`` (default ``"cuda"``) with ``backend`` from the
device: on ``kernel`` the ``routed_walk`` kernel (``home_first``,
``nearest_copy``, ``queue_aware``) or ``scored_walk`` (``nearest_copy_dp``),
on ``torch`` their plain versions.  Everything else is numpy, and the
latency draws are numpy ``default_rng(seed)`` draws in a fixed order.

Failure semantics: an access whose object has *no alive copy* routes to
server -1.  The executor keeps serving the rest of the batch and surfaces
those queries in ``ExecutionReport.query_failed`` (their partial-walk
latency is still reported); it never crashes.  A ``Router`` with the
``hedged`` policy makes the executor race the primary and backup
coordinator picks per query and keep the min-latency completion.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.paths import PathSet
from repro_torch.core.replication import ReplicationScheme
from repro_torch.distsys.cluster import Cluster
from repro_torch.distsys.router import Router
from repro_torch.engine.backends import access_trace, resolve_backend
from repro_torch.engine.packed import n_words, pack_bool_mask
from repro_torch.engine.streaming import resolve_device, to_device, to_host


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    local_us: float = 2.0
    remote_us: float = 60.0
    jitter_sigma: float = 0.15  # lognormal sigma on each term
    coordinator_us: float = 4.0  # result gathering / aggregation
    # per-dispatch overhead (marshalling + engine/RPC launch): paid once
    # per access in per-query serving, once per *batch* under the batched
    # dispatch plane (the serving layer) — the cost batching amortizes.
    # 0.0 keeps every pre-batching number bit-identical.
    dispatch_us: float = 0.0

    def sample(
        self, n_local: np.ndarray, n_remote: np.ndarray, rng: np.random.Generator
    ) -> np.ndarray:
        jit_l = rng.lognormal(0.0, self.jitter_sigma, size=n_local.shape)
        jit_r = rng.lognormal(0.0, self.jitter_sigma, size=n_remote.shape)
        return (
            self.local_us * n_local * jit_l
            + self.remote_us * n_remote * jit_r
            + self.coordinator_us
        )


@dataclasses.dataclass
class ExecutionReport:
    """Aggregate statistics of one workload execution."""

    query_latency_us: np.ndarray      # [n_queries]
    query_traversals: np.ndarray      # [n_queries] critical-path traversals
    per_server_local: np.ndarray      # [S]
    per_server_rpcs: np.ndarray       # [S]
    throughput_qps: float
    query_failed: np.ndarray | None = None  # [n_queries] no-alive-copy hit

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.query_latency_us, q))

    @property
    def mean_us(self) -> float:
        return float(self.query_latency_us.mean())

    @property
    def p99_us(self) -> float:
        return self.percentile(99.0)

    @property
    def n_failed(self) -> int:
        return int(self.query_failed.sum()) if self.query_failed is not None else 0

    def summary(self) -> dict:
        return {
            "mean_us": self.mean_us,
            "p50_us": self.percentile(50),
            "p95_us": self.percentile(95),
            "p99_us": self.p99_us,
            "max_traversals": int(self.query_traversals.max(initial=0)),
            "mean_traversals": float(self.query_traversals.mean())
            if len(self.query_traversals)
            else 0.0,
            "throughput_qps": self.throughput_qps,
            "failed_queries": self.n_failed,
        }


def failover_home(scheme: ReplicationScheme, alive: np.ndarray) -> np.ndarray:
    """Per-object routing target under liveness (executor + simulator).

    Original if its server is alive, else the lowest-id alive copy holder,
    else -1 (object unavailable — the access fails).
    """
    mask = scheme.mask & alive[None, :]
    orig_alive = alive[scheme.shard]
    first_alive = np.where(mask.any(axis=1), mask.argmax(axis=1), -1).astype(
        np.int32
    )
    return np.where(orig_alive, scheme.shard, first_alive).astype(np.int32)


def walk_inputs(
    pathset: PathSet,
    scheme: ReplicationScheme,
    alive: np.ndarray,
    start: np.ndarray | None = None,
) -> tuple:
    """The host side of one walk: (objects int32 [P, L], lengths int32 [P],
    words int32 [n + 1, W], home int32 [n], start int32 [P] | None).

    ``words`` packs the liveness-filtered mask the way
    ``PackedScheme.from_mask`` lays it out (uint32 bits viewed as int32,
    one empty sacrificial last row), the layout the walk kernels read;
    ``home`` is the fail-over map.
    """
    mask = scheme.mask & alive[None, :]
    n, S = mask.shape
    words = np.zeros((n + 1, n_words(S)), np.uint32)
    words[:n] = pack_bool_mask(mask)
    return (
        np.asarray(pathset.objects, np.int32),
        np.asarray(pathset.lengths, np.int32),
        words.view(np.int32),
        failover_home(scheme, alive),
        None if start is None else np.asarray(start, np.int32),
    )


def trace_paths(
    pathset: PathSet,
    scheme: ReplicationScheme,
    alive: np.ndarray,
    start: np.ndarray | None = None,
    policy=None,
    load: np.ndarray | None = None,
    device=None,
    backend: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Engine-backed access walk (Eqn 1) under liveness.

    Returns (servers int32 [P, L], local bool [P, L]); ``start`` optionally
    sets the per-path start server (a router's coordinator picks).  Visited
    server -1 means the access had no alive copy to go to.

    ``policy`` (str | ``repro_torch.engine.routing.RoutingPolicy``) selects
    the remote-hop target rule — the fail-over home under ``home_first``, a
    holder pick from the alive-masked replica words under
    ``nearest_copy``/``queue_aware`` (``load`` = live queue depths).  The
    holder words are liveness-filtered, so the policy walk subsumes both
    the fail-over map and the scalar ``Router.route_hop``.

    ``device`` (default ``"cuda"``) and ``backend`` (``kernel`` on CUDA,
    ``torch`` on the CPU by default) pick where and how the walk runs.
    """
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    objects, lengths, words, home, start = walk_inputs(pathset, scheme, alive, start)
    if objects.shape[0] == 0:
        return np.zeros(objects.shape, np.int32), np.zeros(objects.shape, bool)
    servers, local = access_trace(
        to_device(objects, dev),
        to_device(lengths, dev),
        to_device(words, dev),
        to_device(home, dev),
        start=None if start is None else to_device(start, dev),
        policy=policy,
        load=load,
        backend=backend,
    )
    return to_host(servers), to_host(local)


def trace_paths_batched(
    pathset: PathSet,
    scheme: ReplicationScheme,
    alive: np.ndarray,
    batches: list[tuple[np.ndarray, np.ndarray | None]],
    policy=None,
    load: np.ndarray | None = None,
    device=None,
    backend: str | None = None,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """One engine dispatch for MANY batches of paths (amortized launch).

    ``batches`` is a list of ``(path_idx, start)`` pairs: the member path
    rows of each batch and their optional per-path start servers (a
    coordinator pick; ``None`` = home start).  The path subsets are
    concatenated into a single ``access_trace`` call — one mask pack, one
    device upload, one kernel launch — and the outputs are split back per
    batch.  Row-for-row identical to calling :func:`trace_paths` once per
    batch: the walk is per-path, so concatenation cannot change any row.

    This is the engine entry point of the batched dispatch plane: the
    serving layer coalesces same-window queries and pays the dispatch
    overhead once per batch instead of once per query.
    """
    if not batches:
        return []
    objects = np.asarray(pathset.objects, np.int32)
    lengths = np.asarray(pathset.lengths, np.int32)
    idx_all = []
    starts_all = []
    any_start = any(st is not None for _, st in batches)
    for idx, st in batches:
        idx = np.asarray(idx, np.int64)
        idx_all.append(idx)
        if any_start:
            starts_all.append(
                np.full(len(idx), -1, np.int32)
                if st is None
                else np.asarray(st, np.int32)
            )
    cat = np.concatenate(idx_all)
    sub = PathSet(
        objects[cat],
        lengths[cat],
        np.arange(len(cat), dtype=np.int32),
    )
    start = np.concatenate(starts_all) if any_start else None
    if start is not None and (start < 0).any():
        # mixed home/coordinator starts: access_trace's start is all-or-
        # nothing, so fill holes with the fail-over home of each root
        home = failover_home(scheme, alive)
        roots = np.maximum(objects[cat, 0], 0)
        start = np.where(start >= 0, start, home[roots]).astype(np.int32)
    servers, local = trace_paths(sub, scheme, alive, start, policy, load, device,
                                 backend)
    out = []
    off = 0
    for idx in idx_all:
        out.append((servers[off: off + len(idx)], local[off: off + len(idx)]))
        off += len(idx)
    return out


def _path_costs(
    pathset: PathSet,
    scheme: ReplicationScheme,
    alive: np.ndarray,
    start: np.ndarray | None = None,
    policy=None,
    load: np.ndarray | None = None,
    device=None,
    backend: str | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Access walk + counters.

    Returns (n_local [P], n_remote [P], local_per_server [S],
    rpc_per_server [S], dead [P], servers [P, L], local [P, L]).  A dead
    server's copies are unavailable; originals of dead servers are served
    by the lowest-id alive replica holder (fail-over).  ``dead[p]`` marks
    paths that hit an object with no alive copy at all (visited server -1).
    """
    S = scheme.n_servers
    servers, local = trace_paths(pathset, scheme, alive, start, policy, load, device,
                                 backend)

    valid = pathset.objects >= 0
    remote = valid & ~local  # only positions >= 1 can be remote
    dead = ((servers < 0) & valid).any(axis=1)
    n_local = local.sum(axis=1).astype(np.int64)
    n_remote = remote.sum(axis=1).astype(np.int64)

    srv_c = np.maximum(servers, 0)
    local_srv = np.bincount(srv_c[local], minlength=S).astype(np.int64)
    rpc_srv = np.bincount(srv_c[remote], minlength=S).astype(np.int64)
    return n_local, n_remote, local_srv, rpc_srv, dead, servers, local


def _query_roots(pathset: PathSet) -> np.ndarray:
    """Root object per query (the root is shared by all the query's paths)."""
    roots = np.zeros(pathset.n_queries, np.int64)
    np.maximum.at(
        roots, np.asarray(pathset.query_ids), np.maximum(pathset.objects[:, 0], 0)
    )
    return roots


def _emit_structural_spans(
    trace, pathset, servers, local, model, q_lat, q_dead
) -> None:
    """Record the closed-form walk into a tracer (``record`` / ``finalize``).

    Shared prefixes across a query's paths execute once (Def 4.1) and
    emit one span each, exactly like the simulator's trie-deduped trees;
    times are cumulative jitter-free model constants with zero queue wait.
    """
    qids = np.asarray(pathset.query_ids)
    lengths = np.asarray(pathset.lengths)
    objects = np.asarray(pathset.objects)
    seen: dict[int, set] = {}
    for p in range(pathset.n_paths):
        q = int(qids[p])
        prefixes = seen.setdefault(q, set())
        t = 0.0
        prefix: tuple = ()
        for x in range(int(lengths[p])):
            obj = int(objects[p, x])
            prefix = prefix + (obj,)
            lc = bool(local[p, x])
            cost = model.local_us if lc else model.remote_us
            if prefix not in prefixes:
                prefixes.add(prefix)
                trace.record(q, obj, int(servers[p, x]), lc, t, t, t + cost)
            t += cost
    for q in range(len(q_lat)):
        trace.finalize(q, 0.0, float(q_lat[q]), failed=bool(q_dead[q]))


def execute_workload(
    cluster: Cluster,
    pathset: PathSet,
    model: LatencyModel | None = None,
    seed: int = 0,
    hedge_replicas: bool = False,
    router: Router | None = None,
    policy=None,
    trace=None,
    device=None,
    backend: str | None = None,
) -> ExecutionReport:
    """Execute a workload; per-query latency = slowest path + coordination.

    ``router``: replica-aware coordinator selection.  ``replica_lb`` starts
    each query at the least-loaded alive copy holder of its root (seeded
    with the cluster's live queue depths); ``hedged`` additionally races a
    backup coordinator and keeps the per-query min-latency completion
    (counters are charged to the primary — the backup's work is the price
    of hedging and is reflected in its latency draw, not double-counted
    into throughput).

    ``policy``: per-hop routing policy (``repro_torch.engine.routing``) for the
    batched walk itself — ``home_first`` (default, Eqn 1 verbatim),
    ``nearest_copy``, or ``queue_aware`` (holders ranked by the cluster's
    live queue depths).  Orthogonal to ``router``, which only picks each
    query's *coordinator*.

    ``hedge_replicas``: per-hop straggler mitigation — when a remote hop
    has >1 alive copy, the executor issues hedged requests and takes the
    faster jitter draw (min of two lognormals), a direct secondary benefit
    of the replication scheme.

    ``trace``: a :class:`repro_torch.obs.Tracer` (or any object with its
    ``record`` / ``finalize`` / ``policy``) collecting *structural* spans —
    one per unique access of each query's shared-prefix walk (hop order,
    object, server, local/remote), timed with the jitter-free model
    constants and no queueing (enqueue == start).  The executor prices
    queries in isolation, so span times decompose the modeled walk, not
    the sampled latency; the simulator's spans are the ones whose
    queue/service split sums to real latency.

    ``device`` (default ``"cuda"``) and ``backend`` (default from the
    device) pick where the walks run; the report is the same on every
    backend.
    """
    model = model or LatencyModel()
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    rng = np.random.default_rng(seed)
    alive = np.asarray([s.alive for s in cluster.servers], bool)
    load = cluster.queue_depths()
    nq = pathset.n_queries
    qids = np.asarray(pathset.query_ids)

    start = backup_start = None
    coord = None
    has_backup = None
    if router is not None and router.policy != "home":
        roots = _query_roots(pathset)
        if router.policy == "hedged":
            coord, backup = router.route_roots_hedged(
                roots, alive, seed=seed, load=cluster.queue_depths()
            )
            has_backup = backup >= 0
            if has_backup.any():
                backup_start = np.where(has_backup, backup, coord)[qids]
        else:
            coord = router.route_roots(
                roots, alive, seed=seed, load=cluster.queue_depths()
            )
        start = coord[qids]

    n_local, n_remote, local_srv, rpc_srv, dead, w_servers, w_local = (
        _path_costs(pathset, cluster.scheme, alive, start, policy, load, dev, backend)
    )

    lat = model.sample(n_local.astype(np.float64), n_remote.astype(np.float64), rng)
    if hedge_replicas:
        # hedging halves the effective tail of the remote term where copies
        # exist; approximate with a second draw on the remote component.
        alt = model.sample(
            n_local.astype(np.float64), n_remote.astype(np.float64), rng
        )
        n_copies = cluster.scheme.mask[np.maximum(pathset.objects, 0)].sum(-1)
        hedgeable = (n_copies.max(axis=1) > 1)
        lat = np.where(hedgeable, np.minimum(lat, alt), lat)

    q_lat = np.zeros(nq, np.float64)
    q_trav = np.zeros(nq, np.int64)
    q_dead = np.zeros(nq, bool)
    np.maximum.at(q_lat, qids, lat)
    np.maximum.at(q_trav, qids, n_remote)
    np.maximum.at(q_dead, qids, dead)

    if backup_start is not None:
        # race the backup coordinator pick: independent walk + jitter draw,
        # keep the faster completion per query (min of two path-maxima).
        b_local, b_remote, _, _, b_dead, _, _ = _path_costs(
            pathset, cluster.scheme, alive, backup_start, policy, load, dev, backend
        )
        b_lat = model.sample(
            b_local.astype(np.float64), b_remote.astype(np.float64), rng
        )
        bq_lat = np.zeros(nq, np.float64)
        bq_trav = np.zeros(nq, np.int64)
        bq_dead = np.zeros(nq, bool)
        np.maximum.at(bq_lat, qids, b_lat)
        np.maximum.at(bq_trav, qids, b_remote)
        np.maximum.at(bq_dead, qids, b_dead)
        # only queries with a real backup pick get the min-of-two; a lone
        # copy holder has nothing to hedge against (its second walk would
        # just be a free extra jitter draw)
        faster = (bq_lat < q_lat) & has_backup
        q_lat = np.where(faster, bq_lat, q_lat)
        q_trav = np.where(faster, bq_trav, q_trav)
        q_dead = q_dead & bq_dead  # failed only if both picks hit a dead end

    for s in cluster.servers:
        s.local_accesses += int(local_srv[s.server_id])
        s.remote_rpcs_in += int(rpc_srv[s.server_id])
    if coord is not None:
        counts = np.bincount(
            np.maximum(coord, 0)[coord >= 0], minlength=cluster.n_servers
        )
        for s in cluster.servers:
            s.queries_coordinated += int(counts[s.server_id])

    if trace is not None:
        if policy is not None:
            trace.policy = getattr(policy, "name", str(policy))
        _emit_structural_spans(
            trace, pathset, w_servers, w_local, model, q_lat, q_dead
        )

    # throughput model: per-server service capacity is shared; the
    # bottleneck server's work bounds qps (open-loop approximation).
    work_us = local_srv * model.local_us + rpc_srv * model.remote_us
    busiest = work_us.max() if work_us.size else 1.0
    qps = nq / (busiest / 1e6) if busiest > 0 else float("inf")
    return ExecutionReport(
        query_latency_us=q_lat,
        query_traversals=q_trav,
        per_server_local=local_srv,
        per_server_rpcs=rpc_srv,
        throughput_qps=qps,
        query_failed=q_dead,
    )
