"""Discrete-event serving simulator: the paper's latency model under load.

The closed-form executor (``repro_torch.distsys.executor``) prices each query in
isolation — latency is the critical path's access costs plus jitter, with
no queueing.  Under traffic that is exactly the regime where tail latency
is decided: requests contend for per-server service capacity, and the p99
the paper tunes (Fig 6b) emerges from queueing delay on the hottest
server, not from the RPC constants.  This module adds the time dimension:

* **open-loop arrivals** — Poisson at an offered ``rate_qps``, or an
  explicit per-query arrival-time trace (replay / drift phases);
* **closed-loop client pool** — alternatively ``clients=N`` serves the
  workload from N clients that each issue a query, wait for its
  completion plus an exponential think time, then issue the next one.
  Closed-loop runs measure *saturation throughput* (offered load adapts
  to service capacity, so ``achieved_qps`` is the system's ceiling) and
  make coordinated omission visible: a closed-loop client stops issuing
  while the system is slow, so its latencies systematically understate
  what an open-loop arrival process (which keeps its schedule) would
  measure — compare the two modes at equal throughput to quantify it;
* **per-hop routing policies** — ``policy`` routes every remote hop of
  the access walk through a ``repro_torch.engine.routing`` policy:
  ``home_first`` (Eqn 1 verbatim), ``nearest_copy`` (holder that keeps
  the walk local longest), or ``queue_aware`` (least-loaded holder,
  seeded from the cluster's live queue depths and refreshed mid-run
  every ``reroute_every`` arrivals — or, with ``hop_feedback=True``,
  re-picked per remote hop at dispatch time — so hop targets react to
  the queues the traffic itself builds up);
* **per-server FIFO queues** — each server serves at most ``concurrency``
  accesses at once (default 32, two hardware threads per vCPU on the
  paper's 16-vCPU r5d.4xlarge servers); excess accesses wait in FIFO
  order;
* **queries as routed hop sequences** — each query's paths come from the
  engine's access trace (Eqn 1 under liveness fail-over, the same walk the
  executor decorates), so a path is a sequence of (server, service-time)
  stages: local accesses cost ``local_us`` at the current server, each
  distributed traversal costs ``remote_us`` at the hop's target server.
  Sibling paths of a query run in parallel; the query completes when its
  slowest path does, plus the coordinator barrier (Def 4.3);
* **router integration** — ``replica_lb`` picks, per arrival, whichever of
  the router's primary/backup coordinators has the shorter live queue
  (queue-aware routing through ``Cluster.queue_depths``-style state);
  ``hedged`` launches both and keeps the first completion (the loser's
  stages still occupy servers — hedging's capacity price is modeled, not
  assumed away);
* **hop-level span tracing** — ``trace`` (a :class:`repro_torch.obs.Tracer`)
  records one span per served access: hop order, object, server,
  local/remote, and the FIFO queue-wait vs service split, tail-biased
  sampled (a query that violated its wall-clock t_Q budget is never
  dropped).  Along a linear walk the span queue+service durations plus
  the coordinator barrier sum exactly to the query's simulated latency,
  so a violation decomposes into named hops on named servers — the input
  to ``repro_torch.obs.attribute_burn``'s per-tenant blame tables.

At utilization -> 0 queueing delay vanishes and the simulator's mean
latency converges to the closed-form model (same access counts, same
service constants, same lognormal jitter mean): at low load the two agree
within 10%.  Accesses whose object has no alive copy (visited server -1)
complete degraded after ``remote_us`` without queueing and mark the query
failed rather than crashing the run.

On the card the walks are the engine's kernels: each routing variant is
one ``trace_paths`` call (one upload, one ``routed_walk`` or
``scored_walk`` launch), and everything else (the access trees, the
event loop, the random draws) is host numpy, in the same order on every
backend, so a report is the same on ``kernel`` and ``torch``.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque

import numpy as np

from repro_torch import obs
from repro_torch.core.paths import PathSet
from repro_torch.distsys.cluster import Cluster
from repro_torch.distsys.executor import LatencyModel, _query_roots, trace_paths
from repro_torch.distsys.router import Router
from repro_torch.engine.backends import resolve_backend
from repro_torch.engine.streaming import resolve_device
from repro_torch.serve.batching import (
    AdmissionConfig,
    BatchingConfig,
    BatchStats,
    HedgePolicy,
)


@dataclasses.dataclass
class SimReport:
    """Statistics of one simulated serving run (all times microseconds)."""

    latency_us: np.ndarray        # [n_queries] completion - arrival
    arrival_us: np.ndarray        # [n_queries]
    query_failed: np.ndarray      # [n_queries] hit an object with no copy
    busy_us: np.ndarray           # [S] total service time per server
    queue_wait_us: float          # mean FIFO wait per stage
    duration_us: float            # makespan (last completion)
    offered_qps: float
    concurrency: int
    # tenant tags: every job of query q carried tenant_of[q] through the
    # event loop, so latencies histogram per tenant (multi-tenant SLOs)
    tenant_of: np.ndarray | None = None      # [n_queries] tenant id
    tenant_names: tuple[str, ...] = ()
    # closed-loop mode: N clients with think time instead of an open-loop
    # arrival process; achieved_qps is then the saturation throughput
    closed_loop: bool = False
    n_clients: int = 0
    policy: str = "home_first"               # per-hop routing policy
    reroutes: int = 0                        # mid-run hop-target refreshes
    # per-hop load feedback: remote-hop targets picked at dispatch time
    # against the queue state the batch itself built up
    hop_feedback: bool = False
    # deadline-aware admission: True where the query was shed (fail-fast)
    # instead of served; shed queries are excluded from surviving stats
    query_shed: np.ndarray | None = None
    # mixed open/closed-loop runs: True where the query was served by the
    # closed-loop client pool (None for pure open/closed runs)
    closed_mask: np.ndarray | None = None
    # batched dispatch: ladder occupancy accounting (None = per-query)
    batch_stats: BatchStats | None = None
    # SLO-driven hedging accounting (slo_hedging marks the mode active)
    slo_hedging: bool = False
    hedges_fired: int = 0
    hedge_wins: int = 0          # fired hedges whose backup completed first
    hedges_cancelled: int = 0    # queued work skipped after first completion
    # chaos injection: the (t_us, kind, server) liveness flips applied
    # mid-run (empty for chaos-free runs)
    chaos_events: list = dataclasses.field(default_factory=list)
    # client-side routing table: direct-vs-fallback counters (None when
    # every query took the coordinator path)
    routing: dict | None = None

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.latency_us, q))

    def surviving_latencies(self) -> np.ndarray:
        """Latencies of queries that were actually served (not shed)."""
        if self.query_shed is None:
            return self.latency_us
        return self.latency_us[~self.query_shed]

    @property
    def shed_frac(self) -> float:
        if self.query_shed is None or not len(self.query_shed):
            return 0.0
        return float(self.query_shed.mean())

    def tenant_latencies(self, name: str) -> np.ndarray:
        """Sojourn latencies of one tenant's queries."""
        if self.tenant_of is None:
            raise ValueError("run was not tenant-tagged (pass slo=)")
        tid = self.tenant_names.index(name)
        return self.latency_us[self.tenant_of == tid]

    @property
    def mean_us(self) -> float:
        return float(self.latency_us.mean())

    @property
    def p50_us(self) -> float:
        return self.percentile(50.0)

    @property
    def p99_us(self) -> float:
        return self.percentile(99.0)

    @property
    def p999_us(self) -> float:
        return self.percentile(99.9)

    @property
    def achieved_qps(self) -> float:
        if len(self.latency_us) == 0:
            return 0.0
        if self.duration_us <= 0:
            return float("inf")
        return len(self.latency_us) / (self.duration_us / 1e6)

    def utilization(self) -> np.ndarray:
        """Busy fraction per server (of duration x concurrency)."""
        if self.duration_us <= 0:
            return np.zeros_like(self.busy_us)
        return self.busy_us / (self.duration_us * self.concurrency)

    def summary(self) -> dict:
        util = self.utilization()
        n_done = int(self.latency_us.size)
        out = {
            # an empty run (clients=0, or a zero-query workload) has no
            # latency distribution: stats are None, never NaN/garbage
            "mean_us": self.mean_us if n_done else None,
            "p50_us": self.p50_us if n_done else None,
            "p99_us": self.p99_us if n_done else None,
            "p999_us": self.p999_us if n_done else None,
            "offered_qps": self.offered_qps,
            "achieved_qps": self.achieved_qps,
            "completed_queries": n_done,
            "max_utilization": float(util.max()) if util.size else 0.0,
            "mean_queue_wait_us": self.queue_wait_us,
            "failed_queries": int(self.query_failed.sum()),
            "mode": "closed_loop" if self.closed_loop else "open_loop",
            "policy": self.policy,
        }
        if self.closed_loop:
            # in closed loop the offered rate is endogenous: achieved_qps
            # IS the saturation throughput at this client count.  With no
            # completed jobs (clients=0) or a degenerate zero-length run
            # there is no throughput to report: None, not a division by
            # zero or +inf
            out["n_clients"] = self.n_clients
            out["saturation_qps"] = (
                self.achieved_qps
                if n_done and self.duration_us > 0
                else None
            )
        if self.hop_feedback:
            out["hop_feedback"] = True
        if self.reroutes:
            out["reroutes"] = self.reroutes
        if self.closed_mask is not None and 0 < self.closed_mask.sum() < len(
            self.closed_mask
        ):
            # mixed run: split the latency distribution per loop so the
            # closed-loop foreground's tail is visible against the
            # open-loop background it contends with
            out["mode"] = "mixed_loop"
            for label, m in (
                ("closed_loop_split", self.closed_mask),
                ("open_loop_split", ~self.closed_mask),
            ):
                lat = self.latency_us[m]
                out[label] = {
                    "n_queries": int(lat.size),
                    "p50_us": float(np.percentile(lat, 50.0)) if lat.size else None,
                    "p99_us": float(np.percentile(lat, 99.0)) if lat.size else None,
                }
        if self.query_shed is not None:
            surv = self.surviving_latencies()
            adm = {
                "n_shed": int(self.query_shed.sum()),
                "shed_frac": self.shed_frac,
                "surviving_p50_us": (
                    float(np.percentile(surv, 50.0)) if surv.size else None
                ),
                "surviving_p99_us": (
                    float(np.percentile(surv, 99.0)) if surv.size else None
                ),
            }
            if self.tenant_of is not None:
                adm["per_tenant_shed_frac"] = {
                    name: float(self.query_shed[self.tenant_of == tid].mean())
                    for tid, name in enumerate(self.tenant_names)
                    if (self.tenant_of == tid).any()
                }
            out["admission"] = adm
        if self.batch_stats is not None:
            out["batching"] = self.batch_stats.summary()
        if self.chaos_events:
            out["chaos"] = {
                "events": [
                    {"at_us": t, "kind": k, "server": s}
                    for t, k, s in self.chaos_events
                ],
                "kills": sum(1 for _, k, _ in self.chaos_events if k == "kill"),
            }
        if self.routing is not None:
            out["routing_table"] = self.routing
        if self.slo_hedging:
            out["hedging"] = {
                "fired": self.hedges_fired,
                "wins": self.hedge_wins,
                "cancelled": self.hedges_cancelled,
                "hedge_frac": (
                    self.hedges_fired / len(self.latency_us)
                    if len(self.latency_us)
                    else 0.0
                ),
            }
        if self.tenant_of is not None:
            per = {}
            for tid, name in enumerate(self.tenant_names):
                lat = self.latency_us[self.tenant_of == tid]
                if not lat.size:
                    continue
                per[name] = {
                    "n_queries": int(lat.size),
                    "mean_us": float(lat.mean()),
                    "p50_us": float(np.percentile(lat, 50.0)),
                    "p99_us": float(np.percentile(lat, 99.0)),
                }
            out["per_tenant"] = per
        return out


def _build_variant(
    pathset: PathSet,
    cluster: Cluster,
    model: LatencyModel,
    alive: np.ndarray,
    start: np.ndarray | None,
    policy=None,
    load: np.ndarray | None = None,
    device=None,
    backend: str | None = None,
):
    """Precompute one routing variant's per-query access trees.

    A query's root-to-leaf paths share prefixes (they enumerate one access
    tree, Def 4.1); each shared access executes *once* and fans out — the
    same structure the closed-form model prices with its max-over-paths.
    Returns (trees_per_query, dead_per_query) where a tree is
    ``(nodes, roots)``: ``nodes[i] = [server, base_service_us, object,
    children]`` and ``roots`` the indices dispatched at arrival.

    ``policy``/``load`` route every remote hop through a
    ``repro_torch.engine.routing`` policy against the given queue-depth
    snapshot (``queue_aware``); the tree's node servers are the policy's
    picks.

    The walk is the variant's one device step: one upload of the packed,
    liveness-filtered words and one ``routed_walk`` / ``scored_walk``
    launch on ``device`` with ``backend`` (their plain versions on
    ``torch``); the trees are built on the host.
    """
    servers, local = trace_paths(
        pathset, cluster.scheme, alive, start, policy, load, device, backend
    )
    nq = pathset.n_queries
    trees: list[tuple[list, list[int]]] = [([], []) for _ in range(nq)]
    tries: list[dict] = [dict() for _ in range(nq)]
    dead = np.zeros(nq, bool)
    qids = np.asarray(pathset.query_ids)
    lengths = np.asarray(pathset.lengths)
    objects = np.asarray(pathset.objects)
    for p in range(pathset.n_paths):
        q = int(qids[p])
        n = int(lengths[p])
        if n == 0:
            continue
        nodes, roots = trees[q]
        trie = tries[q]
        prefix: tuple = ()
        parent = -1
        for x in range(n):
            prefix = prefix + (int(objects[p, x]),)
            idx = trie.get(prefix)
            if idx is None:
                s = int(servers[p, x])
                if s < 0:
                    dead[q] = True
                cost = (
                    model.local_us if bool(local[p, x]) else model.remote_us
                )
                idx = len(nodes)
                nodes.append([s, cost, int(objects[p, x]), []])
                trie[prefix] = idx
                if parent < 0:
                    roots.append(idx)
                else:
                    nodes[parent][3].append(idx)
            parent = idx
    return trees, dead


def _build_dynamic_trees(pathset: PathSet):
    """Per-query access trees with UNRESOLVED hop targets (hop feedback).

    Same shared-prefix trie as :func:`_build_variant`, but a node is
    ``[object, children]`` — the visited server and service cost are
    resolved at *dispatch time* against the live queue state, so every
    remote hop reacts to the congestion accumulated within the batch.
    """
    nq = pathset.n_queries
    trees: list[tuple[list, list[int]]] = [([], []) for _ in range(nq)]
    tries: list[dict] = [dict() for _ in range(nq)]
    qids = np.asarray(pathset.query_ids)
    lengths = np.asarray(pathset.lengths)
    objects = np.asarray(pathset.objects)
    for p in range(pathset.n_paths):
        q = int(qids[p])
        n = int(lengths[p])
        if n == 0:
            continue
        nodes, roots = trees[q]
        trie = tries[q]
        prefix: tuple = ()
        parent = -1
        for x in range(n):
            prefix = prefix + (int(objects[p, x]),)
            idx = trie.get(prefix)
            if idx is None:
                idx = len(nodes)
                nodes.append([int(objects[p, x]), []])
                trie[prefix] = idx
                if parent < 0:
                    roots.append(idx)
                else:
                    nodes[parent][1].append(idx)
            parent = idx
    return trees


def _tree_floors(trees) -> list[tuple[float, list[float]]]:
    """Jitter-free critical-path floor per query and per tree node.

    ``floors[q] = (root_floor, node_floors)`` where ``node_floors[i]`` is
    the cost of node ``i``'s subtree critical path (its own access cost
    plus the max over child subtrees) and ``root_floor`` the max over the
    query's roots — the cheapest the query can possibly finish under the
    active routing (excluding the coordinator barrier), the quantity
    deadline-aware admission compares against the remaining slack.
    Children are appended after their parent in ``_build_variant``, so one
    reverse sweep resolves the recursion.
    """
    out: list[tuple[float, list[float]]] = []
    for nodes, roots in trees:
        nf = [0.0] * len(nodes)
        for i in range(len(nodes) - 1, -1, -1):
            best = 0.0
            for c in nodes[i][3]:
                if nf[c] > best:
                    best = nf[c]
            nf[i] = nodes[i][1] + best
        out.append((max((nf[r] for r in roots), default=0.0), nf))
    return out


def simulate(
    cluster: Cluster,
    pathset: PathSet,
    rate_qps: float = 1e4,
    model: LatencyModel | None = None,
    arrivals_us: np.ndarray | None = None,
    concurrency: int = 32,
    router: Router | None = None,
    seed: int = 0,
    slo=None,
    policy=None,
    reroute_every: int | None = None,
    hop_feedback: bool = False,
    clients: int | None = None,
    think_time_us: float = 0.0,
    trace=None,
    batching: BatchingConfig | None = None,
    admission: AdmissionConfig | None = None,
    hedge: HedgePolicy | None = None,
    closed_queries: np.ndarray | None = None,
    chaos=None,
    routing_table=None,
    device=None,
    backend: str | None = None,
) -> SimReport:
    """Serve ``pathset``'s queries through per-server FIFO queues.

    Queries arrive open-loop (Poisson at ``rate_qps``, or at the explicit
    ``arrivals_us`` times) in query-id order; each executes its routed hop
    sequence against the live cluster state.  Returns per-query sojourn
    latencies and per-server occupancy — the quantities the controller's
    sliding window and the tail benchmarks consume.

    ``clients`` switches to a *closed-loop* client pool instead: N
    clients each issue one query (in id order from a shared backlog),
    wait for its completion plus an exponential think time of mean
    ``think_time_us``, then issue the next — the mode that measures
    saturation throughput and makes coordinated omission observable
    (see module docstring).  ``rate_qps``/``arrivals_us`` are ignored.

    ``policy`` routes every remote hop of the walk through a
    ``repro_torch.engine.routing`` policy (``home_first`` default;
    ``queue_aware`` ranks holders by the cluster's live queue depths —
    the state the previous batch left in ``Cluster.queue_depths()``).
    With ``reroute_every=K`` (requires ``router=None``) the hop targets
    are re-picked mid-run every K arrivals against the simulator's own
    live queue state, so routing reacts to the congestion the batch
    itself builds; in-flight queries finish on their old routes.

    ``hop_feedback=True`` (requires a load-aware policy and
    ``router=None``; mutually exclusive with ``reroute_every``) goes one
    step further: hop targets are not precomputed at all — every remote
    access picks its server at *dispatch time* from the alive copy
    holders ranked by the instantaneous ``busy + queued`` depth (the
    scalar ``pick_holder_host`` oracle), so routing consumes the queue
    depths accumulated *within* the batch, per hop, not per
    ``reroute_every`` window.  ``SimReport.reroutes`` then counts the
    load-ranked remote picks.

    ``slo`` (an :class:`repro_torch.core.slo.SLOSpec` aligned with the pathset's
    queries) tags every job with its query's tenant, so the report carries
    per-tenant latency histograms (``summary()["per_tenant"]``) — the
    per-tenant p99s the multi-tenant controller monitors.

    ``trace`` (a :class:`repro_torch.obs.Tracer`) records a hop-level span per
    served access — queue-wait vs service split on the serving server —
    finalized per query in completion order against the tracer's
    wall-clock ``budget_us``; violating queries' traces are always kept
    (tail-biased sampling).  ``trace=None`` (the default) costs one
    pointer check per access.

    The batched dispatch plane (``repro_torch.serve.batching``):

    ``batching`` (a :class:`BatchingConfig`) coalesces accesses targeting
    the same server within ``window_us`` into one dispatch of a
    ladder-quantized size; the batch occupies a single concurrency slot
    for the members' summed service time plus **one** ``dispatch_us``
    (amortized engine-dispatch overhead — per-query mode pays it per
    access).  Requires ``hop_feedback=False`` (batch members' routes are
    fixed at collection time).

    ``admission`` (an :class:`AdmissionConfig`) sheds queries whose
    jitter-free floor under the active routing can no longer meet their
    wall-clock deadline — at arrival, at every hop dispatch, and at FIFO
    pop (elapsed queue wait counts against the slack).  Shed queries
    complete degraded at the shed instant, are marked in
    ``SimReport.query_shed``, and excluded from surviving-tail stats.

    ``hedge`` (a :class:`HedgePolicy`, requires ``router=None``) races a
    backup coordinator pick only for queries still incomplete when their
    elapsed time crosses the tenant's learned latency quantile; the
    first completion wins and the loser's queued work is skipped
    (``hedges_cancelled``).  Completions feed the policy's per-tenant
    histograms online, so thresholds adapt within the run.

    ``closed_queries`` (requires ``clients=``) selects the subset of
    query ids served by the closed-loop client pool while the rest
    arrive open-loop at ``rate_qps`` — one run with an open-loop
    background and a closed-loop foreground (interference studies);
    ``summary()`` then splits per-loop percentiles.

    ``chaos`` (a list of :class:`repro_torch.distsys.faults.ChaosEvent`,
    requires ``router=None`` and ``hedge=None``) kills and revives
    servers mid-run: at each event's ``at_us`` the server's liveness
    flips (mirrored into ``cluster.servers``, so a controller observing
    between segments sees it), hop targets are re-resolved for every
    query that has NOT arrived yet (``reroute_pending`` — in-flight
    queries keep their old routes and a killed server drains its queue
    gracefully, modeling a crash whose in-flight RPCs time out on the
    old routes), and under ``hop_feedback`` the liveness-masked holder
    arrays are recomputed so the very next dispatch routes around the
    loss.  A killed server's replicas stay on disk and serve again on
    revive.  ``SimReport.chaos_events`` logs the applied flips; feed the
    report to ``repro_torch.distsys.faults.violation_windows`` to score the
    outage.

    ``routing_table`` (a :class:`repro_torch.distsys.RoutingTable` over this
    cluster) models coordinator-free client routing: per arrival the
    query's root is looked up in the client's cached snapshot; a
    live-valid pick goes **direct-to-shard** and skips the
    ``coordinator_us`` barrier, a miss (stale snapshot: target dead or
    replica moved) pays the coordinator hop and force-refreshes the
    table.  ``SimReport.routing`` carries the hit/fallback/refresh
    counters.

    ``device`` (default ``"cuda"``; without a card it raises unless
    ``device="cpu"``) and ``backend`` (``kernel`` on CUDA, ``torch`` on the
    CPU by default) pick where each routing variant's walk runs: every
    variant build and every mid-run rebuild (``reroute_every``, chaos) is
    one upload and one walk launch.  ``hop_feedback`` never walks on the
    device (its hops are picked on the host at dispatch time).  The
    event loop is host numpy on every backend, and the report is the same
    on every backend.
    """
    from repro_torch.engine.routing import pick_holder_host, resolve_policy

    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    model = model or LatencyModel()
    rng = np.random.default_rng(seed)
    alive = np.asarray([s.alive for s in cluster.servers], bool)
    S = cluster.n_servers
    nq = pathset.n_queries
    hop_policy = resolve_policy(policy)
    hop_load = cluster.queue_depths() if hop_policy.uses_load else None
    closed = clients is not None
    if batching is not None and hop_feedback:
        raise ValueError(
            "batching requires hop_feedback=False: batch members' routes "
            "are fixed when the batch is collected"
        )
    if admission is not None and hop_feedback:
        raise ValueError(
            "admission requires hop_feedback=False: floor latencies need "
            "precomputed access trees"
        )
    if hedge is not None:
        if router is not None:
            raise ValueError(
                "hedge= requires router=None (the policy builds its own "
                "primary/backup coordinator variants)"
            )
        if hop_feedback or reroute_every is not None:
            raise ValueError(
                "hedge= is incompatible with hop_feedback/reroute_every"
            )
    if chaos and (router is not None or hedge is not None):
        raise ValueError(
            "chaos= requires router=None and hedge=None: coordinator "
            "variants are built once at entry and would go stale across "
            "liveness flips"
        )
    # mixed open/closed loop: closed_queries picks the client-pool subset
    is_closed: np.ndarray | None = None
    closed_ids: np.ndarray | None = None
    if closed_queries is not None:
        if not closed or int(clients) <= 0:
            raise ValueError("closed_queries requires clients >= 1")
        closed_ids = np.unique(np.asarray(closed_queries, np.int64))
        if len(closed_ids) and (
            closed_ids[0] < 0 or closed_ids[-1] >= nq
        ):
            raise ValueError("closed_queries out of range")
        is_closed = np.zeros(nq, bool)
        is_closed[closed_ids] = True
    elif closed:
        closed_ids = np.arange(nq, dtype=np.int64)
        is_closed = np.ones(nq, bool)
    mixed = is_closed is not None and 0 < len(closed_ids) < nq
    if hop_feedback:
        if router is not None:
            raise ValueError("hop_feedback requires router=None")
        if reroute_every is not None:
            raise ValueError(
                "pass either reroute_every or hop_feedback, not both"
            )
        if not hop_policy.uses_load:
            raise ValueError(
                "hop_feedback only makes sense for a load-aware policy "
                "(queue_aware): load-blind policies pick the same targets"
            )
    tenant_of = None
    tenant_names: tuple[str, ...] = ()
    if slo is not None:
        assert slo.n_queries == nq
        tenant_of = np.asarray(slo.tenant_of, np.int32)
        tenant_names = tuple(ts.name for ts in slo.tenants)
    if nq == 0 or (closed and int(clients) <= 0):
        # nothing to serve (or nobody to serve it): an empty report, with
        # zero-length latency arrays — summary() reports None stats, not
        # NaN percentiles / infinite saturation throughput
        return SimReport(
            latency_us=np.zeros(0), arrival_us=np.zeros(0),
            query_failed=np.zeros(0, bool), busy_us=np.zeros(S),
            queue_wait_us=0.0, duration_us=0.0,
            offered_qps=0.0 if closed else rate_qps,
            concurrency=concurrency,
            tenant_of=tenant_of, tenant_names=tenant_names,
            closed_loop=closed, n_clients=int(clients or 0),
            policy=hop_policy.name, hop_feedback=hop_feedback,
        )

    # --- routing variants -------------------------------------------------
    coord_policy = router.policy if router is not None else "home"
    if hedge is not None:
        # SLO-driven hedging builds the same primary/backup variants as
        # the router's unconditional hedged race, but launches the backup
        # from a learned-quantile timer instead of at arrival
        coord_policy = "hedge_slo"
    if hop_feedback:
        from repro_torch.distsys.executor import failover_home

        coord_policy = "home"
        mask_alive = cluster.scheme.mask & alive[None, :]
        fo_home = failover_home(cluster.scheme, alive)
        variants_trees = [_build_dynamic_trees(pathset)]
        variants_dead = [np.zeros(nq, bool)]
        coords = [None]
    elif coord_policy in ("replica_lb", "hedged", "hedge_slo"):
        hrouter = (
            router if router is not None else Router(cluster.scheme, "hedged")
        )
        roots = _query_roots(pathset)
        primary, backup = hrouter.route_roots_hedged(roots, alive, seed=seed)
        qids = np.asarray(pathset.query_ids)
        v1, d1 = _build_variant(
            pathset, cluster, model, alive, primary[qids],
            hop_policy, hop_load, dev, backend,
        )
        has_b = backup >= 0
        v2, d2 = _build_variant(
            pathset, cluster, model, alive,
            np.where(has_b, backup, primary)[qids],
            hop_policy, hop_load, dev, backend,
        )
        variants_trees = [v1, v2]
        variants_dead = [d1, d2]
        coords = [primary, np.where(has_b, backup, -1)]
    else:
        coord_policy = "home"
        v0, d0 = _build_variant(
            pathset, cluster, model, alive, None, hop_policy, hop_load,
            dev, backend,
        )
        variants_trees = [v0]
        variants_dead = [d0]
        coords = [None]
    if reroute_every is not None:
        if coord_policy != "home":
            raise ValueError("reroute_every requires router=None")
        if not hop_policy.uses_load:
            raise ValueError(
                "reroute_every only makes sense for a load-aware policy "
                "(queue_aware): load-blind policies re-pick identical routes"
            )

    # --- event loop -------------------------------------------------------
    if mixed:
        # open-loop background keeps its schedule; the closed-loop
        # foreground's times are filled at issue by the client pool
        open_ids = np.nonzero(~is_closed)[0]
        if arrivals_us is None:
            arr = np.zeros(nq, np.float64)
            arr[open_ids] = np.cumsum(
                rng.exponential(1e6 / rate_qps, size=len(open_ids))
            )
            arrivals_us = arr
        else:
            arrivals_us = np.asarray(arrivals_us, np.float64).copy()
            assert arrivals_us.shape == (nq,)
    elif closed:
        arrivals_us = np.zeros(nq, np.float64)  # filled at issue time
    elif arrivals_us is None:
        arrivals_us = np.cumsum(
            rng.exponential(1e6 / rate_qps, size=nq)
        )
    else:
        arrivals_us = np.asarray(arrivals_us, np.float64)
        assert arrivals_us.shape == (nq,)

    queues: list[deque] = [deque() for _ in range(S)]
    busy = np.zeros(S, np.int64)
    busy_us = np.zeros(S, np.float64)
    completion = np.full(nq, -1.0)
    failed = np.zeros(nq, bool)
    n_waits = 0
    wait_us = 0.0

    # per-query coordinator barrier: a routing-table direct hit skips it
    coord_barrier = np.full(nq, model.coordinator_us, np.float64)
    roots_all = _query_roots(pathset) if routing_table is not None else None
    chaos_log: list[tuple[float, str, int]] = []

    # --- batched dispatch plane state ------------------------------------
    # admission: per-variant jitter-free floors + wall-clock deadlines
    query_shed = np.zeros(nq, bool) if admission is not None else None
    deadlines = floors = None
    if admission is not None:
        deadlines = admission.deadlines(slo, model, pathset)
        floors = [_tree_floors(v) for v in variants_trees]
    # batching: per-server pending lists awaiting a window flush
    pending: list[list] = [[] for _ in range(S)] if batching is not None else []
    batch_stats = BatchStats() if batching is not None else None
    obs_batch_hist = (
        obs.REGISTRY.histogram("repro.serve.batch_occupancy")
        if batching is not None and obs.enabled()
        else None
    )
    # hedging: fired flags + win/cancel accounting
    hedge_fired = np.zeros(nq, bool) if hedge is not None else None
    hedges_fired = 0
    hedge_wins = 0
    hedges_cancelled = 0

    # a "job" is one access-tree node instance of one (query, variant)
    # launch: job = (query, variant, node_idx, server, base_service_us,
    # object, t_dispatch), with (server, base) resolved at dispatch time —
    # from the precomputed tree in the static modes, from the live queue
    # state under hop feedback; per-(query, variant) remaining-node
    # counters decide completion (all accesses done = slowest chain done).
    remaining: dict[tuple[int, int], int] = {}

    heap: list[tuple[float, int, str, object]] = []
    seq = 0
    reroutes = 0

    def push(t, kind, data):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, data))
        seq += 1

    def jitter():
        return rng.lognormal(0.0, model.jitter_sigma)

    def resolve(q, v, i, parent):
        """(server, base_service_us, object) of one access.

        ``parent`` is the landing server of the node's parent (-2 for a
        root).  Static modes read the precomputed tree node; hop
        feedback applies Eqn 1 live: local at the parent's server when a
        copy is there, otherwise the least-loaded alive holder by the
        instantaneous busy+queued depth (home wins ties).
        """
        nonlocal reroutes
        node = variants_trees[v][q][0][i]
        if not hop_feedback:
            return node[0], node[1], node[2]
        obj = node[0]
        if parent == -2:
            return int(fo_home[obj]), model.local_us, obj
        if parent >= 0 and mask_alive[obj, parent]:
            return parent, model.local_us, obj
        live = np.asarray(
            [busy[s] + len(queues[s]) for s in range(S)], np.float64
        )
        reroutes += 1
        return (
            pick_holder_host(mask_alive[obj], int(fo_home[obj]), live),
            model.remote_us,
            obj,
        )

    # span staging: a flat stride-3 list of job, t_start, t_end — the job
    # tuple already carries (query, variant, node, server, base, object,
    # t_dispatch), so recording a span is three appends of objects that
    # already exist (zero allocation, zero garbage) through a pre-bound
    # method; the Tracer groups, decodes, and samples lazily, off the
    # run's clock
    t_stage = trace.begin_run(nq).append if trace is not None else None

    def start_service(t, s, job):
        busy[s] += 1
        if job[0] == "batch":
            # one concurrency slot serves the whole batch: the members'
            # summed base cost plus a SINGLE amortized dispatch overhead
            # (per-query mode pays dispatch_us once per access)
            svc = job[3] * jitter()
            busy_us[s] += svc
            te = t + svc
            if t_stage is not None:
                for m in job[2]:
                    t_stage(m)
                    t_stage(t)
                    t_stage(te)
            push(te, "done", (s, job))
            return
        svc = (job[4] + model.dispatch_us) * jitter()
        busy_us[s] += svc
        te = t + svc
        if t_stage is not None:
            t_stage(job)
            t_stage(t)
            t_stage(te)
        push(te, "done", (s, job))

    def dispatch(t, q, v, i, parent):
        if query_shed is not None and query_shed[q]:
            return
        if hedge is not None and completion[q] >= 0:
            return
        s, base, obj = resolve(q, v, i, parent)
        job = (q, v, i, s, base, obj, t)
        if s < 0:
            # no alive copy anywhere: degraded completion, no queueing
            if hop_feedback:
                failed[q] = True
            push(t + model.remote_us, "advance", job)
            return
        if query_shed is not None and completion[q] < 0:
            # remaining slack check at every hop: elapsed sojourn plus
            # the subtree's jitter-free floor plus the barrier
            if (
                (t - arrivals_us[q]) + floors[v][q][1][i]
                + model.coordinator_us > deadlines[q]
            ):
                shed_query(q, t)
                return
        if batching is not None:
            pend = pending[s]
            pend.append(job)
            if len(pend) == 1:
                # first pending access arms the server's window
                push(t + batching.window_us, "flush", s)
            return
        if busy[s] < concurrency:
            start_service(t, s, job)
        else:
            queues[s].append((t, job))

    next_ci = 0
    cur_variant = 0
    since_reroute = 0
    think = float(think_time_us)

    def client_next(q, t_free):
        nonlocal next_ci
        if closed and is_closed[q] and next_ci < len(closed_ids):
            # the freed client thinks, then issues the next query
            delay = rng.exponential(think) if think > 0 else 0.0
            push(t_free + delay, "arrive", int(closed_ids[next_ci]))
            next_ci += 1

    def complete(q, t, v=0):
        nonlocal hedge_wins
        completion[q] = t + coord_barrier[q]
        if hedge is not None:
            tid = int(tenant_of[q]) if tenant_of is not None else 0
            hedge.observe(tid, completion[q] - arrivals_us[q])
            if hedge_fired[q] and v == 1:
                hedge_wins += 1
        client_next(q, completion[q])

    def shed_query(q, t):
        # fail-fast: the query completes degraded at the shed instant;
        # nothing below it dispatches, queued work is skipped at pop,
        # and a closed-loop client is freed to issue its next query
        query_shed[q] = True
        completion[q] = t
        client_next(q, t)

    def skip_job(job, t):
        """Lazily drop queued work that no longer needs serving."""
        nonlocal hedges_cancelled
        if job[0] == "batch":
            return False  # batch cost was committed at flush time
        q = job[0]
        if query_shed is not None:
            if query_shed[q]:
                return True
            if completion[q] < 0 and (
                (t - arrivals_us[q]) + floors[job[1]][q][1][job[2]]
                + model.coordinator_us > deadlines[q]
            ):
                # the FIFO wait ate the slack: shed at pop time
                shed_query(q, t)
                return True
        if hedge is not None and completion[q] >= 0:
            hedges_cancelled += 1
            return True
        return False

    def advance(t, job):
        nonlocal hedges_cancelled
        q, v, i, s = job[0], job[1], job[2], job[3]
        shed_q = query_shed is not None and query_shed[q]
        won = hedge is not None and completion[q] >= 0 and not shed_q
        if shed_q or won:
            # cancellation-on-first-completion / fail-fast: the subtree
            # below a dead attempt never dispatches (the router's
            # unconditional ``hedged`` mode keeps racing both — hedging's
            # capacity price — only the SLO-driven policy cancels)
            if won:
                hedges_cancelled += len(variants_trees[v][q][0][i][-1])
        else:
            for child in variants_trees[v][q][0][i][-1]:
                dispatch(t, q, v, child, s)
        remaining[(q, v)] -= 1
        if remaining[(q, v)] == 0 and completion[q] < 0:
            complete(q, t, v)

    def launch(t, q, v):
        """Dispatch one (query, variant); False = refused by admission."""
        if query_shed is not None:
            if query_shed[q]:
                return False
            if completion[q] < 0 and (
                (t - arrivals_us[q]) + floors[v][q][0]
                + model.coordinator_us > deadlines[q]
            ):
                return False
        nodes, roots = variants_trees[v][q]
        remaining[(q, v)] = len(nodes)
        if not nodes:
            if completion[q] < 0:
                complete(q, t, v)
            return True
        for i in roots:
            dispatch(t, q, v, i, -2)
        return True

    if closed:
        for _ in range(min(int(clients), len(closed_ids))):
            push(0.0, "arrive", int(closed_ids[next_ci]))
            next_ci += 1
        if mixed:
            for q in open_ids:
                push(float(arrivals_us[q]), "arrive", int(q))
    else:
        for q in range(nq):
            push(float(arrivals_us[q]), "arrive", q)
    if chaos:
        for ev in chaos:
            push(float(ev.at_us), "chaos", ev)

    arrivals_left = nq
    arrived_flag = np.zeros(nq, bool)
    qids_all = np.asarray(pathset.query_ids)
    live_depth = np.zeros(S, np.int64)
    live_busy = np.zeros(S, np.int64)

    def reroute_pending(live):
        """Re-pick hop targets for the queries that have NOT arrived yet.

        Already-arrived queries keep their old variant (in-flight work
        never re-routes), so each rebuild traces only the shrinking
        pending suffix instead of the whole pathset.
        """
        pending = np.nonzero(~arrived_flag)[0]
        vt: list = [([], [])] * nq
        vd = np.zeros(nq, bool)
        if len(pending):
            idx = np.nonzero(~arrived_flag[qids_all])[0]
            sub = PathSet(
                np.asarray(pathset.objects)[idx],
                np.asarray(pathset.lengths)[idx],
                np.searchsorted(pending, qids_all[idx]).astype(np.int32),
            )
            vt_sub, vd_sub = _build_variant(
                sub, cluster, model, alive, None, hop_policy, live,
                dev, backend,
            )
            for li, g in enumerate(pending[: len(vt_sub)]):
                vt[int(g)] = vt_sub[li]
                vd[int(g)] = bool(vd_sub[li])
        variants_trees.append(vt)
        variants_dead.append(vd)
        if floors is not None:
            floors.append(_tree_floors(vt))
        return len(variants_trees) - 1

    while heap:
        t, _, kind, data = heapq.heappop(heap)
        if kind == "arrive":
            q = data
            if closed and is_closed[q]:
                arrivals_us[q] = t
            arrivals_left -= 1
            if arrivals_left == 0:
                # snapshot queueing state while traffic is still in flight
                # (the drained end state is always empty) — this is what
                # Cluster.queue_depths() hands the router between batches
                live_depth = np.asarray([len(qu) for qu in queues], np.int64)
                live_busy = busy.copy()
            if reroute_every is not None:
                since_reroute += 1
                if since_reroute >= int(reroute_every):
                    # re-pick hop targets against the simulator's own live
                    # queue state; the arriving query is still pending, so
                    # it launches on the fresh routes
                    since_reroute = 0
                    reroutes += 1
                    live = np.asarray(
                        [busy[s] + len(queues[s]) for s in range(S)],
                        np.int64,
                    )
                    cur_variant = reroute_pending(live)
            arrived_flag[q] = True
            if routing_table is not None:
                # client-side snapshot lookup: a live-valid pick goes
                # direct-to-shard and skips the coordinator barrier
                _, direct = routing_table.lookup(int(roots_all[q]), t)
                if direct:
                    coord_barrier[q] = 0.0
            if coord_policy == "hedged":
                # race both coordinator picks; first completion wins
                ok0 = launch(t, q, 0)
                ok1 = launch(t, q, 1) if coords[1][q] >= 0 else False
                if ok0 or ok1:
                    d0 = bool(variants_dead[0][q]) if ok0 else True
                    d1 = bool(variants_dead[1][q]) if ok1 else True
                    failed[q] = d0 and d1
                elif completion[q] < 0:
                    shed_query(q, t)
            elif coord_policy == "hedge_slo":
                # primary only; the backup fires from a learned-quantile
                # timer if the query is still incomplete by then
                if launch(t, q, 0):
                    failed[q] = variants_dead[0][q]
                    if coords[1][q] >= 0:
                        tid = (
                            int(tenant_of[q]) if tenant_of is not None else 0
                        )
                        th = hedge.threshold_us(tid)
                        if th is not None:
                            push(t + th, "hedge", q)
                elif completion[q] < 0:
                    shed_query(q, t)
            elif coord_policy == "replica_lb":
                # queue-aware: per arrival, the less-loaded coordinator
                c1, c2 = int(coords[0][q]), int(coords[1][q])
                v = 0
                if c2 >= 0 and c1 >= 0:
                    l1 = busy[c1] + len(queues[c1])
                    l2 = busy[c2] + len(queues[c2])
                    v = 1 if l2 < l1 else 0
                if launch(t, q, v):
                    failed[q] = variants_dead[v][q]
                elif completion[q] < 0:
                    shed_query(q, t)
            else:
                if launch(t, q, cur_variant):
                    # OR, not assignment: a hop-feedback launch may already
                    # have flagged the query dead at dispatch time
                    failed[q] = failed[q] or bool(
                        variants_dead[cur_variant][q]
                    )
                elif completion[q] < 0:
                    shed_query(q, t)
        elif kind == "done":
            s, job = data
            busy[s] -= 1
            while queues[s]:
                t_enq, nxt = queues[s].popleft()
                if skip_job(nxt, t):
                    continue
                n_waits += 1
                wait_us += t - t_enq
                start_service(t, s, nxt)
                break
            if job[0] == "batch":
                for m in job[2]:
                    advance(t, m)
            else:
                advance(t, job)
        elif kind == "flush":
            s = data
            pend = pending[s]
            if not pend:
                continue
            live = [j for j in pend if not skip_job(j, t)]
            take = batching.ladder.pick(len(live)) if live else 0
            members = live[:take]
            pending[s] = live[take:]
            if pending[s]:
                # leftovers flush immediately at the next ladder rung —
                # a deep backlog drains in rung-sized chunks without
                # re-arming the collection window
                push(t, "flush", s)
            if not members:
                continue
            total = model.dispatch_us + sum(j[4] for j in members)
            wrapper = ("batch", s, tuple(members), total)
            batch_stats.observe(len(members))
            if obs_batch_hist is not None:
                obs_batch_hist.record(float(len(members)))
            if busy[s] < concurrency:
                start_service(t, s, wrapper)
            else:
                queues[s].append((t, wrapper))
        elif kind == "hedge":
            q = data
            if completion[q] >= 0 or (
                query_shed is not None and query_shed[q]
            ):
                continue  # completed (or shed) before the timer: no hedge
            if hedges_fired >= hedge.max_hedges_frac * nq:
                continue  # capacity guard
            if launch(t, q, 1):
                hedges_fired += 1
                hedge_fired[q] = True
                failed[q] = failed[q] and bool(variants_dead[1][q])
        elif kind == "chaos":
            ev = data
            want = ev.kind == "revive"
            if alive[ev.server] != want:
                alive[ev.server] = want
                cluster.servers[ev.server].alive = want
                chaos_log.append((t, ev.kind, ev.server))
                if hop_feedback:
                    # next dispatch routes around the loss immediately
                    mask_alive = cluster.scheme.mask & alive[None, :]
                    fo_home = failover_home(cluster.scheme, alive)
                else:
                    # pending (not-yet-arrived) queries re-trace against
                    # the new liveness; in-flight work keeps its routes
                    live = np.asarray(
                        [busy[s] + len(queues[s]) for s in range(S)],
                        np.int64,
                    )
                    cur_variant = reroute_pending(live)
        else:  # "advance" (degraded hop completion)
            job = data
            if t_stage is not None and job[3] < 0:
                # no alive copy: the hop "served" nowhere — the span keeps
                # server -1 so the trace still accounts the lost time
                t_stage(job)
                t_stage(job[6])
                t_stage(t)
            advance(t, job)

    done = completion >= 0
    assert done.all(), "simulator leaked queries"
    duration = float(completion.max() - arrivals_us.min()) if nq else 0.0

    # expose the in-flight queueing state (sampled at the last arrival)
    # through the cluster's queue-aware hooks
    for s in cluster.servers:
        s.queue_depth = int(live_depth[s.server_id])
        s.busy = int(live_busy[s.server_id])

    if trace is not None:
        trace.policy = hop_policy.name
        # hand over the verdict arrays; decoding, per-query finalize, and
        # head/ring/violator sampling all happen lazily on first access,
        # so none of it is billed to the simulated run's wall clock
        trace.end_run(arrivals_us, completion, tenant_of, failed,
                      model.local_us, shed=query_shed)
    if obs.enabled():
        obs.REGISTRY.histogram("repro.serve.latency_us").record_many(
            completion - arrivals_us
        )
        obs.REGISTRY.counter("repro.serve.queries").inc(nq)
        obs.REGISTRY.counter("repro.serve.reroutes").inc(reroutes)
        obs.REGISTRY.gauge("repro.serve.mean_queue_wait_us").set(
            wait_us / n_waits if n_waits else 0.0
        )
        if query_shed is not None:
            obs.REGISTRY.counter("repro.serve.shed").inc(
                int(query_shed.sum())
            )
        if hedge is not None:
            obs.REGISTRY.counter("repro.serve.hedges_fired").inc(
                hedges_fired
            )
            obs.REGISTRY.counter("repro.serve.hedge_wins").inc(hedge_wins)

    return SimReport(
        latency_us=completion - arrivals_us,
        arrival_us=arrivals_us,
        query_failed=failed,
        busy_us=busy_us,
        queue_wait_us=wait_us / n_waits if n_waits else 0.0,
        duration_us=duration,
        offered_qps=0.0 if closed else rate_qps,
        concurrency=concurrency,
        tenant_of=tenant_of,
        tenant_names=tenant_names,
        closed_loop=closed,
        n_clients=int(clients or 0),
        policy=hop_policy.name,
        reroutes=reroutes,
        hop_feedback=hop_feedback,
        query_shed=query_shed,
        closed_mask=is_closed if mixed else None,
        batch_stats=batch_stats,
        slo_hedging=hedge is not None,
        hedges_fired=hedges_fired,
        hedge_wins=hedge_wins,
        hedges_cancelled=hedges_cancelled,
        chaos_events=chaos_log,
        routing=routing_table.summary() if routing_table is not None else None,
    )
