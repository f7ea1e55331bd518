"""Adaptive replication controller: close the loop around the greedy core.

The paper's algorithm is offline — analyze the workload, replicate once,
serve.  Under drift the hotspot moves and the scheme silently stops being
feasible; rebuilding from scratch re-prices every path and re-ships the
whole replica set.  This controller instead watches **per-tenant sliding
windows** of served queries and, on violation, repairs *incrementally*:

  1. **monitor** — every completed batch feeds per-query traversal counts
     (from the resident ``LatencyEngine``, one streamed evaluation) and,
     when available, simulated wall-clock latencies into each tenant's own
     window; each query is judged against *its own* budget t_Q (an
     ``SLOSpec``, scalar config broadcast as the degenerate case).  The
     trigger is per tenant: a feasibility violation (> ``violation_frac``
     of the tenant's windowed queries exceed their t_Q) or that tenant's
     wall-clock p99 SLO breach;
  2. **arbitrate** — when several tenants trigger in the same step *and*
     capacity / load-balance headroom is finite, their repairs compete for
     the same bytes: the tenant with the cheapest estimated *weighted*
     marginal-bytes-per-violation (estimated bytes divided by
     ``TenantSpec.weight``, so paying tenants outrank) wins this round,
     the losers are *deferred* (named in the report; their windows still
     violate, so they re-trigger on a later step — and a deferred tenant
     outranks any weight on the next contended round, so low-weight
     tenants cannot starve).  With unbounded headroom all triggered
     tenants repair together in one vector-budget pass;
  3. **repair** — the *violating paths observed in the windows* (a tiny
     delta, not the workload) go through
     :func:`repro_torch.core.greedy.replicate_delta` with their per-path budget
     vector: the batched Alg 2 UPDATE warm-started against the engine's
     device-resident ``PackedScheme`` (bit-tests + scatter-OR adds, no
     rebuild, sound by Thm 5.3);
  4. **apply** — the returned (object, server) delta lands on the live
     ``Cluster`` via ``apply_scheme_delta`` (monotone mask flips) and its
     resharding-map entries are recorded, so later reshards still work;
  5. **evict** — when storage pressure exceeds capacity, replicas that
     have been cold (untouched by any windowed path) for
     ``demote_after`` *consecutive eviction checks* — demotion
     hysteresis, preventing add/evict thrash on an oscillating hotspot —
     *and* are unreferenced by the §5.4 resharding map (RC == 0) are
     dropped, largest first, until the cluster fits.  Eviction re-packs
     the engine (removals are not monotone).

The controller never blocks serving: observe() is one engine evaluation
plus (rarely) one warm-started greedy pass over a few hundred paths.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.core.greedy import replicate_delta
from repro_torch.core.paths import PathSet
from repro_torch.core.reshard import ReshardingMap
from repro_torch.core.slo import SLOSpec, TenantSpec
from repro_torch.distsys.cluster import Cluster
from repro_torch.engine import KResilient, LatencyEngine
from repro_torch.obs import attribute_burn


@dataclasses.dataclass
class ControllerConfig:
    t: int | None = None                    # scalar budget (single-tenant)
    window: int = 1024                      # queries kept per tenant window
    violation_frac: float = 0.01            # windowed infeasible-query frac
    p99_slo_us: float | None = None         # wall-clock p99 SLO fallback
    capacity: np.ndarray | float | None = None
    epsilon: float | None = None
    min_queries: int = 64                   # don't trigger on tiny windows
    demote_after: int = 1                   # consecutive cold checks before
    #                                         a replica may be evicted
    tenants: tuple[TenantSpec, ...] = ()    # known tenants (budgets + SLOs)
    # per-tenant cap on cumulative repair bytes: a scalar applies to every
    # tenant, a dict maps tenant name -> cap (missing names are uncapped).
    # The cap shapes *arbitration*, not repair itself: on a contended round
    # a tenant over its quota ranks behind every under-quota competitor,
    # so one tenant's runaway hotspot cannot monopolize the shared
    # capacity/epsilon headroom round after round.  Aging still dominates —
    # a tenant deferred for >= ``quota_grace`` consecutive steps is
    # "starving" and wins the round outright even over quota, so a capped
    # tenant with a persistent violation is delayed, never denied.
    tenant_quota_bytes: float | dict | None = None
    quota_grace: int = 3                    # deferred steps before starving
    # routing policy h is scored under for triggers / window re-checks
    # AND the policy repairs are priced under (replicate_delta(policy=)):
    # "home_first" (historical) or "nearest_copy" (the paper-faithful
    # any-co-located-replica reading — tighter, so fewer false triggers
    # and no bytes bought for paths the routed walk already serves)
    score_policy: str = "home_first"
    # route window evaluations (observe() scoring + post-repair window
    # re-checks) through the engine's persistent dirty-set cache
    # (``path_latencies(incremental=True)``): after a repair, only the
    # windowed paths touching the delta's objects are re-walked.
    # Bit-identical to full re-evaluation; off reproduces the historical
    # evaluate-everything profile
    incremental_recheck: bool = True

    def __post_init__(self):
        if self.t is None and not self.tenants:
            raise ValueError("ControllerConfig needs a scalar t or tenants")

    def default_slo(self, n_queries: int) -> SLOSpec:
        """Spec for batches observed without an explicit SLOSpec."""
        if self.t is not None:
            return SLOSpec.uniform(
                self.t, n_queries, tenant="default",
                p99_slo_us=self.p99_slo_us,
            )
        if len(self.tenants) == 1:
            return SLOSpec.from_tenants(
                self.tenants, np.zeros(n_queries, np.int32)
            )
        raise ValueError(
            "multi-tenant config: observe() needs the batch's SLOSpec"
        )


@dataclasses.dataclass
class AdaptationReport:
    """What one repair did (the benchmark's bytes-replicated accounting)."""

    step: int
    trigger: str          # "feasibility" | "p99_slo" | "forecast" | "liveness"
    paths_repaired: int
    replicas_added: int
    bytes_added: float
    replicas_evicted: int
    bytes_evicted: float
    feasible_after: bool
    runtime_s: float
    tenants: tuple[str, ...] = ("default",)   # whose violations were repaired
    deferred: tuple[str, ...] = ()            # arbitration losers this round
    additions: tuple[np.ndarray, np.ndarray] = dataclasses.field(
        default=(np.zeros(0, np.int64), np.zeros(0, np.int64)), repr=False
    )
    # why the repair triggered, per repaired tenant: burn rate over the
    # traced window plus the per-server blame decomposition (which server's
    # queues ate the violators' budgets) — present when observe() was
    # handed the serving run's span trace
    blame: dict | None = None


@dataclasses.dataclass
class _Entry:
    """One observed batch, restricted to one tenant's paths/queries."""

    pathset: PathSet          # tenant's paths (batch-local query ids)
    path_lats: np.ndarray     # int32 per path
    path_budgets: np.ndarray  # int32 per path (each path's own t_q)
    n_queries: int            # tenant queries in the batch
    n_bad: int                # tenant queries whose l_Q exceeded their t_Q
    latency_us: np.ndarray | None  # tenant queries' wall-clock latencies


@dataclasses.dataclass
class _TenantWindow:
    spec: TenantSpec
    entries: deque = dataclasses.field(default_factory=deque)
    n_queries: int = 0
    last_seen_step: int = 0     # step of the newest observed entry
    last_repair_step: int = -1  # step this tenant was last repaired at

    def violation_frac(self) -> float:
        if not self.n_queries:
            return 0.0
        return sum(e.n_bad for e in self.entries) / self.n_queries

    def p99_us(self) -> float | None:
        lats = [e.latency_us for e in self.entries if e.latency_us is not None]
        if not lats:
            return None
        return float(np.percentile(np.concatenate(lats), 99.0))


def evict_cold_replicas(
    cluster: Cluster,
    rmap: ReshardingMap,
    active_objects: np.ndarray,
    f: np.ndarray | None = None,
    capacity: np.ndarray | float | None = None,
    cold_streak: dict[tuple[int, int], int] | None = None,
    min_streak: int = 1,
) -> tuple[int, float]:
    """Drop cold, RM-unreferenced replicas until every server fits.

    Cost-aware in the §5.4 sense: only replicas with ``RC(v, s) == 0`` are
    candidates — the resharding map holds no association that would have to
    be re-transferred after an original-copy move — and originals and
    window-active objects are never touched.  Within a server, largest
    ``f(v)`` goes first (frees the most bytes per eviction).

    ``cold_streak`` adds demotion hysteresis: a replica is only eligible
    once it has been observed cold ``min_streak`` consecutive times (the
    controller maintains the streak counters); evicted pairs are removed
    from the dict.  Without it every cold replica is immediately eligible
    (the pre-hysteresis behavior).
    """
    scheme = cluster.scheme
    if capacity is None:
        return 0, 0.0
    fv = (
        np.ones(scheme.n_objects, np.float64)
        if f is None
        else np.asarray(f, np.float64)
    )
    cap = np.broadcast_to(
        np.asarray(capacity, np.float64), (scheme.n_servers,)
    )
    load = scheme.storage_per_server(fv)
    active = np.zeros(scheme.n_objects, bool)
    active[np.asarray(active_objects, np.int64)] = True
    n_evicted = 0
    bytes_evicted = 0.0
    for s in np.argsort(-(load - cap)):
        if load[s] <= cap[s]:
            continue
        cands = np.nonzero(
            scheme.mask[:, s] & (scheme.shard != s) & ~active
        )[0]
        cands = [
            int(v) for v in cands if rmap.rc.get((int(v), int(s)), 0) == 0
        ]
        if cold_streak is not None:
            cands = [
                v for v in cands
                if cold_streak.get((v, int(s)), 0) >= min_streak
            ]
        cands.sort(key=lambda v: -fv[v])
        for v in cands:
            if load[s] <= cap[s]:
                break
            scheme.mask[v, s] = False
            load[s] -= fv[v]
            n_evicted += 1
            bytes_evicted += float(fv[v])
            if cold_streak is not None:
                cold_streak.pop((v, int(s)), None)
    return n_evicted, bytes_evicted


class AdaptiveController:
    """Per-tenant sliding-window monitor + incremental repair over a live
    cluster.

    The controller shares the cluster's ``ReplicationScheme`` object with
    its ``LatencyEngine``, so the engine's device-resident packed words,
    the host mask, and the cluster's routing state stay one source of
    truth: warm-start additions scatter-OR into the packed words and flip
    the same host mask the router reads.

    Each observed batch may carry its own :class:`SLOSpec` (per-query
    budgets + query->tenant map); without one the config's scalar ``t``
    broadcasts to a single "default" tenant — the degenerate case that
    reproduces the original scalar controller exactly.

    Without ``engine`` the controller builds ``LatencyEngine(
    cluster.scheme, device=device, backend=backend)``: ``device`` defaults
    to ``"cuda"`` (without a card it raises unless ``device="cpu"``) and
    ``backend`` to ``kernel`` there, ``torch`` on the CPU.  An explicit
    ``engine`` carries its own device and backend.  The repairs
    (``replicate_delta``) run their gates and UPDATE batches on the
    engine's backend; the window re-checks go through its incremental
    cache (``path_latency`` / ``routed_walk`` / ``scored_walk`` launches
    on ``kernel``).
    """

    def __init__(
        self,
        cluster: Cluster,
        config: ControllerConfig,
        f: np.ndarray | None = None,
        engine: LatencyEngine | None = None,
        rmap: ReshardingMap | None = None,
        device=None,
        backend: str | None = None,
    ):
        self.cluster = cluster
        self.config = config
        self.f = None if f is None else np.asarray(f, np.float32)
        if engine is None:
            engine = LatencyEngine(cluster.scheme, backend=backend, device=device)
        self.engine = engine
        assert self.engine.scheme is cluster.scheme, (
            "controller engine must wrap the cluster's live scheme"
        )
        self.rmap = rmap or ReshardingMap({}, {})
        self._tenants: dict[str, _TenantWindow] = {}
        # demotion hysteresis: (object, server) -> consecutive cold checks
        self._cold_streak: dict[tuple[int, int], int] = {}
        # arbitration aging: tenant -> step it was first deferred at; a
        # deferred tenant wins the next contended round outright (oldest
        # first), so a persistently-cheap tenant can't starve the rest
        self._deferred_since: dict[str, int] = {}
        # cumulative repair bytes attributed per tenant (quota accounting)
        self._tenant_bytes: dict[str, float] = {}
        self.step = 0
        self.reports: list[AdaptationReport] = []

    # -- monitoring --------------------------------------------------------
    def window_feasible_frac(self) -> float:
        """1 - fraction of windowed queries exceeding their t_Q (all
        tenants pooled; diagnostics)."""
        total = sum(w.n_queries for w in self._tenants.values())
        if not total:
            return 1.0
        bad = sum(
            e.n_bad for w in self._tenants.values() for e in w.entries
        )
        return 1.0 - bad / total

    def tenant_stats(self) -> dict[str, dict]:
        """Per-tenant window diagnostics (violation frac, p99, size)."""
        return {
            name: {
                "violation_frac": w.violation_frac(),
                "p99_us": w.p99_us(),
                "window_queries": w.n_queries,
                "t_q": w.spec.t_q,
                "repair_bytes": self._tenant_bytes.get(name, 0.0),
                "quota_bytes": self._quota_of(name),
            }
            for name, w in self._tenants.items()
        }

    def _quota_of(self, name: str) -> float | None:
        q = self.config.tenant_quota_bytes
        if q is None:
            return None
        if isinstance(q, dict):
            v = q.get(name)
            return None if v is None else float(v)
        return float(q)

    def _over_quota(self, name: str) -> bool:
        cap = self._quota_of(name)
        return cap is not None and self._tenant_bytes.get(name, 0.0) >= cap

    def _window_of(self, spec: TenantSpec) -> _TenantWindow:
        w = self._tenants.get(spec.name)
        if w is None:
            w = _TenantWindow(spec=spec)
            self._tenants[spec.name] = w
        else:
            w.spec = spec  # newest spec wins (budgets may be re-tuned live)
        return w

    def observe(
        self,
        pathset: PathSet,
        latency_us: np.ndarray | None = None,
        slo: SLOSpec | None = None,
        trace=None,
        forecast: PathSet | None = None,
        forecast_slo: SLOSpec | None = None,
    ) -> AdaptationReport | None:
        """Feed one served batch; repair and return a report on violation.

        ``pathset`` is the batch's observed access paths (what the serving
        layer routed); ``latency_us`` the simulator's per-query sojourn
        times for the optional wall-clock SLO trigger; ``slo`` the batch's
        per-query budgets + tenant map (defaults to the config's scalar
        ``t`` under a single "default" tenant); ``trace`` the serving
        run's :class:`repro_torch.obs.Tracer` — when given, a repair's report
        carries ``blame``: per repaired tenant, the SLO burn rate and the
        per-server decomposition of where the violators' budgets went.

        ``forecast`` is a PathSet delta the caller expects to start
        serving soon (e.g. the next :class:`~repro_torch.serve.drift.PhaseDelta`
        observed upstream before its violations land): the controller
        *pre-warms* a repair for the forecast paths that are already over
        budget under the live scheme, so the phase flip arrives against a
        scheme provisioned for it.  Cheap by construction — the forecast's
        dirty set is small, and the warm-started delta pass prices only
        its infeasible paths.  ``forecast_slo`` carries the forecast's
        budgets (defaults like ``slo``).  A reactive repair, if one also
        triggered this step, takes precedence in the returned report; the
        forecast report is appended to :attr:`reports` either way.
        """
        self.step += 1
        slo = slo if slo is not None else self.config.default_slo(
            pathset.n_queries
        )
        assert slo.n_queries == pathset.n_queries
        pl = self.engine.path_latencies(
            pathset, policy=self.config.score_policy,
            incremental=self.config.incremental_recheck,
        )
        qids = np.asarray(pathset.query_ids)
        ql = self.engine.query_latencies(pathset, pl)
        bad_q = ql > slo.t_q  # each query vs its OWN budget
        t_path = slo.t_q[qids] if len(qids) else np.zeros(0, np.int32)

        for tid, ts in enumerate(slo.tenants):
            q_sel = slo.tenant_of == tid
            if not q_sel.any():
                continue
            p_sel = q_sel[qids] if len(qids) else np.zeros(0, bool)
            p_idx = np.nonzero(p_sel)[0]
            w = self._window_of(ts)
            w.entries.append(
                _Entry(
                    # single-tenant batches (the degenerate case) are kept
                    # by reference, not copied
                    pathset=(
                        pathset if p_sel.all() else pathset.select(p_idx)
                    ),
                    path_lats=pl if p_sel.all() else pl[p_idx],
                    path_budgets=(
                        t_path if p_sel.all() else t_path[p_idx]
                    ),
                    n_queries=int(q_sel.sum()),
                    n_bad=int(bad_q[q_sel].sum()),
                    latency_us=(
                        np.asarray(latency_us)[q_sel]
                        if latency_us is not None
                        else None
                    ),
                )
            )
            w.n_queries += int(q_sel.sum())
            w.last_seen_step = self.step
            while w.n_queries > self.config.window and len(w.entries) > 1:
                w.n_queries -= w.entries.popleft().n_queries

        triggered = self._triggered_tenants()
        # a deferral only keeps its aging claim while the tenant's
        # violation persists — if it cleared on its own (e.g. another
        # tenant's repair covered the shared paths), the stale entry must
        # not grant arbitration priority on some much later round
        names = {name for name, _ in triggered}
        self._deferred_since = {
            k: v for k, v in self._deferred_since.items() if k in names
        }
        if not triggered:
            if forecast is not None:
                return self._prewarm(forecast, forecast_slo)
            return None

        contended = (
            self.config.capacity is not None
            or self.config.epsilon is not None
        ) and len(triggered) > 1
        if contended:
            # arbitration: repairs compete for the same capacity/epsilon
            # headroom — cheapest estimated *weighted* marginal-byte-per-
            # violation wins this round (estimated bytes / tenant weight,
            # so a paying tenant's violations buy proportionally more
            # bytes), everyone else is deferred (their windows still
            # violate, so they re-trigger on a later observe()).  Quota
            # caps rank an over-budget tenant behind every under-quota
            # competitor; aging breaks starvation two ways: a *starving*
            # tenant (deferred >= quota_grace consecutive steps) wins the
            # round outright — even over quota — and among the rest an
            # earlier deferral outranks any weight or score.
            scored = sorted(
                (
                    not (
                        self.step
                        - self._deferred_since.get(name, self.step)
                        >= self.config.quota_grace
                    ),
                    self._over_quota(name),
                    self._deferred_since.get(name, self.step),
                    self._repair_score(name)
                    / self._tenants[name].spec.weight,
                    name,
                    trig,
                )
                for name, trig in triggered
            )
            repair = [(scored[0][4], scored[0][5])]
            deferred = tuple(name for *_, name, _ in scored[1:])
            for name in deferred:
                self._deferred_since.setdefault(name, self.step)
        else:
            repair = triggered
            deferred = ()
        for name, _ in repair:
            self._deferred_since.pop(name, None)
        report = self._adapt(repair, deferred)
        if trace is not None:
            burn = attribute_burn(
                trace,
                tenant_names=tuple(ts.name for ts in slo.tenants),
                allowed_frac=self.config.violation_frac,
            )
            report.blame = {
                name: burn[name].summary()
                for name in report.tenants
                if name in burn.tenants
            }
        if forecast is not None:
            # the reactive repair ran first; the pre-warm tops it up for
            # the forecast paths it did not cover (and is a cheap no-op
            # when the forecast is already feasible)
            self._prewarm(forecast, forecast_slo)
        return report

    def _triggered_tenants(self) -> list[tuple[str, str]]:
        out = []
        for name, w in self._tenants.items():
            if w.n_queries < self.config.min_queries:
                continue
            # a repair attempt (even one that couldn't fix anything, e.g.
            # fully capacity-blocked) re-arms only on NEW evidence for this
            # tenant — otherwise an unrepairable window would re-fire a
            # full no-op repair on every later observe() of anyone's
            # traffic (the old global window aged such entries out)
            if w.last_seen_step <= w.last_repair_step:
                continue
            if w.violation_frac() > self.config.violation_frac:
                out.append((name, "feasibility"))
                continue
            p99_slo = (
                w.spec.p99_slo_us
                if w.spec.p99_slo_us is not None
                else self.config.p99_slo_us
            )
            if p99_slo is not None:
                p99 = w.p99_us()
                if p99 is not None and p99 > p99_slo:
                    out.append((name, "p99_slo"))
        return out

    # -- repair ------------------------------------------------------------
    def _violating(self, name: str):
        """(violating-path PathSets, per-part per-path budgets) of a tenant."""
        parts, budgets = [], []
        for e in self._tenants[name].entries:
            idx = np.nonzero(e.path_lats > e.path_budgets)[0]
            if len(idx):
                parts.append(e.pathset.select(idx))
                budgets.append(e.path_budgets[idx])
        return parts, budgets

    def _repair_score(self, name: str) -> float:
        """Estimated marginal bytes per violating query (arbitration key).

        Upper-bound estimate, priced against the engine's device-resident
        snapshot: replicate every non-root object of each violating path
        to the path's coordinator (the root's home server) — the t=0-style
        candidate that dominates all of Alg 2's cheaper merges.
        """
        parts, _ = self._violating(name)
        if not parts:
            return float("inf")
        shard = self.engine.host_shard()
        est = 0.0
        n_viol = 0
        for part in parts:
            tails = np.asarray(part.objects[:, 1:], np.int32)
            if tails.size == 0:
                continue
            root_home = shard[np.maximum(part.objects[:, 0], 0)]
            srv = np.broadcast_to(root_home[:, None], tails.shape)
            est += float(
                np.sum(self.engine.margin_costs(tails, srv, self.f))
            )
            n_viol += int(np.unique(np.asarray(part.query_ids)).size)
        return est / max(n_viol, 1)

    def _active_objects(self) -> np.ndarray:
        objs = [
            np.asarray(e.pathset.objects).ravel()
            for w in self._tenants.values()
            for e in w.entries
        ]
        cat = np.concatenate(objs) if objs else np.zeros(0, np.int64)
        return np.unique(cat[cat >= 0])

    def _reeval_windows(self, repaired_names: set) -> bool:
        """Re-judge every windowed entry against the live scheme.

        The stored per-path latencies are stale after any scheme change
        and would re-trigger forever.  With ``incremental_recheck`` each
        entry's evaluation goes through the engine's dirty-set cache, so
        only the windowed paths touching the delta's objects are actually
        re-walked — the steady-state cost of a repair round scales with
        the delta, not the window.  Wall-clock latencies are dropped only
        for REPAIRED tenants (theirs were measured against the pre-repair
        scheme; a deferred tenant keeps its p99 evidence — it must win
        the next arbitration round).  Returns whether every repaired
        tenant's window is feasible after the change.
        """
        inc = self.config.incremental_recheck
        feasible = True
        for name, w in self._tenants.items():
            for e in w.entries:
                e.path_lats = self.engine.path_latencies(
                    e.pathset, policy=self.config.score_policy,
                    incremental=inc,
                )
                qids = np.asarray(e.pathset.query_ids)
                if len(qids):
                    ql = self.engine.query_latencies(e.pathset, e.path_lats)
                    slack_bad = ql[qids] > e.path_budgets
                    e.n_bad = int(np.unique(qids[slack_bad]).size)
                else:
                    e.n_bad = 0
                if name in repaired_names:
                    e.latency_us = None
                    if e.n_bad:
                        feasible = False
            if name in repaired_names:
                w.last_repair_step = self.step
        return feasible

    def _prewarm(
        self, forecast: PathSet, forecast_slo: SLOSpec | None
    ) -> AdaptationReport:
        """Repair a *forecast* PathSet delta before its violations land.

        Evaluates the forecast against the live scheme (through the
        dirty-set cache when enabled — repeated forecasts of the same
        PathSet cost only their dirty fraction), selects the paths
        already over their budgets, and warm-starts the same
        ``replicate_delta`` pass a reactive repair would run — so when
        the drift phase actually flips, the scheme is already provisioned
        for it and the violation window the reactive loop would have
        served through never opens.  Feasible forecasts are near-free: a
        gather-compacted evaluation plus no-op repair.
        """
        t0 = time.perf_counter()
        slo = (
            forecast_slo
            if forecast_slo is not None
            else self.config.default_slo(forecast.n_queries)
        )
        inc = self.config.incremental_recheck
        pl = self.engine.path_latencies(
            forecast, policy=self.config.score_policy, incremental=inc
        )
        qids = np.asarray(forecast.query_ids)
        t_path = slo.t_q[qids] if len(qids) else np.zeros(0, np.int32)
        idx = np.nonzero(pl > t_path)[0]
        add_obj = np.zeros(0, np.int64)
        add_srv = np.zeros(0, np.int64)
        n_paths = int(len(idx))
        if n_paths:
            bad = forecast.select(idx)
            tq_q = np.full(bad.n_queries, np.int32(0))
            tq_q[np.asarray(bad.query_ids)] = t_path[idx]
            bad_slo = SLOSpec(
                tq_q,
                np.zeros(bad.n_queries, np.int32),
                (TenantSpec("forecast", 0),),
            )
            stats, (add_obj, add_srv) = replicate_delta(
                bad,
                self.engine,
                bad_slo,
                f=self.f,
                capacity=self.config.capacity,
                epsilon=self.config.epsilon,
                track_rm=True,
                policy=self.config.score_policy,
                policy_backend=self.engine.backend,
            )
            self.cluster.apply_scheme_delta(add_obj, add_srv)
            for u, v, s in stats.rm or ():
                self.rmap.rm.setdefault(int(u), set()).add(int(v))
                self.rmap.rc[(int(v), int(s))] = (
                    self.rmap.rc.get((int(v), int(s)), 0) + 1
                )
            # windows were scored against the pre-warm scheme: re-judge
            # (dirty-scoped), without re-arming any tenant's repair state
            self._reeval_windows(set())
        fv = (
            np.ones(len(add_obj)) if self.f is None else self.f[add_obj]
        )
        report = AdaptationReport(
            step=self.step,
            trigger="forecast",
            paths_repaired=n_paths,
            replicas_added=int(len(add_obj)),
            bytes_added=float(np.sum(fv)) if len(add_obj) else 0.0,
            replicas_evicted=0,
            bytes_evicted=0.0,
            feasible_after=bool(
                self.engine.is_feasible(
                    forecast, slo, policy=self.config.score_policy,
                    incremental=inc,
                )
            ),
            runtime_s=time.perf_counter() - t0,
            tenants=("forecast",),
            additions=(add_obj, add_srv),
        )
        self.reports.append(report)
        return report

    def _update_cold_streaks(self, active_objects: np.ndarray) -> None:
        """Advance the per-replica cold streak counters (hysteresis).

        A replica is "cold" when no windowed path touched its object.  A
        streak survives only while the pair stays cold on *consecutive*
        checks; touching the object (or losing the replica) resets it.
        """
        scheme = self.cluster.scheme
        repl = scheme.mask.copy()
        repl[np.arange(scheme.n_objects), scheme.shard] = False
        act = np.zeros(scheme.n_objects, bool)
        act[active_objects] = True
        vs, ss = np.nonzero(repl & ~act[:, None])
        fresh: dict[tuple[int, int], int] = {}
        for v, s in zip(vs.tolist(), ss.tolist()):
            fresh[(v, s)] = self._cold_streak.get((v, s), 0) + 1
        self._cold_streak = fresh

    def _adapt(
        self, repair: list[tuple[str, str]], deferred: tuple[str, ...]
    ) -> AdaptationReport:
        t0 = time.perf_counter()
        # one vector-budget delta pass over every repaired tenant's
        # violating paths: each path keeps its own t_q
        parts: list[PathSet] = []
        part_tq: list[np.ndarray] = []
        part_tenant: list[np.ndarray] = []
        table: list[TenantSpec] = []
        for name, _ in repair:
            tid = len(table)
            table.append(self._tenants[name].spec)
            t_parts, t_budgets = self._violating(name)
            for part, pb in zip(t_parts, t_budgets):
                nq_p = part.n_queries
                tq_q = np.full(nq_p, table[tid].t_q, np.int32)
                tq_q[np.asarray(part.query_ids)] = pb
                parts.append(part)
                part_tq.append(tq_q)
                part_tenant.append(np.full(nq_p, tid, np.int32))
        if parts:
            bad = PathSet.concatenate(parts)
            bad_slo = SLOSpec(
                np.concatenate(part_tq),
                np.concatenate(part_tenant),
                tuple(table) or (TenantSpec("default", 0),),
            )
        else:
            bad = PathSet.from_lists([])
            bad_slo = SLOSpec.uniform(0, 0)

        # repair under the SAME policy the violations were scored with:
        # a nearest_copy-scored trigger is repaired by the policy-aware
        # delta pass, so the controller never buys home-first bytes the
        # serving walk will not use (score_policy="home_first" keeps the
        # historical pricing, bit-identical)
        stats, (add_obj, add_srv) = replicate_delta(
            bad,
            self.engine,
            bad_slo,
            f=self.f,
            capacity=self.config.capacity,
            epsilon=self.config.epsilon,
            track_rm=True,
            policy=self.config.score_policy,
            policy_backend=self.engine.backend,
        )
        # the engine already flipped the shared host mask; this records the
        # delta through the cluster's own hook (idempotent monotone flips)
        self.cluster.apply_scheme_delta(add_obj, add_srv)
        for u, v, s in stats.rm or ():
            self.rmap.rm.setdefault(int(u), set()).add(int(v))
            self.rmap.rc[(int(v), int(s))] = (
                self.rmap.rc.get((int(v), int(s)), 0) + 1
            )

        n_ev = 0
        bytes_ev = 0.0
        if self.config.capacity is not None:
            active = self._active_objects()
            self._update_cold_streaks(active)
            n_ev, bytes_ev = evict_cold_replicas(
                self.cluster, self.rmap, active, self.f,
                self.config.capacity,
                cold_streak=self._cold_streak,
                min_streak=self.config.demote_after,
            )
            if n_ev:
                self.engine.refresh()  # removals are not monotone: re-pack

        fv = (
            np.ones(len(add_obj))
            if self.f is None
            else self.f[add_obj]
        )
        # quota accounting: the vector-budget pass does not attribute
        # individual replicas to tenants, so a shared round splits its
        # bytes evenly; contended rounds repair exactly one tenant, and
        # there the attribution is exact
        if len(add_obj) and repair:
            share = float(np.sum(fv)) / len(repair)
            for name, _ in repair:
                self._tenant_bytes[name] = (
                    self._tenant_bytes.get(name, 0.0) + share
                )
        # re-evaluate every window against the repaired scheme: the stored
        # per-path latencies are stale and would re-trigger forever.  The
        # wall-clock latencies are dropped only for the REPAIRED tenants —
        # theirs were measured against the pre-repair scheme, and keeping
        # them would make a queueing-only p99 breach re-fire no-op repairs
        # until the batch ages out (the p99 trigger re-arms on fresh
        # measurements).  A deferred tenant keeps its p99 evidence: nothing
        # was repaired for it, and wiping it would erase the very violation
        # that must win the next arbitration round.
        repaired_names = {name for name, _ in repair}
        feasible = self._reeval_windows(repaired_names)

        triggers = [trig for _, trig in repair]
        report = AdaptationReport(
            step=self.step,
            trigger=(
                "feasibility" if "feasibility" in triggers else triggers[0]
            ),
            paths_repaired=bad.n_paths,
            replicas_added=int(len(add_obj)),
            bytes_added=float(np.sum(fv)) if len(add_obj) else 0.0,
            replicas_evicted=n_ev,
            bytes_evicted=bytes_ev,
            feasible_after=feasible,
            runtime_s=time.perf_counter() - t0,
            tenants=tuple(name for name, _ in repair),
            deferred=deferred,
            additions=(add_obj, add_srv),
        )
        self.reports.append(report)
        return report

    def on_liveness_change(
        self, pathset: PathSet, slo: SLOSpec | None = None
    ) -> AdaptationReport | None:
        """React to a liveness change: provision around the dead set.

        The serving layer routes around dead servers (``failover_home``),
        but routed-around queries pay extra distributed traversals the
        greedy bound never priced — the chaos violation window.  This
        closes it proactively: the currently-dead servers become a single
        loss case (``KResilient(k=1, domains=(dead,))``), and one
        ``replicate_delta`` pass provisions replicas *on survivors* until
        every path meets its budget with the dead set masked out — the
        same masked re-walk machinery the k-resilient gate uses at
        provisioning time, warm-started from the live scheme.

        No-op (returns None) when every server is alive; safe to call on
        every kill *and* revive — a revive shrinks the dead set, and the
        remaining dead servers still get their loss case repaired.  The
        additions are monotone, so a later revive never invalidates them
        (Thm 5.3); they simply become standing k-resilience headroom.
        """
        t0 = time.perf_counter()
        alive = np.asarray([s.alive for s in self.cluster.servers], bool)
        dead = np.nonzero(~alive)[0]
        if not len(dead):
            return None
        slo = (
            slo if slo is not None
            else self.config.default_slo(pathset.n_queries)
        )
        res = KResilient(k=1, domains=(tuple(int(s) for s in dead),))
        stats, (add_obj, add_srv) = replicate_delta(
            pathset,
            self.engine,
            slo,
            f=self.f,
            capacity=self.config.capacity,
            epsilon=self.config.epsilon,
            track_rm=True,
            policy=self.config.score_policy,
            policy_backend=self.engine.backend,
            resilience=res,
        )
        self.cluster.apply_scheme_delta(add_obj, add_srv)
        for u, v, s in stats.rm or ():
            self.rmap.rm.setdefault(int(u), set()).add(int(v))
            self.rmap.rc[(int(v), int(s))] = (
                self.rmap.rc.get((int(v), int(s)), 0) + 1
            )
        # windows were scored against the pre-repair scheme: re-judge
        # (dirty-scoped), without re-arming any tenant's repair state
        self._reeval_windows(set())
        fv = np.ones(len(add_obj)) if self.f is None else self.f[add_obj]
        report = AdaptationReport(
            step=self.step,
            trigger="liveness",
            paths_repaired=pathset.n_paths,
            replicas_added=int(len(add_obj)),
            bytes_added=float(np.sum(fv)) if len(add_obj) else 0.0,
            replicas_evicted=0,
            bytes_evicted=0.0,
            feasible_after=bool(
                self.engine.is_resilient_feasible(
                    pathset, slo.t_q, res,
                    policy=self.config.score_policy,
                )
            ),
            runtime_s=time.perf_counter() - t0,
            tenants=("liveness",),
            additions=(add_obj, add_srv),
        )
        self.reports.append(report)
        return report
