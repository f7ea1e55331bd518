"""The port's discrete-event serving simulator (``repro_torch.serve.simulate``)
against the JAX package's.

The ``simulate`` cases of ``tests/test_serve.py``, ``tests/test_routing.py``
and ``tests/test_obs.py`` (hop spans) and the chaos cases of
``tests/test_faults.py`` run on both packages from the same numpy inputs:
every ``SimReport`` array and ``summary()`` equals ``repro``'s bit for bit,
so do the tracers' spans, the burn reports, the obs registry and the
cluster state a run leaves behind, and each case's own contract holds on
the port.  A matrix covers open / closed / mixed loops, the four routing
policies, the three routers, ``reroute_every``, ``hop_feedback``, ``slo``,
chaos and ``routing_table``.  The ``cuda`` cases hold each routing
variant's walk on ``kernel`` against ``torch`` on a card.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import json

import numpy as np
import pytest
import torch

import repro_torch.core as T
from conftest import random_workload
from torch_serve_sides import JAX, PORT, SIDES, assert_sim_equal, both, spans_of

POLICIES = ("home_first", "nearest_copy", "queue_aware", "nearest_copy_dp")


def _greedy(ps, shard, n_srv, t, **kw):
    """The port's greedy scheme (its masks equal the JAX package's)."""
    scheme, _ = T.replicate_workload(PORT.paths(ps), shard, n_srv, t=t, device="cpu", **kw)
    return scheme.mask.copy(), scheme.shard.copy()


def _random_scheme(rng, n_obj, n_srv, density):
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    mask = np.zeros((n_obj, n_srv), bool)
    mask[np.arange(n_obj), shard] = True
    mask |= rng.random((n_obj, n_srv)) < density
    return mask, shard


def _run(side, ps, mask, shard, dead=(), cluster_kw=None, **kw):
    cluster = side.cluster(mask, shard, **(cluster_kw or {}))
    for d in dead:
        cluster.fail_server(d)
    return side.simulate(cluster, side.paths(ps), **kw), cluster


def _pair(ps, mask, shard, dead=(), **kw):
    """One configuration on both packages; reports and the clusters' server
    state afterwards held equal."""
    (j, jc), (p, pc) = both(lambda s: _run(s, ps, mask, shard, dead, **kw))
    assert_sim_equal(j, p)
    assert [vars(s) for s in jc.servers] == [vars(s) for s in pc.servers]
    return p


@pytest.fixture(scope="module")
def closed_setup():
    """``test_serve._closed_loop_setup``: 400 paths, 4 servers, no replicas."""
    ps, shard = random_workload(np.random.default_rng(0), n_obj=200, n_srv=4, n_paths=400,
                                n_queries=200)
    mask = np.zeros((200, 4), bool)
    mask[np.arange(200), shard] = True
    return ps, mask, shard


@pytest.fixture(scope="module")
def matrix_case():
    """A t = 1 scheme with extra random copies, so every policy and router
    has holders to choose between."""
    rng = np.random.default_rng(21)
    ps, shard = random_workload(rng, n_obj=150, n_srv=5, n_paths=240, n_queries=110)
    mask, shard = _greedy(ps, shard, 5, 1)
    mask |= rng.random(mask.shape) < 0.15
    return ps, mask, shard


# ---------------------------------------------------------------------------
# test_serve.py: queueing, routers, failure
# ---------------------------------------------------------------------------
def test_sim_lowload_matches_closed_form():
    ps, shard = random_workload(np.random.default_rng(0), n_paths=300, n_queries=200)
    mask, shard = _greedy(ps, shard, 5, 1)
    sim = _pair(ps, mask, shard, rate_qps=200, model=PORT.distsys.LatencyModel(), seed=2)
    closed = PORT.distsys.execute_workload(PORT.cluster(mask, shard), PORT.paths(ps),
                                           PORT.distsys.LatencyModel(), seed=2, device="cpu")
    assert abs(sim.mean_us - closed.mean_us) / closed.mean_us < 0.10


def test_sim_p99_grows_with_offered_load():
    ps, shard = random_workload(np.random.default_rng(0), n_paths=400, n_queries=250)
    mask, shard = _greedy(ps, shard, 5, 2)
    lo = _pair(ps, mask, shard, rate_qps=500, seed=3, concurrency=2)
    hi = _pair(ps, mask, shard, rate_qps=500_000, seed=3, concurrency=2)
    assert hi.p99_us > lo.p99_us * 1.5
    assert hi.utilization().max() > lo.utilization().max()
    assert hi.queue_wait_us > lo.queue_wait_us


@pytest.mark.parametrize("router", ["replica_lb", "hedged", None])
def test_sim_routing_policies_and_failure(router):
    ps, shard = random_workload(np.random.default_rng(0), n_paths=200, n_queries=120)
    mask, shard = _greedy(ps, shard, 5, 0)
    if router is None:
        # all servers of some object dead -> failed queries, no crash
        rep = _pair(ps, mask, shard, dead=(0, 1), rate_qps=5_000, seed=4)
    else:
        (j, _), (rep, _) = both(lambda s: _run(
            s, ps, mask, shard, rate_qps=5_000, seed=4,
            router=s.distsys.Router(s.scheme(mask, shard), router)))
        assert_sim_equal(j, rep)
        assert len(rep.latency_us) == ps.n_queries
    assert np.isfinite(rep.latency_us).all()


def test_closed_loop_serves_all_and_reports(closed_setup):
    ps, mask, shard = closed_setup
    rep = _pair(ps, mask, shard, clients=8, think_time_us=100.0, seed=1, concurrency=4)
    assert rep.closed_loop and rep.n_clients == 8
    assert len(rep.latency_us) == ps.n_queries and (rep.latency_us > 0).all()
    s = rep.summary()
    assert s["mode"] == "closed_loop" and s["n_clients"] == 8
    assert s["saturation_qps"] == rep.achieved_qps > 0


def test_closed_loop_throughput_saturates(closed_setup):
    ps, mask, shard = closed_setup
    qps = {n: _pair(ps, mask, shard, clients=n, seed=1, concurrency=4) for n in (4, 16, 64, 128)}
    assert qps[16].achieved_qps > 1.5 * qps[4].achieved_qps
    assert qps[128].achieved_qps < 1.15 * qps[64].achieved_qps
    assert float(qps[64].utilization().max()) > 0.9


def test_closed_loop_think_time_throttles(closed_setup):
    ps, mask, shard = closed_setup
    fast = _pair(ps, mask, shard, clients=4, seed=1, concurrency=4)
    slow = _pair(ps, mask, shard, clients=4, think_time_us=500.0, seed=1, concurrency=4)
    assert slow.achieved_qps < 0.5 * fast.achieved_qps
    assert slow.p99_us <= fast.p99_us


@pytest.mark.parametrize("k", [7, 64])
def test_reroute_closed_loop_counts_exactly_and_orphans_nothing(closed_setup, k):
    ps, mask, shard = closed_setup
    rep = _pair(ps, mask, shard, clients=6, think_time_us=50.0, seed=3, concurrency=4,
                policy="queue_aware", reroute_every=k)
    assert rep.reroutes == ps.n_queries // k
    assert len(rep.latency_us) == ps.n_queries and (rep.latency_us > 0).all()
    assert rep.closed_loop and rep.policy == "queue_aware"


def test_saturation_qps_none_when_no_jobs(closed_setup):
    ps, mask, shard = closed_setup
    rep = _pair(ps, mask, shard, clients=0)
    s = rep.summary()
    assert s["saturation_qps"] is None and s["p99_us"] is None and s["mean_us"] is None
    assert s["completed_queries"] == 0 and rep.achieved_qps == 0.0
    for kw in ({"clients": 4}, {}):
        (j, _), (rep, _) = both(lambda side: (side.simulate(
            side.cluster(mask, shard), side.from_lists([]), **kw), None))
        assert_sim_equal(j, rep)
        assert rep.summary().get("saturation_qps") is None and rep.summary()["p99_us"] is None


def test_hop_feedback_contract():
    rng = np.random.default_rng(0)
    ps, shard = random_workload(rng, n_obj=150, n_srv=5, n_paths=250, n_queries=120)
    mask = np.zeros((150, 5), bool)
    mask[np.arange(150), shard] = True
    mask |= rng.random((150, 5)) < 0.3
    rep = _pair(ps, mask, shard, rate_qps=3e4, seed=2, policy="queue_aware",
                hop_feedback=True)
    assert rep.hop_feedback and rep.reroutes > 0
    assert len(rep.latency_us) == ps.n_queries and (rep.latency_us > 0).all()
    assert rep.summary()["hop_feedback"] is True
    for s in SIDES:
        for kw in (dict(policy="queue_aware", hop_feedback=True, reroute_every=4),
                   dict(policy="nearest_copy", hop_feedback=True),
                   dict(policy="queue_aware", hop_feedback=True,
                        router=s.distsys.Router(s.scheme(mask, shard), "replica_lb")),
                   dict(policy="queue_aware", hop_feedback=True,
                        batching=s.serve.BatchingConfig())):
            with pytest.raises(ValueError):
                _run(s, ps, mask, shard, **kw)


def test_hop_feedback_closed_loop_serves_all(closed_setup):
    ps, mask, shard = closed_setup
    rep = _pair(ps, mask, shard, clients=6, think_time_us=25.0, seed=4, concurrency=4,
                policy="queue_aware", hop_feedback=True)
    assert len(rep.latency_us) == ps.n_queries
    assert rep.summary()["saturation_qps"] is not None


# ---------------------------------------------------------------------------
# test_routing.py: policy + reroute
# ---------------------------------------------------------------------------
def test_simulator_policy_and_reroute():
    rng = np.random.default_rng(0)
    ps, _ = random_workload(rng, n_obj=100, n_srv=5, n_paths=150, n_queries=60)
    mask, shard = _random_scheme(rng, 100, 5, density=0.3)
    rep = _pair(ps, mask, shard, rate_qps=3e4, seed=2, policy="queue_aware", reroute_every=16)
    assert rep.policy == "queue_aware" and rep.reroutes >= 1
    assert (rep.latency_us > 0).all()
    for s in SIDES:
        with pytest.raises(ValueError):
            _run(s, ps, mask, shard, router=s.distsys.Router(s.scheme(mask, shard),
                                                              "replica_lb"),
                 policy="queue_aware", reroute_every=8)
        with pytest.raises(ValueError):
            _run(s, ps, mask, shard, policy="nearest_copy", reroute_every=8)


# ---------------------------------------------------------------------------
# the matrix: loops x policies x routers x liveness
# ---------------------------------------------------------------------------
ROUTERS = (None, "replica_lb", "hedged")


@pytest.mark.parametrize("dead", [(), (2,)], ids=["alive", "dead2"])
@pytest.mark.parametrize("router", ROUTERS, ids=["home", "replica_lb", "hedged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_router_matrix_equals_repro(matrix_case, policy, router, dead):
    ps, mask, shard = matrix_case
    n = ps.n_queries
    t_q = np.random.default_rng(4).integers(0, 3, n)

    def run(s):
        cluster = s.cluster(mask, shard)
        for d in dead:
            cluster.fail_server(d)
        # a live queue state for queue_aware's entry snapshot
        for srv in cluster.servers:
            srv.queue_depth, srv.busy = srv.server_id % 3, srv.server_id % 2
        slo = s.slo(t_q, np.arange(n) % 2, [("x", 1, {}), ("y", 2, {"p99_slo_us": 300.0})])
        kw = dict(rate_qps=8e4, seed=6, concurrency=3, policy=policy, slo=slo)
        if router is not None:
            kw["router"] = s.distsys.Router(cluster.scheme, router)
        return s.simulate(cluster, s.paths(ps), **kw), cluster

    (j, jc), (p, pc) = both(run)
    assert_sim_equal(j, p)
    assert [vars(s) for s in jc.servers] == [vars(s) for s in pc.servers]
    assert p.policy == policy and set(p.summary()["per_tenant"]) <= {"x", "y"}


@pytest.mark.parametrize("mode", ["open", "closed", "mixed", "trace"])
@pytest.mark.parametrize("policy", ["nearest_copy", "queue_aware"])
def test_loops_and_reroutes_equal_repro(matrix_case, mode, policy):
    ps, mask, shard = matrix_case
    n = ps.n_queries
    kw = dict(seed=9, concurrency=2, policy=policy)
    if policy == "queue_aware":
        kw["reroute_every"] = 13
    if mode == "open":
        kw["rate_qps"] = 2e5
    elif mode == "closed":
        kw.update(clients=5, think_time_us=40.0)
    elif mode == "mixed":
        kw.update(rate_qps=5e4, clients=3, closed_queries=np.arange(0, n, 2))
    else:
        kw["arrivals_us"] = np.cumsum(np.random.default_rng(5).exponential(8.0, n))
    rep = _pair(ps, mask, shard, **kw)
    assert len(rep.latency_us) == n
    if policy == "queue_aware":
        assert rep.reroutes == n // 13


@pytest.mark.parametrize("clients", [None, 5])
def test_hop_feedback_with_dead_server_equals_repro(matrix_case, clients):
    ps, mask, shard = matrix_case
    kw = dict(rate_qps=1e5) if clients is None else dict(clients=clients)
    rep = _pair(ps, mask, shard, dead=(1,), seed=8, concurrency=2, policy="queue_aware",
                hop_feedback=True, **kw)
    assert rep.hop_feedback and rep.reroutes > 0


# ---------------------------------------------------------------------------
# test_obs.py: hop-level spans of the simulator
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def traced_case():
    """``test_obs._traced_run``'s workload: 150 paths, t = 2."""
    ps, shard = random_workload(np.random.default_rng(0), n_paths=150, n_queries=60)
    return (ps, *_greedy(ps, shard, 5, 2))


def _traced(inputs, rate_qps=1.0, jitter=0.0, budget=1e12, tracer_kw=None, **kw):
    ps, mask, shard = inputs

    def run(s):
        tr = s.obs.Tracer(budget_us=budget, **(tracer_kw or {}))
        rep, _ = _run(s, ps, mask, shard, rate_qps=rate_qps, trace=tr,
                      model=s.distsys.LatencyModel(jitter_sigma=jitter), seed=4, **kw)
        return rep, tr

    (jr, jt), (rep, tr) = both(run)
    assert_sim_equal(jr, rep)
    assert spans_of(tr) == spans_of(jt)
    assert (tr.n_spans, tr.n_completed, tr.n_violations, tr.policy) == (
        jt.n_spans, jt.n_completed, jt.n_violations, jt.policy)
    return rep, tr


def test_one_span_per_served_access(traced_case):
    ps = traced_case[0]
    rep, tr = _traced(traced_case)
    expected, prefixes = 0, {}
    for p in range(ps.n_paths):
        seen = prefixes.setdefault(int(ps.query_ids[p]), set())
        pref = ()
        for x in range(int(ps.lengths[p])):
            pref = pref + (int(ps.objects[p, x]),)
            if pref not in seen:
                seen.add(pref)
                expected += 1
    assert tr.n_spans == expected
    for t in tr.traces:
        for s in t.spans:
            assert s.queue_wait_us == pytest.approx(0.0) and s.server >= 0


def test_linear_walk_spans_sum_to_latency(traced_case):
    rep, tr = _traced(traced_case, jitter=0.0)
    model = PORT.distsys.LatencyModel(jitter_sigma=0.0)
    checked = 0
    for t in tr.traces:
        spans = t.spans
        if not spans:
            continue
        starts = sorted(s.t_start_us for s in spans)
        ends = sorted(s.t_end_us for s in spans)
        if all(e <= s2 + 1e-9 for e, s2 in zip(ends[:-1], starts[1:])):
            total = sum(s.queue_wait_us + s.service_us for s in spans)
            assert total + model.coordinator_us == pytest.approx(t.latency_us)
            checked += 1
    assert checked > 0


def test_tracing_does_not_perturb_simulation():
    ps, shard = random_workload(np.random.default_rng(0), n_paths=200, n_queries=80)
    mask, shard = _greedy(ps, shard, 5, 2)
    rep0 = _pair(ps, mask, shard, rate_qps=50_000, seed=9)
    rep1, tr = _traced((ps, mask, shard), rate_qps=50_000, budget=100.0, jitter=0.15)
    rep2 = _pair(ps, mask, shard, rate_qps=50_000, seed=4)
    assert np.array_equal(rep1.latency_us, rep2.latency_us)
    assert rep0.latency_us.shape == rep1.latency_us.shape


def test_tail_bias_never_drops_violators():
    ps, shard = random_workload(np.random.default_rng(0), n_paths=300, n_queries=120)
    inputs = (ps, *_greedy(ps, shard, 5, 2))
    rep0 = _pair(*inputs, rate_qps=300_000, seed=4, concurrency=4)
    p80 = float(np.percentile(rep0.latency_us, 80.0))
    rep, tr = _traced(inputs, rate_qps=300_000, jitter=0.15, budget=p80,
                      tracer_kw={"head": 2, "ring": 4}, concurrency=4)
    violators = set(np.nonzero(rep.latency_us > p80)[0].tolist())
    assert len(violators) > 4
    assert tr.n_violations == len(violators)
    kept = {t.query for t in tr.traces}
    assert violators <= kept and all(t.violated for t in tr.violations)
    assert len(tr.traces) <= 2 + 4 + len(violators) and len(kept) < ps.n_queries


def test_tracer_reused_across_runs_accumulates():
    ps, shard = random_workload(np.random.default_rng(0), n_paths=100, n_queries=40)
    mask, shard = _greedy(ps, shard, 5, 2)

    def run(s):
        tr = s.obs.Tracer(budget_us=1e12)
        for seed in (1, 2):
            _run(s, ps, mask, shard, rate_qps=1000, seed=seed, trace=tr)
        return tr

    jt, tr = both(run)
    assert tr.n_completed == 2 * ps.n_queries
    assert spans_of(tr) == spans_of(jt)


def test_chrome_trace_export(traced_case, tmp_path):
    _, tr = _traced(traced_case, rate_qps=100_000, jitter=0.15)
    out = tmp_path / "trace.json"
    blob = tr.chrome_trace(str(out))
    assert json.loads(out.read_text()) == blob
    slices = [e for e in blob["traceEvents"] if e["ph"] == "X"]
    assert slices
    for e in slices:
        assert e["dur"] >= 0 and e["ts"] >= 0
        assert {"query", "hop", "object", "why"} <= set(e["args"])
    names = {e["args"]["name"] for e in blob["traceEvents"] if e["ph"] == "M"}
    assert any(n.startswith("server-") for n in names)


def test_executor_and_simulator_span_counts_agree():
    ps, shard = random_workload(np.random.default_rng(0), n_paths=120, n_queries=50)
    mask, shard = _greedy(ps, shard, 5, 2)
    ex = PORT.obs.Tracer()
    PORT.distsys.execute_workload(PORT.cluster(mask, shard), PORT.paths(ps),
                                  PORT.distsys.LatencyModel(), seed=1, trace=ex, device="cpu")
    _, sim = _traced((ps, mask, shard), jitter=0.15)
    assert ex.n_completed == ps.n_queries and ex.n_spans == sim.n_spans


def _hotspot_case(rng, n_queries=120):
    """``test_obs._hotspot_case``: hot(s0) -> spread(s1/s2) -> hot(s0)."""
    n_obj = 30
    shard = np.zeros(n_obj, np.int32)
    shard[20:] = rng.integers(1, 3, 10)
    paths = [[int(rng.integers(0, 10)), int(rng.integers(20, n_obj)),
              int(rng.integers(10, 20))] for _ in range(n_queries)]
    ps = PORT.from_lists(paths, list(range(n_queries)))
    mask = np.zeros((n_obj, 3), bool)
    mask[np.arange(n_obj), shard] = True
    return ps, mask, shard


def test_burn_attribution_names_hotspot_server():
    inputs = _hotspot_case(np.random.default_rng(0))
    rep0 = _pair(*inputs, rate_qps=400_000, seed=3, concurrency=2)
    p90 = float(np.percentile(rep0.latency_us, 90.0))
    ps, mask, shard = inputs

    def run(s):
        tr = s.obs.Tracer(budget_us=p90)
        _run(s, ps, mask, shard, rate_qps=400_000, seed=3, concurrency=2, trace=tr)
        return tr, s.obs.attribute_burn(tr, allowed_frac=0.01)

    (jt, jb), (tr, burn) = both(run)
    assert spans_of(tr) == spans_of(jt)
    tb = burn["default"]
    assert tb.summary() == jb["default"].summary()
    assert tr.n_violations > 0 and tb.n_violations == tr.n_violations
    assert tb.burn_rate > 1.0 and tb.top_server() == 0
    assert tb.blame_queue_us[0] == max(tb.blame_queue_us.values())
    worst = [h.server for h in tb.worst_hops]
    assert worst and worst.count(0) >= len(worst) // 2
    for h in tb.worst_hops:
        assert 0.0 <= h.share <= 1.0 + 1e-9 and h.latency_us > h.budget_us


@pytest.fixture
def obs_on():
    """Both obs planes on, with clean registries; restored on exit."""
    was = (PORT.obs.enabled(), JAX.obs.enabled())
    for o in (PORT.obs, JAX.obs):
        o.REGISTRY.reset()
        o.enable()
    try:
        yield
    finally:
        for o, w in zip((PORT.obs, JAX.obs), was):
            (o.enable if w else o.disable)()
            o.REGISTRY.reset()


def test_simulator_registers_serve_metrics(matrix_case, obs_on):
    ps, mask, shard = matrix_case
    n = ps.n_queries
    _pair(ps, mask, shard, rate_qps=10_000, seed=1)
    _pair(ps, mask, shard, rate_qps=3e5, seed=2, concurrency=2,
          slo=PORT.core.SLOSpec.uniform(1, n), hedge=None)
    for s in SIDES:
        _run(s, ps, mask, shard, rate_qps=3e5, seed=2, concurrency=2,
             slo=s.core.SLOSpec.uniform(1, n), batching=s.serve.BatchingConfig(),
             admission=s.serve.AdmissionConfig(stretch=2.0),
             hedge=s.serve.HedgePolicy(min_samples=16))
    snaps = [{k: v for k, v in s.obs.REGISTRY.snapshot().items()
              if k.startswith("repro.serve.")} for s in SIDES]
    assert snaps[0] == snaps[1]
    snap = snaps[1]
    assert snap["repro.serve.queries"] == 3 * n
    assert snap["repro.serve.latency_us"]["count"] == 3 * n
    assert snap["repro.serve.batch_occupancy"]["count"] > 0
    assert "repro.serve.shed" in snap and "repro.serve.hedges_fired" in snap


def test_disabled_plane_registers_nothing(matrix_case):
    PORT.obs.disable()
    PORT.obs.REGISTRY.reset()
    ps, mask, shard = matrix_case
    _run(PORT, ps, mask, shard, rate_qps=10_000, seed=1, batching=PORT.serve.BatchingConfig())
    assert PORT.obs.REGISTRY.names() == []


# ---------------------------------------------------------------------------
# test_faults.py: chaos and routing tables
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def chaos_case():
    """``test_faults``' headline chaos workload: 160 paths, 6 servers, t = 2."""
    ps, shard = random_workload(np.random.default_rng(11), n_obj=120, n_srv=6, n_paths=160)
    return (ps, *_greedy(ps, shard.copy(), 6, 2))


def _chaos(s, kinds):
    return [s.distsys.ChaosEvent(at, kind, srv) for at, kind, srv in kinds]


KILL_REVIVE = ((30_000.0, "kill", 2), (70_000.0, "revive", 2))


def test_chaos_kill_revive_equals_repro_and_opens_a_window(chaos_case):
    ps, mask, shard = chaos_case
    kw = dict(rate_qps=2_000.0, seed=5, concurrency=8)
    calm = _pair(ps, mask, shard, **kw)
    thr = 1.3 * np.percentile(calm.latency_us, 99)
    (j, jc), (static, pc) = both(lambda s: _run(s, ps, mask, shard,
                                                chaos=_chaos(s, KILL_REVIVE), **kw))
    assert_sim_equal(j, static)
    assert [vars(s) for s in jc.servers] == [vars(s) for s in pc.servers]
    assert [(k, s) for _, k, s in static.chaos_events] == [("kill", 2), ("revive", 2)]
    fin = static.arrival_us + static.latency_us
    w = PORT.distsys.violation_windows(fin, static.latency_us > thr)
    assert w and PORT.distsys.time_to_repair(w, 30_000.0) > 0.0
    assert static.summary()["chaos"]["kills"] == 1


@pytest.mark.parametrize("policy,hop_feedback", [
    ("home_first", False), ("nearest_copy", False), ("nearest_copy_dp", False),
    ("queue_aware", False), ("queue_aware", True)])
def test_chaos_schedules_equal_repro(chaos_case, policy, hop_feedback):
    ps, mask, shard = chaos_case
    kinds = ((20_000.0, "kill", 0), (25_000.0, "kill", 3), (25_000.0, "kill", 3),
             (50_000.0, "revive", 0), (60_000.0, "revive", 5), (90_000.0, "revive", 3))
    (j, jc), (rep, pc) = both(lambda s: _run(s, ps, mask, shard, rate_qps=2_000.0, seed=7,
                                             concurrency=4, policy=policy,
                                             hop_feedback=hop_feedback,
                                             chaos=_chaos(s, kinds)))
    assert_sim_equal(j, rep)
    assert [vars(s) for s in jc.servers] == [vars(s) for s in pc.servers]
    assert [(k, s) for _, k, s in rep.chaos_events] == [
        ("kill", 0), ("kill", 3), ("revive", 0), ("revive", 3)]
    for s in SIDES:
        with pytest.raises(ValueError, match="chaos"):
            _run(s, ps, mask, shard, chaos=_chaos(s, kinds),
                 router=s.distsys.Router(s.scheme(mask, shard), "replica_lb"))


def test_routing_table_direct_hits_skip_coordinator():
    ps, shard = random_workload(np.random.default_rng(0), n_obj=100, n_srv=5, n_paths=120)
    mask, shard = _greedy(ps, shard.copy(), 5, 2)
    kw = dict(rate_qps=500.0, seed=3, concurrency=4)
    base = _pair(ps, mask, shard, **kw)

    def run(s):
        cl = s.cluster(mask, shard)
        return s.simulate(cl, s.paths(ps), routing_table=s.distsys.RoutingTable(cl), **kw)

    j, rep = both(run)
    assert_sim_equal(j, rep)
    assert rep.routing["direct_hit_rate"] == 1.0
    assert np.mean(base.latency_us) - np.mean(rep.latency_us) == pytest.approx(
        PORT.distsys.LatencyModel().coordinator_us)


def test_stale_routing_table_under_chaos_equals_repro(chaos_case):
    ps, mask, shard = chaos_case

    def run(s):
        cl = s.cluster(mask, shard)
        table = s.distsys.RoutingTable(cl, max_age_us=5e4)
        return s.simulate(cl, s.paths(ps), rate_qps=2_000.0, seed=5, concurrency=8,
                          chaos=_chaos(s, KILL_REVIVE), routing_table=table)

    j, rep = both(run)
    assert_sim_equal(j, rep)
    r = rep.routing
    assert r["fallbacks"] > 0 and r["direct_hits"] > 0


# ---------------------------------------------------------------------------
# the card: each variant's walk, kernel = torch
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("router", ROUTERS, ids=["home", "replica_lb", "hedged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_kernel_equals_torch_on_the_card(matrix_case, policy, router):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (routed_walk / scored_walk have no CPU mode)")
    from repro_torch.kernels import routed_walk as rw

    ps, mask, shard = matrix_case
    counter = "SCORED_LAUNCHES" if policy == "nearest_copy_dp" else "LAUNCHES"
    reps = []
    for backend in ("kernel", "torch"):
        cluster = PORT.cluster(mask, shard)
        kw = dict(rate_qps=8e4, seed=6, concurrency=3, policy=policy, device="cuda",
                  backend=backend, chaos=_chaos(PORT, ((300.0, "kill", 1),))
                  if router is None else None)
        if router is not None:
            kw["router"] = PORT.distsys.Router(cluster.scheme, router)
        before = getattr(rw, counter)
        reps.append(PORT.serve.simulate(cluster, PORT.paths(ps), **kw))
        launched = getattr(rw, counter) - before
        assert (launched > 0) == (backend == "kernel")
    assert_sim_equal(*reps)
