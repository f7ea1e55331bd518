"""The port's batched dispatch plane (``repro_torch.serve.batching``) and
asyncio harness against the JAX package's.

Each case of ``tests/test_batching.py`` that does not time a real clock
runs here on both packages from the same numpy inputs: the ``SimReport``s
(every array and ``summary()``), the traces, burn reports and learned
hedge thresholds equal ``repro``'s bit for bit, and the case's own
contract holds on the port.  The harness is held only to what does not
depend on the clock (ROADMAP trap e): every query completes, its
arrivals and failed flags equal the simulator's (and the JAX harness's),
every served access goes through a batch.  The ``cuda`` case holds the
plane on ``kernel`` against ``torch`` on a card.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import numpy as np
import pytest
import torch

import repro.distsys.executor as RX
import repro_torch.core as T
import repro_torch.distsys.executor as TX
from conftest import random_workload
from torch_serve_sides import JAX, PORT, SIDES, assert_sim_equal, both, spans_of


def _inputs(n_paths=200, n_queries=150, t=1, max_len=5, seed=0):
    """``test_batching._cluster``'s workload and its t-scheme (the port's
    greedy: its masks equal the JAX package's)."""
    ps, shard = random_workload(np.random.default_rng(seed), n_paths=n_paths,
                                n_queries=n_queries, max_len=max_len)
    scheme, _ = T.replicate_workload(PORT.paths(ps), shard, 5, t=t, device="cpu")
    return ps, scheme.mask.copy(), scheme.shard.copy()


@pytest.fixture(scope="module")
def case():
    return _inputs()


@pytest.fixture(scope="module")
def small():
    return _inputs(n_paths=40, n_queries=30)


def _run(side, inputs, **kw):
    ps, mask, shard = inputs
    return side.simulate(side.cluster(mask, shard), side.paths(ps), **kw)


def _pair(inputs, **kw):
    """One configuration on both packages; reports held equal."""
    j, p = both(lambda s: _run(s, inputs, **kw))
    assert_sim_equal(j, p)
    return p


# ---------------------------------------------------------------------------
# ladder + config units
# ---------------------------------------------------------------------------
def test_batch_ladder_pick_rungs():
    lad = PORT.serve.BatchLadder()
    assert lad.rungs == (1, 2, 4, 8, 16)
    assert lad.pick(0) == 1
    assert lad.pick(1) == 1
    assert lad.pick(3) == 2
    assert lad.pick(7) == 4
    assert lad.pick(16) == 16
    assert lad.pick(1000) == 16
    assert PORT.serve.BatchLadder(rungs=(1, 3, 9)).pick(8) == 3
    for rungs in ((1, 2, 4, 8, 16), (1, 3, 9), (1,), (1, 5, 6, 40)):
        picks = [[s.serve.BatchLadder(rungs=rungs).pick(d) for d in range(-2, 60)]
                 for s in SIDES]
        assert picks[0] == picks[1]
        assert PORT.serve.BatchLadder(rungs=rungs).max_rung == rungs[-1]


@pytest.mark.parametrize("rungs", [(2, 4), (1, 4, 2), ()])
def test_batch_ladder_validation(rungs):
    for s in SIDES:
        with pytest.raises(ValueError):
            s.serve.BatchLadder(rungs=rungs)
    for s in SIDES:
        with pytest.raises(ValueError, match="window_us"):
            s.serve.BatchingConfig(window_us=-1.0)
        with pytest.raises(ValueError, match="stretch"):
            s.serve.AdmissionConfig(stretch=0.0)


def test_admission_config_needs_a_deadline(small):
    for s in SIDES:
        with pytest.raises(ValueError, match="deadline"):
            _run(s, small, rate_qps=1e3, admission=s.serve.AdmissionConfig())


def test_derived_deadlines_equal_repro(case):
    ps = case[0]
    t_q = np.random.default_rng(3).integers(0, 3, ps.n_queries)
    out = []
    for s in SIDES:
        slo = s.slo(t_q, np.zeros(ps.n_queries), [("default", 1, {})])
        model = s.distsys.LatencyModel()
        out.append((s.serve.derive_deadlines(slo, model, s.paths(ps)),
                    s.serve.AdmissionConfig(stretch=2.5).deadlines(slo, model, s.paths(ps)),
                    s.serve.AdmissionConfig(deadline_us=70.0).deadlines(None, model,
                                                                        s.paths(ps))))
    for a, b in zip(*out):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        PORT.serve.AdmissionConfig(deadline_us=np.ones(3)).deadlines(
            None, PORT.distsys.LatencyModel(), PORT.paths(ps))


# ---------------------------------------------------------------------------
# batching: the amortization headline + straggler behavior
# ---------------------------------------------------------------------------
def test_batched_p99_not_worse_at_saturation(case):
    kw = dict(rate_qps=1e5, concurrency=2, seed=3)
    per_query, batched = (
        both(lambda s: _run(s, case, model=s.distsys.LatencyModel(dispatch_us=20.0),
                            batching=s.serve.BatchingConfig() if on else None, **kw))
        for on in (False, True))
    assert_sim_equal(*per_query)
    assert_sim_equal(*batched)
    per_query, batched = per_query[1], batched[1]
    assert batched.p99_us <= per_query.p99_us
    bs = batched.batch_stats
    assert bs is not None and bs.n_batches > 0
    assert bs.batched_jobs >= bs.n_batches
    assert bs.mean_occupancy > 1.0
    assert 1 <= bs.max_occupancy <= 16


def test_batch_single_straggler_flushes_alone():
    ps = PORT.from_lists([[i] for i in range(30)], list(range(30)))
    shard = (np.arange(30) % 5).astype(np.int32)
    scheme, _ = T.replicate_workload(ps, shard, 5, t=1, device="cpu")
    arrivals = np.arange(ps.n_queries, dtype=np.float64) * 5e3
    j, rep = both(lambda s: _run(s, (ps, scheme.mask, shard), arrivals_us=arrivals,
                                 batching=s.serve.BatchingConfig(), seed=0))
    assert_sim_equal(j, rep)
    assert rep.batch_stats.max_occupancy == 1
    assert rep.batch_stats.n_batches == rep.batch_stats.batched_jobs
    assert (rep.latency_us <= 50.0 + 100.0).all()
    assert (rep.latency_us > 0).all()
    assert np.isfinite(rep.latency_us).all()


# ---------------------------------------------------------------------------
# deadline-aware admission
# ---------------------------------------------------------------------------
def test_zero_budget_sheds_at_admission(case):
    ps = case[0]
    j, rep = both(lambda s: _run(s, case, rate_qps=1e4, seed=1,
                                 admission=s.serve.AdmissionConfig(deadline_us=0.0)))
    assert_sim_equal(j, rep)
    assert rep.query_shed is not None and rep.query_shed.all()
    assert rep.shed_frac == 1.0
    assert rep.surviving_latencies().size == 0
    assert np.isfinite(rep.latency_us).all()
    s = rep.summary()
    assert s["admission"]["n_shed"] == ps.n_queries
    assert s["admission"]["surviving_p99_us"] is None


def _uniform_slo(s, n, t, tenant="default", **kw):
    return s.core.SLOSpec.uniform(t, n, tenant=tenant, **kw)


def test_shedding_improves_surviving_p99_at_overload(case):
    n = case[0].n_queries
    kw = dict(rate_qps=3e5, concurrency=2, seed=5)
    over = both(lambda s: _run(s, case, slo=_uniform_slo(s, n, 2, p99_slo_us=400.0), **kw))
    shed = both(lambda s: _run(s, case, slo=_uniform_slo(s, n, 2, p99_slo_us=400.0),
                               admission=s.serve.AdmissionConfig(stretch=4.0), **kw))
    assert_sim_equal(*over)
    assert_sim_equal(*shed)
    overloaded, shed = over[1], shed[1]
    assert 0.0 < shed.shed_frac < 1.0
    assert float(np.percentile(shed.surviving_latencies(), 99.0)) < overloaded.p99_us
    s = shed.summary()
    assert s["admission"]["per_tenant_shed_frac"]["default"] == pytest.approx(shed.shed_frac)


def test_burn_attribution_reports_shed_next_to_violated(case):
    n = case[0].n_queries

    def run(s):
        tracer = s.obs.Tracer(budget_us=300.0)
        rep = _run(s, case, rate_qps=3e5, concurrency=2, seed=5,
                   slo=_uniform_slo(s, n, 2, tenant="gold", p99_slo_us=300.0),
                   admission=s.serve.AdmissionConfig(stretch=4.0), trace=tracer)
        return rep, tracer, s.obs.attribute_burn(tracer, tenant_names=("gold",))

    (jr, jt, jb), (rep, tracer, burn) = both(run)
    assert_sim_equal(jr, rep)
    assert spans_of(tracer) == spans_of(jt)
    assert burn["gold"].summary() == jb["gold"].summary()
    assert rep.shed_frac > 0.0
    tb = burn["gold"]
    assert tb.n_shed == int(rep.query_shed.sum())
    assert tb.n_violations + tb.n_shed <= tb.n_queries
    assert tb.shed_frac == pytest.approx(rep.shed_frac)


# ---------------------------------------------------------------------------
# SLO-driven hedging
# ---------------------------------------------------------------------------
def test_hedge_fires_and_primary_win_not_double_counted(case):
    ps = case[0]

    def run(s):
        hedge = s.serve.HedgePolicy(quantile=75.0, min_samples=32)
        rep = _run(s, case, rate_qps=3e4, concurrency=4, seed=7,
                   slo=_uniform_slo(s, ps.n_queries, 2), hedge=hedge)
        return rep, hedge

    (jr, jh), (rep, hedge) = both(run)
    assert_sim_equal(jr, rep)
    assert hedge.snapshot() == jh.snapshot()
    assert rep.slo_hedging and rep.hedges_fired > 0
    assert rep.latency_us.shape == (ps.n_queries,)
    assert np.isfinite(rep.latency_us).all()
    assert 0 <= rep.hedge_wins <= rep.hedges_fired
    s = rep.summary()["hedging"]
    assert s["fired"] == rep.hedges_fired and s["wins"] == rep.hedge_wins
    assert 0.0 < s["hedge_frac"] <= hedge.max_hedges_frac + 1e-9


def test_hedge_threshold_learns_per_tenant():
    hps = [s.serve.HedgePolicy(quantile=95.0, min_samples=8) for s in SIDES]
    assert hps[1].threshold_us(0) is None
    vals = np.random.default_rng(2).lognormal(4.0, 0.6, 64)
    for hp in hps:
        for i in range(64):
            hp.observe(0, 100.0 + i)
        for v in vals:
            hp.observe(3, float(v))
    th = hps[1].threshold_us(0)
    assert th is not None and 140.0 < th < 175.0
    assert hps[1].threshold_us(1) is None
    assert hps[0].snapshot() == hps[1].snapshot()
    assert hps[1].snapshot()[0] == pytest.approx(th)
    for kw in ({"quantile": 0.0}, {"quantile": 100.0}, {"min_samples": 0}):
        with pytest.raises(ValueError):
            PORT.serve.HedgePolicy(**kw)


def test_hedge_rejects_conflicting_modes(small):
    for s in SIDES:
        ps, mask, shard = small
        cluster = s.cluster(mask, shard)
        with pytest.raises(ValueError):
            s.simulate(cluster, s.paths(ps), hedge=s.serve.HedgePolicy(),
                       router=s.distsys.Router(cluster.scheme, "hedged"))
        with pytest.raises(ValueError):
            s.simulate(cluster, s.paths(ps), hedge=s.serve.HedgePolicy(), hop_feedback=True)
        with pytest.raises(ValueError):
            s.simulate(cluster, s.paths(ps), hedge=s.serve.HedgePolicy(),
                       policy="queue_aware", reroute_every=4)


# ---------------------------------------------------------------------------
# mixed open/closed loop
# ---------------------------------------------------------------------------
def test_mixed_loop_splits_percentiles(case):
    ps = case[0]
    closed = np.arange(0, ps.n_queries, 3)
    rep = _pair(case, rate_qps=2e4, clients=4, closed_queries=closed, seed=2)
    assert rep.closed_mask is not None and int(rep.closed_mask.sum()) == len(closed)
    s = rep.summary()
    assert s["mode"] == "mixed_loop"
    n_c, n_o = s["closed_loop_split"]["n_queries"], s["open_loop_split"]["n_queries"]
    assert n_c == len(closed) and n_c + n_o == ps.n_queries
    assert s["closed_loop_split"]["p99_us"] > 0 and s["open_loop_split"]["p99_us"] > 0


def test_mixed_loop_with_explicit_arrivals(case):
    ps = case[0]
    arrivals = np.cumsum(np.random.default_rng(8).exponential(40.0, ps.n_queries))
    closed = np.arange(1, ps.n_queries, 4)
    rep = _pair(case, arrivals_us=arrivals, clients=3, think_time_us=30.0,
                closed_queries=closed, seed=6)
    assert rep.summary()["mode"] == "mixed_loop"


def test_mixed_loop_requires_clients(small):
    for s in SIDES:
        with pytest.raises(ValueError, match="clients"):
            _run(s, small, closed_queries=np.array([0, 1]))
        with pytest.raises(ValueError, match="out of range"):
            _run(s, small, clients=2, closed_queries=np.array([0, 99]))


# ---------------------------------------------------------------------------
# the asyncio harness: what does not depend on the clock
# ---------------------------------------------------------------------------
HARNESS_SCALE = 1e-6  # real seconds per model µs: the run takes ~0.1 s


@pytest.mark.parametrize("batched", [False, True], ids=["per_query", "batched"])
@pytest.mark.parametrize("dead", [(), (0, 1)], ids=["alive", "dead01"])
def test_harness_clock_free_contract(case, batched, dead):
    ps, mask, shard = case
    model_kw = dict(dispatch_us=20.0) if batched else {}

    def run(s):
        out = []
        for harness in (False, True):
            cluster = s.cluster(mask, shard)
            for d in dead:
                cluster.fail_server(d)
            kw = dict(rate_qps=2e4, concurrency=2, seed=11,
                      model=s.distsys.LatencyModel(**model_kw),
                      batching=s.serve.BatchingConfig() if batched else None)
            out.append(s.harness(cluster, s.paths(ps), time_scale=HARNESS_SCALE, **kw)
                       if harness else s.simulate(cluster, s.paths(ps), **kw))
        return out

    (jsim, jhar), (sim, har) = both(run)
    assert_sim_equal(jsim, sim)
    for rep in (har, jhar):
        assert rep.latency_us.shape == sim.latency_us.shape
        assert np.isfinite(rep.latency_us).all() and (rep.latency_us > 0).all()
        assert np.array_equal(rep.arrival_us, sim.arrival_us)
        assert np.array_equal(rep.query_failed, sim.query_failed)
    assert har.policy == jhar.policy == "home_first"
    assert har.offered_qps == jhar.offered_qps and har.concurrency == jhar.concurrency
    assert har.query_failed.any() == bool(dead)
    if batched:
        # every served access (a tree node with a live server) rides a batch
        assert har.batch_stats.batched_jobs == sim.batch_stats.batched_jobs
        assert har.batch_stats.batched_jobs == jhar.batch_stats.batched_jobs
        assert 1 <= har.batch_stats.max_occupancy <= 16
    else:
        assert har.batch_stats is None


def test_harness_empty_and_tenant_tagged(case):
    ps, mask, shard = case

    def run(s):
        empty = s.harness(s.cluster(mask, shard), s.from_lists([]), time_scale=HARNESS_SCALE)
        slo = s.slo(np.ones(ps.n_queries), np.arange(ps.n_queries) % 2,
                    [("a", 1, {}), ("b", 2, {})])
        tagged = s.harness(s.cluster(mask, shard), s.paths(ps), rate_qps=5e4, seed=2, slo=slo,
                           policy="nearest_copy", time_scale=HARNESS_SCALE)
        return empty, tagged

    (je, jt), (empty, tagged) = both(run)
    assert_sim_equal(je, empty)
    assert empty.summary()["p99_us"] is None
    assert tagged.tenant_names == jt.tenant_names == ("a", "b")
    assert np.array_equal(tagged.tenant_of, jt.tenant_of)
    assert np.array_equal(tagged.query_failed, jt.query_failed)
    assert tagged.policy == "nearest_copy"
    assert set(tagged.summary()["per_tenant"]) == {"a", "b"}


# ---------------------------------------------------------------------------
# engine: one dispatch for many batches
# ---------------------------------------------------------------------------
def test_trace_paths_batched_row_identity():
    ps, mask, shard = _inputs(n_paths=90, n_queries=60)
    alive = np.ones(5, bool)
    rb = np.random.default_rng(9)
    idx = rb.permutation(ps.n_paths)
    batches = []
    for lo in range(0, ps.n_paths, 17):
        sub = idx[lo:lo + 17]
        batches.append((sub, rb.integers(0, 5, len(sub)).astype(np.int32) if lo % 2 == 0
                        else None))
    want = RX.trace_paths_batched(JAX.paths(ps), JAX.scheme(mask, shard), alive, batches)
    tsch = PORT.scheme(mask, shard)
    got = TX.trace_paths_batched(PORT.paths(ps), tsch, alive, batches, device="cpu")
    assert len(got) == len(batches)
    for (sub, start), (srv_b, loc_b), (js, jl) in zip(batches, got, want):
        assert np.array_equal(srv_b, js) and np.array_equal(loc_b, jl)
        sel = PORT.paths(ps).select(np.asarray(sub))
        srv_1, loc_1 = TX.trace_paths(sel, tsch, alive, start, device="cpu")
        L = srv_1.shape[1]
        assert np.array_equal(srv_b[:, :L], srv_1) and np.array_equal(loc_b[:, :L], loc_1)


# ---------------------------------------------------------------------------
# the card: kernel = torch
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_batched_plane_kernel_equals_torch_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (routed_walk has no CPU mode)")
    from repro_torch.kernels import routed_walk as rw

    ps, mask, shard = case
    n = ps.n_queries
    reps = []
    for backend in ("kernel", "torch"):
        before = rw.LAUNCHES
        cluster = PORT.cluster(mask, shard)
        reps.append(PORT.serve.simulate(
            cluster, PORT.paths(ps), rate_qps=3e5, concurrency=2, seed=5,
            model=PORT.distsys.LatencyModel(dispatch_us=20.0),
            slo=_uniform_slo(PORT, n, 2), batching=PORT.serve.BatchingConfig(),
            admission=PORT.serve.AdmissionConfig(stretch=4.0),
            hedge=PORT.serve.HedgePolicy(quantile=75.0, min_samples=32),
            device="cuda", backend=backend))
        assert (rw.LAUNCHES - before == 2) == (backend == "kernel")
    assert_sim_equal(*reps)
