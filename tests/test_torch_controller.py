"""The port's adaptive controller (``repro_torch.serve.AdaptiveController``)
against the JAX package's.

The controller cases of ``tests/test_serve.py``, ``tests/test_slo.py``,
``tests/test_incremental.py``, ``tests/test_obs.py`` (blame) and
``tests/test_faults.py`` (``on_liveness_change``) run on both packages
from the same numpy inputs: after every step the ``AdaptationReport``s
equal ``repro``'s field by field (``runtime_s``, a ``perf_counter``
reading, excepted), the repaired masks are equal, and so are the
resharding maps and tenant statistics; each case's own contract holds on
the port.  One case forces an eviction (removals are not monotone: the
engine re-packs) and checks that the incremental re-check of every window
then equals a full evaluation and a fresh engine's.  The ``cuda`` case
runs a drift on ``kernel`` against a ``torch`` twin on a card.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import numpy as np
import pytest
import torch

import repro_torch.core as T
from conftest import random_workload
from torch_serve_sides import JAX, PORT, assert_adapt_equal, assert_sim_equal, both


def synthetic_phases(n_phases=2, n_obj=300, queries=120, seed=0):
    """``test_serve.synthetic_phases``: 3-hop chains rooted in a rotating
    hot set (the port's drift generator; its phases equal ``repro``'s)."""

    def for_phase(k, rng):
        def paths_fn(root):
            return [[int(root) % n_obj, int(rng.integers(0, n_obj)),
                     int(rng.integers(0, n_obj))]]
        return paths_fn

    return PORT.serve.hotspot_phases(for_phase, np.arange(n_obj), n_phases=n_phases,
                                     queries_per_phase=queries, hot_frac=0.08, hot_prob=0.9,
                                     seed=seed)


def _greedy(ps, shard, n_srv, t, **kw):
    scheme, _ = T.replicate_workload(PORT.paths(ps), shard, n_srv, t=t, device="cpu", **kw)
    return scheme.mask.copy(), scheme.shard.copy()


def _drifted_setup(seed=0, n_obj=300, n_srv=5, queries=150):
    """``test_incremental._drifted_setup``: phases, and phase 0's t = 1 mask."""
    phases = synthetic_phases(n_phases=2, n_obj=n_obj, queries=queries, seed=seed)
    shard = np.random.default_rng(seed).integers(0, n_srv, n_obj).astype(np.int32)
    return phases, (*_greedy(phases[0].pathset, shard, n_srv, 1),)


class Drive:
    """One side's controller over a fresh scheme built from ``mask``."""

    def __init__(self, side, mask, shard, engine=True, f=None, rmap=None, **cfg):
        self.side = side
        self.scheme = side.scheme(mask, shard)
        self.cluster = side.distsys.Cluster(self.scheme)
        self.engine = side.latency_engine(self.scheme) if engine else None
        self.ctl = side.controller(self.cluster, side.serve.ControllerConfig(**cfg),
                                   engine=self.engine, f=f, rmap=rmap)
        self.steps = []  # (report, mask after the step)

    def observe(self, ps, **kw):
        r = self.ctl.observe(self.side.paths(ps), **kw)
        self.steps.append((r, self.scheme.mask.copy()))
        return r

    def liveness(self, ps, **kw):
        r = self.ctl.on_liveness_change(self.side.paths(ps), **kw)
        self.steps.append((r, self.scheme.mask.copy()))
        return r


def assert_drives_equal(j: Drive, p: Drive) -> None:
    """Reports and masks after every step, and the controller's state."""
    assert len(j.steps) == len(p.steps)
    for (jr, jm), (pr, pm) in zip(j.steps, p.steps):
        assert_adapt_equal(jr, pr)
        assert np.array_equal(jm, pm)
    assert len(j.ctl.reports) == len(p.ctl.reports)
    for a, b in zip(j.ctl.reports, p.ctl.reports):
        assert_adapt_equal(a, b)
    assert j.ctl.rmap.rc == p.ctl.rmap.rc and j.ctl.rmap.rm == p.ctl.rmap.rm
    assert j.ctl.tenant_stats() == p.ctl.tenant_stats()
    assert j.ctl.window_feasible_frac() == p.ctl.window_feasible_frac()
    assert j.ctl._cold_streak == p.ctl._cold_streak
    assert np.array_equal(p.ctl.engine.host_mask(), p.scheme.mask)  # words == host mask


def _both_drives(script, *args, **kw):
    j, p = both(lambda s: script(s, *args, **kw))
    assert_drives_equal(j, p)
    return p


# ---------------------------------------------------------------------------
# test_serve.py: drift repair, p99 re-arm, eviction, score policy
# ---------------------------------------------------------------------------
def test_controller_converges_after_drift():
    phases = synthetic_phases(n_phases=2, queries=150, seed=5)
    shard = np.random.default_rng(0).integers(0, 5, 300).astype(np.int32)
    mask, shard = _greedy(phases[0].pathset, shard, 5, 1)
    drifted = phases[1].pathset

    def script(s):
        d = Drive(s, mask, shard, t=1, window=300, min_queries=20)
        d.observe(drifted)
        d.observe(drifted)
        return d

    p = _both_drives(script)
    report, quiet = p.steps[0][0], p.steps[1][0]
    assert report is not None and report.trigger == "feasibility"
    assert report.replicas_added > 0 and report.feasible_after
    assert T.is_latency_feasible(drifted, p.cluster.scheme, 1, device="cpu")
    assert quiet is None
    # the controller's apply_scheme_delta re-flips what replicate_delta
    # already mirrored: idempotent, a host-only flip, no second upload
    before = p.scheme.mask.copy()
    with PORT.engine.TRANSFER.scope() as tr:
        p.cluster.apply_scheme_delta(*report.additions)
        assert tr.h2d_bytes == 0 and tr.h2d_calls == 0
    assert np.array_equal(p.scheme.mask, before)
    assert np.array_equal(p.ctl.engine.host_mask(), before)


def test_controller_p99_trigger_rearms_on_fresh_latencies():
    shard = np.random.default_rng(11).integers(0, 3, 40).astype(np.int32)
    ps = PORT.from_lists([[i, (i + 1) % 40] for i in range(40)])
    mask, shard = _greedy(ps, shard, 3, 2)

    def script(s):
        d = Drive(s, mask, shard, t=2, window=200, min_queries=10, p99_slo_us=100.0)
        d.observe(ps, latency_us=np.full(ps.n_queries, 500.0))
        d.observe(ps)
        d.observe(ps, latency_us=np.full(ps.n_queries, 50.0))
        return d

    p = _both_drives(script)
    assert p.steps[0][0] is not None and p.steps[0][0].trigger == "p99_slo"
    assert p.steps[1][0] is None and p.steps[2][0] is None


def test_controller_eviction_respects_capacity():
    def run(s):
        shard = np.zeros(6, np.int32)
        scheme = s.core.ReplicationScheme.from_sharding(shard, 3)
        scheme.mask[:, 1] = True
        cluster = s.distsys.Cluster(scheme)
        rmap = s.core.ReshardingMap({}, {(0, 1): 1})
        n, b = s.serve.evict_cold_replicas(cluster, rmap, active_objects=np.asarray([1]),
                                           capacity=2.0)
        return n, b, scheme

    (jn, jb, js), (n, b, scheme) = both(run)
    assert (n, b) == (jn, jb) and np.array_equal(scheme.mask, js.mask)
    assert scheme.storage_per_server()[1] <= 2.0
    assert n > 0 and b > 0
    assert scheme.mask[0, 1] and scheme.mask[1, 1] and scheme.mask[:, 0].all()


def _square_wave_evictions(s, min_streak: int, flips: int = 6):
    scheme = s.core.ReplicationScheme.from_sharding(np.zeros(4, np.int32), 2)
    scheme.mask[:, 1] = True
    cluster = s.distsys.Cluster(scheme)
    ctl = s.controller(cluster, s.serve.ControllerConfig(t=0, demote_after=min_streak))
    rmap = s.core.ReshardingMap({}, {})
    groups = (np.asarray([0, 1]), np.asarray([2, 3]))
    counts = []
    for k in range(flips):
        active = groups[k % 2]
        scheme.mask[active, 1] = True
        ctl._update_cold_streaks(active)
        n, _ = s.serve.evict_cold_replicas(cluster, rmap, active, capacity=3.0,
                                           cold_streak=ctl._cold_streak, min_streak=min_streak)
        counts.append((n, scheme.mask.copy(), dict(ctl._cold_streak)))
    return counts


@pytest.mark.parametrize("min_streak", [1, 2])
def test_eviction_hysteresis_square_wave(min_streak):
    j, p = both(_square_wave_evictions, min_streak)
    for (jn, jm, jc), (n, m, c) in zip(j, p):
        assert jn == n and np.array_equal(jm, m) and jc == c
    total = sum(n for n, _, _ in p)
    assert total >= 5 if min_streak == 1 else total == 0


def test_eviction_hysteresis_fires_on_sustained_cold():
    def run(s):
        scheme = s.core.ReplicationScheme.from_sharding(np.zeros(3, np.int32), 2)
        scheme.mask[:, 1] = True
        cluster = s.distsys.Cluster(scheme)
        ctl = s.controller(cluster, s.serve.ControllerConfig(t=0, demote_after=2))
        rmap = s.core.ReshardingMap({}, {})
        active = np.asarray([0])
        counts = []
        for _ in range(3):
            ctl._update_cold_streaks(active)
            n, _ = s.serve.evict_cold_replicas(cluster, rmap, active, capacity=1.0,
                                               cold_streak=ctl._cold_streak, min_streak=2)
            counts.append(n)
        return counts, scheme

    (jc, js), (counts, scheme) = both(run)
    assert counts == jc and np.array_equal(scheme.mask, js.mask)
    assert counts[0] == 0 and counts[1] > 0
    assert scheme.storage_per_server()[1] <= 1.0


@pytest.mark.parametrize("demote_after", [1, 2])
def test_controller_demote_after_wiring(demote_after):
    shard = np.asarray([0, 0, 0, 0, 0, 1], np.int32)
    mask = np.zeros((6, 2), bool)
    mask[np.arange(6), shard] = True
    mask[:, 1] = True  # pre-existing (non-RM) replicas at s1; s1 over capacity
    bad = PORT.from_lists([[0, 5]])

    def script(s):
        d = Drive(s, mask, shard, engine=False, t=0, min_queries=1,
                  capacity=np.asarray([6.0, 4.0]), demote_after=demote_after)
        for _ in range(3):
            d.observe(bad)
        return d

    r = [rep for rep, _ in _both_drives(script).steps]
    if demote_after == 1:
        assert r[0].replicas_evicted > 0
        assert r[1].feasible_after and r[1].replicas_added > 0
    else:
        assert r[0].replicas_evicted == 0 and not r[0].feasible_after
        assert r[1].replicas_evicted > 0
        assert r[2].feasible_after and r[2].replicas_added > 0


def test_controller_repairs_under_score_policy():
    phases = synthetic_phases(n_phases=2, queries=150, seed=5)
    shard = (np.arange(300) % 5).astype(np.int32)
    mask, shard = _greedy(phases[0].pathset, shard, 5, 1)
    drifted = phases[1].pathset

    def script(s):
        d = Drive(s, mask, shard, engine=False, t=1, window=600, min_queries=32,
                  score_policy="nearest_copy")
        for lo in range(0, drifted.n_queries, 50):
            d.observe(drifted.select_queries(lo, min(lo + 50, drifted.n_queries)))
        return d

    p = _both_drives(script)
    reports = [r for r, _ in p.steps if r is not None]
    assert reports and reports[-1].feasible_after
    eng = PORT.engine.LatencyEngine(p.cluster.scheme, device="cpu")
    for w in p.ctl._tenants.values():
        for e in w.entries:
            assert (eng.path_latencies(e.pathset, policy="nearest_copy") <= e.path_budgets).all()


# ---------------------------------------------------------------------------
# test_slo.py: per-tenant triggers, arbitration, weights, quotas
# ---------------------------------------------------------------------------
def _two_tenant_batch(s, n_srv=4, weights=(1.0, 1.0)):
    n_obj = 40
    shard = (np.arange(n_obj) % n_srv).astype(np.int32)
    cheap = [[i, i + 1] for i in range(0, 8, 2)]
    costly = [[i, i + 1, i + 2, i + 3] for i in range(8, 32, 4)]
    ps = s.from_lists(cheap + costly, list(range(len(cheap) + len(costly))))
    tenant_of = np.asarray([0] * len(cheap) + [1] * len(costly), np.int32)
    tenants = (s.core.TenantSpec("cheap", 0, weight=weights[0]),
               s.core.TenantSpec("costly", 1, weight=weights[1]))
    return ps, shard, s.core.SLOSpec.from_tenants(tenants, tenant_of), n_obj, n_srv


def _sharded_drive(s, shard, n_srv, **cfg):
    mask = np.zeros((len(shard), n_srv), bool)
    mask[np.arange(len(shard)), shard] = True
    return Drive(s, mask, shard, engine=False, **cfg)


def _observe_slo(d, ps, slo, **kw):
    r = d.ctl.observe(ps, slo=slo, **kw)
    d.steps.append((r, d.scheme.mask.copy()))
    return r


@pytest.mark.parametrize("weights,quota", [((1.0, 1.0), None), ((1.0, 100.0), None),
                                           ((1.0, 1.0), 1e9)],
                         ids=["cheapest_byte", "weighted", "scalar_quota"])
def test_controller_arbitration_deterministic_winner(weights, quota):
    def script(s):
        ps, shard, slo, n_obj, n_srv = _two_tenant_batch(s, weights=weights)
        d = _sharded_drive(s, shard, n_srv, tenants=slo.tenants, window=64, min_queries=1,
                           capacity=float(n_obj), tenant_quota_bytes=quota)
        _observe_slo(d, ps, slo)
        _observe_slo(d, ps, slo)
        d.slo = slo
        return d

    p = _both_drives(script)
    r1, r2 = p.steps[0][0], p.steps[1][0]
    win, lose = ("costly", "cheap") if weights[1] > 1 else ("cheap", "costly")
    assert r1.tenants == (win,) and r1.deferred == (lose,) and r1.replicas_added > 0
    assert r2 is not None and r2.tenants == (lose,)
    if weights[1] == 1.0:
        assert r2.feasible_after
        assert T.is_latency_feasible(p.side.paths(_two_tenant_batch(PORT)[0]), p.scheme,
                                     p.slo, device="cpu")
    if quota is not None:
        assert p.ctl.tenant_stats()["cheap"]["quota_bytes"] == 1e9


def test_controller_uncontended_repairs_all_triggered_tenants():
    def script(s):
        ps, shard, slo, _, n_srv = _two_tenant_batch(s)
        d = _sharded_drive(s, shard, n_srv, tenants=slo.tenants, window=64, min_queries=1)
        _observe_slo(d, ps, slo)
        return d

    p = _both_drives(script)
    report = p.steps[0][0]
    assert set(report.tenants) == {"cheap", "costly"} and report.deferred == ()
    assert report.feasible_after


def test_controller_p99_tenant_not_starved_in_arbitration():
    shard = (np.arange(40) % 4).astype(np.int32)

    def script(s):
        tenants = (s.core.TenantSpec("a", 0), s.core.TenantSpec("p", 5, p99_slo_us=100.0))
        d = _sharded_drive(s, shard, 4, tenants=tenants, min_queries=1, capacity=40.0)
        for offset in (0, 8):
            a_paths = [[offset + i, offset + i + 1] for i in range(0, 6, 2)]
            ps = s.from_lists(a_paths + [[30 + i] for i in range(4)],
                              list(range(len(a_paths) + 4)))
            slo = s.core.SLOSpec.from_tenants(
                tenants, np.asarray([0] * len(a_paths) + [1] * 4, np.int32))
            lat = np.asarray([10.0] * len(a_paths) + [500.0] * 4)
            _observe_slo(d, ps, slo, latency_us=lat)
        return d

    p = _both_drives(script)
    r1, r2 = p.steps[0][0], p.steps[1][0]
    assert r1.tenants == ("a",) and r1.deferred == ("p",)
    assert r2.tenants == ("p",) and "a" in r2.deferred
    assert r2.trigger in ("p99_slo", "feasibility")


def test_controller_unrepairable_window_rearms_on_new_evidence_only():
    shard = np.asarray([0, 1, 0, 0], np.int32)

    def script(s):
        tenants = (s.core.TenantSpec("a", 5), s.core.TenantSpec("b", 0))
        d = _sharded_drive(s, shard, 2, tenants=tenants, min_queries=1,
                           capacity=np.asarray([3.0, 1.0]))
        bad = s.from_lists([[0, 1]])
        slo_b = s.core.SLOSpec.from_tenants(tenants, np.asarray([1], np.int32))
        ok = s.from_lists([[2], [3]])
        slo_a = s.core.SLOSpec.from_tenants(tenants, np.asarray([0, 0], np.int32))
        _observe_slo(d, bad, slo_b)
        for _ in range(3):
            _observe_slo(d, ok, slo_a)
        _observe_slo(d, bad, slo_b)
        return d

    r = [rep for rep, _ in _both_drives(script).steps]
    assert r[0] is not None and not r[0].feasible_after and r[0].replicas_added == 0
    assert r[1:4] == [None, None, None]
    assert r[4] is not None and "b" in r[4].tenants


def test_controller_per_tenant_windows_and_stats():
    def script(s):
        ps, shard, slo, _, n_srv = _two_tenant_batch(s)
        d = _sharded_drive(s, shard, n_srv, tenants=slo.tenants, window=64, min_queries=1000)
        _observe_slo(d, ps, slo)
        return d

    p = _both_drives(script)
    assert p.steps[0][0] is None
    stats = p.ctl.tenant_stats()
    assert set(stats) == {"cheap", "costly"}
    assert stats["cheap"]["violation_frac"] == stats["costly"]["violation_frac"] == 1.0
    assert stats["cheap"]["t_q"] == 0 and stats["costly"]["t_q"] == 1
    with pytest.raises(ValueError, match="SLOSpec"):
        p.ctl.observe(_two_tenant_batch(PORT)[0])


def test_controller_low_weight_tenant_cannot_starve():
    shard = (np.arange(48) % 4).astype(np.int32)

    def script(s):
        tenants = (s.core.TenantSpec("vip", 0, weight=100.0),
                   s.core.TenantSpec("lo", 0, weight=0.01))
        d = _sharded_drive(s, shard, 4, tenants=tenants, window=256, min_queries=1,
                           capacity=48.0)
        for offset in (0, 8):
            vip = [[offset + i, offset + i + 1] for i in range(0, 8, 2)]
            lo = [[24 + offset + i, 24 + offset + i + 1] for i in range(0, 8, 2)]
            ps = s.from_lists(vip + lo, list(range(len(vip) + len(lo))))
            slo = s.core.SLOSpec.from_tenants(
                tenants, np.asarray([0] * len(vip) + [1] * len(lo), np.int32))
            _observe_slo(d, ps, slo)
        return d

    p = _both_drives(script)
    r1, r2 = p.steps[0][0], p.steps[1][0]
    assert r1.tenants == ("vip",) and r1.deferred == ("lo",)
    assert r2.tenants == ("lo",) and "vip" in r2.deferred


def test_controller_quota_caps_arbitration_until_grace():
    shard = (np.arange(96) % 4).astype(np.int32)

    def script(s):
        tenants = (s.core.TenantSpec("hot", 0), s.core.TenantSpec("cold", 0))
        d = _sharded_drive(s, shard, 4, tenants=tenants, window=256, min_queries=1,
                           capacity=96.0, tenant_quota_bytes={"hot": 1.0}, quota_grace=2)
        for offset, hot_only in ((0, True), (8, False), (16, False), (24, False)):
            hot = [[offset + i, offset + i + 1] for i in range(0, 6, 2)]
            cold = [] if hot_only else [[48 + offset + i + j for j in range(4)]
                                        for i in range(0, 8, 4)]
            ps = s.from_lists(hot + cold, list(range(len(hot) + len(cold))))
            slo = s.core.SLOSpec.from_tenants(
                tenants, np.asarray([0] * len(hot) + [1] * len(cold), np.int32))
            _observe_slo(d, ps, slo)
        return d

    p = _both_drives(script)
    r = [rep for rep, _ in p.steps]
    assert r[0].tenants == ("hot",)
    assert r[1].tenants == ("cold",) and r[1].deferred == ("hot",)
    assert r[2].tenants == ("cold",) and r[2].deferred == ("hot",)
    assert r[3].tenants == ("hot",) and "cold" in r[3].deferred
    assert p.ctl.tenant_stats()["hot"]["repair_bytes"] > 1.0


# ---------------------------------------------------------------------------
# test_incremental.py: the dirty-set re-check and forecast pre-warm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("inc", [False, True])
def test_controller_incremental_recheck_is_bit_identical(inc):
    phases, (mask, shard) = _drifted_setup(seed=5)

    def script(s):
        d = Drive(s, mask, shard, t=1, window=300, min_queries=20, incremental_recheck=inc)
        for _ in range(3):
            d.observe(phases[1].pathset)
        return d

    p = _both_drives(script)
    # the port's report stream does not depend on the cache either
    q = Drive(PORT, mask, shard, t=1, window=300, min_queries=20, incremental_recheck=not inc)
    for _ in range(3):
        q.observe(phases[1].pathset)
    assert_drives_equal(p, q)


def test_forecast_prewarm_shrinks_violation_window():
    phases, (mask, shard) = _drifted_setup(seed=9)
    flip = phases[1].pathset

    def reactive(s):
        d = Drive(s, mask, shard, t=1, window=400, min_queries=20)
        d.bad = int((d.engine.query_latencies(d.side.paths(flip), d.engine.path_latencies(
            d.side.paths(flip), policy="home_first")) > 1).sum())
        d.observe(flip)
        return d

    def forecast(s):
        d = Drive(s, mask, shard, t=1, window=400, min_queries=20)
        d.observe(phases[0].pathset, forecast=s.paths(flip))
        fl = d.side.paths(flip)
        d.bad = int((d.engine.query_latencies(fl, d.engine.path_latencies(fl)) > 1).sum())
        d.observe(flip)
        d.observe(phases[0].pathset, forecast=s.paths(flip))
        return d

    r = _both_drives(reactive)
    f = _both_drives(forecast)
    assert r.bad > 0 and r.steps[0][0].trigger == "feasibility"
    r0, quiet, r2 = (rep for rep, _ in f.steps)
    assert r0.trigger == "forecast" and r0.replicas_added > 0 and r0.feasible_after
    assert f.bad == 0 and quiet is None
    assert r2.trigger == "forecast" and r2.replicas_added == 0


@pytest.mark.parametrize("score_policy", ["home_first", "nearest_copy"])
def test_eviction_then_incremental_recheck_equals_full(score_policy):
    """A repair that evicts: cold replicas (on objects no window touches)
    push every server over capacity, so the pass evicts and re-packs the
    engine (removals are not monotone).  The next incremental re-checks
    must then see the new words: each window's latencies equal a full
    evaluation and a fresh engine's, on the port as in ``repro``."""
    phases, (mask, shard) = _drifted_setup(seed=3)
    used = np.unique(np.concatenate([np.asarray(p.pathset.objects).ravel() for p in phases]))
    cold = np.setdiff1d(np.arange(mask.shape[0]), used)
    extra = mask.copy()
    extra[cold] = True
    cap = float(mask.sum(axis=0).max()) + 4.0  # below the cold copies' load

    def script(s):
        d = Drive(s, extra, shard, t=1, window=300, min_queries=20, capacity=cap,
                  score_policy=score_policy)
        for ps in (phases[0].pathset, phases[1].pathset, phases[1].pathset):
            d.observe(ps)
        return d

    p = _both_drives(script)
    reports = [r for r, _ in p.steps if r is not None]
    assert reports and sum(r.replicas_evicted for r in reports) > 0
    fresh = PORT.engine.LatencyEngine(p.scheme.copy(), device="cpu")
    eng = p.ctl.engine
    for w in p.ctl._tenants.values():
        for e in w.entries:
            full = fresh.path_latencies(e.pathset, policy=score_policy)
            assert np.array_equal(e.path_lats, full)
            assert np.array_equal(eng.path_latencies(e.pathset, policy=score_policy,
                                                     incremental=True), full)
            assert np.array_equal(eng.path_latencies(e.pathset, policy=score_policy), full)


# ---------------------------------------------------------------------------
# test_obs.py: a repair explains itself
# ---------------------------------------------------------------------------
def test_controller_report_carries_blame():
    rng = np.random.default_rng(0)
    n_obj = 30
    shard = np.zeros(n_obj, np.int32)
    shard[20:] = rng.integers(1, 3, 10)
    ps = PORT.from_lists([[int(rng.integers(0, 10)), int(rng.integers(20, n_obj)),
                           int(rng.integers(10, 20))] for _ in range(120)], list(range(120)))
    mask = np.zeros((n_obj, 3), bool)
    mask[np.arange(n_obj), shard] = True

    def run(s):
        cluster = s.cluster(mask, shard)
        rep0 = s.simulate(cluster, s.paths(ps), rate_qps=400_000, seed=3, concurrency=2)
        tr = s.obs.Tracer(budget_us=float(np.percentile(rep0.latency_us, 90.0)))
        rep = s.simulate(cluster, s.paths(ps), rate_qps=400_000, seed=3, concurrency=2,
                         trace=tr)
        ctl = s.controller(cluster, s.serve.ControllerConfig(t=1, window=512, min_queries=32))
        traced = ctl.observe(s.paths(ps), latency_us=rep.latency_us, trace=tr)
        ctl2 = s.controller(s.cluster(mask, shard),
                            s.serve.ControllerConfig(t=1, window=512, min_queries=32))
        return rep, traced, ctl2.observe(s.paths(ps), latency_us=rep.latency_us)

    (jr, jt, ju), (rep, traced, untraced) = both(run)
    assert_sim_equal(jr, rep)
    assert_adapt_equal(jt, traced)
    assert_adapt_equal(ju, untraced)
    assert traced is not None and traced.blame is not None
    assert traced.blame["default"]["top_server"] == 0
    assert traced.blame["default"]["burn_rate"] > 1.0
    assert untraced is not None and untraced.blame is None


# ---------------------------------------------------------------------------
# test_faults.py: the liveness reaction
# ---------------------------------------------------------------------------
def test_chaos_kill_revive_mid_drift_controller_shrinks_window():
    ps, shard = random_workload(np.random.default_rng(11), n_obj=120, n_srv=6, n_paths=160)
    mask, shard = _greedy(ps, shard.copy(), 6, 2)
    kw = dict(rate_qps=2_000.0, seed=5, concurrency=8)
    kinds = ((30_000.0, "kill", 2), (70_000.0, "revive", 2))

    def run(s):
        chaos = [s.distsys.ChaosEvent(*k) for k in kinds]
        calm = s.simulate(s.cluster(mask, shard), s.paths(ps), **kw)
        static = s.simulate(s.cluster(mask, shard), s.paths(ps), chaos=chaos, **kw)
        d = Drive(s, mask, shard, t=2)
        d.cluster.fail_server(2)
        d.liveness(ps)
        d.cluster.recover_server(2)
        reactive = s.simulate(s.distsys.Cluster(d.scheme.copy()), s.paths(ps), chaos=chaos,
                              **kw)
        return calm, static, reactive, d

    (jc, js, jr, jd), (calm, static, reactive, d) = both(run)
    for a, b in ((jc, calm), (js, static), (jr, reactive)):
        assert_sim_equal(a, b)
    assert_drives_equal(jd, d)
    rep = d.steps[0][0]
    assert rep.trigger == "liveness" and rep.replicas_added > 0 and rep.feasible_after
    thr = 1.3 * np.percentile(calm.latency_us, 99)
    total = lambda w: sum(hi - lo for lo, hi in w)  # noqa: E731
    windows = [PORT.distsys.violation_windows(r.arrival_us + r.latency_us, r.latency_us > thr)
               for r in (static, reactive)]
    assert windows[0] and total(windows[1]) < total(windows[0])


def test_controller_liveness_noop_when_all_alive():
    ps, shard = random_workload(np.random.default_rng(0), n_obj=100, n_srv=5, n_paths=100)
    mask, shard = _greedy(ps, shard.copy(), 5, 2)

    def script(s):
        d = Drive(s, mask, shard, t=2)
        d.liveness(ps)
        return d

    assert _both_drives(script).steps[0][0] is None


@pytest.mark.parametrize("score_policy", ["home_first", "nearest_copy"])
def test_liveness_repair_feasible_under_score_policy(score_policy):
    ps, shard = random_workload(np.random.default_rng(0), n_obj=120, n_srv=6, n_paths=150)
    mask, shard = _greedy(ps, shard.copy(), 6, 2, policy="nearest_copy")

    def script(s):
        d = Drive(s, mask, shard, t=2, score_policy=score_policy)
        d.cluster.fail_server(1)
        d.liveness(ps)
        d.cluster.fail_server(4)
        d.liveness(ps)
        return d

    p = _both_drives(script)
    for rep, _ in p.steps:
        assert rep.trigger == "liveness" and rep.feasible_after
    res = PORT.engine.KResilient(k=1, domains=((1, 4),))
    assert p.ctl.engine.is_resilient_feasible(PORT.paths(ps), np.full(ps.n_queries, 2, np.int32),
                                              res, policy=score_policy)


# ---------------------------------------------------------------------------
# the card: a drift on kernel against its torch twin
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("score_policy", ["home_first", "nearest_copy"])
def test_controller_kernel_equals_torch_on_the_card(score_policy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walks and the UPDATE batches have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    phases, (mask, shard) = _drifted_setup(seed=3)
    drives = []
    for backend in ("kernel", "torch"):
        scheme = PORT.scheme(mask, shard)
        cluster = PORT.distsys.Cluster(scheme)
        ctl = PORT.serve.AdaptiveController(
            cluster, PORT.serve.ControllerConfig(t=1, window=300, min_queries=20,
                                                 score_policy=score_policy),
            device="cuda", backend=backend)
        steps = []
        for ph in phases:
            rep = PORT.serve.simulate(cluster, ph.pathset, rate_qps=2e4, seed=1, device="cuda",
                                      backend=backend)
            steps.append((rep, ctl.observe(ph.pathset, latency_us=rep.latency_us),
                          scheme.mask.copy()))
        cluster.fail_server(2)
        steps.append((None, ctl.on_liveness_change(phases[1].pathset), scheme.mask.copy()))
        drives.append(steps)
    for (ka, kb, km), (ta, tb, tm) in zip(*drives):
        if ka is not None:
            assert_sim_equal(ka, ta)
        assert_adapt_equal(kb, tb)
        assert np.array_equal(km, tm)


# ---------------------------------------------------------------------------
# benchmarks/torch_tenant_frontier.py: the drift part
# ---------------------------------------------------------------------------
def test_tenant_frontier_drift_equals_repro():
    """The port's drift block (arbitrating multi-tenant controller over
    three ``snb_drift`` / ``gnn_drift`` phases, per-tenant p99 static vs
    repaired) equals ``benchmarks/tenant_frontier.py``'s on the same
    numpy, float for float."""
    from benchmarks.tenant_frontier import _drift
    from benchmarks.torch_tenant_frontier import drift

    want = {}
    _drift(want)
    got = drift(device="cpu")
    assert got == want["drift"]
    assert got["adaptations"] > 0 and all(got["controller_beats_static"].values())


# ---------------------------------------------------------------------------
# examples/torch_serve_replicated.py
# ---------------------------------------------------------------------------
def test_serve_replicated_example_equals_repro():
    """The port's serving example on the CPU: every phase feasible, and each
    phase's SimReport and adaptation equal to ``examples/serve_replicated.py``'s
    steps run on the JAX package."""
    import importlib.util
    import pathlib

    import repro.core as R
    import repro.graph as RG

    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / "torch_serve_replicated.py"
    spec = importlib.util.spec_from_file_location("torch_serve_replicated", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    rows, overhead = ex.run(device="cpu")

    snb = RG.snb_like(1, seed=0)
    f = snb.graph.object_sizes().astype(np.float32)
    shard = RG.make_sharding("hash", snb.graph, ex.N_SERVERS, seed=0)
    phases = JAX.serve.snb_drift(snb, n_phases=3, queries_per_phase=600, seed=0)
    scheme, _, engine = R.replicate_workload(phases[0].pathset, shard, ex.N_SERVERS, t=ex.T,
                                             f=f, return_engine=True)
    cluster = JAX.distsys.Cluster(scheme, f=f)
    ctl = JAX.serve.AdaptiveController(
        cluster, JAX.serve.ControllerConfig(t=ex.T, window=400, min_queries=100), f=f,
        engine=engine)
    for row, delta in zip(rows, JAX.serve.drift_stream(phases)):
        rep = JAX.serve.simulate(cluster, delta.pathset, rate_qps=ex.RATE_QPS, seed=delta.phase)
        assert_sim_equal(rep, row["report"])
        assert_adapt_equal(ctl.observe(delta.pathset, latency_us=rep.latency_us),
                           row["adaptation"])
        assert row["feasible"]
    assert overhead == cluster.scheme.replication_overhead(f)
    assert sum(r["adaptation"] is not None for r in rows) == 2
