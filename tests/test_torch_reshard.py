"""The port's §5.4 resharding (``repro_torch.core.reshard``) and fault
driver (``repro_torch.distsys.faults``) against the JAX package's on the
same seeded inputs (CPU, exact): ``apply_reshard``, ``drain_server`` and
``repair_paths`` give the same masks, shards, resharding maps and
reports; ``event_schedule``, ``apply_event`` / ``run_schedule`` (a
resident engine resynced after every event), ``chaos_schedule``,
``violation_windows`` and ``time_to_repair`` give the same results.
"""
import copy
import dataclasses

import numpy as np
import pytest

import repro.core as J
import repro.distsys as JD
import repro_torch.core as T
import repro_torch.distsys as TD
from conftest import random_workload
from repro_torch.engine import LatencyEngine


@pytest.fixture(scope="module")
def built():
    """A t = 1 scheme with its resharding entries (JAX greedy), 6 servers."""
    ps, shard = random_workload(np.random.default_rng(0), n_obj=150, n_srv=6, n_paths=200)
    scheme, stats = J.replicate_workload(ps, shard.copy(), 6, 1, track_rm=True)
    return ps, scheme, stats.rm


def _pair(built):
    ps, scheme, rm = built
    js = J.ReplicationScheme(scheme.mask.copy(), scheme.shard.copy())  # copy() shares shard
    ts = T.ReplicationScheme(scheme.mask.copy(), scheme.shard.copy())
    return (ps, js, J.ReshardingMap.from_entries(rm, js.shard),
            T.PathSet(ps.objects, ps.lengths, ps.query_ids), ts,
            T.ReshardingMap.from_entries(rm, ts.shard))


def _same_state(js, jm, ts, tm):
    assert np.array_equal(js.mask, ts.mask) and np.array_equal(js.shard, ts.shard)
    assert jm.rm == tm.rm and jm.rc == tm.rc


def test_resharding_map_from_entries(built):
    _, js, jm, _, ts, tm = _pair(built)
    _same_state(js, jm, ts, tm)
    assert jm.n_entries() == tm.n_entries() > 0


@pytest.mark.parametrize("sized", [False, True])
def test_apply_reshard_matches_jax(built, sized):
    _, js, jm, _, ts, tm = _pair(built)
    f = np.random.default_rng(1).uniform(0.5, 2.0, 150) if sized else None
    moves = {int(u): 1 for u in np.nonzero(js.shard == 0)[0]}
    moves.update({int(u): 4 for u in np.nonzero(js.shard == 5)[0][::2]})
    jr = J.apply_reshard(js, jm, moves, f)
    tr = T.apply_reshard(ts, tm, moves, f)
    assert dataclasses.asdict(jr) == dataclasses.asdict(tr)
    assert tr.moved_originals > 0 and tr.replicas_deleted > 0
    _same_state(js, jm, ts, tm)


@pytest.mark.parametrize("strategy", ["single", "round_robin"])
def test_drain_and_repair_match_jax(built, strategy):
    """A drain, then the repair on the port's engine (torch backend) and on
    the JAX package's: the same moves, reports, masks and maps, and the
    repaired scheme feasible."""
    jps, js, jm, tps, ts, tm = _pair(built)
    f = np.random.default_rng(2).uniform(0.5, 2.0, 150)
    jmoves, jr = J.drain_server(js, jm, 3, f, strategy=strategy)
    tmoves, tr = T.drain_server(ts, tm, 3, f, strategy=strategy)
    assert jmoves == tmoves and dataclasses.asdict(jr) == dataclasses.asdict(tr)
    _same_state(js, jm, ts, tm)
    want = J.repair_paths(js, jm, jps, 1, f)
    got = T.repair_paths(ts, tm, tps, 1, f, device="cpu")
    assert got == want and got["failed_paths"] == 0
    if strategy == "round_robin":
        assert got["repaired_paths"] > 0
    _same_state(js, jm, ts, tm)
    assert T.is_latency_feasible(tps, ts, 1, device="cpu")
    with pytest.raises(ValueError):
        T.drain_server(ts, tm, 2, strategy="nope")


def test_repair_with_capacity_matches_jax(built):
    jps, js, jm, tps, ts, tm = _pair(built)
    J.drain_server(js, jm, 0, strategy="round_robin")
    T.drain_server(ts, tm, 0, strategy="round_robin")
    cap = js.storage_per_server().max() + 3.0
    want = J.repair_paths(js, jm, jps, 0, capacity=cap, epsilon=0.5)
    got = T.repair_paths(ts, tm, tps, 0, capacity=cap, epsilon=0.5, device="cpu",
                         backend="reference")
    assert got == want and got["failed_paths"] > 0
    _same_state(js, jm, ts, tm)


def _events(ev_list):
    return [dataclasses.astuple(e) for e in ev_list]


@pytest.mark.parametrize("kinds", [("fail", "recover"), ("fail", "recover", "scale_out"),
                                   ("scale_in", "recover", "scale_out")])
def test_event_schedule_matches_jax(kinds):
    for seed in range(3):
        want = JD.event_schedule(6, 24, 100, seed=seed, kinds=kinds)
        got = TD.event_schedule(6, 24, 100, seed=seed, kinds=kinds)
        assert _events(want) == _events(got) and got


def test_run_schedule_matches_jax(built):
    """Every event of a schedule applied to both clusters: the same reports
    and schemes; the port's resident engine, resynced by each event,
    agrees with a fresh engine after every step."""
    _, js, jm, tps, ts, tm = _pair(built)
    jc, tc = JD.Cluster(js), TD.Cluster(ts)
    engine = LatencyEngine(ts, device="cpu")
    events = TD.event_schedule(6, 12, 100, seed=3, kinds=("fail", "recover", "scale_out"))
    j_events = JD.event_schedule(6, 12, 100, seed=3, kinds=("fail", "recover", "scale_out"))
    kinds = set()
    for (jev, jrep), (tev, trep) in zip(JD.run_schedule(jc, jm, j_events),
                                        TD.run_schedule(tc, tm, events, engine=engine)):
        assert dataclasses.astuple(jev) == dataclasses.astuple(tev)
        assert jrep == trep and not trep.get("skipped")
        kinds.add(tev.kind)
        _same_state(jc.scheme, jm, tc.scheme, tm)
        assert [s.alive for s in jc.servers] == [s.alive for s in tc.servers]
        fresh = LatencyEngine(tc.scheme, device="cpu").path_latencies(tps)
        assert np.array_equal(engine.path_latencies(tps), fresh)
    assert kinds == {"fail", "recover", "scale_out"}


def test_inapplicable_events_match_jax(built):
    _, js, jm, _, ts, tm = _pair(built)
    jc, tc = JD.Cluster(js), TD.Cluster(ts)
    for c in (jc, tc):
        c.fail_server(2)
    for ev in (("recover", 0, 1), ("fail", 2, 2), ("scale_in", 2, 3)):
        assert JD.apply_event(jc, jm, JD.Event(*ev)) == TD.apply_event(tc, tm, TD.Event(*ev))
    for s in (0, 1, 3, 4):
        for c in (jc, tc):
            c.fail_server(s)
    assert JD.apply_event(jc, jm, JD.Event("fail", 5, 4)) == TD.apply_event(
        tc, tm, TD.Event("fail", 5, 4))
    with pytest.raises(ValueError):
        TD.apply_event(tc, tm, TD.Event("melt", 0, 0))


@pytest.mark.parametrize("min_alive", [1, 2])
def test_chaos_schedule_matches_jax(min_alive):
    for seed in range(3):
        want = JD.chaos_schedule(5, 30, 100_000.0, seed=seed, min_alive=min_alive)
        got = TD.chaos_schedule(5, 30, 100_000.0, seed=seed, min_alive=min_alive)
        assert _events(want) == _events(got) and got


def test_violation_windows_and_ttr_match_jax():
    rng = np.random.default_rng(4)
    fin = np.sort(rng.uniform(0, 50_000.0, 400))
    bad = rng.random(400) < 0.1
    for bin_us in (250.0, 1000.0, 4000.0):
        want = JD.violation_windows(fin, bad, bin_us)
        got = TD.violation_windows(fin, bad, bin_us)
        assert want == got and got
        for kill in (0.0, 1234.5, 30_000.0, 60_000.0):
            assert JD.time_to_repair(want, kill) == TD.time_to_repair(got, kill)
    assert TD.violation_windows(fin, np.zeros(400, bool)) == []
    assert TD.violation_windows(np.zeros(0), np.zeros(0, bool)) == []


def test_drain_dirty_objects_match_jax(built):
    from repro.distsys.faults import _drain_dirty_objects as j_dirty
    from repro_torch.distsys.faults import _drain_dirty_objects as t_dirty

    _, js, jm, _, ts, tm = _pair(built)
    for s in range(6):
        assert np.array_equal(np.sort(j_dirty(js, jm, s)), np.sort(t_dirty(ts, tm, s)))
    assert copy.deepcopy(tm.rm) == jm.rm
