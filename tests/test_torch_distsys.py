"""The port's cluster, router, executor, routing table and checkpoints
(``repro_torch.distsys``) against the JAX package's on the same seeded
numpy inputs.

* On the CPU (``device="cpu"``, the torch backend): ``execute_workload``'s
  report equals ``repro``'s field for field and bit for bit (latencies,
  traversals, per-server counters, failed queries, throughput, and the
  cluster's server counters) under the four routing policies, routers
  home / replica_lb / hedged, with and without ``hedge_replicas``, all
  servers alive or one dead with objects that have no alive copy; the
  walk (``trace_paths``) with arbitrary starts, -1 included;
  ``trace_paths_batched`` equal to row-wise ``trace_paths``; the routers,
  the routing table, the structural spans and the checkpoints.
* On the card (``cuda``, skipped without one): ``trace_paths`` and
  ``execute_workload`` on the ``kernel`` backend (the ``routed_walk`` /
  ``scored_walk`` kernels) against the ``torch`` backend, on random schemes
  with dead servers and W 1, 2 and 3 (6, 40 and 70 servers).
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import repro.core as J
import repro.distsys as JD
import repro_torch.core as T
import repro_torch.distsys as TD
from conftest import random_workload
from repro.distsys.executor import trace_paths_batched as j_batched
from repro_torch.distsys.executor import trace_paths_batched as t_batched
from repro_torch.distsys.executor import walk_inputs
from repro_torch.kernels import routed_walk as rw

POLICIES = [None, "nearest_copy", "queue_aware", "nearest_copy_dp"]
REPORT_FIELDS = ("query_latency_us", "query_traversals", "per_server_local",
                 "per_server_rpcs", "query_failed")


def _case(seed, n_srv=5, n_obj=120, n_paths=300, dead=(), p_copy=0.2, n_queries=90):
    """A seeded workload and a scheme with random extra copies; the dead
    servers' objects without another copy are holderless."""
    rng = np.random.default_rng(seed)
    ps, shard = random_workload(rng, n_obj=n_obj, n_srv=n_srv, n_paths=n_paths,
                                n_queries=n_queries)
    mask = rng.random((n_obj, n_srv)) < p_copy
    mask[np.arange(n_obj), shard] = True
    alive = np.ones(n_srv, bool)
    alive[list(dead)] = False
    return ps, shard, mask, alive


def _schemes(shard, mask):
    return J.ReplicationScheme(mask.copy(), shard.copy()), T.ReplicationScheme(mask.copy(),
                                                                              shard.copy())


def _tps(ps):
    return T.PathSet(ps.objects, ps.lengths, ps.query_ids)


def _clusters(shard, mask, alive, load=None):
    js, ts = _schemes(shard, mask)
    jc, tc = JD.Cluster(js), TD.Cluster(ts)
    for c in (jc, tc):
        for s in np.nonzero(~alive)[0]:
            c.fail_server(int(s))
        if load is not None:
            for s, q in zip(c.servers, load):
                s.queue_depth = int(q)
    return jc, tc


def _server_counters(cluster):
    return [(s.local_accesses, s.remote_rpcs_in, s.queries_coordinated)
            for s in cluster.servers]


def _assert_reports_equal(jr, tr):
    for name in REPORT_FIELDS:
        a, b = getattr(jr, name), getattr(tr, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert jr.throughput_qps == tr.throughput_qps
    assert jr.summary() == tr.summary()


def _router(mod, cluster, name):
    return None if name == "home" else mod.Router(cluster.scheme, name)


@pytest.mark.parametrize("dead", [(), (2,)])
@pytest.mark.parametrize("hedge", [False, True])
@pytest.mark.parametrize("router", ["home", "replica_lb", "hedged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_execute_workload_matches_jax(policy, router, hedge, dead):
    ps, shard, mask, alive = _case(11, dead=dead)
    load = np.random.default_rng(5).integers(0, 4, 5)  # queue_aware ranks, replica_lb seeds
    jc, tc = _clusters(shard, mask, alive, load)
    if dead:
        assert (JD.failover_home(jc.scheme, alive) < 0).any()  # holderless objects
    kw = dict(seed=3, hedge_replicas=hedge, policy=policy)
    jr = JD.execute_workload(jc, ps, router=_router(JD, jc, router), **kw)
    tr = TD.execute_workload(tc, _tps(ps), router=_router(TD, tc, router), device="cpu", **kw)
    _assert_reports_equal(jr, tr)
    assert _server_counters(jc) == _server_counters(tc)
    if dead:
        assert tr.n_failed > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_execute_workload_wide_matches_jax(policy):
    """40 servers (two words), three dead, the hedged router."""
    ps, shard, mask, alive = _case(12, n_srv=40, dead=(0, 31, 33), p_copy=0.05)
    jc, tc = _clusters(shard, mask, alive)
    jr = JD.execute_workload(jc, ps, seed=1, router=JD.Router(jc.scheme, "hedged"),
                             policy=policy, hedge_replicas=True)
    tr = TD.execute_workload(tc, _tps(ps), seed=1, router=TD.Router(tc.scheme, "hedged"),
                             policy=policy, hedge_replicas=True, device="cpu")
    _assert_reports_equal(jr, tr)
    assert _server_counters(jc) == _server_counters(tc)


@pytest.mark.parametrize("policy", POLICIES)
def test_trace_paths_matches_jax(policy):
    """The walk from arbitrary starts (-1 included) with a dead server."""
    ps, shard, mask, alive = _case(13, dead=(1,))
    js, ts = _schemes(shard, mask)
    start = np.random.default_rng(2).integers(-1, 5, ps.n_paths).astype(np.int32)
    load = np.asarray([3, 0, 1, 1, 2])
    for st in (None, start):
        want = JD.trace_paths(ps, js, alive, st, policy=policy, load=load)
        got = TD.trace_paths(_tps(ps), ts, alive, st, policy=policy, load=load, device="cpu")
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_walk_inputs_layout():
    """The uploaded words are the liveness-filtered mask in the packed
    layout (one empty last row) and the homes the fail-over map."""
    ps, shard, mask, alive = _case(14, n_srv=40, dead=(3, 32))
    _, ts = _schemes(shard, mask)
    objects, lengths, words, home, start = walk_inputs(_tps(ps), ts, alive)
    assert words.dtype == np.int32 and words.shape == (mask.shape[0] + 1, 2)
    assert not words[-1].any()
    packed = T.ReplicationScheme(mask & alive[None, :], shard).pack()
    assert np.array_equal(words[:-1].view(np.uint32), packed)
    assert np.array_equal(home, JD.failover_home(J.ReplicationScheme(mask, shard), alive))
    assert start is None and objects.dtype == np.int32 and lengths.dtype == np.int32


@pytest.mark.parametrize("policy", [None, "nearest_copy_dp"])
def test_trace_paths_batched_matches_rowwise(policy):
    """One concatenated walk equals a walk per batch, and the JAX package's
    batched walk; mixed home / coordinator starts are filled with the
    fail-over home of each root."""
    ps, shard, mask, alive = _case(15, dead=(4,))
    js, ts = _schemes(shard, mask)
    rng = np.random.default_rng(3)
    batches = []
    for i in range(5):
        idx = rng.choice(ps.n_paths, 40, replace=False)
        st = None if i % 2 else rng.integers(0, 5, 40).astype(np.int32)
        batches.append((idx, st))
    got = t_batched(_tps(ps), ts, alive, batches, policy=policy, device="cpu")
    want = j_batched(ps, js, alive, batches, policy=policy)
    home = TD.failover_home(ts, alive)
    for (idx, st), (gs, gl), (ws, wl) in zip(batches, got, want):
        assert np.array_equal(gs, ws) and np.array_equal(gl, wl)
        sub = T.PathSet(ps.objects[idx], ps.lengths[idx], np.arange(len(idx), dtype=np.int32))
        row_start = home[np.maximum(ps.objects[idx, 0], 0)] if st is None else st
        rs, rl = TD.trace_paths(sub, ts, alive, row_start, policy=policy, device="cpu")
        assert np.array_equal(gs, rs) and np.array_equal(gl, rl)
    assert t_batched(_tps(ps), ts, alive, [], device="cpu") == []


def test_routers_match_jax():
    ps, shard, mask, alive = _case(16, dead=(0,))
    js, ts = _schemes(shard, mask)
    roots = np.maximum(ps.objects[:, 0], 0)
    load = np.asarray([0, 2, 1, 0, 3])
    for policy in ("home", "replica_lb", "hedged"):
        for a, ld in ((None, None), (alive, load)):
            want = JD.Router(js, policy).route_roots(roots, a, seed=4, load=ld)
            got = TD.Router(ts, policy).route_roots(roots, a, seed=4, load=ld)
            assert np.array_equal(want, got)
    for w, g in zip(JD.Router(js, "hedged").route_roots_hedged(roots, alive, 2, load),
                    TD.Router(ts, "hedged").route_roots_hedged(roots, alive, 2, load)):
        assert np.array_equal(w, g)
    jr, tr = JD.Router(js), TD.Router(ts)
    for obj in range(0, 120, 7):
        for cur in range(5):
            for a, ld in ((None, None), (alive, None), (None, load), (alive, load)):
                assert jr.route_hop(obj, cur, a, ld) == tr.route_hop(obj, cur, a, ld)


def test_cluster_matches_jax():
    ps, shard, mask, _ = _case(17)
    f = np.random.default_rng(0).uniform(0.5, 2.0, 120)
    js, ts = _schemes(shard, mask)
    jc = JD.Cluster(js, f=f, capacity=np.full(5, 40.0))
    tc = TD.Cluster(ts, f=f, capacity=np.full(5, 40.0))
    for c in (jc, tc):
        c.fail_server(3)
        c.apply_scheme_delta([1, 2, -1, 5], [4, 0, 1, -1])
        c.servers[1].queue_depth, c.servers[1].busy = 2, 1
    assert jc.storage_report() == tc.storage_report()
    assert np.array_equal(jc.alive_servers(), tc.alive_servers())
    assert np.array_equal(jc.queue_depths(), tc.queue_depths())
    assert np.array_equal(jc.scheme.mask, tc.scheme.mask)
    assert [jc.holds(o, s) for o in range(10) for s in range(5)] == \
        [tc.holds(o, s) for o in range(10) for s in range(5)]
    for c in (jc, tc):
        c.recover_server(3)
        c.reset_counters()
    assert np.array_equal(jc.alive_servers(), tc.alive_servers())
    assert np.array_equal(jc.queue_depths(), tc.queue_depths())


def test_routing_table_matches_jax():
    """The same lookups under liveness churn and a scale-out give the same
    picks, direct / fallback split and refreshes."""
    ps, shard, mask, _ = _case(18)
    js, ts = _schemes(shard, mask)
    jc, tc = JD.Cluster(js), TD.Cluster(ts)
    jt, tt = JD.RoutingTable(jc, max_age_us=300.0), TD.RoutingTable(tc, max_age_us=300.0)
    rng = np.random.default_rng(9)
    now = 0.0
    for step in range(200):
        now += float(rng.uniform(0, 40))
        if step % 37 == 5:
            s = int(rng.integers(0, 5))
            for c in (jc, tc):
                (c.recover_server if not c.servers[s].alive else c.fail_server)(s)
        if step == 120:
            for c in (jc, tc):
                c.scheme.mask = np.pad(c.scheme.mask, ((0, 0), (0, 1)))
                c.servers.append(type(c.servers[0])(5))
        obj = int(rng.integers(0, 120))
        assert jt.lookup(obj, now) == tt.lookup(obj, now)
    assert jt.summary() == tt.summary() and tt.summary()["fallbacks"] > 0


class _Spans:
    """A span recorder with the tracer's interface."""

    def __init__(self):
        self.records, self.finals, self.policy = [], [], None

    def record(self, *args):
        self.records.append(args)

    def finalize(self, *args, **kw):
        self.finals.append((args, kw))


def test_structural_spans_match_jax():
    ps, shard, mask, alive = _case(19, dead=(2,))
    jc, tc = _clusters(shard, mask, alive)
    jt, tt = _Spans(), _Spans()
    JD.execute_workload(jc, ps, seed=2, policy="nearest_copy", trace=jt)
    TD.execute_workload(tc, _tps(ps), seed=2, policy="nearest_copy", trace=tt, device="cpu")
    assert jt.records == tt.records and jt.finals == tt.finals
    assert jt.policy == tt.policy == "nearest_copy" and len(tt.records) > 0


def test_latency_model_draws_match_jax():
    rng = np.random.default_rng(0)
    n_local = rng.integers(0, 7, 500).astype(np.float64)
    n_remote = rng.integers(0, 4, 500).astype(np.float64)
    for jm, tm in ((JD.LatencyModel(), TD.LatencyModel()),
                   (JD.LatencyModel(1.0, 80.0, 0.3, 2.0), TD.LatencyModel(1.0, 80.0, 0.3, 2.0))):
        want = jm.sample(n_local, n_remote, np.random.default_rng(4))
        got = tm.sample(n_local, n_remote, np.random.default_rng(4))
        assert np.array_equal(want, got)


def test_executor_surfaces_failed_queries():
    """An object with no alive copy: the query is reported failed, the run
    completes (the JAX package's own case)."""
    shard = np.asarray([0, 1, 1], np.int32)
    cl = TD.Cluster(T.ReplicationScheme.from_sharding(shard, 2))
    cl.fail_server(0)
    rep = TD.execute_workload(cl, T.PathSet.from_lists([[0, 1], [1, 2]]), seed=0,
                              device="cpu")
    assert rep.query_failed.tolist() == [True, False] and rep.n_failed == 1
    assert np.isfinite(rep.query_latency_us).all()


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(32, 8)).astype(np.float32),
            "opt": [np.arange(6), (np.zeros(2), None)],
            "b": np.float64(3.5),
            "mask": rng.random((10, 6)) < 0.3}


def test_checkpoint_matches_jax_layout():
    """The same tree gives the same manifest (names, shapes, dtypes,
    checksum) and arrays in both packages, and each restores the other's."""
    tree = _tree()
    with tempfile.TemporaryDirectory() as d:
        jm, tm = JD.CheckpointManager(os.path.join(d, "j")), TD.CheckpointManager(
            os.path.join(d, "t"))
        jm.save(4, tree)
        tm.save(4, tree)
        import json

        man = [json.load(open(os.path.join(d, k, "step_4", "manifest.json")))
               for k in ("j", "t")]
        for key in ("step", "names", "shapes", "dtypes", "checksum"):
            assert man[0][key] == man[1][key], key
        got, step = TD.CheckpointManager(os.path.join(d, "j")).restore_latest(tree)
        assert step == 4
        back = JD.CheckpointManager(os.path.join(d, "t")).restore(4, tree)
        for out in (got, back):
            assert np.array_equal(out["w"], tree["w"]) and np.array_equal(out["mask"],
                                                                          tree["mask"])
            assert np.array_equal(out["opt"][0], tree["opt"][0]) and out["opt"][1][1] is None
            assert float(out["b"]) == 3.5


def test_checkpoint_roundtrip_retention_and_tensors():
    tree = {"w": torch.arange(6, dtype=torch.float32), "h": torch.ones(3, dtype=torch.bfloat16),
            "b": np.zeros(2)}
    with tempfile.TemporaryDirectory() as d:
        mgr = TD.CheckpointManager(d, keep=2)
        for step in (1, 2, 3):
            mgr.save(step, tree)
        assert mgr.all_steps() == [2, 3]
        got, step = mgr.restore_latest(tree)
        assert step == 3
        assert torch.equal(got["w"], tree["w"]) and got["h"].dtype == torch.bfloat16
        assert torch.equal(got["h"], tree["h"]) and isinstance(got["b"], np.ndarray)
        assert TD.CheckpointManager(os.path.join(d, "empty")).restore_latest(tree) == (None, -1)


def test_checkpoint_async_snapshot():
    """``save_async`` snapshots at the call: a later in-place change of the
    tree is not in the checkpoint."""
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(32, 8)))
    want = w.clone()
    with tempfile.TemporaryDirectory() as d:
        mgr = TD.CheckpointManager(d)
        mgr.save_async(7, {"w": w})
        w.add_(1.0)
        mgr.wait()
        got, step = mgr.restore_latest({"w": w})
        assert step == 7 and torch.equal(got["w"], want)


def test_checkpoint_corruption_detected():
    with tempfile.TemporaryDirectory() as d:
        mgr = TD.CheckpointManager(d)
        mgr.save(1, {"w": np.ones(4, np.float32)})
        path = os.path.join(d, "step_1", "arrays.npz")
        data = open(path, "rb").read()
        open(path, "wb").write(data[: len(data) // 2])
        with pytest.raises(Exception):
            mgr.restore(1, {"w": np.ones(4, np.float32)})
        mgr.save(2, {"w": np.ones(4, np.float32)})
        man = os.path.join(d, "step_2", "manifest.json")
        text = open(man).read().replace('"checksum": "', '"checksum": "0')
        open(man, "w").write(text)
        with pytest.raises(IOError, match="checksum mismatch"):
            mgr.restore(2, {"w": np.ones(4, np.float32)})


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("n_srv", [6, 40, 70])
@pytest.mark.parametrize("policy", POLICIES)
def test_trace_paths_kernel_matches_torch(cuda, policy, n_srv):
    """``routed_walk`` / ``scored_walk`` under the executor's inputs: dead
    servers (holderless objects, fail-over homes of -1) and starts of -1
    filled by the fail-over home of each root, as ``trace_paths_batched``
    fills them."""
    ps, shard, mask, alive = _case(n_srv, n_srv=n_srv, n_obj=400, n_paths=3000,
                                   dead=(0, n_srv - 1), p_copy=0.1)
    lonely = np.nonzero(~alive[shard])[0][::3]  # every third object of the dead servers
    mask[lonely] = False
    mask[lonely, shard[lonely]] = True  # only their dead home holds them
    _, ts = _schemes(shard, mask)
    tps = _tps(ps)
    rng = np.random.default_rng(n_srv)
    start = rng.integers(-1, n_srv, ps.n_paths).astype(np.int32)
    home = TD.failover_home(ts, alive)
    filled = np.where(start >= 0, start, home[np.maximum(ps.objects[:, 0], 0)]).astype(np.int32)
    load = rng.integers(0, 3, n_srv)
    counter = "SCORED_LAUNCHES" if policy == "nearest_copy_dp" else "LAUNCHES"
    for st in (None, start, filled):
        before = getattr(rw, counter)
        got = TD.trace_paths(tps, ts, alive, st, policy=policy, load=load, device=cuda,
                             backend="kernel")
        assert getattr(rw, counter) > before
        want = TD.trace_paths(tps, ts, alive, st, policy=policy, load=load, device=cuda,
                              backend="torch")
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        assert (got[0] < 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("router", ["home", "hedged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_execute_workload_kernel_matches_torch(cuda, policy, router):
    ps, shard, mask, alive = _case(21, n_srv=40, n_obj=400, n_paths=3000, dead=(5,),
                                   p_copy=0.05)
    lonely = np.nonzero(shard == 5)[0][::3]
    mask[lonely] = False
    mask[lonely, 5] = True
    reports = []
    for backend in ("kernel", "torch"):
        _, ts = _schemes(shard, mask)
        cl = TD.Cluster(ts)
        cl.fail_server(5)
        reports.append(TD.execute_workload(cl, _tps(ps), seed=4, policy=policy,
                                           router=_router(TD, cl, router),
                                           hedge_replicas=True, device=cuda,
                                           backend=backend))
        reports[-1].counters = _server_counters(cl)
    _assert_reports_equal(*reports)
    assert reports[0].counters == reports[1].counters and reports[0].n_failed > 0
