"""The port's engine against the JAX package's engine, exactly.

The port's ``torch`` backend (and its ``reference`` oracle) is held
against ``repro``'s ``jnp`` backend, its ``pallas`` backend (interpret
mode on the CPU, as ``tests/test_engine.py`` runs it) and its
``reference`` oracle: integer path latencies and full access traces
under ``home_first``, ``nearest_copy``, ``queue_aware`` and
``nearest_copy_dp``.  Each kernel's plain torch version is also held
against the Pallas kernel it replaces, on the gathered inputs that kernel
takes.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.slo import SLOSpec as JSLO
from repro.engine import LatencyEngine as JEngine
from repro.engine import PackedScheme as JPacked
from repro.engine.backends import pallas_prep
from repro.kernels.path_latency import path_latency_pallas
from repro.kernels.routed_walk import routed_walk_pallas
from repro_torch.core.slo import SLOSpec as TSLO
from repro_torch.engine import LatencyEngine as TEngine
from repro_torch.kernels.path_latency import path_latency_plain
from repro_torch.kernels.routed_walk import routed_walk_plain

CPU = "cpu"
POLICIES = ("home_first", "nearest_copy", "queue_aware", "nearest_copy_dp")


def _case(seed, n_obj=150, n_srv=5, n_paths=200, max_len=7, extra=0.15):
    """Random scheme + paths, with empty and one-object paths mixed in."""
    rng = np.random.default_rng(seed)
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    mask = np.zeros((n_obj, n_srv), bool)
    mask[np.arange(n_obj), shard] = True
    k = int(extra * n_obj * n_srv)
    mask[rng.integers(0, n_obj, k), rng.integers(0, n_srv, k)] = True
    paths = [
        rng.integers(0, n_obj, rng.integers(1, max_len + 1)).tolist()
        for _ in range(n_paths)
    ]
    paths[3] = []
    paths[7] = []
    paths[11] = [int(rng.integers(0, n_obj))]
    qids = np.sort(rng.integers(0, n_paths // 3, n_paths))
    jps = R.PathSet.from_lists(paths, qids.tolist())
    tps = T.PathSet(jps.objects, jps.lengths, jps.query_ids)
    # a load vector with ties (servers 1 and 3 share the minimum)
    load = np.full(n_srv, 2.0)
    load[1] = load[3] = 0.0
    load[0] = 1.0
    return jps, tps, mask, shard, load


def _engines(mask, shard):
    js = R.ReplicationScheme(mask.copy(), shard)
    ts = T.ReplicationScheme.from_numpy(mask, shard)
    return (
        {b: JEngine(js, backend=b, chunk=128) for b in ("jnp", "pallas", "reference")},
        {b: TEngine(ts, backend=b, chunk=128, device=CPU) for b in ("torch", "reference")},
    )


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n_srv", [5, 40, 70])
def test_path_latencies_match_all_jax_backends(policy, n_srv):
    jps, tps, mask, shard, load = _case(n_srv, n_srv=n_srv)
    load = np.resize(load, n_srv)
    jeng, teng = _engines(mask, shard)
    want = jeng["reference"].path_latencies(jps, policy=policy, load=load)
    for b, e in jeng.items():
        assert np.array_equal(e.path_latencies(jps, policy=policy, load=load), want), b
    for b, e in teng.items():
        got = e.path_latencies(tps, policy=policy, load=load)
        assert got.dtype == np.int32
        assert np.array_equal(got, want), b


def test_bool_scan_matches_jax():
    from repro.engine.backends import bool_scan as j_bool_scan
    from repro_torch.engine.backends import bool_scan

    jps, _, mask, shard, _ = _case(12, n_srv=40)
    want = np.asarray(j_bool_scan(jps.objects, jps.lengths, mask, shard))
    got = bool_scan(*(torch.from_numpy(np.array(a)) for a in
                      (jps.objects, jps.lengths, mask, shard)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("policy", ["nearest_copy", "queue_aware", "nearest_copy_dp"])
def test_backend_functions_match_jax(policy):
    from repro.engine import backends as jb
    from repro_torch.engine import backends as tb

    jps, _, mask, shard, load = _case(13, n_srv=40)
    load = np.resize(load, 40)
    words = np.asarray(JPacked.from_mask(mask, shard).words)
    args = (jps.objects, jps.lengths, words.view(np.int32), shard)
    t_args = [torch.from_numpy(np.array(a)) for a in args]
    want = np.asarray(jb.routed_counts(jps.objects, jps.lengths, words, shard, policy, load))
    got = tb.routed_counts(*t_args, policy, load)
    assert np.array_equal(got.numpy(), want)
    ws, wl = jb.access_trace(jps.objects, jps.lengths, words, shard, policy=policy, load=load)
    s, l = tb.access_trace(*t_args, policy=policy, load=load)
    assert np.array_equal(s.numpy(), np.asarray(ws)) and np.array_equal(l.numpy(), np.asarray(wl))


@pytest.mark.parametrize("policy", POLICIES)
def test_access_trace_matches(policy):
    jps, tps, mask, shard, load = _case(1)
    jeng, teng = _engines(mask, shard)
    start = np.random.default_rng(2).integers(0, 5, jps.n_paths).astype(np.int32)
    for kw in ({}, {"start": start}):
        ws, wl = jeng["jnp"].access_trace(jps, policy=policy, load=load, **kw)
        for b in ("pallas", "reference"):
            s, l = jeng[b].access_trace(jps, policy=policy, load=load, **kw)
            assert np.array_equal(s, ws) and np.array_equal(l, wl), b
        for b, e in teng.items():
            s, l = e.access_trace(tps, policy=policy, load=load, **kw)
            assert np.array_equal(s, ws), b
            assert np.array_equal(l, wl), b
            assert l.dtype == bool


def test_chunked_prepared_and_updates():
    jps, tps, mask, shard, load = _case(3, n_paths=300)
    jeng, teng = _engines(mask, shard)
    je, te = jeng["jnp"], teng["torch"]
    prepared = te.prepare(tps)
    for policy in POLICIES:
        want = je.path_latencies(jps, policy=policy, load=load)
        for chunk in (128, 4096):
            assert np.array_equal(te.path_latencies(tps, chunk=chunk, policy=policy, load=load), want)
        assert np.array_equal(te.path_latencies(prepared, policy=policy, load=load), want)
    rng = np.random.default_rng(4)
    obj = rng.integers(0, 150, 60)
    srv = rng.integers(0, 5, 60)
    obj[0], srv[1] = -1, -2
    je.add_replicas(obj, srv)
    te.add_replicas(obj, srv)
    assert np.array_equal(te.host_mask(), je.host_mask())
    assert np.array_equal(te.scheme.mask, je.host_mask())
    assert np.array_equal(te.path_latencies(prepared), je.path_latencies(jps))
    je.remove_replicas(obj[:30], srv[:30])
    te.remove_replicas(obj[:30], srv[:30])
    assert np.array_equal(te.packed.numpy_words(), np.asarray(je.packed.words))
    for policy in POLICIES:
        assert np.array_equal(
            te.path_latencies(tps, policy=policy, load=load),
            je.path_latencies(jps, policy=policy, load=load),
        )
    te.scheme.mask[:] = True
    te.refresh()
    assert te.path_latencies(tps).sum() == 0
    assert np.array_equal(te.to_scheme().mask, te.scheme.mask)


def test_zero_length_and_single_object_paths():
    _, _, mask, shard, _ = _case(5)
    ps = T.PathSet.from_lists([[], [3], [], [7]])
    eng = TEngine(T.ReplicationScheme.from_numpy(mask, shard), device=CPU)
    for policy in POLICIES:
        assert np.array_equal(eng.path_latencies(ps, policy=policy), np.zeros(4, np.int32))
        s, l = eng.access_trace(ps, policy=policy)
        assert np.array_equal(l[:, 0], [False, True, False, True])
    assert eng.path_latencies(T.PathSet.from_lists([])).shape == (0,)


@pytest.mark.parametrize("policy", [None, "nearest_copy"])
def test_query_slack_and_feasibility(policy):
    jps, tps, mask, shard, load = _case(6)
    jeng, teng = _engines(mask, shard)
    je, te = jeng["jnp"], teng["torch"]
    nq = jps.n_queries
    vec = np.random.default_rng(7).integers(0, 4, nq).astype(np.int32)
    budgets = [0, 1, 2, 3, vec, (JSLO.uniform(2, nq), TSLO.uniform(2, nq))]
    for t in budgets:
        jt, tt = t if isinstance(t, tuple) else (t, t)
        assert np.array_equal(
            te.query_slack(tps, tt, policy=policy), je.query_slack(jps, jt, policy=policy)
        )
        assert te.is_feasible(tps, tt, policy=policy) == je.is_feasible(jps, jt, policy=policy)
        js = R.ReplicationScheme(mask.copy(), shard)
        ts = T.ReplicationScheme.from_numpy(mask, shard)
        assert np.array_equal(
            T.query_slacks(tps, ts, tt, policy=policy, device=CPU),
            R.query_slacks(jps, js, jt, policy=policy),
        )
        assert T.is_latency_feasible(tps, ts, tt, policy=policy, device=CPU) == \
            R.is_latency_feasible(jps, js, jt, policy=policy)
    assert np.array_equal(te.query_latencies(tps), je.query_latencies(jps))
    assert np.array_equal(
        T.path_latencies(tps, T.ReplicationScheme.from_numpy(mask, shard), device=CPU),
        R.path_latencies(jps, R.ReplicationScheme(mask.copy(), shard)),
    )


def test_margin_costs_match():
    jps, tps, mask, shard, _ = _case(8)
    jeng, teng = _engines(mask, shard)
    rng = np.random.default_rng(9)
    obj = rng.integers(-1, 150, (40, 6))
    srv = rng.integers(-1, 5, (40, 6))
    f = (rng.integers(1, 32, 150) / 4).astype(np.float32)
    for fv in (None, f):
        assert np.array_equal(
            teng["torch"].margin_costs(obj, srv, fv), jeng["jnp"].margin_costs(obj, srv, fv)
        )


def test_nearest_copy_dp_raises():
    """``nearest_copy_dp`` no longer raises anywhere (it runs through the
    engine and the greedy); only the unported incremental plane does."""
    jps, tps, mask, shard, _ = _case(10)
    jeng, teng = _engines(mask, shard)
    want = jeng["jnp"].path_latencies(jps, policy="nearest_copy_dp")
    for e in teng.values():
        assert np.array_equal(e.path_latencies(tps, policy="nearest_copy_dp"), want)
    scheme, _ = T.replicate_workload(tps, shard, 5, 1, policy="nearest_copy_dp", device=CPU)
    assert T.is_latency_feasible(tps, scheme, 1, policy="nearest_copy_dp", device=CPU)
    for policy in POLICIES:
        with pytest.raises(NotImplementedError, match="incremental"):
            teng["torch"].path_latencies(tps, policy=policy, incremental=True)


def _gathered(seed, P, L, n_srv):
    """Raw kernel inputs (objects/words/shard) plus the gathered planes the
    Pallas kernels take (built by the JAX package's own prep)."""
    rng = np.random.default_rng(seed)
    n_obj = 300
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    mask = rng.random((n_obj, n_srv)) < 0.2
    mask[np.arange(n_obj), shard] = True
    mask[:, n_srv - 1] |= rng.random(n_obj) < 0.5      # the top (sign) bit
    words = np.asarray(JPacked.from_mask(mask, shard).words)
    lengths = rng.integers(0, L + 1, P).astype(np.int32)
    objects = np.full((P, L), -1, np.int32)
    for p in range(P):
        objects[p, : lengths[p]] = rng.integers(0, n_obj, lengths[p])
    start = rng.integers(-1, n_srv, P).astype(np.int32)
    load = np.zeros(((n_srv + 31) // 32) * 32, np.float32)
    load[:n_srv] = rng.integers(0, 3, n_srv)            # ties on purpose
    home, masks = pallas_prep(objects, lengths, words, shard)
    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        objects=objects, lengths=lengths, words=words.view(np.int32),
        shard=shard, start=start, load=load).items()}
    return t, (home, masks, lengths, start, load)


@pytest.mark.parametrize("L,n_srv", [(1, 6), (6, 32), (9, 40), (6, 128), (17, 6), (9, 160)])
def test_path_latency_plain_matches_pallas_kernel(L, n_srv):
    t, (home, masks, lengths, _, _) = _gathered(L + n_srv, 384, L, n_srv)
    want = np.asarray(path_latency_pallas(home, masks, lengths, interpret=True))
    got = path_latency_plain(t["objects"], t["lengths"], t["words"], t["shard"])
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["home_first", "nearest_copy", "no_lookahead"])
@pytest.mark.parametrize("L,n_srv", [(1, 6), (6, 40), (9, 70)])
def test_routed_walk_plain_matches_pallas_kernel(mode, L, n_srv):
    t, (home, masks, lengths, start, load) = _gathered(L * n_srv, 256, L, n_srv)
    home_first = mode == "home_first"
    lookahead = mode == "nearest_copy"
    ws, wl = routed_walk_pallas(home, masks, lengths, start, load, interpret=True,
                                lookahead=lookahead, home_first=home_first)
    s, l = routed_walk_plain(t["objects"], t["lengths"], t["words"], t["shard"],
                             t["start"], t["load"], lookahead=lookahead,
                             home_first=home_first)
    assert np.array_equal(s.numpy(), np.asarray(ws))
    assert np.array_equal(l.numpy(), np.asarray(wl))
