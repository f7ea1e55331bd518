"""The port's warm-start delta and streamed greedy against the JAX package's.

``replicate_delta`` must give ``repro``'s masks, additions and
``GreedyStats`` (separate and ``fused=True``; scalar and per-query
budgets; home-first and ``nearest_copy``); with aligned batches a delta
equals the from-scratch run over the concatenated paths;
``replicate_stream`` equals chunked deltas with one chunk resident and
per-chunk budgets; the drift generators give ``repro``'s streams; and
``benchmarks/torch_provisioning_policies.py`` reproduces
``BENCH_provisioning.json``'s SNB row.  The ``cuda`` case holds the
fused delta's class launch against ``torch`` on a card.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import repro.core as R
import repro.engine as RE
import repro.serve as RS
import repro_torch.core as T
import repro_torch.serve as TS
from conftest import random_workload
from repro_torch.engine import LatencyEngine, PathStream

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent
COUNTERS = ("replicas", "failed_paths", "fallback_paths", "routed_skips",
            "routed_violations", "paths_processed", "total_cost")


def to_port(ps):
    return T.PathSet(ps.objects, ps.lengths, ps.query_ids)


def _delta_case():
    ps, shard = random_workload(np.random.default_rng(0), n_obj=150, n_srv=5, n_paths=150)
    extra, _ = random_workload(np.random.default_rng(3), n_obj=150, n_srv=5, n_paths=80,
                               n_queries=30)
    t_vec = np.random.default_rng(4).integers(0, 3, extra.n_queries).astype(np.int32)
    return ps, shard, extra, t_vec


def _run_delta(C, ps, shard, extra, t, fused, policy, **kw):
    scheme, _, eng = C.replicate_workload(ps, shard, 5, t=2, return_engine=True, **kw)
    before = scheme.mask.copy()
    stats, add = C.replicate_delta(extra, eng, t, fused=fused, policy=policy)
    assert np.array_equal(scheme.mask, eng.host_mask())  # host mirror in sync
    return before, eng.host_mask(), stats, add


CASES = [(fused, policy, tk) for fused in (False, True) for policy in (None, "nearest_copy")
         for tk in ("scalar", "vector")]


@pytest.fixture(scope="module")
def jax_deltas():
    """The JAX package's delta per case (computed on first use)."""
    ps, shard, extra, t_vec = _delta_case()
    cache = {}

    def get(fused, policy, tk):
        key = (fused, policy, tk)
        if key not in cache:
            cache[key] = _run_delta(R, ps, shard, extra, 1 if tk == "scalar" else t_vec,
                                    fused, policy)
        return cache[key]

    return get


@pytest.mark.parametrize("fused,policy,tk", CASES,
                         ids=[f"{'fused' if f else 'separate'}-{p or 'home_first'}-{k}"
                              for f, p, k in CASES])
def test_delta_equals_repro(jax_deltas, fused, policy, tk):
    ps, shard, extra, t_vec = _delta_case()
    t = 1 if tk == "scalar" else t_vec
    got = _run_delta(T, to_port(ps), shard, to_port(extra), t, fused, policy, device=CPU)
    want = jax_deltas(fused, policy, tk)
    for a, b in zip(got[:2], want[:2]):
        assert np.array_equal(a, b)
    for c in COUNTERS:
        assert getattr(got[2], c) == getattr(want[2], c), c
    for a, b in zip(got[3], want[3]):
        assert np.array_equal(a, b)
    # the returned delta is exactly the new copies, mirrored into the scheme
    delta = np.zeros_like(got[0])
    delta[got[3][0], got[3][1]] = True
    assert np.array_equal(got[1] & ~got[0], delta)


def test_incremental_matches_rebuild_on_aligned_batches():
    """replicate_delta == the tail batches of one from-scratch run."""
    rng = np.random.default_rng(7)
    n_obj, n_srv, bs = 90, 4, 64
    mk = lambda n: [rng.integers(0, n_obj, rng.integers(2, 6)).tolist() for _ in range(n)]
    a, b = mk(bs), mk(40)
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    psa, psb, psab = (T.PathSet.from_lists(x, max_len=6) for x in (a, b, a + b))
    kw = dict(prune=False, batch_size=bs, device=CPU)
    before, _, eng = T.replicate_workload(psa, shard, n_srv, t=1, return_engine=True, **kw)
    before = before.mask.copy()
    for fused in (False, True):
        e = LatencyEngine(T.ReplicationScheme(before.copy(), shard.copy()), device=CPU)
        _, (objs, srvs) = T.replicate_delta(psb, e, t=1, prune=False, batch_size=bs,
                                            fused=fused)
        full, _ = T.replicate_workload(psab, shard, n_srv, t=1, fused=fused, **kw)
        assert np.array_equal(e.host_mask(), full.mask)
        assert T.is_latency_feasible(psab, e.to_scheme(), 1, device=CPU)
        delta = np.zeros_like(full.mask)
        delta[objs, srvs] = True
        assert np.array_equal(full.mask & ~before, delta)
    jfull, _ = R.replicate_workload(R.PathSet.from_lists(a + b, max_len=6), shard, n_srv, t=1,
                                    prune=False, batch_size=bs)
    assert np.array_equal(jfull.mask, full.mask)


def _stream_case():
    ps, shard = random_workload(np.random.default_rng(8), n_paths=150)
    f = np.random.default_rng(9).integers(1, 4, 120).astype(np.float32)
    chunks = [ps.select(np.arange(i, min(i + 50, ps.n_paths))) for i in range(0, 150, 50)]
    return ps, shard, f, chunks


@pytest.mark.parametrize("policy", [None, "nearest_copy"])
def test_stream_equals_chunked_deltas(policy):
    ps, shard, f, chunks = _stream_case()
    eng = LatencyEngine(T.ReplicationScheme.from_sharding(shard, 5), device=CPU)
    for c in chunks:
        T.replicate_delta(to_port(c), eng, 2, f=f, policy=policy, fused=True)
    stream = PathStream(iter([to_port(c) for c in chunks]))
    scheme, stats = T.replicate_stream(stream, shard, 5, t=2, f=f, policy=policy, fused=True,
                                       device=CPU)
    jscheme, jstats = R.replicate_stream(RE.PathStream(iter(chunks)), shard, 5, t=2, f=f,
                                         policy=policy, fused=True)
    assert np.array_equal(eng.host_mask(), scheme.mask)
    assert np.array_equal(scheme.mask, jscheme.mask)
    for c in COUNTERS:
        assert getattr(stats, c) == getattr(jstats, c), c
    assert stream.stats.total_paths == ps.n_paths and stream.stats.chunks == 3
    assert stats.peak_resident_paths == 50 < ps.n_paths


def test_stream_tables_residency_per_chunk_budgets_and_single_use(monkeypatch):
    from repro_torch.core import greedy

    ps, shard, f, _ = _stream_case()
    chunks = [to_port(ps.select(np.arange(i, i + 40))) for i in range(0, 120, 40)]
    monkeypatch.setattr(greedy, "_TABLE_STREAM_ROWS", 3)
    stream = PathStream(iter(chunks))
    _, sstats = T.replicate_stream(stream, shard, 5, t=2, f=f, device=CPU)
    assert stream.stats.peak_resident_table_rows == sstats.table_peak_rows
    assert stream.stats.total_table_rows == sstats.table_total_rows
    assert 0 < stream.stats.peak_resident_table_rows <= 3 < stream.stats.total_table_rows
    a, b = to_port(ps.select(np.arange(30))), to_port(ps.select(np.arange(30, 60)))
    stream = PathStream([(a, 1), (b, 3)])
    scheme, _ = T.replicate_stream(stream, shard, 5, f=f, device=CPU)
    jscheme, _ = R.replicate_stream([(ps.select(np.arange(30)), 1),
                                     (ps.select(np.arange(30, 60)), 3)], shard, 5, f=f)
    assert np.array_equal(scheme.mask, jscheme.mask)
    with pytest.raises(RuntimeError, match="single-use"):
        list(stream)
    with pytest.raises(ValueError, match="budget"):
        T.replicate_stream(PathStream([a]), shard, 5, device=CPU)


def test_double_buffer_runs_eagerly_in_order_on_the_cpu():
    from repro_torch.engine import double_buffer

    seen = []
    assert double_buffer(range(5), seen.append) >= 0.0
    assert seen == list(range(5))
    assert double_buffer([], seen.append) == 0.0

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    with pytest.raises(RuntimeError, match="producer failed"):
        double_buffer(boom(), seen.append)


def _drift_pairs():
    from repro.graph import snb_like as jsnb
    from repro_torch.graph import snb_like as tsnb

    js, ts = jsnb(1, seed=0), tsnb(1, seed=0)
    yield "snb", (RS.snb_drift(js, n_phases=3, queries_per_phase=60, seed=0),
                  TS.snb_drift(ts, n_phases=3, queries_per_phase=60, seed=0))
    yield "gnn", (RS.gnn_drift(js.graph, n_phases=3, queries_per_phase=40, seed=1),
                  TS.gnn_drift(ts.graph, n_phases=3, queries_per_phase=40, seed=1))
    yield "recsys", (RS.recsys_drift(200, 900, n_phases=3, queries_per_phase=50, seed=2),
                     TS.recsys_drift(200, 900, n_phases=3, queries_per_phase=50, seed=2))


def test_drift_streams_equal_repro():
    for name, (jp, tp) in _drift_pairs():
        jd, td = list(RS.drift_stream(jp)), list(TS.drift_stream(tp))
        assert len(jd) == len(td) == 3, name
        for a, b in zip(jd, td):
            assert (a.phase, a.name, a.n_removed, a.rate_qps) == (b.phase, b.name, b.n_removed,
                                                                 b.rate_qps), name
            for x, y in ((a.pathset, b.pathset), (a.added, b.added)):
                assert np.array_equal(x.objects, y.objects), name
                assert np.array_equal(x.lengths, y.lengths), name
                assert np.array_equal(x.query_ids, y.query_ids), name
        for x, y in zip(jp, tp):
            assert np.array_equal(x.hot_roots, y.hot_roots), name
    added, removed = TS.path_delta(T.PathSet.from_lists([[0, 1], [2, 3]]),
                                   T.PathSet.from_lists([[4, 5]]))
    assert added.n_paths == 1 and removed == 2


def test_provisioning_benchmark_reproduces_bench_snb_row():
    spec = importlib.util.spec_from_file_location(
        "torch_provisioning_policies", ROOT / "benchmarks" / "torch_provisioning_policies.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    row = mod.snb_row(device=CPU)
    for k, (shipped, resident) in mod.BENCH_SNB.items():
        assert (row[k]["shipped_bytes"], row[k]["resident_bytes"]) == (shipped, resident), k
        assert row[k]["feasible_frac"] == 1.0
    assert row["matches_bench_provisioning"]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "nearest_copy", "nearest_copy_dp"])
def test_fused_delta_class_launch_equals_torch(policy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (fused_update_class against an engine's words)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import provision_update

    ps, shard, extra, t_vec = _delta_case()
    outs = []
    for dev in ("cuda", CPU):
        before = provision_update.LAUNCHES
        outs.append(_run_delta(T, to_port(ps), shard, to_port(extra), t_vec, True, policy,
                               device=dev))
        if dev == "cuda":
            assert provision_update.LAUNCHES > before
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert np.array_equal(a, b)
    for c in COUNTERS:
        assert getattr(outs[0][2], c) == getattr(outs[1][2], c), c
