"""The port's telemetry plane (``repro_torch.obs``) against the JAX package's.

Registry, histograms and their merge, the executor's structural spans,
the Chrome trace export and the burn attribution must equal ``repro.obs``
on the same inputs; the port's ``TRANSFER.scope`` isolates and restores
like ``repro``'s; the fused stream pipeline equals eager deltas and
records the same ``repro.stream.*`` / ``repro.greedy.*`` names; the
compile hook counts the CUDA kernel builds.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import dataclasses
import json

import numpy as np
import pytest

import repro.core as R
import repro.distsys as RD
import repro.obs as RO
import repro_torch.core as T
import repro_torch.distsys as TD
import repro_torch.obs as TO
from conftest import random_workload
from repro_torch.engine import TRANSFER, LatencyEngine, PathStream

CPU = "cpu"


def to_port(ps):
    return T.PathSet(ps.objects, ps.lengths, ps.query_ids)


@pytest.fixture
def obs_on():
    """Enable both planes with clean registries; restore on exit."""
    was = (TO.enabled(), RO.enabled())
    for o in (TO, RO):
        o.REGISTRY.reset()
        o.enable()
    try:
        yield TO.REGISTRY, RO.REGISTRY
    finally:
        for o, w in zip((TO, RO), was):
            (o.enable if w else o.disable)()
            o.REGISTRY.reset()


def test_registry_get_or_create_and_kind_mismatch():
    reg = TO.MetricsRegistry()
    c = reg.counter("a.b")
    c.inc(3)
    assert reg.counter("a.b") is c
    reg.gauge("a.g").set(2.5)
    reg.histogram("a.h").record(10.0)
    assert reg.names() == ["a.b", "a.g", "a.h"]
    with pytest.raises(TypeError, match="already a"):
        reg.gauge("a.b")
    with pytest.raises(TypeError, match="already a"):
        reg.counter("a.h")
    jr = RO.MetricsRegistry()
    jr.counter("a.b").inc(3)
    jr.gauge("a.g").set(2.5)
    jr.histogram("a.h").record(10.0)
    assert reg.snapshot() == jr.snapshot()
    json.dumps(reg.snapshot())
    reg.reset()
    assert reg.names() == []


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_percentiles_and_merge_equal_repro(seed):
    rng = np.random.default_rng(seed)
    x, y = rng.lognormal(2, 1.5, 3000), rng.pareto(1.5, 2000) + 0.1
    edges = 0.1 * 1.1 ** np.arange(120)  # exact bucket edges
    hs = []
    for mod in (TO, RO):
        a, b = mod.Histogram("h", lo=0.1, growth=1.1), mod.Histogram("h", lo=0.1, growth=1.1)
        a.record_many(np.concatenate([x, edges]))
        for v in y[:200]:
            b.record(float(v))
        b.record_many(y[200:])
        hs.append((a, b, a.merge(b)))
    (ta, tb, tm), (ja, jb, jm) = hs
    for t_, j_ in ((ta, ja), (tb, jb), (tm, jm)):
        assert t_.counts == j_.counts and t_.n == j_.n
        assert t_.snapshot() == j_.snapshot()
    ref = TO.Histogram("h", lo=0.1, growth=1.1)
    ref.record_many(np.concatenate([x, edges, y]))
    assert tm.counts == ref.counts
    for q in (50.0, 99.0, 99.9):
        assert tm.percentile(q) == ref.percentile(q)
    with pytest.raises(ValueError, match="geometry"):
        ta.merge(TO.Histogram("h", lo=0.1, growth=1.2))


@pytest.fixture(scope="module")
def served():
    """One workload and its t = 2 scheme, from the JAX package's greedy."""
    ps, shard = random_workload(np.random.default_rng(0), n_paths=120, n_queries=50)
    scheme, _ = R.replicate_workload(ps, shard, 5, t=2)
    return ps, scheme


def _spans(tr):
    return [(qt.query, qt.failed, qt.violated, qt.latency_us,
             [dataclasses.astuple(s) for s in qt.spans]) for qt in tr.traces]


def test_executor_structural_spans_equal_repro(served):
    ps, scheme = served
    jt, tt = RO.Tracer(), TO.Tracer()
    jr = RD.execute_workload(RD.Cluster(scheme), ps, RD.LatencyModel(), seed=1, trace=jt)
    tsch = T.ReplicationScheme(scheme.mask.copy(), scheme.shard.copy())
    tr = TD.execute_workload(TD.Cluster(tsch), to_port(ps), TD.LatencyModel(), seed=1,
                             trace=tt, device=CPU)
    assert tt.n_completed == jt.n_completed == ps.n_queries
    assert tt.n_spans == jt.n_spans
    assert _spans(tt) == _spans(jt)
    assert tr.summary() == jr.summary()


def test_chrome_trace_and_burn_attribution_equal_repro(served, tmp_path):
    ps, scheme = served
    outs = []
    for mod, dmod, sch, p, kw in (
        (RO, RD, scheme, ps, {}),
        (TO, TD, T.ReplicationScheme(scheme.mask.copy(), scheme.shard.copy()), to_port(ps),
         {"device": CPU}),
    ):
        # a budget below the slowest queries' modeled walk: violators kept
        tr = mod.Tracer(budget_us=150.0, head=8, ring=16)
        dmod.execute_workload(dmod.Cluster(sch), p, dmod.LatencyModel(), seed=3, trace=tr, **kw)
        path = tmp_path / f"{mod.__name__}.json"
        ev = tr.chrome_trace(str(path))
        assert json.loads(path.read_text()) == ev
        outs.append((ev, _spans(tr), tr.n_violations, mod.attribute_burn(tr).summary()))
    assert outs[0] == outs[1]
    assert outs[0][2] > 0


def test_burn_attribution_names_hotspot_server():
    """Spans recorded by hand: server 0's queue eats the budget."""
    reps = []
    for mod in (TO, RO):
        tr = mod.Tracer(budget_us=60.0)
        for q in range(40):
            slow = q % 4 == 0
            tr.record(q, 1, 0, True, 0.0, 0.0, 5.0)
            tr.record(q, 2, 1 + q % 2, False, 5.0, 6.0, 20.0)
            tr.record(q, 3, 0, False, 20.0, 90.0 if slow else 30.0, 100.0 if slow else 40.0)
            tr.finalize(q, 0.0, 100.0 if slow else 40.0, tenant=q % 2)
        reps.append(mod.attribute_burn(tr, tenant_names=("a", "b")))
    trep, jrep = reps
    assert trep.summary() == jrep.summary()
    # every fourth query (all of tenant "a"'s even ids) waits on server 0
    assert trep["a"].n_violations == 10 and trep["b"].n_violations == 0
    assert trep["a"].top_server() == 0


def test_transfer_scope_isolates_and_restores():
    base = dict(TRANSFER.snapshot())
    with TRANSFER.scope():
        TRANSFER.h2d_bytes += 100
        TRANSFER.gathered_bytes += 4
        with TRANSFER.scope():
            assert TRANSFER.h2d_bytes == 0 and TRANSFER.gathered_bytes == 0
            TRANSFER.h2d_bytes += 7
        assert TRANSFER.h2d_bytes == 107
    assert TRANSFER.h2d_bytes == base["h2d_bytes"] + 107
    assert TRANSFER.gathered_bytes == base["gathered_bytes"] + 4
    with pytest.raises(RuntimeError):
        with TRANSFER.scope():
            TRANSFER.h2d_bytes += 11
            raise RuntimeError("boom")
    assert TRANSFER.h2d_bytes == base["h2d_bytes"] + 118
    TRANSFER.h2d_bytes -= 118
    TRANSFER.gathered_bytes -= 4
    assert set(TRANSFER.snapshot()) == {"h2d_bytes", "h2d_calls", "d2h_bytes",
                                        "padded_bytes", "gathered_bytes"}


def test_stream_pipeline_matches_eager_and_reports_overlap(obs_on):
    treg, jreg = obs_on
    ps, shard = random_workload(np.random.default_rng(0), n_paths=160, n_queries=80)
    chunks = [ps.select(np.arange(i, min(i + 40, ps.n_paths))) for i in range(0, 160, 40)]
    eng = LatencyEngine(T.ReplicationScheme.from_sharding(shard, 5), device=CPU)
    for c in chunks:
        T.replicate_delta(to_port(c), eng, 2, fused=True)
    treg.reset()
    scheme_s, stats = T.replicate_stream(PathStream(iter([to_port(c) for c in chunks])),
                                         shard, 5, t=2, fused=True, device=CPU)
    j_s, jstats = R.replicate_stream(iter(chunks), shard, 5, t=2, fused=True)
    assert np.array_equal(eng.host_mask(), scheme_s.mask)
    assert np.array_equal(scheme_s.mask, j_s.mask)
    assert stats.ingest_overlap_s >= 0.0
    assert stats.total_cost == jstats.total_cost
    assert stats.timeline == jstats.timeline
    snap, jsnap = treg.snapshot(), jreg.snapshot()
    assert snap["repro.greedy.stat_readbacks"] == 1
    assert snap["repro.stream.chunks"] == len(chunks)
    # the same names, and the same counts for everything but the timings
    assert sorted(snap) == sorted(jsnap)
    for name in snap:
        if name not in ("repro.stream.ingest_overlap_s", "repro.greedy.stat_readbacks"):
            assert snap[name] == jsnap[name], name


def test_incremental_registry_names_equal_repro(obs_on):
    treg, jreg = obs_on
    import repro.engine as RE

    ps, shard = random_workload(np.random.default_rng(4), n_obj=80, n_paths=90)
    mask = np.zeros((80, 5), bool)
    mask[np.arange(80), shard] = True
    engines = (LatencyEngine.from_arrays(mask.copy(), shard, device=CPU),
               RE.LatencyEngine.from_arrays(mask.copy(), shard))
    pss = (to_port(ps), ps)
    for _ in range(2):
        for eng, p in zip(engines, pss):
            eng.path_latencies(p, incremental=True)
            eng.add_replicas([int(ps.objects[0, 0])], [1])
            eng.path_latencies(p, incremental=True)
    assert treg.snapshot() == jreg.snapshot()


def test_disabled_plane_registers_nothing():
    was = TO.enabled()
    TO.disable()
    TO.REGISTRY.reset()
    try:
        ps, shard = random_workload(np.random.default_rng(5), n_paths=40)
        _, stats = T.replicate_workload(to_port(ps), shard, 5, 1, device=CPU)
        assert TO.REGISTRY.names() == [] and stats.timeline is None
    finally:
        (TO.enable if was else TO.disable)()


def test_compile_hook_counts_kernel_builds(monkeypatch):
    from repro_torch.kernels import build

    reg = TO.MetricsRegistry()
    counter = TO.install_compile_hook(reg)
    assert counter is TO.install_compile_hook(reg)  # idempotent
    before = counter.value
    for listener in build.BUILD_LISTENERS:
        listener(1.0)  # what build() calls after a build that ran nvcc
    assert reg.counter(TO.metrics.COMPILE_COUNTER).value >= before + 1
