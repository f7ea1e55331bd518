"""The port's graph, partition and workload copies give the JAX
package's arrays for the same seeds (exact)."""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import numpy as np
import pytest

from repro.graph import hash_partition, make_sharding, snb_like
from repro.workload import snb_workload_materialized
from repro_torch.graph import hash_partition as t_hash_partition
from repro_torch.graph import make_sharding as t_make_sharding
from repro_torch.graph import snb_like as t_snb_like
from repro_torch.workload import snb_workload_materialized as t_snb_workload


@pytest.fixture(scope="module")
def graphs():
    return snb_like(scale=1, seed=0), t_snb_like(scale=1, seed=0)


def test_snb_like_graph_equal(graphs):
    j, t = graphs
    for name in ("indptr", "indices", "edge_types", "node_types"):
        assert np.array_equal(getattr(j.graph, name), getattr(t.graph, name)), name
    for name in ("persons", "posts", "comments", "forums"):
        assert np.array_equal(getattr(j, name), getattr(t, name)), name
    assert np.array_equal(j.graph.object_sizes(), t.graph.object_sizes())


@pytest.mark.parametrize("n_servers,seed", [(6, 0), (40, 3)])
def test_hash_partition_equal(n_servers, seed):
    assert np.array_equal(
        hash_partition(5000, n_servers, seed), t_hash_partition(5000, n_servers, seed)
    )


@pytest.mark.parametrize("kind", ["hash", "ldg"])
def test_make_sharding_equal(graphs, kind):
    j, t = graphs
    assert np.array_equal(
        make_sharding(kind, j.graph, 6, seed=1), t_make_sharding(kind, t.graph, 6, seed=1)
    )


@pytest.mark.parametrize("seed", [0, 7])
def test_snb_workload_equal(graphs, seed):
    j, t = graphs
    a = snb_workload_materialized(j, n_queries=300, seed=seed)
    b = t_snb_workload(t, n_queries=300, seed=seed)
    for name in ("objects", "lengths", "query_ids"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
        assert getattr(a, name).dtype == getattr(b, name).dtype, name


# --------------------------------------------------------------------------
# the GNN, recsys, MoE and tenant workloads, the sampler, the frontier
# --------------------------------------------------------------------------

def _same_pathset(a, b):
    for name in ("objects", "lengths", "query_ids"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
        assert getattr(a, name).dtype == getattr(b, name).dtype, name


@pytest.mark.parametrize("fanouts,exact", [((5, 3), True), ((6, 4), False), ((4,), True)])
def test_gnn_workload_equal(fanouts, exact):
    from repro.graph import ogb_like
    from repro.workload import gnn_workload_materialized
    from repro_torch.graph import ogb_like as t_ogb_like
    from repro_torch.workload import gnn_workload_materialized as t_gnn

    g, tg = ogb_like(2000, seed=0), t_ogb_like(2000, seed=0)
    seeds = np.random.default_rng(1).integers(0, 2000, 60)
    a = gnn_workload_materialized(g, seeds, fanouts, seed=2, exact_draws=exact)
    b = t_gnn(tg, seeds, fanouts, seed=2, exact_draws=exact)
    _same_pathset(a, b)
    assert b.max_len <= len(fanouts) + 1


def test_recsys_and_moe_workloads_equal():
    from repro.workload import moe_workload_materialized, recsys_workload_materialized
    from repro_torch.workload import expert_shard
    from repro_torch.workload import moe_workload_materialized as t_moe
    from repro_torch.workload import recsys_workload_materialized as t_recsys
    from repro.workload import expert_shard as j_expert_shard

    for kw in ({}, {"behaviors_per_req": 3, "candidates_per_req": 0, "seed": 4}):
        _same_pathset(recsys_workload_materialized(100, 500, n_requests=80, **kw),
                      t_recsys(100, 500, n_requests=80, **kw))
    for kw in ({}, {"zipf_a": 1.5, "seed": 3}):
        _same_pathset(moe_workload_materialized(16, 32, 4, n_queries=80, **kw),
                      t_moe(16, 32, 4, n_queries=80, **kw))
    assert np.array_equal(expert_shard(16, 32, 6), j_expert_shard(16, 32, 6))


def test_tenant_workload_and_slo_equal(graphs):
    from repro.workload import FAMILY_TENANTS, multi_tenant_workload, tenant_spec
    from repro.workload import recsys_workload_materialized
    from repro_torch.workload import FAMILY_TENANTS as T_FAMILY
    from repro_torch.workload import multi_tenant_workload as t_multi
    from repro_torch.workload import recsys_workload_materialized as t_recsys
    from repro_torch.workload import tenant_spec as t_tenant_spec

    assert {k: tuple(v.__dict__.values()) for k, v in FAMILY_TENANTS.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in T_FAMILY.items()}
    assert tuple(tenant_spec("gnn", 1, 200.0).__dict__.values()) == \
        tuple(t_tenant_spec("gnn", 1, 200.0).__dict__.values())
    j, t = graphs
    parts_j = [("snb", snb_workload_materialized(j, n_queries=120, seed=0)),
               ("recsys", recsys_workload_materialized(50, 400, n_requests=60))]
    parts_t = [("snb", t_snb_workload(t, n_queries=120, seed=0)),
               ("recsys", t_recsys(50, 400, n_requests=60))]
    for budgets in (None, {"snb": 2, "recsys": 1}):
        ps_j, slo_j = multi_tenant_workload(parts_j, budgets)
        ps_t, slo_t = t_multi(parts_t, budgets)
        _same_pathset(ps_j, ps_t)
        assert np.array_equal(slo_j.t_q, slo_t.t_q)
        assert np.array_equal(slo_j.tenant_of, slo_t.tenant_of)
        assert [tuple(x.__dict__.values()) for x in slo_j.tenants] == \
            [tuple(x.__dict__.values()) for x in slo_t.tenants]


def test_sampler_equal():
    from repro.graph import CSRGraph, distributed_hops, minibatch_sampler, ogb_like
    from repro.graph import sample_neighborhood
    from repro_torch.graph import CSRGraph as TCSR
    from repro_torch.graph import distributed_hops as t_hops
    from repro_torch.graph import minibatch_sampler as t_minibatch
    from repro_torch.graph import ogb_like as t_ogb_like
    from repro_torch.graph import sample_neighborhood as t_sample

    g, tg = ogb_like(2000, seed=1), t_ogb_like(2000, seed=1)
    nodes = np.arange(16)
    nodes[3] = -1  # a padded seed
    a = minibatch_sampler(g, nodes, (5, 3), seed=0)
    b = t_minibatch(tg, nodes, (5, 3), seed=0)
    assert np.array_equal(a.seeds, b.seeds) and np.array_equal(a.all_nodes(), b.all_nodes())
    for x, y in zip(a.layer_nodes, b.layer_nodes):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    shard = hash_partition(2000, 6)
    for seed_node in (0, 7, 1999):
        fa = sample_neighborhood(g, seed_node, (4, 3), np.random.default_rng(seed_node))
        fb = t_sample(tg, seed_node, (4, 3), np.random.default_rng(seed_node))
        assert all(np.array_equal(x, y) for x, y in zip(fa, fb)) and len(fa) == len(fb)
        assert distributed_hops(fa, shard) == t_hops(fb, shard)
    small, tsmall = CSRGraph.from_edges(4, [0, 1], [1, 2]), TCSR.from_edges(4, [0, 1], [1, 2])
    fr = sample_neighborhood(small, 3, (2,), np.random.default_rng(0))  # isolated seed
    assert distributed_hops(fr, shard) == t_hops(
        t_sample(tsmall, 3, (2,), np.random.default_rng(0)), shard)


def test_tenant_frontier_matches_jax():
    """``benchmarks/torch_tenant_frontier.py`` on the CPU: the JAX package's
    frontier (``benchmarks/tenant_frontier.py``, ``BENCH_tenants.json``),
    2431 / 2431 / 3270 / 4481 replicas at t_gnn 3 / 2 / 1 / 0 with SNB at
    1 and 0 failed paths, overhead monotone, every scheme feasible; the
    masks equal the JAX package's at t_gnn 0 / 1 / 2."""
    from benchmarks.torch_tenant_frontier import frontier
    from repro.core import replicate_workload
    from repro.workload import gnn_workload_materialized, multi_tenant_workload

    rows, schemes = frontier(device="cpu")
    assert [r["t_gnn"] for r in rows] == [3, 2, 1, 0]
    assert [r["replicas"] for r in rows] == [2431, 2431, 3270, 4481]
    assert all(r["failed_paths"] == 0 and r["feasible"] for r in rows)
    j = snb_like(1, seed=0)
    g = j.graph
    f = g.object_sizes().astype(np.float32)
    shard = make_sharding("hash", g, 6, seed=0)
    sps = snb_workload_materialized(j, n_queries=500, seed=0)
    gps = gnn_workload_materialized(g, np.random.default_rng(0).integers(0, g.n_nodes, 250),
                                    (6, 4), seed=0)
    for t_gnn in (0, 1, 2):
        ps, slo = multi_tenant_workload([("snb", sps), ("gnn", gps)],
                                        budgets={"snb": 1, "gnn": t_gnn})
        want, _ = replicate_workload(ps, shard, 6, slo, f=f)
        assert np.array_equal(want.mask, schemes[t_gnn].mask), t_gnn


# --------------------------------------------------------------------------
# the streamed analyzer: stream_latencies and workload_latency_summary
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def summary_case(graphs):
    """A two-tenant SNB + recsys stream on the scale-1 graph, three query
    batches, against a seeded scheme with extra replicas (both packages'
    copies of the same inputs)."""
    from repro.core import ReplicationScheme
    from repro.workload import multi_tenant_workload, recsys_workload_materialized
    from repro_torch.core import ReplicationScheme as TScheme
    from repro_torch.workload import multi_tenant_workload as t_multi
    from repro_torch.workload import recsys_workload_materialized as t_recsys

    j, t = graphs
    budgets = {"snb": 2, "recsys": 2}
    ps_j, slo_j = multi_tenant_workload(
        [("snb", snb_workload_materialized(j, n_queries=150, seed=3)),
         ("recsys", recsys_workload_materialized(50, 400, n_requests=60))], budgets)
    ps_t, slo_t = t_multi(
        [("snb", t_snb_workload(t, n_queries=150, seed=3)),
         ("recsys", t_recsys(50, 400, n_requests=60))], budgets)
    shard = make_sharding("hash", j.graph, 6, seed=0)
    rng = np.random.default_rng(5)
    mask = np.zeros((j.graph.n_nodes, 6), bool)
    mask[np.arange(j.graph.n_nodes), shard] = True
    mask[rng.integers(0, j.graph.n_nodes, 3000), rng.integers(0, 6, 3000)] = True
    cuts = [0, 70, 150, ps_j.n_queries]  # the tenants' boundary falls inside a batch
    return {
        "batches_j": [ps_j.select_queries(a, b) for a, b in zip(cuts, cuts[1:])],
        "batches_t": [ps_t.select_queries(a, b) for a, b in zip(cuts, cuts[1:])],
        "slo_j": slo_j, "slo_t": slo_t,
        "scheme_j": ReplicationScheme(mask.copy(), shard.copy()),
        "scheme_t": TScheme(mask.copy(), shard.copy()),
    }


@pytest.mark.parametrize("policy", [None, "nearest_copy"])
@pytest.mark.parametrize("with_slo", [False, True])
def test_workload_latency_summary_equals_jax(summary_case, policy, with_slo):
    """The streamed report (histogram, max_traversals, feasible and, with
    an SLOSpec, the per-tenant dict consumed batch by batch) equals the
    JAX package's on the same batches and scheme, exactly."""
    from repro.workload import workload_latency_summary
    from repro_torch.workload import workload_latency_summary as t_summary

    c = summary_case
    kw_j = {"slo": c["slo_j"]} if with_slo else {"t": 2}
    kw_t = {"slo": c["slo_t"]} if with_slo else {"t": 2}
    want = workload_latency_summary(c["batches_j"], c["scheme_j"], policy=policy, **kw_j)
    got = t_summary(c["batches_t"], c["scheme_t"], policy=policy, device="cpu", **kw_t)
    assert got == want
    assert len(got["histogram"]) > 1
    if with_slo:
        assert set(got["per_tenant"]) == {"snb", "recsys"}
        assert sum(v["queries"] for v in got["per_tenant"].values()) == \
            sum(b.n_queries for b in c["batches_t"])


def test_stream_latencies_reuses_a_resident_engine(summary_case):
    """stream_latencies gives the JAX package's h per batch; with a built
    LatencyEngine it uploads only the path rows (the same bytes as calling
    path_latencies per batch), and from a scheme it packs and uploads the
    scheme once for the whole stream."""
    from repro.workload import stream_latencies
    from repro_torch.engine import TRANSFER, LatencyEngine
    from repro_torch.workload import stream_latencies as t_stream

    c = summary_case
    want = [h for _, h in stream_latencies(c["batches_j"], c["scheme_j"],
                                           policy="nearest_copy")]
    eng = LatencyEngine(c["scheme_t"], device="cpu")
    with TRANSFER.scope() as tr:
        for ps in c["batches_t"]:
            eng.path_latencies(ps, policy="nearest_copy")
        direct = tr.h2d_bytes
    with TRANSFER.scope() as tr:
        got = list(t_stream(c["batches_t"], eng, policy="nearest_copy"))
        resident = tr.h2d_bytes
    assert [ps for ps, _ in got] == c["batches_t"]
    assert all(np.array_equal(h, w) for (_, h), w in zip(got, want))
    assert resident == direct > 0
    with TRANSFER.scope() as tr:
        again = [h for _, h in t_stream(c["batches_t"], c["scheme_t"],
                                        policy="nearest_copy", device="cpu")]
        built = tr.h2d_bytes
    assert all(np.array_equal(h, w) for h, w in zip(again, want))
    # one upload of the scheme, packed on the device: its bool mask and its shard
    assert built == direct + c["scheme_t"].mask.size + eng.packed.shard.numel() * 4
