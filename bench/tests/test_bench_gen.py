"""The benchmark's generators repeat per seed, meet the counts they are
given, and a run's seed orders the same work anew for each drive."""
import numpy as np
import torch

from bench import gen, harness
from bench.gen import common
from bench.gen.graph import ldbc_snb
from bench.gen.graph import ogb_products as ogb
from bench.gen.traffic import graphsage, ldbc_short_reads
from bench.tests.conftest import SMALL_SNB, cut_snb

CPU = torch.device("cpu")


def _rows(paths):
    return sorted(map(tuple, paths.objects.tolist()))


def _small_cell():
    return cut_snb(harness.load_cell("snb_sf1.provision.t1"), 200)


def test_snb_inputs_repeat_per_seed_and_the_seed_orders_them():
    cell = _small_cell()
    a = gen.make_inputs(cell.config, cell.traffic, CPU)
    b = gen.make_inputs(cell.config, cell.traffic, CPU)
    for x, y in ((a.pool.objects, b.pool.objects), (a.pool.query_ids, b.pool.query_ids),
                 (a.home, b.home), (a.f, b.f)):
        assert np.array_equal(x, y)
    s = 2**40 + 1
    d0, d0_again, d1, other = (gen.order(a, s, 0), gen.order(b, s, 0), gen.order(a, s, 1),
                               gen.order(a, 5, 0))
    assert np.array_equal(d0.objects, d0_again.objects)
    for x in (d1, other):
        assert not np.array_equal(d0.objects, x.objects)
        assert _rows(x) == _rows(d0) == _rows(a.pool)
    assert a.t == 1 and a.n_servers == 6 and a.policy == "nearest_copy"
    q = d1.query_ids
    assert np.all(np.diff(q) >= 0) and q.max() + 1 == a.pool.query_ids.max() + 1


def test_ldbc_graph_meets_its_counts():
    spec = {**SMALL_SNB, "generator": "ldbc_snb", "activity_pareto": 2.5}
    g = ldbc_snb.build(spec, 3, CPU)
    again = ldbc_snb.build(spec, 3, CPU)
    assert np.array_equal(g.degree, again.degree)
    ent, edges = spec["entities"], spec["edges"]
    assert g.n_nodes == sum(ent.values())
    d = g.data
    assert d["knows"].n_entries == 2 * edges["knows"]
    post0, comment0 = d["ranges"]["post"][0], d["ranges"]["comment"][0]
    parent = d["parent"]
    assert int((parent < comment0).sum()) == edges["comment_replyof_post"]
    assert int((parent >= comment0).sum()) == edges["comment_replyof_comment"]
    own = np.arange(ent["comment"])
    up = parent >= comment0
    assert np.all(parent[up] - comment0 < own[up])  # an earlier comment of its thread
    n_msg = ent["post"] + ent["comment"]
    stored = (2 * edges["knows"] + 2 * ent["person"] + 2 * ent["forum"] + 2 * ent["post"]
              + 2 * n_msg + 2 * ent["comment"] + 2 * edges["forum_hasmember_person"]
              + 2 * (edges["person_likes_post"] + edges["person_likes_comment"]))
    assert int(g.degree.sum()) == stored
    assert d["messages"].n_entries == n_msg and d["replies"].n_entries == ent["comment"]
    assert g.facts["thread_depth_max"] >= 2


def test_short_reads_follow_their_templates():
    spec = {**SMALL_SNB, "generator": "ldbc_snb", "activity_pareto": 2.5}
    g = ldbc_snb.build(spec, 4, CPU)
    d = g.data
    r = d["ranges"]
    post0, comment0 = r["post"][0], r["comment"][0]
    person = int(np.argmax(np.diff(d["messages"].indptr)))
    assert ldbc_short_reads.is1(d, person)[0][1] in range(*r["city"])
    for p in ldbc_short_reads.is2(d, person):
        assert p[0] == person and len(p) >= 3 and r["post"][0] <= p[-2] < comment0
        assert p[-1] == d["creator"][p[-2] - post0]
        assert all(d["parent"][a - comment0] == b for a, b in zip(p[1:-2], p[2:-1]))
    assert len(ldbc_short_reads.is2(d, person)) == 10
    assert sorted(x[1] for x in ldbc_short_reads.is3(d, person)) == sorted(
        d["knows"].neighbors(person).tolist())
    deep = comment0 + int(np.argmax(d["parent"]))
    six = ldbc_short_reads.is6(d, deep)[0]
    assert six[0] == deep and r["forum"][0] <= six[-2] < post0 and six[-1] < r["person"][1]
    seven = ldbc_short_reads.is7(d, six[-3])
    assert seven[0] == [six[-3], d["creator"][six[-3] - post0]]
    assert all(d["parent"][x[1] - comment0] == six[-3] for x in seven[1:])


def test_short_read_sequences_keep_their_reads_together():
    cell = _small_cell()
    inputs = gen.make_inputs(cell.config, cell.traffic, CPU)
    pool = inputs.pool
    assert pool.groups.max() + 1 == 200
    got = gen.order(inputs, 77, 3)
    starts = np.flatnonzero(np.diff(np.concatenate([[-1], got.groups])))
    assert len(starts) == 200  # every sequence in one run of rows
    for g_ in (0, 1, 2):
        assert np.array_equal(got.objects[got.groups == g_], pool.objects[pool.groups == g_])


def test_products_graph_repeats_and_follows_its_rules():
    g1 = ogb.products_graph(5000, 8, 3, CPU)
    g2 = ogb.products_graph(5000, 8, 3, CPU)
    assert np.array_equal(g1.indptr, g2.indptr) and np.array_equal(g1.indices, g2.indices)
    src = np.repeat(np.arange(g1.n_nodes), g1.degree())
    dst = g1.indices.astype(np.int64)
    assert not np.any(src == dst)
    key = src * g1.n_nodes + dst
    assert np.all(np.diff(key) > 0)  # sorted, no parallel edges
    assert np.array_equal(np.sort(key), np.sort(dst * g1.n_nodes + src))  # symmetric


def test_zipf_draws_follow_the_law():
    gen_ = torch.Generator().manual_seed(0)
    k = ogb.zipf_capped(gen_, 200_000, 1.8, 20, CPU).numpy()
    p1 = 1.0 / ogb.zeta(1.8)
    assert k.min() == 1 and k.max() == 20
    assert abs(np.mean(k == 1) - p1) < 0.01
    r = ogb.zipf_ranks(gen_, 200_000, 1.4, CPU).numpy()
    assert r.min() == 1 and abs(np.mean(r == 1) - 1.0 / ogb.zeta(1.4)) < 0.01


def test_sage_paths_follow_the_fanouts():
    g = ogb.products_graph(3000, 30, 1, CPU)
    p = graphsage.sage_paths(g, np.array([0, 1, 2]), (25, 10), 7)
    q = p.query_ids
    assert p.objects.shape[1] == 3 and set(q.tolist()) == {0, 1, 2}
    for i in range(3):
        rows = p.objects[q == i]
        assert len(np.unique(rows[:, 1])) <= 25 and np.all(rows[:, 0] == i)


def test_shuffle_keeps_each_query_together():
    paths = common.paths_from_lists([[1], [2, 3], [4], [5, 6]], [0, 1, 1, 2])
    got = common.shuffle_queries(paths, 3)
    assert _rows(got) == _rows(paths)
    q = got.query_ids.tolist()
    assert sorted(q) == [0, 1, 1, 2] and q == sorted(q)
    # the query of paths [2, 3] and [4] keeps both, in their order
    i = [row[0] for row in got.objects.tolist()].index(2)
    assert got.objects[i + 1, 0] == 4 and q[i] == q[i + 1]
