"""The port's baselines (``repro_torch.core.baselines``) and hardness
gadget (``repro_torch.core.hardness``) against the JAX package's on the
same seeded inputs (CPU, exact): the single-site oracle's and the
dangling-edge schemes' masks, ``evaluate_baseline``'s latencies and
storage metrics on the torch and reference backends, the Thm 4.5
instance, the bisection schemes and ``is_feasible_ls`` (walked on the
engine from every server) on every bisection and on random schemes.
"""
import dataclasses
import itertools

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from conftest import random_workload
from repro.graph import hash_partition, random_regular, snb_like
from repro_torch.graph import random_regular as t_random_regular


def _tps(ps):
    return T.PathSet(ps.objects, ps.lengths, ps.query_ids)


def test_single_site_oracle_matches_jax():
    ps, shard = random_workload(np.random.default_rng(0), n_paths=300, n_queries=70)
    want = J.single_site_oracle(ps, shard, 5)
    got = T.single_site_oracle(_tps(ps), shard, 5)
    assert np.array_equal(want.mask, got.mask) and got.replica_count() > 0
    empty = T.PathSet(np.zeros((0, 3), np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert T.single_site_oracle(empty, shard, 5).replica_count() == 0


@pytest.mark.parametrize("k", [0, 1])
def test_dangling_edge_replication_matches_jax(k):
    g = snb_like(1, seed=0).graph
    shard = hash_partition(g.n_nodes, 4)
    want = J.dangling_edge_replication(g.indptr, g.indices, shard, 4, k=k)
    got = T.dangling_edge_replication(g.indptr, g.indices, shard, 4, k=k)
    assert np.array_equal(want.mask, got.mask) and got.replica_count() > 0


@pytest.mark.parametrize("backend", ["torch", "reference"])
def test_evaluate_baseline_matches_jax(backend):
    ps, shard = random_workload(np.random.default_rng(1), n_paths=300, n_queries=80)
    f = np.random.default_rng(2).uniform(0.5, 2.0, 120)
    for scheme in (J.single_site_oracle(ps, shard, 5), J.replicate_workload(ps, shard, 5, 1)[0],
                   J.ReplicationScheme.from_sharding(shard, 5)):
        want = J.evaluate_baseline(ps, scheme, f)
        got = T.evaluate_baseline(_tps(ps), T.ReplicationScheme(scheme.mask.copy(), shard), f,
                                  backend=backend, device="cpu")
        assert want.keys() == got.keys()
        for key in want:
            assert np.array_equal(want[key], got[key]), key


def _bisections(n):
    for half in itertools.combinations(range(n), n // 2):
        side = np.ones(n, np.int8)
        side[list(half)] = 0
        yield side


@pytest.mark.parametrize("n,seed", [(6, 0), (6, 3), (8, 1)])
def test_ls_instance_and_feasibility_match_jax(n, seed):
    """Every bisection's scheme, at the min-bridge budget and one below:
    the same instance, scheme and verdict; then random schemes over the
    instance (random copies of every object anywhere) for the walk."""
    adj = random_regular(n, 3, seed)
    assert adj == t_random_regular(n, 3, seed)
    K = J.brute_force_min_bridge_bisection(adj)
    assert T.brute_force_min_bridge_bisection(adj) == K
    verdicts = []
    for budget in sorted({K, max(K - 1, 0)}):
        ji, ti = J.build_ls_instance(adj, budget), T.build_ls_instance(adj, budget)
        for name in ("objects", "lengths", "query_ids"):
            assert np.array_equal(getattr(ji.pathset, name), getattr(ti.pathset, name))
        for name in ("shard", "f", "capacity", "marker_of", "regular_of"):
            assert np.array_equal(getattr(ji, name), getattr(ti, name)), name
        assert (ji.n_servers, ji.t) == (ti.n_servers, ti.t)
        assert J.brute_force_feasible(ji, adj) == T.brute_force_feasible(ti, adj)
        for side in _bisections(n):
            js = J.scheme_from_bisection(ji, adj, side)
            ts = T.scheme_from_bisection(ti, adj, side)
            assert np.array_equal(js.mask, ts.mask)
            verdict = T.is_feasible_ls(ti, ts, device="cpu")
            assert verdict == J.is_feasible_ls(ji, js)
            verdicts.append(verdict)
        # unbounded capacities: the verdict is the walk's alone
        ji, ti = (dataclasses.replace(i, capacity=np.full(4, np.inf)) for i in (ji, ti))
        rng = np.random.default_rng(seed)
        for p_copy in (0.8, 0.9, 0.95, 0.98) * 5:
            mask = rng.random((2 * n, 4)) < p_copy  # a marker and a regular object per vertex
            mask[np.arange(2 * n), ji.shard] = True
            js = J.ReplicationScheme(mask, ji.shard)
            ts = T.ReplicationScheme(mask.copy(), ti.shard)
            want = J.is_feasible_ls(ji, js)
            for backend in ("torch", "reference"):
                assert T.is_feasible_ls(ti, ts, device="cpu", backend=backend) == want
            verdicts.append(want)
    assert any(verdicts) and not all(verdicts)
