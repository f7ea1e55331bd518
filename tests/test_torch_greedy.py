"""The port's greedy against the JAX package's greedy: bit-identical masks.

``repro_torch.core.replicate_workload`` (torch backend on the CPU) and
``repro.core.replicate_workload`` must return identical replica masks and
equal ``GreedyStats`` counters across t x policy, vector budgets,
``SLOSpec`` budgets and capacity / epsilon constraints, and the two
``is_latency_feasible`` must agree.
"""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from conftest import random_workload

CPU = "cpu"
COUNTERS = ("replicas", "failed_paths", "fallback_paths", "routed_skips",
            "routed_violations", "pruned_replicas", "paths_processed")


def policy_kw(policy, n_srv):
    if policy == "queue_aware":
        load = np.zeros(n_srv)
        load[0] = 3.0
        load[2] = load[3] = 1.0  # ties
        return {"policy": policy, "load": load}
    return {"policy": policy}


def to_port(ps):
    return T.PathSet(ps.objects, ps.lengths, ps.query_ids)


def assert_same_run(ps, shard, n_srv, jt, tt, check_policy=None, **kw):
    """Run both greedies; masks and counters must match exactly."""
    js, jst = R.replicate_workload(ps, shard, n_srv, jt, **kw)
    ts, tst = T.replicate_workload(to_port(ps), shard, n_srv, tt, device=CPU, **kw)
    assert np.array_equal(ts.mask, js.mask)
    assert np.array_equal(ts.shard, js.shard)
    for c in COUNTERS:
        assert getattr(tst, c) == getattr(jst, c), c
    pol = check_policy if check_policy is not None else kw.get("policy")
    for policy in {None, pol}:
        assert T.is_latency_feasible(to_port(ps), ts, tt, policy=policy, device=CPU) == \
            R.is_latency_feasible(ps, js, jt, policy=policy)
    return ts, tst


@pytest.fixture(scope="module")
def workload():
    return random_workload(np.random.default_rng(0))


@pytest.mark.parametrize("policy", [None, "nearest_copy", "queue_aware", "nearest_copy_dp"])
@pytest.mark.parametrize("t", [0, 1, 2])
def test_masks_bit_identical(workload, t, policy):
    ps, shard = workload
    assert_same_run(ps, shard, 5, t, t, **policy_kw(policy, 5))


@pytest.mark.parametrize("policy", [None, "nearest_copy"])
def test_vector_budgets(policy):
    ps, shard = random_workload(np.random.default_rng(1), n_queries=40)
    t = np.random.default_rng(2).integers(0, 3, ps.n_queries).astype(np.int32)
    assert_same_run(ps, shard, 5, t, t, policy=policy)


def test_slospec_equals_scalar(workload):
    ps, shard = workload
    nq = ps.n_queries
    ts, tst = assert_same_run(
        ps, shard, 5, R.SLOSpec.uniform(1, nq), T.SLOSpec.uniform(1, nq),
        policy="nearest_copy",
    )
    ts2, _ = T.replicate_workload(to_port(ps), shard, 5, 1, policy="nearest_copy",
                                  device=CPU)
    assert np.array_equal(ts.mask, ts2.mask)


@pytest.mark.parametrize("policy", [None, "nearest_copy"])
def test_capacity_and_epsilon(workload, policy):
    ps, shard = workload
    # integer sizes keep every float32 load sum exact in both frameworks
    f = np.random.default_rng(3).integers(1, 4, 120).astype(np.float32)
    base = np.bincount(shard, weights=f, minlength=5)
    cap = float(base.max() * 1.6)
    assert_same_run(ps, shard, 5, 1, 1, f=f, capacity=cap, epsilon=0.5, policy=policy)


def test_reference_gate_and_track_rm(workload):
    ps, shard = workload
    js, jst = R.replicate_workload(ps, shard, 5, 1, policy="nearest_copy",
                                   policy_backend="reference", track_rm=True)
    ts, tst = T.replicate_workload(to_port(ps), shard, 5, 1, policy="nearest_copy",
                                   policy_backend="reference", track_rm=True, device=CPU)
    assert np.array_equal(ts.mask, js.mask)
    assert sorted(tst.rm) == sorted(jst.rm)
    _, _, eng = T.replicate_workload(to_port(ps), shard, 5, 1, return_engine=True,
                                     device=CPU)
    assert eng.backend == "torch"
    assert np.array_equal(eng.host_mask(), R.replicate_workload(ps, shard, 5, 1)[0].mask)
