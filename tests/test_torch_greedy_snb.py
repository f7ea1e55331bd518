"""The port's greedy against the JAX package's on an SNB short-read workload.

``snb_like(1)`` with 300 queries, hash-sharded over 6 servers: masks must
be bit-identical with unit storage costs (``f=None``) and with
``f = object_sizes()``, whose non-integer float32 candidate costs are
summed in a different order by the two frameworks (ROADMAP trap c).
"""
import numpy as np
import pytest

from repro.graph import hash_partition, snb_like
from repro.workload import snb_workload_materialized
from test_torch_greedy import assert_same_run, policy_kw

N_SRV = 6


@pytest.fixture(scope="module")
def snb_case():
    snb = snb_like(scale=1, seed=0)
    ps = snb_workload_materialized(snb, n_queries=300, seed=0)
    shard = hash_partition(snb.graph.n_nodes, N_SRV)
    return ps, shard, snb.graph.object_sizes().astype(np.float32)


@pytest.mark.parametrize("policy", [None, "nearest_copy", "queue_aware"])
@pytest.mark.parametrize("t", [0, 1, 2])
def test_snb_masks_bit_identical(snb_case, t, policy):
    ps, shard, _ = snb_case
    assert_same_run(ps, shard, N_SRV, t, t, **policy_kw(policy, N_SRV))


@pytest.mark.parametrize("policy", [None, "nearest_copy"])
@pytest.mark.parametrize("t", [1, 2])
def test_snb_object_sizes_bit_identical(snb_case, t, policy):
    ps, shard, f = snb_case
    assert_same_run(ps, shard, N_SRV, t, t, f=f, policy=policy)
