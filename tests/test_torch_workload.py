"""The port's graph, partition and workload copies give the JAX
package's arrays for the same seeds (exact)."""
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
