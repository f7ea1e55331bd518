"""Graph storage, generators, partitioners and neighbor sampling (numpy copies)."""
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.generators import SNBLikeGraph, ogb_like, random_regular, snb_like
from repro_torch.graph.partition import (
    hash_partition,
    hypergraph_partition,
    ldg_partition,
    make_sharding,
)
from repro_torch.graph.sampler import (
    MiniBatch,
    distributed_hops,
    minibatch_sampler,
    sample_neighborhood,
)

__all__ = [
    "CSRGraph",
    "SNBLikeGraph",
    "snb_like",
    "ogb_like",
    "random_regular",
    "hash_partition",
    "ldg_partition",
    "hypergraph_partition",
    "make_sharding",
    "MiniBatch",
    "minibatch_sampler",
    "sample_neighborhood",
    "distributed_hops",
]
