"""MoE expert-dispatch workload analyzer (beyond-paper application).

Token -> expert dispatch in expert-parallel serving is a 1-hop causal
access: the token's activations (at its data-parallel home) must reach the
servers holding its top-k experts.  Modeling experts as dataset objects and
dispatches as 1-hop paths lets the paper's algorithm decide *expert
replication*: hot experts get replicas on more servers, bounding the tail
number of remote dispatches per token — the same heavy-hitter effect
production MoE serving exploits with expert replication.

Object-id layout: [0, n_token_groups) are token-group objects (home =
their data shard); [n_token_groups, n_token_groups + n_experts) are expert
objects (home = expert-parallel shard).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.paths import PathSet
from repro_torch.workload.analyzer import batched, materialize


def moe_workload(
    n_token_groups: int,
    n_experts: int,
    top_k: int,
    n_queries: int = 2000,
    zipf_a: float = 1.2,
    seed: int = 0,
    batch_queries: int = 512,
):
    """Stream 1-hop dispatch paths: token_group -> expert (top-k)."""
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, n_token_groups, size=n_queries)

    def paths_fn(group: int) -> list[list[int]]:
        # zipf-skewed expert popularity (router collapse in practice)
        experts = np.unique(rng.zipf(zipf_a, size=top_k) % n_experts)
        return [[group, int(n_token_groups + e)] for e in experts]

    return batched(paths_fn, groups, batch_queries)


def moe_workload_materialized(n_token_groups, n_experts, top_k, **kw) -> PathSet:
    return materialize(moe_workload(n_token_groups, n_experts, top_k, **kw))


def expert_shard(
    n_token_groups: int, n_experts: int, n_servers: int
) -> np.ndarray:
    """Default sharding: token groups round-robin; experts round-robin."""
    d = np.empty((n_token_groups + n_experts,), np.int32)
    d[:n_token_groups] = np.arange(n_token_groups) % n_servers
    d[n_token_groups:] = np.arange(n_experts) % n_servers
    return d
