"""RecSys embedding-lookup workload analyzer (beyond-paper application).

MIND-style retrieval reads sharded embedding tables: a request touches the
user row, the rows of the user's recent behaviors (variable-length bag),
and candidate item rows scored against the extracted interests.  The
causal structure is

    user_row -> behavior_row_i            (bag gather: parallel paths)
    user_row -> behavior_row_i -> cand_j  (interest-conditioned scoring)

so each request yields 1-2-hop causal access paths over "objects" = table
rows, and the paper's algorithm bounds the tail number of remote lookups —
exactly the embedding-placement problem of production recsys serving.
Row popularity follows a zipf, giving the heavy-hitter skew replication
exploits.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.paths import PathSet
from repro_torch.core.slo import TenantSpec
from repro_torch.workload.analyzer import batched, materialize

# serving tenant: embedding fetch sits inside a strict end-to-end ranking
# budget — tightest default (all rows co-located with the request's
# coordinator, the paper's t=0 single-site regime)
TENANT = TenantSpec("recsys", t_q=0)


def zipf_rows(rng: np.random.Generator, n: int, size, a: float = 1.3) -> np.ndarray:
    """Row ids in [0, n) of zipf(``a``) popularity, the draw behind every
    request's behaviours and candidates in :func:`recsys_workload`."""
    return rng.zipf(a, size=size) % n


def recsys_request_paths(
    user_row: int,
    behavior_rows: np.ndarray,
    candidate_rows: np.ndarray,
) -> list[list[int]]:
    paths = []
    for b in behavior_rows:
        if len(candidate_rows):
            paths.extend([user_row, int(b), int(c)] for c in candidate_rows)
        else:
            paths.append([user_row, int(b)])
    return paths or [[user_row]]


def recsys_workload(
    n_users: int,
    n_items: int,
    n_requests: int = 2000,
    behaviors_per_req: int = 6,
    candidates_per_req: int = 4,
    zipf_a: float = 1.3,
    seed: int = 0,
    batch_queries: int = 512,
):
    """Stream PathSet batches of embedding-lookup requests.

    Object-id layout: rows [0, n_users) are user rows; [n_users,
    n_users + n_items) are item rows (one global id space = one dataset D).
    """
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, size=n_requests)

    def paths_fn(user: int) -> list[list[int]]:
        beh = n_users + zipf_rows(rng, n_items, behaviors_per_req, zipf_a)
        cand = n_users + zipf_rows(rng, n_items, candidates_per_req, zipf_a)
        return recsys_request_paths(user, np.unique(beh), np.unique(cand))

    return batched(paths_fn, users, batch_queries)


def recsys_workload_materialized(n_users, n_items, **kw) -> PathSet:
    return materialize(recsys_workload(n_users, n_items, **kw))
