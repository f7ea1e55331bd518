"""Deterministic synthetic graph generators (paper §6.1 substitutes).

The paper evaluates on LDBC SNB (SF1-SF30) and OGB (mag, papers100M).
Those datasets are not shipped offline, so we generate graphs with the
same *structural properties the algorithms are sensitive to*:

* SNB-like social graph: typed vertices (person / post / comment / forum),
  typed edges (knows / created / replyOf / containerOf / likes), power-law
  "knows" degree (social), heavy post/comment fan-out — because the paper's
  short-read templates traverse specific edge types from person roots.
* OGB-like citation graph: untyped, heavier-tailed power-law in-degree —
  neighborhood sampling is type-blind and degree-driven.

Everything is seeded and reproducible; scale is a parameter (the SNB scale
factors map to vertex counts).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph

# SNB-like type ids
PERSON, POST, COMMENT, FORUM = 0, 1, 2, 3
KNOWS, CREATED, REPLY_OF, CONTAINER_OF, LIKES, HAS_CREATOR = 0, 1, 2, 3, 4, 5

NODE_TYPE_NAMES = {PERSON: "person", POST: "post", COMMENT: "comment", FORUM: "forum"}
EDGE_TYPE_NAMES = {
    KNOWS: "knows",
    CREATED: "created",
    REPLY_OF: "replyOf",
    CONTAINER_OF: "containerOf",
    LIKES: "likes",
    HAS_CREATOR: "hasCreator",
}


@dataclasses.dataclass(frozen=True)
class SNBLikeGraph:
    graph: CSRGraph
    persons: np.ndarray
    posts: np.ndarray
    comments: np.ndarray
    forums: np.ndarray


def _power_law_targets(rng, n_src, n_dst_pool, mean_deg, alpha=1.8, dst_offset=0):
    """Draw power-law out-degrees and preferential targets."""
    deg = np.minimum(
        rng.zipf(alpha, size=n_src), max(4 * mean_deg, 8)
    ) + np.maximum(mean_deg - 1, 0)
    total = int(deg.sum())
    # preferential attachment approximated with a zipf-ranked pool
    ranks = rng.zipf(1.4, size=total) % n_dst_pool
    src = np.repeat(np.arange(n_src, dtype=np.int64), deg)
    dst = ranks.astype(np.int64) + dst_offset
    return src, dst


def snb_like(scale: int = 1, seed: int = 0) -> SNBLikeGraph:
    """SNB-like typed social graph.  ``scale``≈SF: SF1 ~ 30k persons here
    (reduced ~100x vs real SNB for CPU memory; structure preserved)."""
    rng = np.random.default_rng(seed)
    n_person = 3000 * scale
    n_forum = 800 * scale
    n_post = 12000 * scale
    n_comment = 30000 * scale

    p0 = 0
    f0 = n_person
    o0 = f0 + n_forum
    c0 = o0 + n_post
    n = c0 + n_comment

    node_types = np.empty(n, dtype=np.int16)
    node_types[p0:f0] = PERSON
    node_types[f0:o0] = FORUM
    node_types[o0:c0] = POST
    node_types[c0:n] = COMMENT

    srcs, dsts, etys = [], [], []

    def add(src, dst, et):
        srcs.append(src)
        dsts.append(dst)
        etys.append(np.full(len(src), et, np.int16))

    # person -knows-> person (power law, symmetric)
    s, d = _power_law_targets(rng, n_person, n_person, mean_deg=12)
    keep = s != d
    add(s[keep], d[keep], KNOWS)
    add(d[keep], s[keep], KNOWS)

    # person -created-> post / comment; inverse hasCreator
    post_creator = rng.integers(0, n_person, n_post)
    add(post_creator, np.arange(o0, c0), CREATED)
    add(np.arange(o0, c0), post_creator, HAS_CREATOR)
    comment_creator = rng.integers(0, n_person, n_comment)
    add(comment_creator, np.arange(c0, n), CREATED)
    add(np.arange(c0, n), comment_creator, HAS_CREATOR)

    # comment -replyOf-> post|comment (threads; earlier ids only)
    parent_is_post = rng.random(n_comment) < 0.6
    parent = np.where(
        parent_is_post,
        rng.integers(o0, c0, n_comment),
        c0 + rng.integers(0, np.maximum(np.arange(n_comment), 1)),
    )
    add(np.arange(c0, n), parent, REPLY_OF)

    # forum -containerOf-> post
    post_forum = rng.integers(f0, o0, n_post)
    add(post_forum, np.arange(o0, c0), CONTAINER_OF)

    # person -likes-> post (power-law popularity)
    s, d = _power_law_targets(rng, n_person, n_post, mean_deg=6, dst_offset=o0)
    add(s, d, LIKES)

    graph = CSRGraph.from_edges(
        n,
        np.concatenate(srcs),
        np.concatenate(dsts),
        np.concatenate(etys),
        node_types,
    )
    return SNBLikeGraph(
        graph=graph,
        persons=np.arange(p0, f0),
        posts=np.arange(o0, c0),
        comments=np.arange(c0, n),
        forums=np.arange(f0, o0),
    )


def ogb_like(n_nodes: int = 50_000, mean_deg: int = 15, seed: int = 0) -> CSRGraph:
    """OGB-like citation graph: untyped, power-law in-degree."""
    rng = np.random.default_rng(seed)
    src, dst = _power_law_targets(rng, n_nodes, n_nodes, mean_deg=mean_deg)
    keep = src != dst
    return CSRGraph.from_edges(n_nodes, src[keep], dst[keep], symmetrize=True)


def random_regular(n: int, d: int = 3, seed: int = 0) -> list[list[int]]:
    """Small d-regular graph as adjacency lists (hardness-gadget tests)."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        stubs = np.repeat(np.arange(n), d)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        if np.any(pairs[:, 0] == pairs[:, 1]):
            continue
        key = pairs.min(1) * n + pairs.max(1)
        if len(np.unique(key)) != len(key):
            continue
        adj: list[list[int]] = [[] for _ in range(n)]
        for a, b in pairs:
            adj[int(a)].append(int(b))
            adj[int(b)].append(int(a))
        return adj
    raise RuntimeError("failed to generate a simple regular graph")
