"""An LDBC SNB-shaped social graph, drawn to a Datagen scale factor's
entity and edge counts.

Objects, in id order: persons, cities, forums, posts, comments (the
entity types the Interactive short reads touch).  Every count the
configuration's ``entities`` and ``edges`` give is met exactly:

* ``knows``: undirected pairs between persons, endpoints drawn by each
  person's activity (Chung-Lu), self-loops and repeats redrawn;
* every person is located in one city; every forum has one moderator (the
  first ``person`` forums are the persons' walls, moderated by their
  owner, the rest a person drawn by activity);
* every post lies in one forum and every message has one creator, drawn
  by activity;
* comments form reply trees: each comment belongs to the thread of one
  post; the first comment of a thread replies to the post, and of the
  others just enough reply to the post to meet ``comment_replyof_post``,
  the rest to an earlier comment of the same thread;
* ``forum_hasmember_person`` and the likes add to the records' adjacency
  lists only: nothing the short reads do walks them.

A person's activity weight is Pareto-distributed with shape
``activity_pareto``; creation times order each person's messages (a
post at a uniform time, a comment after its parent).  Each object's
degree counts every edge stored with it, both ends of each edge.
"""
from __future__ import annotations

import numpy as np

from bench.gen.common import Graph, csr_from_edges, csr_from_groups

ENTITIES = ("person", "city", "forum", "post", "comment")


def _pairs(rng, n: int, prob: np.ndarray, count: int) -> np.ndarray:
    """``count`` distinct unordered pairs of [0, n), endpoints drawn by
    ``prob``, as int64 keys lo * n + hi."""
    keys = np.zeros(0, np.int64)
    while len(keys) < count:
        k = int((count - len(keys)) * 1.3) + 1024
        a = rng.choice(n, k, p=prob)
        b = rng.choice(n, k, p=prob)
        keep = a != b
        lo, hi = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
        keys = np.unique(np.concatenate([keys, lo * n + hi]))
    if len(keys) > count:
        keys = np.sort(rng.choice(keys, count, replace=False))
    return keys


def build(spec: dict, seed: int, device) -> Graph:
    rng = np.random.default_rng(seed)
    ent, edges = spec["entities"], spec["edges"]
    n_person, n_city, n_forum, n_post, n_comment = (int(ent[k]) for k in ENTITIES)
    city0 = n_person
    forum0 = city0 + n_city
    post0 = forum0 + n_forum
    comment0 = post0 + n_post
    n = comment0 + n_comment
    deg = np.zeros(n, np.int64)

    def stored(*ends):
        for e in ends:
            deg[:] += np.bincount(e, minlength=n)

    w = (1.0 - rng.random(n_person)) ** (-1.0 / float(spec["activity_pareto"]))
    prob = w / w.sum()

    keys = _pairs(rng, n_person, prob, int(edges["knows"]))
    a, b = keys // n_person, keys % n_person
    knows = csr_from_edges(n_person, np.concatenate([a, b]), np.concatenate([b, a]))
    stored(a, b)

    city = city0 + rng.integers(0, n_city, n_person)
    stored(np.arange(n_person), city)

    moderator = np.concatenate([np.arange(min(n_forum, n_person)),
                                rng.choice(n_person, max(n_forum - n_person, 0), p=prob)])
    stored(np.arange(forum0, post0), moderator)

    forum_of_post = forum0 + rng.integers(0, n_forum, n_post)
    stored(np.arange(post0, comment0), forum_of_post)

    creator = rng.choice(n_person, n_post + n_comment, p=prob)
    stored(np.arange(post0, n), creator)

    # reply trees: threads, then parents within each thread
    thread = rng.integers(0, n_post, n_comment)
    order = np.argsort(thread, kind="stable")  # comment index by (thread, creation)
    t_sorted = thread[order]
    first = np.ones(n_comment, bool)
    first[1:] = t_sorted[1:] != t_sorted[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(n_comment), 0))
    rank = np.arange(n_comment) - start  # comments before it in its thread
    n_to_post = int(edges["comment_replyof_post"])
    n_first = int(first.sum())
    if not n_first <= n_to_post <= n_comment:
        raise ValueError(f"{n_to_post} replies to posts cannot hold {n_first} thread starts")
    to_post = first.copy()
    later = np.flatnonzero(~first)
    to_post[rng.choice(later, n_to_post - n_first, replace=False)] = True
    earlier = start + np.floor(rng.random(n_comment) * np.maximum(rank, 1)).astype(np.int64)
    parent_sorted = np.where(to_post, post0 + t_sorted, comment0 + order[earlier])
    parent = np.empty(n_comment, np.int64)
    parent[order] = parent_sorted
    stored(np.arange(comment0, n), parent)

    # creation times: a post uniform, a comment after its parent
    ts = np.empty(n_post + n_comment)
    ts[:n_post] = rng.random(n_post)
    gap = rng.exponential(1e-3, n_comment)
    for r in range(int(rank.max()) + 1 if n_comment else 0):
        c = order[rank == r]
        ts[n_post + c] = ts[parent[c] - post0] + gap[c]

    members = rng.choice(n_person, int(edges["forum_hasmember_person"]), p=prob)
    stored(members, forum0 + rng.integers(0, n_forum, len(members)))
    for kind, lo, count in (("post", post0, n_post), ("comment", comment0, n_comment)):
        likes = int(edges[f"person_likes_{kind}"])
        stored(rng.choice(n_person, likes, p=prob), lo + rng.integers(0, count, likes))

    # each person's messages, newest first; each message's direct replies
    msg = np.arange(post0, n)
    by_person = np.lexsort((-ts, creator))
    messages = csr_from_groups(n_person, creator[by_person], msg[by_person])
    replies = csr_from_groups(n_post + n_comment, parent - post0, np.arange(comment0, n))
    data = {
        "ranges": {"person": (0, city0), "city": (city0, forum0), "forum": (forum0, post0),
                   "post": (post0, comment0), "comment": (comment0, n)},
        "knows": knows, "city": city.astype(np.int64), "moderator": moderator.astype(np.int64),
        "forum_of_post": forum_of_post, "creator": creator.astype(np.int64),
        "parent": parent, "messages": messages, "replies": replies,
    }
    facts = {"objects": n, **{k: int(ent[k]) for k in ENTITIES},
             "knows": int(edges["knows"]), "replies_to_post": n_to_post,
             "thread_depth_max": 0 if not n_comment else _depth_max(parent, post0, comment0)}
    return Graph(n, deg, data, facts)


def _depth_max(parent: np.ndarray, post0: int, comment0: int) -> int:
    """The most replies between a comment and its thread's post."""
    depth = np.zeros(len(parent), np.int64)
    cur = parent.copy()
    while True:
        up = cur >= comment0
        if not up.any():
            return int(depth.max()) + 1
        depth[up] += 1
        cur[up] = parent[cur[up] - comment0]
