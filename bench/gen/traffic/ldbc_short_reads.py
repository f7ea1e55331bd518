"""The LDBC SNB Interactive short reads IS1-IS7 as causal access paths.

Short reads come in sequences, as the Interactive workload's driver issues
them: a person sequence runs the person reads (IS1-IS3) on one person, a
message sequence the message reads (IS4-IS7) on one message.  The traffic
file names the reads of each sequence, the share of each sequence and how
many sequences a drive provisions; roots are drawn uniformly among the
persons, and among all messages (posts and comments).  Each read is one
query and expands to one path per leaf of its access tree (Def 4.1):

* IS1 profile: person -> city;
* IS2 recent messages: person -> each of the 10 newest messages -> the
  reply chain up to the thread's post -> the post's creator;
* IS3 friends: person -> each friend;
* IS4 content: the message;
* IS5 creator: message -> creator;
* IS6 forum: message -> the reply chain up to the post -> its forum ->
  the forum's moderator;
* IS7 replies: message -> its creator, and message -> each direct reply
  -> the reply's creator (whether the two know each other is read from
  the reply creator's record).
"""
from __future__ import annotations

import numpy as np

from bench.gen.common import Graph, Paths, paths_from_lists


def _chain(g: dict, m: int) -> list:
    """The message and its reply chain up to the thread's post."""
    comment0 = g["ranges"]["comment"][0]
    out = [m]
    while m >= comment0:
        m = int(g["parent"][m - comment0])
        out.append(m)
    return out


def _creator(g: dict, m: int) -> int:
    return int(g["creator"][m - g["ranges"]["post"][0]])


def is1(g, p):
    return [[p, int(g["city"][p])]]


def is2(g, p):
    out = []
    for m in g["messages"].neighbors(p)[:10]:
        chain = _chain(g, int(m))
        out.append([p, *chain, _creator(g, chain[-1])])
    return out or [[p]]


def is3(g, p):
    return [[p, int(f)] for f in g["knows"].neighbors(p)] or [[p]]


def is4(g, m):
    return [[m]]


def is5(g, m):
    return [[m, _creator(g, m)]]


def is6(g, m):
    chain = _chain(g, m)
    post0, forum0 = g["ranges"]["post"][0], g["ranges"]["forum"][0]
    forum = int(g["forum_of_post"][chain[-1] - post0])
    return [[*chain, forum, int(g["moderator"][forum - forum0])]]


def is7(g, m):
    post0 = g["ranges"]["post"][0]
    out = [[m, _creator(g, m)]]
    for r in g["replies"].neighbors(m - post0):
        out.append([m, int(r), _creator(g, int(r))])
    return out


READS = {"IS1": is1, "IS2": is2, "IS3": is3, "IS4": is4, "IS5": is5, "IS6": is6, "IS7": is7}
ROOTS = {"person": ("person",), "message": ("post", "comment")}


def draw(traffic: dict, graph: Graph, seed) -> Paths:
    g = graph.data
    rng = np.random.default_rng(seed)
    kinds = list(traffic["sequences"])
    share = np.asarray([traffic["sequences"][k]["share"] for k in kinds], np.float64)
    n_seq = int(traffic["sequences_per_drive"])
    pick = rng.choice(len(kinds), size=n_seq, p=share / share.sum())
    paths, qids, groups = [], [], []
    q = 0
    for s, k in enumerate(pick.tolist()):
        spec = traffic["sequences"][kinds[k]]
        lo = [g["ranges"][r][0] for r in ROOTS[spec["root"]]]
        hi = [g["ranges"][r][1] for r in ROOTS[spec["root"]]]
        size = sum(b - a for a, b in zip(lo, hi))
        i = int(rng.integers(0, size))
        for a, b in zip(lo, hi):
            if i < b - a:
                root = a + i
                break
            i -= b - a
        for name in spec["reads"]:
            got = READS[name](g, root)
            paths.extend(got)
            qids.extend([q] * len(got))
            groups.extend([s] * len(got))
            q += 1
    return paths_from_lists(paths, qids, groups)
