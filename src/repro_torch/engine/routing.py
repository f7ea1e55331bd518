"""Pluggable hop-target routing policies for the batched access walk.

The paper's latency model (Eqn 1 / Def 4.3) counts an access as local
whenever *any* replica of the next object is co-located with the current
server; when it is not, the walk must pick a remote target.  Eqn 1's
second case nominally sends the hop to the object's home server, but the
model is indifferent to *which* copy holder serves a remote hop — and the
choice matters twice over: the landing server decides whether *later*
accesses of the path are local (a holder of the next object keeps the
walk local one hop longer), and under traffic it decides which queue the
RPC waits in.  This module makes that choice a first-class, swappable
policy consumed by ``repro_torch.engine.backends.access_trace`` and every layer
above it (engine -> distsys executor -> serve simulator/controller):

  ``home_first``    Eqn 1 verbatim: remote hops go to the object's home
                    (or the caller's fail-over map).  Bit-identical to the
                    historical hardcoded walk.
  ``nearest_copy``  stay local when possible; a remote hop prefers an
                    alive copy holder that *also* holds the path's next
                    object (one-step locality lookahead), then the home
                    server, then the lowest id.  The paper-faithful
                    "any co-located replica counts" reading of Eqn 1 —
                    h under ``nearest_copy`` is what ``is_feasible`` can
                    optionally be scored against.
  ``queue_aware``   ``nearest_copy``'s candidate preference, tie-broken by
                    a per-server load vector (live queue depths): within
                    the preferred candidate class the least-loaded holder
                    serves the hop, the home server winning ties — the
                    batched generalization of ``Router.route_hop``.
  ``nearest_copy_dp(k)``  the depth-``k`` generalization of the locality
                    lookahead: a remote hop scores every alive holder by
                    the *optimal* number of paid hops over the next ``k``
                    accesses of the path (a DP over the path suffix,
                    recomputed against the live replica state) and picks
                    the best-scoring holder, home winning ties, then the
                    lowest id.  ``k=0`` reduces to ``home_first`` and
                    ``k=1`` to ``nearest_copy`` **bit-identically** (the
                    one-step score is exactly "does this holder keep the
                    next access local"); ``depth=None`` scores the whole
                    remaining suffix, i.e. executes the *optimal*
                    replica-aware walk — the latency it reports
                    pathwise-dominates every other policy and is monotone
                    under replica additions (the two properties
                    ``tests/test_policy_properties.py`` pins).  For
                    intermediate ``k`` the walk is receding-horizon:
                    better in aggregate as ``k`` grows, but not pathwise
                    (a deeper-but-still-myopic pick can lose to a lucky
                    shallow one on an adversarial path).

Policies are frozen dataclasses (hashable);
the device implementations live in ``repro_torch.engine.backends`` and a CUDA
kernel twin in ``repro_torch.kernels.routed_walk``.  :func:`pick_holder_host`
and :func:`pick_holder_scored` are the scalar numpy twins shared by
``Router.route_hop`` and the ``reference`` backend oracle, so all three
implementations pin one semantics.
"""
from __future__ import annotations

import dataclasses

import numpy as np

POLICIES = ("home_first", "nearest_copy", "queue_aware", "nearest_copy_dp")


@dataclasses.dataclass(frozen=True)
class RoutingPolicy:
    """Base marker: how the batched walk picks a remote hop's target."""

    name = "home_first"
    uses_load = False
    lookahead = False


@dataclasses.dataclass(frozen=True)
class HomeFirst(RoutingPolicy):
    """Eqn 1 second case verbatim: remote hops go to ``home[obj]``."""

    name = "home_first"


@dataclasses.dataclass(frozen=True)
class NearestCopy(RoutingPolicy):
    """Locality-greedy holder pick: lookahead class, then home, then id.

    ``lookahead=False`` drops the one-step locality preference, reducing
    the pick to "home if it holds a copy, else lowest-id holder".
    """

    name = "nearest_copy"
    lookahead: bool = True


@dataclasses.dataclass(frozen=True)
class QueueAware(NearestCopy):
    """``nearest_copy`` tie-broken by a per-server load vector.

    Within the preferred candidate class (lookahead holders when any,
    else all holders) the least-loaded server wins; ties prefer the home
    server, then the lowest id.  With no lookahead candidates this is
    exactly ``Router.route_hop``'s queue-aware scalar pick, batched.
    """

    name = "queue_aware"
    uses_load = True


@dataclasses.dataclass(frozen=True)
class NearestCopyDP(RoutingPolicy):
    """Depth-``k`` locality lookahead: a DP over the path suffix.

    A remote hop scores every holder ``s'`` by the optimal paid-hop count
    over the next ``depth`` accesses when the walk lands at ``s'`` (the
    suffix DP of ``repro_torch.engine.backends._dp_score_tables``); the
    best-scoring holder serves the hop, the home server winning ties,
    then the lowest id.  ``depth=None`` scores the entire remaining
    suffix — the *optimal* replica-aware walk, the strongest reading of
    Eqn 1's "any co-located copy counts".  ``depth=0`` is ``home_first``
    and ``depth=1`` is ``nearest_copy``, bit-identically.
    """

    name = "nearest_copy_dp"
    depth: int | None = None

    def __post_init__(self):
        if self.depth is not None and self.depth < 0:
            raise ValueError("nearest_copy_dp depth must be >= 0 or None")


def nearest_copy_dp(depth: int | None = None) -> NearestCopyDP:
    """The depth-``k`` DP lookahead policy (``None`` = full suffix)."""
    return NearestCopyDP(depth=depth)


def resolve_policy(policy) -> RoutingPolicy:
    """str | RoutingPolicy | None -> RoutingPolicy (None = home_first)."""
    if policy is None:
        return HomeFirst()
    if isinstance(policy, RoutingPolicy):
        return policy
    if policy == "home_first":
        return HomeFirst()
    if policy == "nearest_copy":
        return NearestCopy()
    if policy == "queue_aware":
        return QueueAware()
    if policy == "nearest_copy_dp":
        return NearestCopyDP()
    raise ValueError(f"unknown routing policy {policy!r}; use {POLICIES}")


def pick_holder_host(
    holders: np.ndarray,
    home: int,
    load: np.ndarray | None = None,
    lookahead: np.ndarray | None = None,
) -> int:
    """Scalar oracle of the remote-hop holder pick (one access).

    ``holders`` bool [S] — alive copy holders of the hopped-to object;
    ``home`` the object's home server (may be -1 when no alive copy
    exists — it then never wins a tie); ``load`` optional per-server
    queue depths (None = unloaded, the ``nearest_copy`` case);
    ``lookahead`` optional bool [S] — holders of the *next* object on the
    path (the preferred candidate class when it intersects ``holders``).

    Returns the picked server id, or -1 when ``holders`` is empty.  The
    vectorized torch walk and the CUDA kernel are parity-tested against
    this function.
    """
    holders = np.asarray(holders, bool)
    cand = holders
    if lookahead is not None:
        both = holders & np.asarray(lookahead, bool)
        if both.any():
            cand = both
    ids = np.nonzero(cand)[0]
    if len(ids) == 0:
        return -1
    lv = (
        np.zeros(len(ids))
        if load is None
        else np.asarray(load, np.float64)[ids]
    )
    m = lv.min()
    best = ids[lv <= m]
    if home in best:
        return int(home)
    return int(best[0])


def pick_holder_scored(
    holders: np.ndarray, home: int, scores: np.ndarray
) -> int:
    """Scalar oracle of the scored holder pick (``nearest_copy_dp``).

    ``holders`` bool [S] — alive copy holders of the hopped-to object;
    ``home`` the object's home server (never wins a tie when -1);
    ``scores`` float/int [S] — per-server cost-to-go (lower is better).
    Among the minimum-score holders the home wins, then the lowest id;
    returns -1 when ``holders`` is empty.
    """
    holders = np.asarray(holders, bool)
    ids = np.nonzero(holders)[0]
    if len(ids) == 0:
        return -1
    sc = np.asarray(scores, np.float64)[ids]
    m = sc.min()
    best = ids[sc <= m]
    if home in best:
        return int(home)
    return int(best[0])


def dp_suffix_scores(
    objs: np.ndarray, mask: np.ndarray, depth: int | None
) -> "np.ndarray":
    """Suffix-DP score table for one path (the scalar oracle).

    ``E[pos, s]`` = minimal number of paid hops over the next ``depth``
    accesses of the path (``objs[pos + 1 :]``, clipped at the path end)
    when the walk sits at server ``s`` after access ``pos``; a hop may go
    to any holder of the hopped-to object (``mask``), and an object with
    no holder sends the walk to the dead server -1 (from which nothing is
    local but later hops can still revive to a real holder).  The last
    row ``E[pos, S]`` is that dead-state value.  ``depth=None`` scores
    the whole suffix (the optimal cost-to-go).  Returns float64
    ``[n, S + 1]``.
    """
    objs = [int(v) for v in objs]
    n = len(objs)
    S = mask.shape[1]
    k = n if depth is None else min(int(depth), n)
    # E[m] rows roll over positions; build bottom-up over the window size m
    E = np.zeros((n, S + 1), np.float64)
    for _ in range(k):
        nxt = np.zeros((n, S + 1), np.float64)
        for pos in range(n - 1):
            v = objs[pos + 1]
            hold = mask[v]
            if hold.any():
                hop = 1.0 + E[pos + 1, :S][hold].min()
            else:
                hop = 1.0 + E[pos + 1, S]
            nxt[pos, :S] = np.where(hold, E[pos + 1, :S], hop)
            nxt[pos, S] = hop
        E = nxt
    return E
