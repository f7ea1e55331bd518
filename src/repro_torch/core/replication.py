"""Replication schemes and the latency/access function (paper §4).

A replication scheme ``r`` maps each object to the set of servers holding a
copy; the original copy placed by the sharding function ``d`` is always
included.  We represent ``r`` as a host boolean matrix
``[n_objects, n_servers]``; the engine keeps the packed copy on the device.

The access function rho (Eqn 1) and the path latency h(p, r, rho)
(Eqn 2) are evaluated by ``repro_torch.engine.LatencyEngine``.  The
module-level functions below build a transient engine per call; every one
takes ``device`` (default ``"cuda"``) and resolves its backend from it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.paths import PathSet
from repro_torch.engine import LatencyEngine, pack_bool_mask
from repro_torch.engine import backends as _backends
from repro_torch.engine.packed import scatter_clear_pairs, scatter_or_pairs
from repro_torch.engine.streaming import resolve_device, to_device, to_host


@dataclasses.dataclass
class ReplicationScheme:
    """Boolean replication matrix with storage accounting.

    Attributes:
      mask: bool [n_objects, n_servers]; ``mask[v, s]`` == object v has a copy
        at server s.  Always a superset of the sharding function.
      shard: int32 [n_objects]; the sharding function d (home server).
    """

    mask: np.ndarray
    shard: np.ndarray

    @staticmethod
    def from_sharding(shard: np.ndarray, n_servers: int) -> "ReplicationScheme":
        n = shard.shape[0]
        mask = np.zeros((n, n_servers), dtype=bool)
        mask[np.arange(n), shard] = True
        return ReplicationScheme(mask, shard.astype(np.int32))

    @staticmethod
    def from_numpy(mask: np.ndarray, shard: np.ndarray) -> "ReplicationScheme":
        """Adopt a mask and shard held as numpy arrays (copies both), e.g.
        the JAX package's scheme, mid-greedy or final."""
        return ReplicationScheme(
            np.array(mask, dtype=bool), np.array(shard, dtype=np.int32)
        )

    @property
    def n_objects(self) -> int:
        return self.mask.shape[0]

    @property
    def n_servers(self) -> int:
        return self.mask.shape[1]

    def copy(self) -> "ReplicationScheme":
        return ReplicationScheme(self.mask.copy(), self.shard)

    def add(self, objects: np.ndarray, servers: np.ndarray) -> None:
        """Monotone in-place addition of replicas (0->1 flips only)."""
        self.mask[objects, servers] = True

    def replica_count(self) -> int:
        """Number of *replica* copies (total copies minus originals)."""
        return int(self.mask.sum()) - self.n_objects

    def storage_per_server(self, f: np.ndarray | None = None) -> np.ndarray:
        """f_r(s) = sum of f(v) over v with s in r(v) (paper notation)."""
        if f is None:
            return self.mask.sum(axis=0).astype(np.float64)
        return f.astype(np.float64) @ self.mask

    def replication_overhead(self, f: np.ndarray | None = None) -> float:
        """Replicated bytes / original bytes (the paper's Fig 2d/6 metric)."""
        if f is None:
            total = float(self.mask.sum())
            orig = float(self.n_objects)
        else:
            total = float(self.storage_per_server(f).sum())
            orig = float(f.sum())
        return (total - orig) / orig

    def is_feasible(
        self,
        f: np.ndarray | None = None,
        capacity: np.ndarray | float | None = None,
        epsilon: float | None = None,
    ) -> bool:
        """Check storage capacity M_s and the eps load-imbalance constraint."""
        cost = self.storage_per_server(f)
        if capacity is not None:
            cap = np.broadcast_to(np.asarray(capacity, dtype=np.float64), cost.shape)
            if np.any(cost > cap + 1e-9):
                return False
        if epsilon is not None:
            mean = cost.mean()
            if mean > 0 and cost.max() > (1.0 + epsilon) * mean + 1e-9:
                return False
        return True

    def pack(self) -> np.ndarray:
        """Pack to uint32 bit-words [n_objects, ceil(S/32)] (kernel input)."""
        return pack_bool_mask(self.mask)


# ---------------------------------------------------------------------------
# Subpath decomposition (Def 5.1) under the *sharding* function d.
# ---------------------------------------------------------------------------
def subpath_structure(objects: torch.Tensor, lengths: torch.Tensor, shard: torch.Tensor):
    """Segment each path into server-local subpaths under d.

    Args:
      objects: int32 [P, L] padded paths.
      lengths: int32 [P].
      shard:   int32 [n_objects] sharding function.

    Returns:
      home: int32 [P, L]  home server per position (PAD positions -> -1)
      seg:  int32 [P, L]  subpath index per position (0-based)
      h:    int32 [P]     number of distributed traversals under d
                          (= #subpaths - 1)
    """
    P, L = objects.shape
    dev = objects.device
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < lengths[:, None]
    safe = objects.clamp_min(0).long()
    home = torch.where(valid, shard[safe], -1).int()
    prev = torch.cat(
        [torch.full((P, 1), -2, dtype=torch.int32, device=dev), home[:, :-1]], dim=1
    )
    boundary = valid & (pos > 0) & (home != prev)
    seg = torch.cumsum(boundary.int(), dim=1, dtype=torch.int32)
    seg = torch.where(valid, seg, -1)
    last = (lengths - 1).clamp_min(0).long()
    h = seg.gather(1, last[:, None])[:, 0]
    h = torch.where(lengths > 0, h, 0)
    return home, seg, h


# ---------------------------------------------------------------------------
# Latency of paths under a replication scheme (Eqns 1-3) — engine-backed.
# ---------------------------------------------------------------------------
def path_latencies(
    pathset: PathSet,
    scheme: ReplicationScheme,
    chunk: int = 8192,
    backend: str | None = None,
    policy=None,
    device=None,
) -> np.ndarray:
    """h(p, r, rho) for every path: #distributed traversals (Def 4.2).

    Builds a transient ``LatencyEngine`` (one packed upload) per call.
    ``policy`` scores the walk under a routing policy (default
    ``home_first``).
    """
    eng = LatencyEngine(scheme, backend=backend, chunk=chunk, device=device)
    return eng.path_latencies(pathset, policy=policy)


def query_latencies(
    pathset: PathSet,
    scheme: ReplicationScheme,
    path_lats: np.ndarray | None = None,
    device=None,
) -> np.ndarray:
    """l_Q = max over the query's paths (Def 4.3); int array [n_queries]."""
    if path_lats is None:
        path_lats = path_latencies(pathset, scheme, device=device)
    out = np.zeros((pathset.n_queries,), dtype=np.int32)
    np.maximum.at(out, pathset.query_ids, path_lats)
    return out


def path_latency_reference(path: list[int], mask: np.ndarray, shard: np.ndarray) -> int:
    """Pure-python oracle for a single path (used by tests)."""
    if not path:
        return 0
    server = int(shard[path[0]])
    cost = 0
    for v in path[1:]:
        if mask[v, server]:
            continue  # local replica: stay (Eqn 1 first case)
        server = int(shard[v])  # distributed traversal to the original copy
        cost += 1
    return cost


def _feasible_walk(pathset, scheme, path_lats, policy, device, backend) -> np.ndarray:
    """``path_lats``, or h of every path by a transient engine (the spans
    ``feasible.engine`` and ``feasible.walk``)."""
    if path_lats is None:
        with obs.span("feasible.engine"):
            eng = LatencyEngine(scheme, backend=backend, device=device)
        with obs.span("feasible.walk"):
            path_lats = eng.path_latencies(pathset, policy=policy)
    return path_lats


def _slacks(pathset: PathSet, t, path_lats: np.ndarray) -> np.ndarray:
    lq = query_latencies(pathset, None, path_lats=path_lats)
    t_q = getattr(t, "t_q", t)
    return (np.broadcast_to(np.asarray(t_q, np.int64), lq.shape) - lq).astype(np.int64)


@obs.spanned("feasible")
def query_slacks(
    pathset: PathSet,
    scheme: ReplicationScheme,
    t,
    path_lats: np.ndarray | None = None,
    policy=None,
    device=None,
    backend: str | None = None,
) -> np.ndarray:
    """Per-query slack t_Q - l_Q (negative = violating its constraint).

    ``t`` is an int (broadcast), a per-query budget vector, or an
    :class:`~repro_torch.core.slo.SLOSpec`.  ``policy`` scores the walk
    under a hop-routing policy (ignored when ``path_lats`` is given).
    """
    path_lats = _feasible_walk(pathset, scheme, path_lats, policy, device, backend)
    with obs.span("feasible.reduce"):
        return _slacks(pathset, t, path_lats)


@obs.spanned("feasible")
def is_latency_feasible(
    pathset: PathSet,
    scheme: ReplicationScheme,
    t,
    path_lats: np.ndarray | None = None,
    policy=None,
    device=None,
    backend: str | None = None,
) -> bool:
    """All queries within their latency constraint t_Q (Def 4.4 constraint 1).

    ``t``: int | per-query vector | SLOSpec.  ``policy`` scores
    feasibility under a hop-routing policy (``nearest_copy`` is the
    paper-faithful tighter reading).
    """
    path_lats = _feasible_walk(pathset, scheme, path_lats, policy, device, backend)
    with obs.span("feasible.reduce"):
        return bool(np.all(_slacks(pathset, t, path_lats) >= 0))


_PRUNE_GROUP_MAX = 512  # candidates per batched prune step


def _prune_group_step(words, gobj, gsrv, robj, rlen, rt, rcand, shard, rank, pol,
                      backend: str):
    """One batched prune round over an independent candidate group.

    Clears the group's ``G`` candidate bits at once, re-walks every
    affected row under the policy, scatter-maxes each row's violation onto
    its candidate (``rcand``), and restores exactly the violating
    candidates' bits.  Updates ``words`` in place; returns bool [G], True
    where the candidate must stay.
    """
    G = gobj.shape[0]
    scatter_clear_pairs(words, gobj, gsrv)
    h = _backends.gate_counts(robj, rlen, words, shard, pol, rank, backend=backend)
    viol = (h > rt).int()
    bad = torch.zeros((G,), dtype=torch.int32, device=words.device)
    bad = bad.scatter_reduce(0, rcand.long(), viol, "amax").bool()
    scatter_or_pairs(words, torch.where(bad, gobj, -1), gsrv)
    return bad


def _independent_groups(order, vs, affected, n_paths, group_max):
    """Partition prune candidates into serially-equivalent batches.

    Two candidates are independent iff no path touches both objects:
    neither's keep/drop decision can change what the other's affected
    walks read.  Greedy sweep in the serial (descending-f) order with
    *deferral closure*: once a candidate is deferred, its affected rows
    block every later candidate from joining the current group, so no
    candidate is evaluated against a snapshot that differs from the
    serial sweep's.  Once a group is full every later candidate is
    deferred, so the round stops scanning there (the JAX package's loop
    scans on, marking rows no later candidate can use): same groups.
    """
    remaining = list(order)
    groups = []
    while remaining:
        used = np.zeros(n_paths, bool)
        group: list[int] = []
        deferred: list[int] = []
        for pos, i in enumerate(remaining):
            if len(group) == group_max:
                deferred.extend(remaining[pos:])
                break
            rows = affected(int(vs[i]))
            if not used[rows].any():
                group.append(i)
            else:
                deferred.append(i)
            used[rows] = True
        groups.append(group)
        remaining = deferred
    return groups


def prune_scheme_replicas(
    scheme: ReplicationScheme,
    pathset: PathSet,
    t,
    policy="nearest_copy",
    f: np.ndarray | None = None,
    backend: str | None = None,
    fused: bool = False,
    load: np.ndarray | None = None,
    device=None,
    group_max: int = _PRUNE_GROUP_MAX,
    stage_s: dict | None = None,
) -> tuple[int, float]:
    """Drop replicas a policy-routed walk doesn't need for feasibility.

    Visits the scheme's replicas (non-originals) largest-``f`` first,
    tentatively removes each, and keeps the removal when every path that
    contains the object stays within its budget under ``policy``.  A walk
    reads only the replica words of its own path's objects, so removing
    the copy (v, s) can only change the paths that contain ``v``: each
    candidate clears one bit on the device and re-walks just those paths.
    Mutates ``scheme`` in place; returns ``(n_dropped, bytes_saved)``.

    One greedy sweep, not an optimal set cover.  The routes, all making
    the same decisions:

    * one :func:`~repro_torch.engine.backends.prune_sweep` call over the
      whole candidate sequence: on ``kernel`` one ``prune_walk`` launch
      (``prune_walk_scored`` under ``nearest_copy_dp``, its DP scores
      rebuilt from the words inside the walk), with ``fused`` or not; on
      ``torch`` with ``fused=False``, the plain per-candidate loop;
    * ``fused=True`` on ``torch``: the batched sweep.  Candidates whose
      objects never share a path are independent, so each independent
      group (at most ``group_max``, see :func:`_independent_groups`) is
      cleared, re-walked and selectively restored in one
      :func:`_prune_group_step`, decision for decision the serial sweep's;
    * on ``reference``, a re-walk per candidate.

    ``stage_s`` (a ``GreedyStats.stage_s`` dict) receives the batched
    sweep's host seconds as ``prune_plan`` (grouping) and ``prune_steps``,
    and the one-call sweep's (uploads, kernel, readback) as
    ``prune_walk``.  ``bytes_saved`` is summed in candidate order, except
    by the batched sweep, which sums group by group.
    """
    from repro_torch.core.slo import normalize_path_budgets  # local: no cycle
    from repro_torch.engine.incremental import PathIndex
    from repro_torch.engine.routing import resolve_policy

    device = resolve_device(device)
    pol = resolve_policy(policy)
    with obs.span("prune.engine"):
        engine = LatencyEngine(scheme, backend=backend, device=device)
    backend = engine.backend
    objects = np.asarray(pathset.objects, np.int32)
    lengths = np.asarray(pathset.lengths, np.int32)
    with obs.span("prune.precheck"):
        t_path = normalize_path_budgets(t, pathset).astype(np.int64)
        h0 = np.asarray(engine.path_latencies(pathset, policy=pol, load=load), np.int64)
        if pathset.n_paths == 0 or np.any(h0 > t_path):
            return 0, 0.0
    with obs.span("prune.index"):
        index = PathIndex(objects, scheme.n_objects)
    affected = index.paths_of
    packed = engine.packed
    rank = _backends._load_vector(load if pol.uses_load else None, packed.words)

    def subset_ok(idx: np.ndarray) -> bool:
        """h under the policy for the affected rows, vs their budgets (the
        ``reference`` walk)."""
        if not len(idx):
            return True
        from repro_torch.core.reference import routed_path_latencies_reference

        h = routed_path_latencies_reference(
            objects[idx], lengths[idx], scheme.mask, scheme.shard, policy=pol, load=load,
        )
        return bool(np.all(h <= t_path[idx]))

    with obs.span("prune.candidates"):
        fv = (
            np.ones(scheme.n_objects, np.float64)
            if f is None
            else np.asarray(f, np.float64)
        )
        repl = scheme.mask.copy()
        repl[np.arange(scheme.n_objects), scheme.shard] = False
        vs, ss = np.nonzero(repl)
        order = np.argsort(-fv[vs], kind="stable")
    n_dropped = 0
    bytes_saved = 0.0

    if fused and backend == "torch" and len(order):
        with obs.span("prune.plan", stage_s, "prune_plan"):
            groups = _independent_groups(order, vs, affected, pathset.n_paths, group_max)
        with obs.span("prune.steps", stage_s, "prune_steps"):
            for group in groups:
                gi = np.asarray(group)
                rows = [affected(int(v)) for v in vs[gi]]
                sizes = [len(r) for r in rows]
                ridx = np.concatenate(rows)
                bad = _prune_group_step(
                    packed.words,
                    to_device(vs[gi].astype(np.int32), device),
                    to_device(ss[gi].astype(np.int32), device),
                    to_device(objects[ridx], device), to_device(lengths[ridx], device),
                    to_device(t_path[ridx].astype(np.int32), device),
                    to_device(np.repeat(np.arange(len(gi), dtype=np.int32), sizes), device),
                    packed.shard, rank, pol, backend,
                )
                keep = ~to_host(bad)
                if keep.any():
                    gk = gi[keep]
                    n_dropped += int(keep.sum())
                    bytes_saved += float(fv[vs[gk]].sum())
                    scheme.mask[vs[gk], ss[gk]] = False
        return n_dropped, bytes_saved

    if backend != "reference" and len(order):
        with obs.span("prune.sweep", stage_s, "prune_walk"):
            keep = to_host(_backends.prune_sweep(
                packed.words,
                to_device(vs[order].astype(np.int32), device),
                to_device(ss[order].astype(np.int32), device),
                to_device(index.starts.astype(np.int32), device),
                to_device(index.rows, device),
                to_device(objects, device), to_device(lengths, device),
                # h <= L - 1, so capping a budget at the int32 range keeps every verdict
                to_device(np.minimum(t_path, np.iinfo(np.int32).max).astype(np.int32),
                          device),
                packed.shard, pol, rank, backend=backend,
            ))
        with obs.span("prune.apply"):
            kept = order[keep]
            scheme.mask[vs[kept], ss[kept]] = False
            if len(kept):
                # a running sum in candidate order (not numpy's pairwise sum):
                # the per-candidate sweep's float, bit for bit
                bytes_saved = float(np.add.accumulate(fv[vs[kept]])[-1])
        return len(kept), bytes_saved

    for i in order:
        v, s = int(vs[i]), int(ss[i])
        packed.set_bit(v, s, False)
        scheme.mask[v, s] = False
        if subset_ok(affected(v)):
            n_dropped += 1
            bytes_saved += float(fv[v])
        else:
            packed.set_bit(v, s, True)
            scheme.mask[v, s] = True
    return n_dropped, bytes_saved
