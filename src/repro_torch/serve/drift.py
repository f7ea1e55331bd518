"""Drifting workload generator: time-phased query mixes + hotspot shifts.

A static replication scheme is tuned for the workload it was built from;
the paper's feasibility guarantee says nothing once the query mix or the
root hotspot moves.  This module generates exactly that stress: a sequence
of *phases*, each a (PathSet, offered-rate, duration) triple, where the
hot region of the root distribution rotates between phases and the query
mix re-weights — and reports, per transition, the **PathSet delta** (paths
that appeared / disappeared), which is the unit the adaptive controller's
incremental greedy consumes.

Works over all three workload families (the same analyzers the greedy
driver uses):

  ``snb_drift``     — SNB short reads with a rotating hot person/post set
                      and a per-phase template-mix rotation
  ``gnn_drift``     — GNN sampling with a rotating hot seed-node region
  ``recsys_drift``  — embedding lookups with a rotating hot item block
                      (the GeoLayer-style "popular partition moved" case)

All generators are deterministic in ``seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from repro_torch.core.paths import PathSet
from repro_torch.workload.analyzer import batched, materialize


@dataclasses.dataclass(frozen=True)
class DriftPhase:
    """One phase of a drifting workload."""

    name: str
    pathset: PathSet
    rate_qps: float
    duration_s: float
    hot_roots: np.ndarray  # the phase's hot root set (diagnostics)


@dataclasses.dataclass(frozen=True)
class PhaseDelta:
    """A phase plus its path-level diff against the previous phase."""

    phase: int
    name: str
    pathset: PathSet        # the full phase workload
    added: PathSet          # paths present now but not in the previous phase
    n_removed: int          # paths of the previous phase that disappeared
    rate_qps: float
    duration_s: float


def _path_keys(ps: PathSet) -> np.ndarray:
    """Row key per path: (length, objects...) — padding is canonical (-1)."""
    return np.concatenate(
        [ps.lengths[:, None].astype(np.int64), ps.objects.astype(np.int64)],
        axis=1,
    )


def path_delta(prev: PathSet | None, cur: PathSet) -> tuple[PathSet, int]:
    """(added paths of ``cur``, count of ``prev`` paths that vanished).

    Paths are compared structurally (object sequence), not by query id —
    a re-arrival of an identical path is not workload drift.
    """
    if prev is None or prev.n_paths == 0:
        return cur, 0
    if cur.n_paths == 0:
        return cur, prev.n_paths
    L = max(prev.max_len, cur.max_len)
    pk = _path_keys(prev.pad_to(max_len=L))
    ck = _path_keys(cur.pad_to(max_len=L))
    prev_set = {row.tobytes() for row in pk}
    cur_rows = [row.tobytes() for row in ck]
    new_idx = np.asarray(
        [i for i, r in enumerate(cur_rows) if r not in prev_set], np.int64
    )
    n_removed = len(prev_set - set(cur_rows))
    added = cur.select(new_idx) if len(new_idx) else PathSet.from_lists([])
    return added, n_removed


def drift_stream(phases: list[DriftPhase]) -> Iterator[PhaseDelta]:
    """Yield each phase with its path delta against the previous one."""
    prev: PathSet | None = None
    for i, ph in enumerate(phases):
        added, n_removed = path_delta(prev, ph.pathset)
        yield PhaseDelta(
            phase=i,
            name=ph.name,
            pathset=ph.pathset,
            added=added,
            n_removed=n_removed,
            rate_qps=ph.rate_qps,
            duration_s=ph.duration_s,
        )
        prev = ph.pathset


def hotspot_phases(
    paths_fn_for_phase: Callable[[int, np.random.Generator], Callable[[int], list[list[int]]]],
    root_pool: np.ndarray,
    n_phases: int = 3,
    queries_per_phase: int = 500,
    hot_frac: float = 0.1,
    hot_prob: float = 0.8,
    rate_qps: float = 1e4,
    duration_s: float = 1.0,
    seed: int = 0,
    name: str = "phase",
) -> list[DriftPhase]:
    """Generic rotating-hotspot phase builder.

    The root pool is permuted once; phase ``k`` declares the ``k``-th
    contiguous slice (``hot_frac`` of the pool) *hot* and samples each
    query's root from it with probability ``hot_prob`` (uniform over the
    rest otherwise).  ``paths_fn_for_phase(k, rng)`` returns the
    root -> paths expander for phase ``k``, letting the query mix shift
    alongside the hotspot.
    """
    rng = np.random.default_rng(seed)
    pool = rng.permutation(np.asarray(root_pool))
    n_hot = max(1, int(len(pool) * hot_frac))
    phases: list[DriftPhase] = []
    for k in range(n_phases):
        prng = np.random.default_rng(seed * 7919 + k)
        lo = (k * n_hot) % len(pool)
        hot = np.take(pool, np.arange(lo, lo + n_hot), mode="wrap")
        pick_hot = prng.random(queries_per_phase) < hot_prob
        roots = np.where(
            pick_hot,
            prng.choice(hot, size=queries_per_phase),
            prng.choice(pool, size=queries_per_phase),
        )
        ps = materialize(
            batched(paths_fn_for_phase(k, prng), roots, queries_per_phase)
        )
        phases.append(
            DriftPhase(
                name=f"{name}{k}",
                pathset=ps,
                rate_qps=rate_qps,
                duration_s=duration_s,
                hot_roots=hot,
            )
        )
    return phases


# ---------------------------------------------------------------------------
# Family-specific drifts
# ---------------------------------------------------------------------------
def snb_drift(
    snb,
    n_phases: int = 3,
    queries_per_phase: int = 500,
    hot_frac: float = 0.1,
    hot_prob: float = 0.8,
    rate_qps: float = 1e4,
    duration_s: float = 1.0,
    seed: int = 0,
) -> list[DriftPhase]:
    """SNB short reads: rotating hot person set + rotating template mix."""
    from repro_torch.workload.snb import DEFAULT_MIX, snb_query_paths

    templates = sorted(DEFAULT_MIX)

    def for_phase(k: int, rng: np.random.Generator):
        # rotate the mix so each phase emphasizes a different template
        weights = np.asarray(
            [DEFAULT_MIX[t] for t in templates], np.float64
        )
        weights = np.roll(weights, k)
        weights /= weights.sum()

        def paths_fn(root: int) -> list[list[int]]:
            tmpl = templates[int(rng.choice(len(templates), p=weights))]
            if tmpl in ("IS2", "IS3"):
                # person-rooted templates need a person root; remap
                root = int(snb.persons[root % len(snb.persons)])
            else:
                root = int(snb.posts[root % len(snb.posts)])
            return snb_query_paths(snb, root, tmpl, rng)

        return paths_fn

    pool = np.arange(len(snb.persons) + len(snb.posts))
    return hotspot_phases(
        for_phase, pool, n_phases, queries_per_phase, hot_frac, hot_prob,
        rate_qps, duration_s, seed, name="snb",
    )


def gnn_drift(
    g,
    n_phases: int = 3,
    queries_per_phase: int = 300,
    fanouts: tuple[int, ...] = (5, 3),
    hot_frac: float = 0.05,
    hot_prob: float = 0.8,
    rate_qps: float = 1e4,
    duration_s: float = 1.0,
    seed: int = 0,
) -> list[DriftPhase]:
    """GNN sampling with a rotating hot seed-node region."""
    from repro_torch.workload.gnn import gnn_query_paths

    def for_phase(k: int, rng: np.random.Generator):
        def paths_fn(root: int) -> list[list[int]]:
            return gnn_query_paths(g, int(root), fanouts, rng)

        return paths_fn

    return hotspot_phases(
        for_phase, np.arange(g.n_nodes), n_phases, queries_per_phase,
        hot_frac, hot_prob, rate_qps, duration_s, seed, name="gnn",
    )


def recsys_drift(
    n_users: int,
    n_items: int,
    n_phases: int = 3,
    queries_per_phase: int = 400,
    behaviors_per_req: int = 6,
    candidates_per_req: int = 4,
    hot_frac: float = 0.05,
    hot_prob: float = 0.8,
    rate_qps: float = 1e4,
    duration_s: float = 1.0,
    seed: int = 0,
) -> list[DriftPhase]:
    """Embedding lookups with a rotating hot item block.

    Object-id layout matches ``repro_torch.workload.recsys``: rows
    ``[0, n_users)`` are users, ``[n_users, n_users + n_items)`` items.
    Each request is user -> behavior items -> candidate items; behavior and
    candidate items are drawn from the phase's hot item block with
    ``hot_prob``.
    """

    rng0 = np.random.default_rng(seed)
    item_perm = rng0.permutation(n_items)
    n_hot = max(1, int(n_items * hot_frac))

    def for_phase(k: int, rng: np.random.Generator):
        hot = np.take(
            item_perm, np.arange(k * n_hot, (k + 1) * n_hot), mode="wrap"
        )

        def draw_items(count):
            pick_hot = rng.random(count) < hot_prob
            uni = rng.integers(0, n_items, count)
            hot_pick = rng.choice(hot, size=count)
            return np.where(pick_hot, hot_pick, uni) + n_users

        def paths_fn(root: int) -> list[list[int]]:
            user = int(root) % n_users
            behaviors = draw_items(behaviors_per_req)
            cands = draw_items(candidates_per_req)
            return [
                [user, int(b), int(c)] for b in behaviors for c in cands[:1]
            ] + [[user, int(c)] for c in cands]

        return paths_fn

    return hotspot_phases(
        for_phase, np.arange(n_users), n_phases, queries_per_phase,
        hot_frac, hot_prob, rate_qps, duration_s, seed, name="recsys",
    )
