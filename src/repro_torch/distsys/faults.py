"""Fault injection + elastic-event driver (paper §5.4 scenario source).

Generates reproducible sequences of cluster events — server failures,
recoveries, scale-out/scale-in — and applies them to a Cluster while
invoking the §5.4 incremental replication update so the latency bound is
re-established after each event.  Used by tests, the elastic launcher, and
the reshard-cost benchmark.

Two event vocabularies live here:

* **step-indexed** :class:`Event` schedules (``event_schedule`` /
  ``apply_event`` / ``run_schedule``) drive the reshard machinery — a
  failure permanently drains the server and re-homes its partition;
* **microsecond-indexed** :class:`ChaosEvent` schedules
  (``chaos_schedule``) drive the serving simulator's mid-drift
  kill/revive injection (the serving simulator's ``chaos=``), where a
  killed server keeps its data and comes back.

Both samplers track liveness while sampling, so a schedule never asks to
kill a dead server or revive a live one.  :func:`violation_windows`
post-processes a simulated timeline into the contiguous SLO-violation
intervals a chaos run is scored on.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.core.replication import ReplicationScheme
from repro_torch.core.reshard import ReshardingMap, apply_reshard, drain_server
from repro_torch.distsys.cluster import Cluster, ServerState


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str          # "fail" | "recover" | "scale_out" | "scale_in"
    server: int
    at_step: int


def event_schedule(
    n_servers: int,
    n_events: int,
    horizon: int,
    seed: int = 0,
    kinds: tuple[str, ...] = ("fail", "recover"),
) -> list[Event]:
    """Sample a reproducible, *state-consistent* event sequence.

    Liveness is tracked while sampling: ``fail`` only targets a live
    server (and never the last one), ``recover`` only a dead one,
    ``scale_out`` always joins the next fresh index.  When the sampled
    kind has no valid target the other fail/recover kind stands in; when
    neither has one the slot is dropped — so every emitted event is
    applicable, and ``apply_event`` never has to skip a scheduled event.
    (May therefore return fewer than ``n_events`` events.)
    """
    rng = np.random.default_rng(seed)
    alive = np.ones(n_servers, bool)
    steps = sorted(int(rng.integers(1, horizon)) for _ in range(n_events))
    events: list[Event] = []
    for step in steps:
        kind = str(rng.choice(list(kinds)))
        n_alive = int(alive.sum())
        if kind in ("fail", "scale_in") and n_alive <= 1:
            kind = "recover" if "recover" in kinds and (~alive).any() else None
        elif kind == "recover" and not (~alive).any():
            kind = "fail" if "fail" in kinds and n_alive > 1 else None
        if kind is None:
            continue
        if kind in ("fail", "scale_in"):
            server = int(rng.choice(np.nonzero(alive)[0]))
            alive[server] = False
        elif kind == "recover":
            server = int(rng.choice(np.nonzero(~alive)[0]))
            alive[server] = True
        else:  # scale_out: the next fresh server index joins
            server = len(alive)
            alive = np.append(alive, True)
        events.append(Event(kind=kind, server=server, at_step=step))
    return events


def _drain_dirty_objects(
    scheme: ReplicationScheme, rmap: ReshardingMap, server: int
) -> np.ndarray:
    """Objects whose replica rows a drain of ``server`` will touch.

    The drain clears every holder bit at the server, moves its partition,
    and transfers each moved original's RM-associated replicas — the
    union of all three is the exact dirty set an incremental latency
    cache must drop (computed *before* the drain mutates the scheme).
    """
    dirty = set(np.nonzero(scheme.mask[:, server])[0].tolist())
    for u in np.nonzero(scheme.shard == server)[0]:
        dirty.add(int(u))
        dirty.update(int(v) for v in rmap.rm.get(int(u), ()))
    return np.fromiter(dirty, np.int64) if dirty else np.zeros(0, np.int64)


def apply_event(
    cluster: Cluster,
    rmap: ReshardingMap,
    event: Event,
    f: np.ndarray | None = None,
    engine=None,
) -> dict:
    """Apply one event; §5.4 incremental update restores feasibility.

    ``engine`` (a :class:`~repro_torch.engine.LatencyEngine` holding
    ``cluster.scheme``) is resynced after every scheme mutation: the
    device-resident packed words are re-packed and the incremental
    latency cache drops exactly the dirty objects the event touched
    (everything, for a scale-out's layout change).  Without it a
    resident engine would keep evaluating the pre-event words.

    An inapplicable event is reported, not silently swallowed: the
    returned dict carries ``{"skipped": True, "reason": ...}``.
    """
    scheme = cluster.scheme
    if event.kind == "fail":
        if sum(s.alive for s in cluster.servers) <= 1:
            return {
                "skipped": True,
                "reason": "last alive server cannot fail",
                "server": event.server,
            }
        if not cluster.servers[event.server].alive:
            return {
                "skipped": True,
                "reason": "server already dead",
                "server": event.server,
            }
        dirty = _drain_dirty_objects(scheme, rmap, event.server)
        cluster.fail_server(event.server)
        moves, rep = drain_server(scheme, rmap, event.server, f)
        if engine is not None:
            engine.refresh(objects=dirty)
        return {
            "moved": rep.moved_originals,
            "moves": moves,
            "dirty_objects": int(len(dirty)),
            "transferred": rep.replicas_transferred,
            "deleted": rep.replicas_deleted,
            "bytes": rep.bytes_transferred,
        }
    if event.kind == "recover":
        if cluster.servers[event.server].alive:
            return {
                "skipped": True,
                "reason": "server already alive",
                "server": event.server,
            }
        cluster.recover_server(event.server)
        return {"recovered": event.server}
    if event.kind == "scale_in":
        return apply_event(
            cluster, rmap, Event("fail", event.server, event.at_step), f,
            engine=engine,
        )
    if event.kind == "scale_out":
        # new server joins empty; rebalancing is a planned reshard:
        # move a 1/S' slice of originals to it.
        S_new = event.server
        if S_new >= scheme.n_servers:
            grow = S_new + 1 - scheme.n_servers
            scheme.mask = np.pad(scheme.mask, ((0, 0), (0, grow)))
            for s in range(scheme.n_servers - grow, scheme.n_servers):
                cluster.servers.append(ServerState(s))
        victims = np.nonzero(scheme.shard != S_new)[0]
        take = victims[:: max(scheme.n_servers, 1)]
        moves = {int(u): S_new for u in take}
        rep = apply_reshard(scheme, rmap, moves, f)
        if engine is not None:
            # the server axis itself changed: the packed [n, W] word
            # layout is re-derived and every cached latency dropped
            engine.refresh()
        return {
            "moved": rep.moved_originals,
            "transferred": rep.replicas_transferred,
            "bytes": rep.bytes_transferred,
        }
    raise ValueError(event.kind)


def run_schedule(
    cluster: Cluster,
    rmap: ReshardingMap,
    events: list[Event],
    f: np.ndarray | None = None,
    engine=None,
) -> Iterator[tuple[Event, dict]]:
    for ev in events:
        yield ev, apply_event(cluster, rmap, ev, f, engine=engine)


# -- chaos schedules for the serving simulator ---------------------------


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """A liveness flip injected into a running simulation.

    Unlike :class:`Event`'s ``fail`` (permanent loss, data drained), a
    ``kill`` models a crash/partition: the server's replicas stay on disk
    and serve again the moment a ``revive`` lands.
    """

    at_us: float
    kind: str          # "kill" | "revive"
    server: int


def chaos_schedule(
    n_servers: int,
    n_events: int,
    horizon_us: float,
    seed: int = 0,
    min_alive: int = 1,
) -> list[ChaosEvent]:
    """Sample a state-consistent kill/revive timeline for ``simulate``.

    Kills only target live servers and never push the live count below
    ``min_alive``; revives only target dead ones.  Event times are
    uniform over ``(0, horizon_us)``, sorted.  Slots with no applicable
    event (everything alive and at the kill floor) are dropped.
    """
    rng = np.random.default_rng(seed)
    alive = np.ones(n_servers, bool)
    times = np.sort(rng.uniform(0.0, horizon_us, n_events))
    events: list[ChaosEvent] = []
    for at in times:
        can_kill = int(alive.sum()) > min_alive
        can_revive = bool((~alive).any())
        if not can_kill and not can_revive:
            continue
        if can_kill and (not can_revive or rng.random() < 0.5):
            server = int(rng.choice(np.nonzero(alive)[0]))
            alive[server] = False
            events.append(ChaosEvent(float(at), "kill", server))
        else:
            server = int(rng.choice(np.nonzero(~alive)[0]))
            alive[server] = True
            events.append(ChaosEvent(float(at), "revive", server))
    return events


def violation_windows(
    finish_us: np.ndarray,
    violated: np.ndarray,
    bin_us: float = 1000.0,
) -> list[tuple[float, float]]:
    """Contiguous SLO-violation windows of a simulated timeline.

    Bins query completions on ``bin_us`` boundaries; a bin violates if
    any query finishing in it missed its SLO, and adjacent violating
    bins merge into one ``(start_us, end_us)`` window.  The summed
    window length is the headline a chaos run is scored on — a reactive
    controller shortens it, a static scheme rides the whole outage.
    """
    finish_us = np.asarray(finish_us, np.float64)
    violated = np.asarray(violated, bool)
    if finish_us.size == 0 or not violated.any():
        return []
    bins = np.floor(finish_us / bin_us).astype(np.int64)
    bad = np.unique(bins[violated])
    windows: list[tuple[float, float]] = []
    start = prev = bad[0]
    for b in bad[1:]:
        if b == prev + 1:
            prev = b
            continue
        windows.append((float(start * bin_us), float((prev + 1) * bin_us)))
        start = prev = b
    windows.append((float(start * bin_us), float((prev + 1) * bin_us)))
    return windows


def time_to_repair(
    windows: list[tuple[float, float]], kill_us: float
) -> float:
    """Time from a kill to the end of the violation window it opened.

    0.0 when the kill never produced a violating window (the scheme rode
    through it — what a k-resilient scheme is supposed to do).
    """
    for lo, hi in windows:
        if hi > kill_us:
            return max(0.0, hi - kill_us)
    return 0.0
