"""Incremental dirty-set latency evaluation: index, cache, compacted re-walks.

Under every shipped routing policy h(p, r, rho) depends only on rho
restricted to the objects *on p*: ``home_first`` reads the replica rows
of the path's own objects, ``nearest_copy`` / ``queue_aware`` pick
holders of the path's objects, and the ``nearest_copy_dp`` suffix scores
are functions of the path-suffix objects' holder sets.  So the exact set
of paths whose latency a scheme delta can change is the union of an
object->path inverted index's rows over the changed objects; everything
else is a cache hit.

Three pieces, owned per :class:`~repro_torch.engine.engine.LatencyEngine`:

  :class:`PathIndex`        CSR object->path inverted index of one
                            PathSet (the greedy's revalidation rounds and
                            the prune sweep read it too).
  :class:`IncrementalEval`  the persistent per-path latency cache.  One
                            entry per PathSet (weakref-guarded), holding
                            the index, the path block pinned on the device
                            (uploaded once, padded to a
                            :func:`~repro_torch.engine.sharding.round_up_rows`
                            quantum) and one cached h-vector per (policy,
                            load-fingerprint) slot.  Scheme mutations
                            (``add_replicas`` / ``remove_replicas`` /
                            ``note_changed`` / ``refresh(objects=)``)
                            invalidate by exact dirty set; ``refresh()``
                            drops everything.
  the gather-compact step   dirty rows are shipped as one small padded
                            int32 index vector (booked under
                            ``TRANSFER.gathered_bytes``), the ``[D, L]``
                            block is gathered on the device from the pinned
                            paths (:func:`gather_rows`), walked by the same
                            compute the engine's full evaluation runs (on
                            ``kernel``: ``path_latency``, ``routed_walk``,
                            or ``scored_walk`` under ``nearest_copy_dp``),
                            and scattered back into the cached vector.

Bit-identity is structural: each path is an independent lane of those
walks, so a gathered subset runs the exact integer ops of the full
evaluation on its lanes.  The ``reference`` backend re-walks the dirty
rows with the host oracle instead and pins nothing.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from repro_torch import obs
from repro_torch.engine import backends
from repro_torch.engine.routing import resolve_policy
from repro_torch.engine.sharding import round_up_rows
from repro_torch.engine.streaming import TRANSFER, to_device, to_host

# row quantum of the pinned and gathered blocks (the JAX package's
# default path block)
ROW_QUANTUM = 128


class PathIndex:
    """CSR object->path inverted index of a padded path matrix.

    ``rows[starts[v] : starts[v + 1]]`` are the path rows containing
    object ``v`` (with multiplicity when a path visits ``v`` twice).
    Built once per PathSet in O(nnz log nnz); both the prune sweep's
    per-candidate ``affected`` lookups and the cache's dirty-set unions
    read it.
    """

    def __init__(self, objects: np.ndarray, n_objects: int):
        objects = np.asarray(objects)
        self.n_objects = int(n_objects)
        self.n_paths = int(objects.shape[0])
        valid = objects >= 0
        flat_v = objects[valid].astype(np.int64)
        flat_p = np.repeat(
            np.arange(self.n_paths), objects.shape[1]
        )[valid.ravel()]
        order = np.argsort(flat_v, kind="stable")
        self.rows = flat_p[order].astype(np.int32)
        self.starts = np.searchsorted(
            flat_v[order], np.arange(self.n_objects + 1)
        )

    @classmethod
    def from_pathset(cls, pathset, n_objects: int) -> "PathIndex":
        return cls(np.asarray(pathset.objects), n_objects)

    def paths_of(self, v: int) -> np.ndarray:
        """Unique path rows containing object ``v`` (sorted)."""
        return np.unique(self.rows[self.starts[v] : self.starts[v + 1]])

    def dirty_paths(self, changed_objects) -> np.ndarray:
        """Unique path rows touching ANY changed object (sorted int64).

        The exact dirty set of a scheme delta: a path absent from every
        changed object's row slice reads none of the flipped replica
        bits, so its walk — under any shipped policy — is unchanged.
        Object ids outside ``[0, n_objects)`` are ignored (the engines'
        negative-pair masking).
        """
        v = np.unique(np.asarray(changed_objects, np.int64).ravel())
        v = v[(v >= 0) & (v < self.n_objects)]
        if v.size == 0:
            return np.zeros(0, np.int64)
        cnt = self.starts[v + 1] - self.starts[v]
        total = int(cnt.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        # multi-slice gather: absolute position of each slice element
        base = np.repeat(
            self.starts[v] - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt
        )
        return np.unique(self.rows[base + np.arange(total)]).astype(np.int64)


def gather_rows(objects: torch.Tensor, lengths: torch.Tensor, idx: torch.Tensor):
    """Compact the dirty block on the device: ``[P, L]`` x ``[Db]`` -> ``[Db, L]``.

    ``idx`` is the padded dirty-row index vector (-1 pad lanes); pad lanes
    come out as empty paths (objects -1, length 0), which every walk
    scores as h = 0 and the scatter-back discards.
    """
    ok = idx >= 0
    safe = idx.clamp_min(0).long()
    o = torch.where(ok[:, None], objects[safe], -1).to(torch.int32)
    ln = torch.where(ok, lengths[safe], 0).to(torch.int32)
    return o, ln


@dataclasses.dataclass
class _Slot:
    """One cached h-vector: a (policy, load-fingerprint) evaluation."""

    h: np.ndarray       # int32 [P] per-path latencies
    dirty: np.ndarray   # bool [P]; True = stale since last evaluation


class _PathSetCache:
    """Index + pinned device block + value slots for one PathSet."""

    def __init__(self, pathset, n_objects: int, device, pin: bool):
        self.ref = weakref.ref(pathset)
        self.n_paths = pathset.n_paths
        self.index = PathIndex.from_pathset(pathset, n_objects)
        self.slots: dict[tuple, _Slot] = {}
        self.objects_host = np.asarray(pathset.objects, np.int32)
        self.lengths_host = np.asarray(pathset.lengths, np.int32)
        self.dev_objects = None
        self.dev_lengths = None
        if pin:
            # pinned once, padded with empty paths to the row quantum
            P, L = self.objects_host.shape
            Pb = round_up_rows(P, ROW_QUANTUM, device)
            o = np.full((Pb, L), -1, np.int32)
            o[:P] = self.objects_host
            ln = np.zeros(Pb, np.int32)
            ln[:P] = self.lengths_host
            self.dev_objects = to_device(o, device, payload_bytes=self.objects_host.nbytes)
            self.dev_lengths = to_device(ln, device, payload_bytes=self.lengths_host.nbytes)


class IncrementalEval:
    """The persistent latency cache of one :class:`LatencyEngine`.

    Entries are keyed by PathSet identity (weakref-checked, so a freed
    entry cannot alias a recycled id) and invalidated by exact dirty set
    on every scheme mutation the engine observes.  Evaluation returns a
    defensive copy of the cached vector.
    """

    def __init__(self, engine):
        self.engine = engine
        self.caches: dict[int, _PathSetCache] = {}

    # -- invalidation ------------------------------------------------------
    def invalidate_objects(self, objects) -> None:
        """Mark paths touching any of ``objects`` dirty in every entry."""
        changed = np.unique(np.asarray(objects, np.int64).ravel())
        changed = changed[changed >= 0]
        if changed.size == 0:
            return
        dead = []
        for key, cache in self.caches.items():
            if cache.ref() is None:
                dead.append(key)
                continue
            rows = cache.index.dirty_paths(changed)
            if len(rows):
                for slot in cache.slots.values():
                    slot.dirty[rows] = True
        for key in dead:
            self.caches.pop(key, None)

    def invalidate_all(self) -> None:
        self.caches.clear()

    # -- evaluation --------------------------------------------------------
    def _cache_of(self, pathset) -> _PathSetCache:
        key = id(pathset)
        cache = self.caches.get(key)
        if cache is not None and cache.ref() is not pathset:
            # the id was recycled by a dead PathSet: this entry is not ours
            self.caches.pop(key)
            cache = None
        if cache is None:
            eng = self.engine
            cache = _PathSetCache(pathset, eng.packed.n_objects, eng.device,
                                  pin=eng.backend != "reference")
            self.caches[key] = cache
        return cache

    @staticmethod
    def _slot_key(pol, load) -> tuple:
        # queue_aware latencies are a function of the load vector too: a
        # different load profile is a different cached value
        fp = None
        if pol.uses_load and load is not None:
            fp = np.asarray(load, np.float32).tobytes()
        return (pol, fp)

    def _eval_rows_host(self, cache, rows, pol, load) -> np.ndarray:
        """Reference-backend subset re-walk (host oracle, no device)."""
        eng = self.engine
        return np.asarray(backends.reference_eval(
            cache.objects_host[rows], cache.lengths_host[rows], eng.host_mask(),
            eng.host_shard(), pol, load,
        ), np.int32)

    def _full_eval(self, cache, pol, load) -> np.ndarray:
        if self.engine.backend == "reference":
            return self._eval_rows_host(cache, np.arange(cache.n_paths), pol, load)
        out = self.engine._make_compute(pol, load)(cache.dev_objects, cache.dev_lengths)
        return to_host(out)[: cache.n_paths].astype(np.int32)

    def _rewalk_rows(self, cache, rows, pol, load) -> np.ndarray:
        """Gather-compacted re-walk of ``rows`` against the live scheme."""
        eng = self.engine
        if eng.backend == "reference":
            return self._eval_rows_host(cache, rows, pol, load)
        D = len(rows)
        idx = np.full(round_up_rows(D, ROW_QUANTUM, eng.device), -1, np.int32)
        idx[:D] = rows
        # the only host->device traffic of the re-walk: the compacted index
        # vector (the [D, L] block is gathered from the pinned paths)
        payload = D * 4
        idx_d = to_device(idx, eng.device, payload_bytes=payload)
        TRANSFER.gathered_bytes += payload
        o, ln = gather_rows(cache.dev_objects, cache.dev_lengths, idx_d)
        out = eng._make_compute(pol, load)(o, ln)
        return to_host(out)[:D].astype(np.int32)

    def path_latencies(self, pathset, policy=None, load=None) -> np.ndarray:
        pol = resolve_policy(policy)
        if pathset.n_paths == 0:
            return np.zeros((0,), np.int32)
        cache = self._cache_of(pathset)
        key = self._slot_key(pol, load)
        slot = cache.slots.get(key)
        if slot is None:
            h = self._full_eval(cache, pol, load)
            cache.slots[key] = _Slot(h=h, dirty=np.zeros(cache.n_paths, bool))
            if obs.enabled():
                obs.REGISTRY.counter("repro.engine.inc_cache_misses").inc()
            return h.copy()
        rows = np.nonzero(slot.dirty)[0]
        if obs.enabled():
            obs.REGISTRY.gauge("repro.engine.inc_dirty_fraction").set(
                len(rows) / cache.n_paths
            )
            if len(rows):
                obs.REGISTRY.counter("repro.engine.inc_dirty_rewalks").inc()
                obs.REGISTRY.counter("repro.engine.inc_dirty_rows").inc(len(rows))
            else:
                obs.REGISTRY.counter("repro.engine.inc_cache_hits").inc()
        if len(rows):
            slot.h[rows] = self._rewalk_rows(cache, rows, pol, load)
            slot.dirty[rows] = False
        return slot.h.copy()
