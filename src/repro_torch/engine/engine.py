"""LatencyEngine: one backend-dispatched evaluation core for h(p, r, rho).

  engine = LatencyEngine(scheme)              # device "cuda", backend "kernel"
  h  = engine.path_latencies(pathset)         # int32 [n_paths]
  lq = engine.query_latencies(pathset, h)     # int32 [n_queries]
  ok = engine.is_feasible(pathset, t, path_lats=h)
  dc = engine.margin_costs(cand_objs, cand_srvs, f)   # vs device snapshot
  engine.add_replicas(objs, srvs)             # on-device scatter-OR
  h  = engine.path_latencies(pathset, incremental=True)  # dirty rows only
  hr = engine.resilient_path_latencies(pathset, 1)       # [loss cases, P]

State model: the scheme lives on the device as a
:class:`~repro_torch.engine.packed.PackedScheme` — one packed upload at
construction, in-place updates afterwards; chunked evaluation streams only
the int32 path chunks.  ``device`` defaults to ``"cuda"`` (a machine
without a card raises unless ``device="cpu"``), and ``backend`` defaults
from the device (``kernel`` on CUDA, ``torch`` on the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.engine import backends
from repro_torch.engine.packed import PackedScheme
from repro_torch.engine.routing import resolve_policy
from repro_torch.engine.streaming import resolve_device, stream_chunks, to_device, to_host

DEFAULT_CHUNK = 8192


@dataclasses.dataclass
class RawScheme:
    """Lightweight mask + shard scheme (the engine's minimal input contract)."""

    mask: np.ndarray
    shard: np.ndarray

    def __post_init__(self):
        self.mask = np.asarray(self.mask, bool)
        self.shard = np.asarray(self.shard, np.int32)
        if self.mask.ndim != 2 or self.shard.shape != (self.mask.shape[0],):
            raise ValueError("RawScheme needs mask [n, S] and shard [n]")


def _budget_vector(t, n_queries: int) -> np.ndarray:
    """int | per-query array | SLOSpec (duck-typed ``.t_q``) -> int32 [nq]."""
    t = getattr(t, "t_q", t)
    return np.broadcast_to(np.asarray(t, np.int32), (n_queries,))


class DevicePaths:
    """A PathSet pinned to the device (uploaded once, reused per call)."""

    def __init__(self, pathset, device):
        self.n_paths = pathset.n_paths
        self.n_queries = pathset.n_queries
        self.query_ids = np.asarray(pathset.query_ids)
        self.objects = to_device(np.asarray(pathset.objects, np.int32), device)
        self.lengths = to_device(np.asarray(pathset.lengths, np.int32), device)


class LatencyEngine:
    """Backend-dispatched latency evaluation over a replication scheme.

    Args:
      scheme: anything with ``.mask`` (bool [n, S]) and ``.shard`` (int
        [n]) — typically ``repro_torch.core.ReplicationScheme`` — or None
        when ``packed`` is given directly.
      backend: "reference" | "torch" | "kernel" | None (from the device).
      chunk: paths per evaluation chunk (streaming granularity).
      device: "cuda" (default) or "cpu"; ignored when ``packed`` is given
        (the packed words fix the device).
    """

    def __init__(
        self,
        scheme=None,
        *,
        packed: PackedScheme | None = None,
        backend: str | None = None,
        chunk: int = DEFAULT_CHUNK,
        device=None,
    ):
        if scheme is None and packed is None:
            raise ValueError("need a scheme or a PackedScheme")
        self.device = packed.device if packed is not None else resolve_device(device)
        self.backend = backends.resolve_backend(backend, self.device)
        self.chunk = int(chunk)
        self.scheme = scheme
        self.packed = packed
        if self.packed is None:
            self.packed = PackedScheme.from_mask(scheme.mask, scheme.shard, self.device)
        # lazy incremental dirty-set evaluation plane (engine.incremental)
        self._inc = None

    # -- classmethods -----------------------------------------------------
    @classmethod
    def from_arrays(cls, mask: np.ndarray, shard: np.ndarray, **kw) -> "LatencyEngine":
        return cls(RawScheme(mask, shard), **kw)

    # -- state ------------------------------------------------------------
    @property
    def n_servers(self) -> int:
        return self.packed.n_servers

    def host_mask(self) -> np.ndarray:
        """Current bool mask on the host (one readback of the words)."""
        return self.packed.unpack()

    def host_shard(self) -> np.ndarray:
        return to_host(self.packed.shard)

    @property
    def incremental(self):
        """The engine's :class:`~repro_torch.engine.incremental.IncrementalEval`.

        Created on first use; scheme mutations routed through this engine
        (:meth:`add_replicas` / :meth:`remove_replicas` /
        :meth:`note_changed` / :meth:`refresh`) keep it exact.
        """
        if self._inc is None:
            from repro_torch.engine.incremental import IncrementalEval  # lazy

            self._inc = IncrementalEval(self)
        return self._inc

    def note_changed(self, objects) -> None:
        """Invalidate cached incremental latencies of paths touching
        ``objects``.

        :meth:`add_replicas` / :meth:`remove_replicas` call this; callers
        that mutate ``packed.words`` directly (the greedy's UPDATE) must
        call it with the objects they touched — a superset is safe, a
        miss is not.
        """
        if self._inc is not None:
            self._inc.invalidate_objects(objects)

    def refresh(self, objects=None) -> None:
        """Re-pack after the host scheme's mask was mutated directly.

        ``objects`` — when the caller knows the exact set of objects whose
        replica rows changed (a §5.4 drain's dirty set) — invalidates only
        the cached latencies of paths touching them, keeping the rest of
        the incremental cache warm; without it every cached vector is
        dropped (the safe call for layout changes like scale-out).
        """
        if self.scheme is not None:
            self.packed = PackedScheme.from_mask(
                self.scheme.mask, self.scheme.shard, self.device
            )
        if self._inc is not None:
            if objects is None:
                self._inc.invalidate_all()
            else:
                self._inc.invalidate_objects(objects)

    @staticmethod
    def _valid_pairs(objects, servers):
        obj = np.asarray(objects)
        srv = np.asarray(servers)
        ok = (obj >= 0) & (srv >= 0)
        return obj[ok], srv[ok]

    def add_replicas(self, objects, servers) -> None:
        """Monotone additions, applied on the device (and to the host
        scheme).  Pairs with a negative object or server are ignored."""
        obj, srv = self._valid_pairs(objects, servers)
        if obj.size == 0:
            return
        self.packed.add(obj, srv)
        if self.scheme is not None:
            self.scheme.mask[obj, srv] = True
        self.note_changed(obj)

    def remove_replicas(self, objects, servers) -> None:
        """Drop replicas on the device (and in the host scheme).  Removals
        are not monotone: the caller owns the feasibility re-check."""
        obj, srv = self._valid_pairs(objects, servers)
        if obj.size == 0:
            return
        self.packed.remove(obj, srv)
        if self.scheme is not None:
            self.scheme.mask[obj, srv] = False
        self.note_changed(obj)

    def prepare(self, pathset) -> DevicePaths:
        """Pin a PathSet on the device for repeated evaluation (one upload)."""
        return DevicePaths(pathset, self.device)

    def to_scheme(self):
        from repro_torch.core.replication import ReplicationScheme  # lazy: no cycle

        return ReplicationScheme(self.host_mask(), self.host_shard())

    # -- evaluation -------------------------------------------------------
    def path_latencies(
        self,
        pathset,
        chunk: int | None = None,
        policy=None,
        load: np.ndarray | None = None,
        incremental: bool = False,
    ) -> np.ndarray:
        """h(p, r, rho) per path: #distributed traversals (Def 4.2).

        ``policy`` (str | ``RoutingPolicy``; default ``home_first``)
        scores the walk under a hop-routing policy; ``load`` ranks holders
        for ``queue_aware``.

        ``incremental=True`` routes through the engine's persistent
        per-path latency cache (:attr:`incremental`): the first call for a
        PathSet evaluates fully, later calls re-walk only the paths whose
        latency a scheme delta since then could have changed.  Equal to
        ``incremental=False`` bit for bit as long as every scheme mutation
        is routed through the engine (or reported via
        :meth:`note_changed`).  A :class:`DevicePaths` is always evaluated
        in full.
        """
        pol = resolve_policy(policy)
        if pathset.n_paths == 0:
            return np.zeros((0,), dtype=np.int32)
        if incremental and not isinstance(pathset, DevicePaths):
            return self.incremental.path_latencies(pathset, policy=pol, load=load)
        if self.backend == "reference":
            pinned = isinstance(pathset, DevicePaths)
            objects = to_host(pathset.objects) if pinned else np.asarray(pathset.objects)
            lengths = to_host(pathset.lengths) if pinned else np.asarray(pathset.lengths)
            return backends.reference_eval(
                objects, lengths, self.host_mask(), self.host_shard(), pol, load
            )
        compute = self._make_compute(pol, load)
        if isinstance(pathset, DevicePaths):
            out = compute(pathset.objects, pathset.lengths)
            return to_host(out)[: pathset.n_paths].astype(np.int32)
        n = pathset.n_paths
        outs = stream_chunks(
            [np.asarray(pathset.objects, np.int32), np.asarray(pathset.lengths, np.int32)],
            n,
            int(chunk or self.chunk),
            compute,
            pad_values=[-1, 0],
            device=self.device,
        )
        return to_host(torch.cat(outs))[:n].astype(np.int32)

    def _make_compute(self, pol, load):
        """Chunk-compute closure for the engine's backend and a policy."""
        words, shard = self.packed.words, self.packed.shard
        if pol.name == "home_first":
            fn = backends.kernel_eval if self.backend == "kernel" else backends.words_scan

            def compute(objects, lengths):
                return fn(objects, lengths, words, shard)

            return compute
        rank = backends._load_vector(load if pol.uses_load else None, words)

        def compute(objects, lengths):
            return backends.gate_counts(
                objects, lengths, words, shard, pol, rank, backend=self.backend
            )

        return compute

    def access_trace(
        self,
        pathset,
        start: np.ndarray | None = None,
        policy=None,
        load: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Policy-routed access walk against the engine's scheme.

        ``start`` optionally overrides the per-path start server.  Returns
        host arrays (servers int32 [P, L], local bool [P, L]).
        """
        pol = resolve_policy(policy)
        pinned = isinstance(pathset, DevicePaths)
        if self.backend == "reference":
            from repro_torch.core.reference import routed_trace_reference  # lazy

            return routed_trace_reference(
                to_host(pathset.objects) if pinned else np.asarray(pathset.objects, np.int32),
                to_host(pathset.lengths) if pinned else np.asarray(pathset.lengths, np.int32),
                self.host_mask(), self.host_shard(),
                start=start, policy=pol, load=load,
            )
        obj_d = pathset.objects if pinned else to_device(
            np.asarray(pathset.objects, np.int32), self.device)
        len_d = pathset.lengths if pinned else to_device(
            np.asarray(pathset.lengths, np.int32), self.device)
        start_d = None
        if start is not None:
            start_d = to_device(np.asarray(start, np.int32), self.device)
        servers, local = backends.access_trace(
            obj_d, len_d, self.packed.words, self.packed.shard,
            start=start_d, policy=pol, load=load, backend=self.backend,
        )
        return to_host(servers), to_host(local)

    def query_latencies(self, pathset, path_lats: np.ndarray | None = None) -> np.ndarray:
        """l_Q = max over the query's paths (Def 4.3)."""
        if path_lats is None:
            path_lats = self.path_latencies(pathset)
        out = np.zeros((pathset.n_queries,), dtype=np.int32)
        np.maximum.at(out, np.asarray(pathset.query_ids), path_lats)
        return out

    def query_slack(
        self,
        pathset,
        t,
        path_lats: np.ndarray | None = None,
        policy=None,
        load: np.ndarray | None = None,
        incremental: bool = False,
    ) -> np.ndarray:
        """t_Q - l_Q per query, computed on the device (int32 [n_queries]).

        ``t`` is an int, a per-query budget vector, or an ``SLOSpec``.
        Negative entries mark violating queries.  ``incremental=True``
        sources the path latencies from the dirty-set cache.
        """
        if path_lats is None:
            path_lats = self.path_latencies(
                pathset, policy=policy, load=load, incremental=incremental
            )
        nq = pathset.n_queries
        t_q = _budget_vector(t, nq)
        if nq == 0:
            return np.zeros((0,), np.int32)
        out = backends.query_slack(
            to_device(np.asarray(path_lats, np.int32), self.device),
            to_device(np.asarray(pathset.query_ids, np.int32), self.device),
            to_device(np.asarray(t_q, np.int32), self.device),
        )
        return to_host(out)

    def is_feasible(
        self,
        pathset,
        t,
        path_lats: np.ndarray | None = None,
        policy=None,
        load: np.ndarray | None = None,
        incremental: bool = False,
    ) -> bool:
        """All queries within their own t_Q (Def 4.4); ``incremental=True``
        sources the path latencies from the dirty-set cache."""
        return bool(np.all(
            self.query_slack(pathset, t, path_lats, policy, load, incremental=incremental) >= 0
        ))

    def resilient_path_latencies(
        self,
        pathset,
        resilience,
        policy=None,
        load: np.ndarray | None = None,
    ) -> np.ndarray:
        """h per (loss case, path) under ``resilience``: int32 [D, P].

        Row d is the policy walk with loss case d's servers down — their
        holder bits cleared from the packed words and every lost home
        remapped by rotation failover (``repro_torch.engine.resilience``).
        A path is k-resilient iff every row keeps it within budget.  The
        ``torch`` backend walks all D cases in one batched evaluation,
        ``kernel`` launches the walk once per case over the masked words,
        ``reference`` loops the host oracle.
        """
        from repro_torch.engine.resilience import (  # lazy: no cycle
            failover_shard,
            resolve_resilience,
        )

        res = resolve_resilience(resilience)
        if res is None:
            raise ValueError("resilient_path_latencies needs a resilience spec")
        S = self.n_servers
        cases = res.loss_cases(S)
        if pathset.n_paths == 0:
            return np.zeros((len(cases), 0), np.int32)
        homes = [failover_shard(self.host_shard(), c, S) for c in cases]
        return backends.case_latencies(
            self.packed, pathset.objects, pathset.lengths, cases, homes,
            policy=policy, load=load, backend=self.backend,
        )

    def is_resilient_feasible(
        self,
        pathset,
        t,
        resilience,
        policy=None,
        load: np.ndarray | None = None,
    ) -> bool:
        """Every query within its t_Q under EVERY loss case (Def 4.4 + k):
        the per-query latency is maxed over the query's paths and over all
        loss cases of ``resilience`` before the budget comparison."""
        h = self.resilient_path_latencies(pathset, resilience, policy=policy, load=load)
        if h.shape[1] == 0:
            return True
        t_q = _budget_vector(t, pathset.n_queries)
        lq = np.zeros(pathset.n_queries, np.int32)
        np.maximum.at(lq, np.asarray(pathset.query_ids), h.max(axis=0))
        return bool(np.all(lq <= t_q))

    def margin_costs(
        self, objects, servers, f: np.ndarray | None = None
    ) -> np.ndarray:
        """Marginal storage cost of candidate additions vs the snapshot.

        ``objects``/``servers`` are int arrays of identical shape
        ``[..., K]``; negative entries are ignored.  Returns float32
        ``[...]`` — the sum of ``f[v]`` over pairs not already replicated.
        """
        n = self.packed.n_objects
        fv = np.ones((n,), np.float32) if f is None else np.asarray(f, np.float32)
        out = backends.margin_cost(
            self.packed.words,
            to_device(fv, self.device),
            to_device(np.asarray(objects, np.int32), self.device),
            to_device(np.asarray(servers, np.int32), self.device),
        )
        return to_host(out)
