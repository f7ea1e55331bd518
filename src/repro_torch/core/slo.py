"""Per-query / per-tenant latency constraints t_Q (paper Def 4.4).

The paper's feasibility definition is *per query*: a replication scheme is
feasible when every query Q finishes within **its own** latency constraint
t_Q.  The implementation historically collapsed that vector to one scalar
``t``; :class:`SLOSpec` restores the general form — a per-query budget
vector plus a query->tenant map — with scalar broadcast as the degenerate
case (``SLOSpec.uniform(t, nq)`` behaves bit-identically to ``t``).

A *tenant* is a query family sharing one SLO (a workload analyzer, a
product surface, a customer): the serve layer monitors feasibility and
wall-clock p99 per tenant and arbitrates between tenants when their
repairs compete for the same capacity headroom.

This module depends only on numpy so every layer (core, engine, serve,
workload) can import it without cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's serving contract.

    Attributes:
      name: stable tenant identifier (query family / customer).
      t_q: default latency budget in distributed traversals (Def 4.4).
      p99_slo_us: optional wall-clock p99 SLO for the serve-layer monitor.
      weight: priority weight for the controller's capacity arbitration —
        a triggered tenant's repair is ranked by *weighted*
        bytes-per-violation (estimated bytes / weight), so a weight-10
        tenant wins a contended round against an equal-cost weight-1
        tenant.  Arbitration aging still outranks any weight (a deferred
        tenant wins the next contended round), so low-weight tenants
        cannot starve.  Must be > 0.
    """

    name: str
    t_q: int
    p99_slo_us: float | None = None
    weight: float = 1.0

    def __post_init__(self):
        if not self.weight > 0:
            raise ValueError("tenant weight must be > 0")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Vector latency constraints: per-query budgets + query->tenant map.

    Attributes:
      t_q: int32 [n_queries] — latency budget per query (traversals).
      tenant_of: int32 [n_queries] — index into ``tenants`` per query.
      tenants: the tenant table (index = tenant id).
    """

    t_q: np.ndarray
    tenant_of: np.ndarray
    tenants: tuple[TenantSpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "t_q", np.asarray(self.t_q, np.int32))
        object.__setattr__(
            self, "tenant_of", np.asarray(self.tenant_of, np.int32)
        )
        assert self.t_q.ndim == 1
        assert self.tenant_of.shape == self.t_q.shape
        assert np.all(self.t_q >= 0), "latency budgets must be >= 0"
        if len(self.t_q):
            assert int(self.tenant_of.max()) < len(self.tenants)

    # -- constructors ------------------------------------------------------
    @classmethod
    def uniform(
        cls,
        t: int,
        n_queries: int,
        tenant: str = "default",
        p99_slo_us: float | None = None,
    ) -> "SLOSpec":
        """Scalar broadcast: every query gets budget ``t`` (degenerate case)."""
        return cls(
            t_q=np.full(n_queries, int(t), np.int32),
            tenant_of=np.zeros(n_queries, np.int32),
            tenants=(TenantSpec(tenant, int(t), p99_slo_us),),
        )

    @classmethod
    def from_tenants(
        cls, tenants: Sequence[TenantSpec], tenant_of: np.ndarray
    ) -> "SLOSpec":
        """Budgets from each query's tenant default (``tenant_of`` ids)."""
        tenant_of = np.asarray(tenant_of, np.int32)
        defaults = np.asarray([ts.t_q for ts in tenants], np.int32)
        return cls(
            t_q=defaults[tenant_of],
            tenant_of=tenant_of,
            tenants=tuple(tenants),
        )

    @staticmethod
    def concat(specs: Iterable["SLOSpec"]) -> "SLOSpec":
        """Concatenate specs in query order (mirrors PathSet.concatenate).

        Tenant tables are merged by name (first occurrence wins) so two
        sections of the same tenant share one id.
        """
        specs = list(specs)
        table: list[TenantSpec] = []
        index: dict[str, int] = {}
        t_q, tenant_of = [], []
        for sp in specs:
            remap = np.zeros(max(len(sp.tenants), 1), np.int32)
            for i, ts in enumerate(sp.tenants):
                if ts.name not in index:
                    index[ts.name] = len(table)
                    table.append(ts)
                remap[i] = index[ts.name]
            t_q.append(sp.t_q)
            tenant_of.append(remap[sp.tenant_of])
        return SLOSpec(
            t_q=np.concatenate(t_q) if t_q else np.zeros(0, np.int32),
            tenant_of=(
                np.concatenate(tenant_of)
                if tenant_of
                else np.zeros(0, np.int32)
            ),
            tenants=tuple(table),
        )

    # -- views -------------------------------------------------------------
    @property
    def n_queries(self) -> int:
        return int(self.t_q.shape[0])

    @property
    def is_uniform(self) -> bool:
        """True when every query shares one budget (the scalar case)."""
        return len(self.t_q) == 0 or bool(
            np.all(self.t_q == self.t_q[0])
        )

    def scalar(self) -> int:
        """The single budget of a uniform spec (errors otherwise)."""
        if not self.is_uniform:
            raise ValueError("SLOSpec is not uniform; no scalar t exists")
        return int(self.t_q[0]) if len(self.t_q) else 0

    def max_t(self) -> int:
        return int(self.t_q.max()) if len(self.t_q) else 0

    def path_budgets(self, pathset) -> np.ndarray:
        """Per-path budgets: each path inherits its owning query's t_Q."""
        qids = np.asarray(pathset.query_ids)
        assert self.n_queries >= (int(qids.max()) + 1 if len(qids) else 0), (
            "SLOSpec covers fewer queries than the pathset references"
        )
        return self.t_q[qids]

    def select_queries(self, lo: int, hi: int) -> "SLOSpec":
        """Spec slice for queries [lo, hi) (PathSet.select_queries twin).

        NOTE the twin is not exact when trailing queries of the range have
        zero paths: ``PathSet.select_queries`` reports ``max(qid) + 1``
        queries while this slice keeps ``hi - lo`` budgets.  Re-align with
        :meth:`align_to` before pairing the two (``PathSet.concatenate``
        offsets by the *pathset's* count, so a misaligned pair would shift
        every later section's budgets).
        """
        return SLOSpec(self.t_q[lo:hi], self.tenant_of[lo:hi], self.tenants)

    def align_to(self, pathset) -> "SLOSpec":
        """Truncate to ``pathset.n_queries`` (drops trailing budgets of
        queries that contributed no paths; errors if the spec is short)."""
        nq = pathset.n_queries
        if self.n_queries < nq:
            raise ValueError(
                f"SLOSpec covers {self.n_queries} queries, pathset has {nq}"
            )
        if self.n_queries == nq:
            return self
        return SLOSpec(self.t_q[:nq], self.tenant_of[:nq], self.tenants)

    def tenant_id(self, name: str) -> int:
        for i, ts in enumerate(self.tenants):
            if ts.name == name:
                return i
        raise KeyError(name)

    def tenant_queries(self, name: str) -> np.ndarray:
        """Query ids belonging to ``name``."""
        return np.nonzero(self.tenant_of == self.tenant_id(name))[0]


def normalize_query_budgets(t, n_queries: int) -> np.ndarray:
    """int | per-query array | SLOSpec -> int32 [n_queries] budget vector."""
    if isinstance(t, SLOSpec):
        assert t.n_queries == n_queries, (
            f"SLOSpec covers {t.n_queries} queries, workload has {n_queries}"
        )
        return t.t_q
    arr = np.asarray(t)
    if arr.ndim == 0:
        return np.full(n_queries, int(arr), np.int32)
    assert arr.shape == (n_queries,), (
        f"budget vector shape {arr.shape} != ({n_queries},)"
    )
    return arr.astype(np.int32)


def normalize_path_budgets(t, pathset) -> np.ndarray:
    """int | per-query array | SLOSpec -> int32 [n_paths] per-path budgets."""
    if isinstance(t, SLOSpec):
        return t.path_budgets(pathset)
    arr = np.asarray(t)
    if arr.ndim == 0:
        return np.full(pathset.n_paths, int(arr), np.int32)
    qids = np.asarray(pathset.query_ids)
    assert arr.shape == (pathset.n_queries,), (
        f"budget vector shape {arr.shape} != ({pathset.n_queries},)"
    )
    return arr.astype(np.int32)[qids]
