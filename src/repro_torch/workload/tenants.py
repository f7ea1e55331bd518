"""Tenant registry: each workload family is one serving tenant.

The analyzers (``snb``/``gnn``/``recsys``) each declare a
:class:`~repro_torch.core.slo.TenantSpec` with a distinct default latency budget
t_Q; this module stitches per-family workloads into one multi-tenant
workload — a concatenated :class:`~repro_torch.core.paths.PathSet` plus the
aligned :class:`~repro_torch.core.slo.SLOSpec` the greedy drivers and the engine's
feasibility path consume.
"""
from __future__ import annotations

from typing import Mapping, Sequence

from repro_torch.core.paths import PathSet
from repro_torch.core.slo import SLOSpec, TenantSpec
from repro_torch.workload import gnn, recsys, snb

FAMILY_TENANTS: dict[str, TenantSpec] = {
    "snb": snb.TENANT,
    "gnn": gnn.TENANT,
    "recsys": recsys.TENANT,
}


def tenant_spec(
    family: str,
    t_q: int | None = None,
    p99_slo_us: float | None = None,
) -> TenantSpec:
    """The family's declared tenant, optionally re-budgeted."""
    base = FAMILY_TENANTS[family]
    return TenantSpec(
        base.name,
        base.t_q if t_q is None else int(t_q),
        base.p99_slo_us if p99_slo_us is None else p99_slo_us,
    )


def multi_tenant_workload(
    parts: Sequence[tuple[str, PathSet]],
    budgets: Mapping[str, int] | None = None,
) -> tuple[PathSet, SLOSpec]:
    """Concatenate per-family workloads into (PathSet, aligned SLOSpec).

    ``parts`` is a sequence of (family, pathset); every query of a part is
    tagged with that family's tenant and gets the tenant's default t_Q
    (overridable per family via ``budgets``).  Query-id offsets of the
    returned spec match ``PathSet.concatenate``'s.
    """
    budgets = budgets or {}
    sections = []
    for family, ps in parts:
        ts = tenant_spec(family, budgets.get(family))
        sections.append(SLOSpec.uniform(ts.t_q, ps.n_queries, ts.name,
                                        ts.p99_slo_us))
    return (
        PathSet.concatenate([ps for _, ps in parts]),
        SLOSpec.concat(sections),
    )
