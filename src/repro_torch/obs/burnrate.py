"""SLO burn-rate attribution: fold spans into per-tenant blame tables.

SRE-style burn rate: a tenant with a violation-fraction SLO of
``allowed_frac`` burns its error budget at rate
``observed_frac / allowed_frac`` — burn 1.0 exactly exhausts the budget
over the window, burn 10 exhausts it 10x faster.  The number alone says
*that* a tenant is burning; the attribution below says *where*: for every
violating query the traced walk names the hop whose **queue wait** ate
the budget, and those blame pointers aggregate into a per-server table —
the per-tenant "which server do I fix" answer the adaptive controller
surfaces in its :class:`~repro_torch.serve.controller.AdaptationReport`.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HopBlame", "TenantBurn", "BurnReport", "attribute_burn"]


@dataclasses.dataclass(frozen=True)
class HopBlame:
    """The hop of one violating query that consumed the largest share."""

    query: int
    hop: int
    obj: int
    server: int
    queue_wait_us: float
    service_us: float
    share: float          # (queue+service) of this hop / query latency
    latency_us: float
    budget_us: float | None


@dataclasses.dataclass
class TenantBurn:
    """One tenant's violation budget burn + per-server blame decomposition."""

    tenant: str
    n_queries: int = 0
    n_violations: int = 0
    # queries dropped by deadline-aware admission: shed != violated — a
    # shed query failed fast by policy and never burned queue time
    n_shed: int = 0
    allowed_frac: float = 0.01
    # per-server microseconds of queue wait inside violating queries —
    # the decomposition of where the burned budget actually went
    blame_queue_us: dict = dataclasses.field(default_factory=dict)
    blame_service_us: dict = dataclasses.field(default_factory=dict)
    # how often each server's hop was THE largest consumer of a
    # violating query's budget (the argmax pointer, per query)
    blamed_counts: dict = dataclasses.field(default_factory=dict)
    worst_hops: list = dataclasses.field(default_factory=list)

    @property
    def violation_frac(self) -> float:
        return self.n_violations / self.n_queries if self.n_queries else 0.0

    @property
    def shed_frac(self) -> float:
        return self.n_shed / self.n_queries if self.n_queries else 0.0

    @property
    def burn_rate(self) -> float:
        """Error-budget burn: observed violation frac / allowed frac."""
        return self.violation_frac / self.allowed_frac

    def top_server(self) -> int | None:
        """The server most often blamed for this tenant's violations."""
        if not self.blamed_counts:
            return None
        return max(
            self.blamed_counts,
            key=lambda s: (self.blamed_counts[s], self.blame_queue_us.get(s, 0.0)),
        )

    def summary(self) -> dict:
        top = self.top_server()
        return {
            "n_queries": self.n_queries,
            "n_violations": self.n_violations,
            "n_shed": self.n_shed,
            "shed_frac": self.shed_frac,
            "violation_frac": self.violation_frac,
            "burn_rate": self.burn_rate,
            "top_server": top,
            "top_server_blamed": (
                self.blamed_counts.get(top, 0) if top is not None else 0
            ),
            "blame_queue_us": {
                int(k): float(v) for k, v in sorted(self.blame_queue_us.items())
            },
        }


@dataclasses.dataclass
class BurnReport:
    """Per-tenant burn + blame over one traced serving window."""

    tenants: dict

    def __getitem__(self, name: str) -> TenantBurn:
        return self.tenants[name]

    def summary(self) -> dict:
        return {name: tb.summary() for name, tb in self.tenants.items()}


def attribute_burn(
    tracer,
    tenant_names: tuple = (),
    allowed_frac: float = 0.01,
    worst_per_tenant: int = 8,
) -> BurnReport:
    """Fold a :class:`~repro_torch.obs.trace.Tracer`'s kept traces into blame.

    ``tenant_names`` maps the traces' integer tenant tags to names (an
    ``SLOSpec.tenants`` order); untagged queries (tenant -1, single-tenant
    runs) fold under ``"default"``.  Violation counts use the tracer's
    *complete* completion/violation totals — tail-biased sampling keeps
    every violator, so the blame decomposition is exact over the window
    even though non-violating traces are sampled.  Note the per-tenant
    ``n_queries`` denominators are exact only when every query was
    tenant-tagged or there is a single tenant; the blame tables (built
    from the always-kept violators) are exact regardless.
    """
    names = {i: str(n) for i, n in enumerate(tenant_names)}
    tenants: dict[str, TenantBurn] = {}

    def tb_of(tid: int) -> TenantBurn:
        name = names.get(tid, "default")
        tb = tenants.get(name)
        if tb is None:
            tb = tenants[name] = TenantBurn(
                tenant=name, allowed_frac=allowed_frac
            )
        return tb

    # denominators: count every kept completion per tenant; with a single
    # tenant the tracer's exact totals override below
    for tr in tracer.traces:
        tb_of(tr.tenant).n_queries += 1
    if len(tenants) <= 1 and tracer.n_completed:
        for tb in tenants.values():
            tb.n_queries = tracer.n_completed

    # shed counts are exact (the tracer counts every finalize, sampled or
    # not) — shed is reported NEXT TO violations, never folded into them
    for tid, n in tracer.shed_counts.items():
        tb_of(tid).n_shed += n

    for tr in tracer.violations:
        tb = tb_of(tr.tenant)
        tb.n_violations += 1
        worst = tr.worst_hop()
        latency = tr.latency_us
        for s in tr.spans:
            tb.blame_queue_us[s.server] = (
                tb.blame_queue_us.get(s.server, 0.0) + s.queue_wait_us
            )
            tb.blame_service_us[s.server] = (
                tb.blame_service_us.get(s.server, 0.0) + s.service_us
            )
        if worst is not None:
            tb.blamed_counts[worst.server] = (
                tb.blamed_counts.get(worst.server, 0) + 1
            )
            hb = HopBlame(
                query=tr.query,
                hop=worst.hop,
                obj=worst.obj,
                server=worst.server,
                queue_wait_us=worst.queue_wait_us,
                service_us=worst.service_us,
                share=(
                    (worst.t_end_us - worst.t_enqueue_us) / latency
                    if latency > 0
                    else 0.0
                ),
                latency_us=latency,
                budget_us=tr.budget_us,
            )
            tb.worst_hops.append(hb)
    for tb in tenants.values():
        tb.worst_hops.sort(key=lambda h: -h.queue_wait_us)
        del tb.worst_hops[worst_per_tenant:]
    return BurnReport(tenants=tenants)
