"""Hop-level span tracing for served queries (simulator + executor).

A *span* is one access of one query's routed walk: which hop, which
object, which server, local or remote, and — in the simulator, where time
is real — the split between FIFO **queue wait** and **service** time.
That split is the paper's whole subject made visible: a t_Q violation is
no longer an opaque p99 scalar but a named hop on a named server whose
queue ate the budget.

Sampling is ring-buffered and **tail-biased**: the first ``head``
completed queries are always kept (warm-up visibility), every query that
*violated its budget* is always kept (the tail is the point — a sampler
that can drop the 1-in-10000 violator is useless for tail debugging), and
the rest share a fixed-size ring of recent completions.  The hot path
appends one tuple per access and defers all object construction to
completion time, keeping tracing-enabled serving within the <2% overhead
bound ``benchmarks/serve_tail.py`` asserts.

Traces export as Chrome ``trace_event`` JSON (``chrome://tracing`` /
Perfetto): servers are rendered as process lanes, so a hotspot server's
pile-up is literally visible as a dense lane.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque

import numpy as np

__all__ = ["Span", "QueryTrace", "Tracer", "chrome_trace"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One access of one traced query (all times in microseconds)."""

    query: int
    hop: int                 # dispatch order within the query's walk
    obj: int                 # object accessed
    server: int              # server that served it (-1: no alive copy)
    local: bool              # local access vs distributed traversal
    t_enqueue_us: float      # when the access was dispatched/enqueued
    t_start_us: float        # when service began (== enqueue if no wait)
    t_end_us: float          # when service completed
    variant: int = 0         # routing variant (hedged runs race two)

    @property
    def queue_wait_us(self) -> float:
        return self.t_start_us - self.t_enqueue_us

    @property
    def service_us(self) -> float:
        return self.t_end_us - self.t_start_us

    @property
    def why(self) -> str:
        """Why the hop landed where it did (the policy pick, readably)."""
        if self.server < 0:
            return "no-alive-copy"
        return "local-copy" if self.local else "remote-hop"


@dataclasses.dataclass
class QueryTrace:
    """All spans of one completed query plus its verdict vs t_Q."""

    query: int
    tenant: int                  # -1 when the run was not tenant-tagged
    arrival_us: float
    completion_us: float
    budget_us: float | None      # the query's t_Q in wall-clock terms
    violated: bool               # latency > budget (always kept if True)
    failed: bool                 # hit an object with no alive copy
    policy: str
    # deadline-aware admission dropped the query before serving it: a shed
    # query is NOT a violation (it failed fast by design) — burn-rate
    # attribution reports the two separately
    shed: bool = False
    # raw access tuples (obj, server, local, t_enq, t_start, t_end, variant)
    # in dispatch order; Span objects are built lazily — the hot path never
    # allocates anything heavier than a tuple
    accesses: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def latency_us(self) -> float:
        return self.completion_us - self.arrival_us

    @property
    def spans(self) -> list[Span]:
        return [
            Span(self.query, hop, o, s, bool(lc), te, ts, td, v)
            for hop, (o, s, lc, te, ts, td, v) in enumerate(self.accesses)
        ]

    def worst_hop(self) -> Span | None:
        """The hop whose queue wait ate the most budget (ties: total time).

        This is the blame pointer the burn-rate attribution aggregates:
        for a violating query, the server named here is where the budget
        went.
        """
        spans = self.spans
        if not spans:
            return None
        return max(
            spans, key=lambda s: (s.queue_wait_us, s.t_end_us - s.t_enqueue_us)
        )


class Tracer:
    """Head + tail-biased span sampler threaded through a serving run.

    ``budget_us`` is the wall-clock t_Q: a scalar (every query shares a
    deadline), a per-query array, or None (no violation marking — only
    head/ring sampling applies).  ``head`` first completions and all
    violators are always kept; non-violators beyond that share a ring of
    ``ring`` recent traces (completion order).  One Tracer traces one run;
    pass a fresh one per ``simulate()``/``execute_workload()`` call or
    :meth:`clear` between runs.
    """

    def __init__(
        self,
        budget_us=None,
        head: int = 32,
        ring: int = 256,
        policy: str = "home_first",
    ):
        self.head = int(head)
        self.ring = int(ring)
        self.policy = policy
        self.budget_us = budget_us
        self._staging: dict[int, list] = {}
        self._head: list[QueryTrace] = []
        self._ring: deque = deque(maxlen=self.ring)
        self._violations: list[QueryTrace] = []
        self._n_completed = 0
        self._n_violations = 0
        self._n_spans = 0
        self._n_shed = 0
        self._shed_counts: dict[int, int] = {}  # tenant -> shed queries
        # deferred simulator run (begin_run/end_run): a flat raw-span list
        # plus the run's verdict arrays, folded in lazily by _materialize
        self._run_staging: list | None = None
        self._run: tuple | None = None
        self._run_n_queries = 0

    # -- hot path ----------------------------------------------------------
    def record(self, q, obj, server, local, t_enq, t_start, t_end, variant=0):
        """Append one access tuple (called once per served access)."""
        acc = self._staging.get(q)
        if acc is None:
            acc = self._staging[q] = []
        acc.append((obj, server, local, t_enq, t_start, t_end, variant))
        self._n_spans += 1

    def begin_run(self, n_queries: int) -> list:
        """Hand the simulator its zero-overhead staging structure.

        Returns one flat list; the simulator binds its ``append`` as a
        local and the service path appends ``job, t_start, t_end`` as
        three consecutive elements — where ``job = (q, variant, node,
        server, base_us, obj, t_dispatch)`` is the tuple it already
        holds — so recording a span allocates *nothing* (every appended
        object already exists; no wrapper tuple means no garbage for the
        collector to chase mid-run).  Everything heavier (grouping by
        query, decoding, verdicts, sampling) happens lazily in
        :meth:`_materialize`, outside the simulated run's wall clock.
        """
        if self._run_staging is not None:
            self._materialize()
        self._run_n_queries = int(n_queries)
        self._run_staging = []
        return self._run_staging

    def end_run(
        self, arrivals_us, completion_us, tenant_of, failed, local_us,
        shed=None,
    ) -> None:
        """Close a simulator run: store the verdict arrays, defer the rest.

        ``shed`` (bool [n_queries] or None) marks queries dropped by
        deadline-aware admission: their traces carry ``shed=True`` and
        are exempt from the violation verdict (fail-fast is the policy
        working, not the SLO burning).
        """
        self._run = (
            np.asarray(arrivals_us, np.float64),
            np.asarray(completion_us, np.float64),
            tenant_of,
            np.asarray(failed, bool),
            float(local_us),
            np.asarray(shed, bool) if shed is not None else None,
        )

    def _materialize(self) -> None:
        """Fold a deferred simulator run into the sampled trace stores."""
        staging, run = self._run_staging, self._run
        if staging is None:
            return
        self._run_staging = self._run = None
        if run is None:  # begin_run without end_run: simulate() crashed
            return
        arrivals, completion, tenant_of, failed, local_us, shed = run
        per_q: list[list] = [[] for _ in range(self._run_n_queries)]
        # the flat stream is stride-3 (job, t_start, t_end): group by query
        for k in range(0, len(staging), 3):
            job = staging[k]
            per_q[job[0]].append((job, staging[k + 1], staging[k + 2]))
        # completion order, the order a live collector would see
        for q in np.argsort(completion, kind="stable"):
            q = int(q)
            for job, ts, te in per_q[q]:
                # decode the simulator's raw job tuple into the canonical
                # access layout (obj, server, local, enq, start, end, var)
                self.record(
                    q, job[5], job[3], job[4] == local_us,
                    job[6], ts, te, job[1],
                )
            self.finalize(
                q,
                float(arrivals[q]),
                float(completion[q]),
                int(tenant_of[q]) if tenant_of is not None else -1,
                bool(failed[q]),
                shed=bool(shed[q]) if shed is not None else False,
            )

    def budget_of(self, q: int) -> float | None:
        b = self.budget_us
        if b is None:
            return None
        if np.ndim(b) == 0:
            return float(b)
        return float(b[q])

    def finalize(
        self,
        q: int,
        arrival_us: float,
        completion_us: float,
        tenant: int = -1,
        failed: bool = False,
        shed: bool = False,
    ) -> QueryTrace:
        """Close query ``q``'s trace and apply the sampling policy."""
        budget = self.budget_of(q)
        latency = completion_us - arrival_us
        # a shed query was never served: it cannot violate (fail-fast is
        # the admission policy working), it is accounted separately
        violated = not shed and budget is not None and latency > budget
        tr = QueryTrace(
            query=q,
            tenant=int(tenant),
            arrival_us=float(arrival_us),
            completion_us=float(completion_us),
            budget_us=budget,
            violated=violated,
            failed=bool(failed),
            policy=self.policy,
            shed=bool(shed),
            accesses=self._staging.pop(q, []),
        )
        self._n_completed += 1
        if shed:
            self._n_shed += 1
            t = int(tenant)
            self._shed_counts[t] = self._shed_counts.get(t, 0) + 1
        if violated:
            # tail bias: a violating query's trace is NEVER dropped
            self._n_violations += 1
            self._violations.append(tr)
        elif len(self._head) < self.head:
            self._head.append(tr)
        else:
            self._ring.append(tr)
        return tr

    # -- results -----------------------------------------------------------
    @property
    def violations(self) -> list[QueryTrace]:
        """Every violator's trace (tail bias: never sampled away)."""
        self._materialize()
        return self._violations

    @property
    def n_completed(self) -> int:
        self._materialize()
        return self._n_completed

    @property
    def n_violations(self) -> int:
        self._materialize()
        return self._n_violations

    @property
    def n_spans(self) -> int:
        self._materialize()
        return self._n_spans

    @property
    def n_shed(self) -> int:
        self._materialize()
        return self._n_shed

    @property
    def shed_counts(self) -> dict[int, int]:
        """Exact shed-query count per tenant id (-1: untagged run)."""
        self._materialize()
        return dict(self._shed_counts)

    @property
    def traces(self) -> list[QueryTrace]:
        """Every kept trace (head + ring + all violators)."""
        self._materialize()
        return self._head + list(self._ring) + self._violations

    def trace_of(self, q: int) -> QueryTrace | None:
        for tr in self.traces:
            if tr.query == q:
                return tr
        return None

    def worst(self, n: int = 1) -> list[QueryTrace]:
        """Kept traces sorted by latency, slowest first."""
        return sorted(self.traces, key=lambda t: -t.latency_us)[:n]

    def clear(self) -> None:
        self._staging.clear()
        self._head.clear()
        self._ring.clear()
        self._violations.clear()
        self._run_staging = self._run = None
        self._n_completed = self._n_violations = self._n_spans = 0
        self._n_shed = 0
        self._shed_counts.clear()

    def chrome_trace(self, path: str | None = None) -> dict:
        return chrome_trace(self.traces, path)


def chrome_trace(traces, path: str | None = None) -> dict:
    """Chrome ``trace_event`` JSON for a set of :class:`QueryTrace`.

    Servers map to processes (lanes), queries to threads within the lane
    that served them; each access emits a complete ("X") service slice,
    preceded by a queue-wait slice when the access waited.  Load the file
    in ``chrome://tracing`` or https://ui.perfetto.dev.
    """
    events: list[dict] = []
    servers_seen: set[int] = set()
    for tr in traces:
        for s in tr.spans:
            pid = int(s.server)
            servers_seen.add(pid)
            args = {
                "query": tr.query,
                "tenant": tr.tenant,
                "hop": s.hop,
                "object": s.obj,
                "why": s.why,
                "policy": tr.policy,
                "violated": tr.violated,
            }
            if s.queue_wait_us > 0:
                events.append({
                    "name": f"queue v{s.obj}",
                    "cat": "queue",
                    "ph": "X",
                    "ts": s.t_enqueue_us,
                    "dur": s.queue_wait_us,
                    "pid": pid,
                    "tid": tr.query,
                    "args": args,
                })
            events.append({
                "name": f"hop{s.hop} v{s.obj}",
                "cat": "local" if s.local else "remote",
                "ph": "X",
                "ts": s.t_start_us,
                "dur": s.service_us,
                "pid": pid,
                "tid": tr.query,
                "args": args,
            })
    for pid in sorted(servers_seen):
        events.append({
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {
                "name": f"server-{pid}" if pid >= 0 else "no-alive-copy"
            },
        })
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as fh:
            json.dump(out, fh)
    return out
