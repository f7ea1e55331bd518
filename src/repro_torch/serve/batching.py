"""Batched-dispatch serving policies: ladders, admission, SLO hedging.

The simulator (and the asyncio harness behind the same interface) prices
every access dispatch individually; a real serving plane does not.  This
module holds the three policy objects the batched dispatch plane is
configured with — all plain data, consumed by ``simulate()`` /
``harness_simulate()``:

* :class:`BatchLadder` + :class:`BatchingConfig` — queries targeting the
  same server within a collection window coalesce into **one** engine
  dispatch.  The ladder quantizes the batch size to a fixed rung (default
  1/2/4/8/16, a bounded set of dispatch shapes) picked from the
  instantaneous pending depth, so dispatch overhead (``dispatch_us``) is
  paid once per batch instead of once per access and the device sees a
  bounded set of batch shapes;
* :class:`AdmissionConfig` — deadline-aware admission/shedding.  At
  enqueue time the remaining slack is the query's wall-clock deadline
  (derived from its ``SLOSpec`` budget t_Q) minus the elapsed queue wait;
  a query whose *floor* latency under the active routing policy (the
  jitter-free critical path of its precomputed access tree) can no longer
  meet the deadline is shed — fail fast instead of poisoning the FIFO for
  the queries behind it;
* :class:`HedgePolicy` — SLO-driven request hedging.  Instead of racing
  primary+backup unconditionally at arrival (the simulator's ``hedged``
  router mode), the policy fires the backup dispatch only when the
  query's elapsed time crosses a per-tenant latency quantile *learned
  online* from completions (a ``repro_torch.obs`` log-bucketed
  :class:`~repro_torch.obs.metrics.Histogram` per tenant), with
  cancellation-on-first-completion accounting — the tail-latency
  playbook's "defer hedging to the p95 mark" at ~5% extra load.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs.metrics import Histogram

__all__ = [
    "AdmissionConfig",
    "BatchLadder",
    "BatchStats",
    "BatchingConfig",
    "HedgePolicy",
    "derive_deadlines",
]


@dataclasses.dataclass(frozen=True)
class BatchLadder:
    """Quantized batch sizes: the rung picked from instantaneous depth.

    ``pick(depth)`` returns the largest rung <= ``max(depth, 1)`` — a
    lone straggler ships as a batch of 1 (never waits for peers that are
    not coming), a deep backlog ships at the top rung.  Rungs must be
    positive, strictly increasing, and start at 1 so every depth has a
    feasible rung.
    """

    rungs: tuple[int, ...] = (1, 2, 4, 8, 16)

    def __post_init__(self):
        if not self.rungs or self.rungs[0] != 1:
            raise ValueError("ladder must start at rung 1 (stragglers)")
        if any(b <= a for a, b in zip(self.rungs, self.rungs[1:])):
            raise ValueError("ladder rungs must be strictly increasing")

    @property
    def max_rung(self) -> int:
        return self.rungs[-1]

    def pick(self, depth: int) -> int:
        """Largest rung not exceeding the pending depth (min rung 1)."""
        depth = max(int(depth), 1)
        best = self.rungs[0]
        for r in self.rungs:
            if r > depth:
                break
            best = r
        return best


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """Per-server batch collection: window + size ladder.

    ``window_us`` is how long the first pending access of a server waits
    for peers before the batch flushes (one dispatch).  A flush takes the
    ladder rung for the pending depth; leftovers flush immediately after
    (same timestamp, next rung) so a deep backlog drains in ladder-sized
    chunks rather than re-arming the window.
    """

    window_us: float = 50.0
    ladder: BatchLadder = dataclasses.field(default_factory=BatchLadder)

    def __post_init__(self):
        if self.window_us < 0:
            raise ValueError("window_us must be >= 0")


@dataclasses.dataclass
class BatchStats:
    """Occupancy accounting of one batched run (SimReport.batch_stats)."""

    n_batches: int = 0
    batched_jobs: int = 0     # accesses served through a batch dispatch
    max_occupancy: int = 0

    def observe(self, occupancy: int) -> None:
        self.n_batches += 1
        self.batched_jobs += occupancy
        if occupancy > self.max_occupancy:
            self.max_occupancy = occupancy

    @property
    def mean_occupancy(self) -> float:
        return self.batched_jobs / self.n_batches if self.n_batches else 0.0

    def summary(self) -> dict:
        return {
            "n_batches": self.n_batches,
            "batched_jobs": self.batched_jobs,
            "mean_occupancy": self.mean_occupancy,
            "max_occupancy": self.max_occupancy,
        }


def derive_deadlines(slo, model, pathset) -> np.ndarray:
    """Wall-clock deadline per query from its SLOSpec traversal budget.

    Def 4.4's budget t_Q counts *distributed traversals*; its wall-clock
    reading under the latency model is the cost of the longest path walked
    with exactly t_Q remote hops and the rest local:

        deadline_q = coordinator_us + local_us * max_path_len_q
                     + remote_us * t_q

    A query whose scheme keeps it within budget has a jitter-free floor
    at or below this number, so at zero load nothing is shed; a
    zero-budget query (t_q = 0) must complete fully local to be admitted.
    """
    nq = pathset.n_queries
    maxlen = np.zeros(nq, np.int64)
    np.maximum.at(
        maxlen, np.asarray(pathset.query_ids), np.asarray(pathset.lengths)
    )
    t_q = np.asarray(slo.t_q, np.float64)
    return (
        model.coordinator_us
        + model.local_us * maxlen.astype(np.float64)
        + model.remote_us * t_q
    )


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Deadline-aware admission control (fail-fast shedding).

    ``deadline_us`` — explicit wall-clock deadline(s): a scalar applied
    to every query, or a per-query array.  ``None`` derives deadlines
    from the run's ``SLOSpec`` via :func:`derive_deadlines` (requires
    ``slo=``).  ``stretch`` scales the derived/explicit deadlines
    (stretch 2.0 = "shed only when twice the budget is gone") — the knob
    that trades shed fraction against surviving-query tail.

    Shedding points: (a) at arrival, when the access tree's jitter-free
    floor already exceeds the deadline (a zero-budget query with any
    remote hop sheds here); (b) at every hop dispatch and FIFO pop, when
    elapsed sojourn + the remaining subtree floor + the coordinator
    barrier can no longer meet it.  A shed query completes degraded at
    the shed instant, dispatches nothing further, and its already-queued
    work is skipped when popped — the point of shedding is that doomed
    work stops consuming capacity.
    """

    deadline_us: float | np.ndarray | None = None
    stretch: float = 1.0

    def __post_init__(self):
        if self.stretch <= 0:
            raise ValueError("stretch must be > 0")

    def deadlines(self, slo, model, pathset) -> np.ndarray:
        """Resolved per-query wall-clock deadlines [n_queries]."""
        nq = pathset.n_queries
        if self.deadline_us is not None:
            d = np.asarray(self.deadline_us, np.float64)
            d = np.full(nq, float(d), np.float64) if d.ndim == 0 else d
            if d.shape != (nq,):
                raise ValueError(
                    f"deadline_us shape {d.shape} != ({nq},)"
                )
        else:
            if slo is None:
                raise ValueError(
                    "AdmissionConfig without explicit deadline_us needs "
                    "slo= to derive deadlines from t_Q budgets"
                )
            d = derive_deadlines(slo, model, pathset)
        return d * self.stretch


class HedgePolicy:
    """Fire a backup dispatch when elapsed time crosses a learned quantile.

    Per tenant, completions feed a log-bucketed streaming histogram; once
    ``min_samples`` completions are in, ``threshold_us(tenant)`` returns
    the ``quantile``-th percentile and arrivals schedule a hedge timer at
    ``arrival + threshold``.  A query that completes before its timer
    never hedges (that is the point: only the tail pays the hedge), and a
    fired hedge is cancelled the instant either attempt completes.

    The learned thresholds adapt within a run: early completions warm the
    histograms, so a load shift moves the hedge point without restarts.
    ``max_hedges_frac`` caps the fraction of queries allowed to hedge
    (capacity guard: hedging at p95 costs ~5% extra load by construction,
    but a threshold learned on a calm phase can over-fire on a hot one).
    """

    def __init__(
        self,
        quantile: float = 95.0,
        min_samples: int = 64,
        max_hedges_frac: float = 0.25,
        growth: float = 1.05,
    ):
        if not 0.0 < quantile < 100.0:
            raise ValueError("quantile must be in (0, 100)")
        if min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        self.quantile = float(quantile)
        self.min_samples = int(min_samples)
        self.max_hedges_frac = float(max_hedges_frac)
        self._growth = float(growth)
        self._hists: dict[int, Histogram] = {}

    def _hist(self, tenant: int) -> Histogram:
        h = self._hists.get(tenant)
        if h is None:
            h = Histogram(
                f"hedge.tenant{tenant}.latency_us", lo=1.0,
                growth=self._growth,
            )
            self._hists[tenant] = h
        return h

    def observe(self, tenant: int, latency_us: float) -> None:
        """Feed one completion into the tenant's latency distribution."""
        self._hist(tenant).record(float(latency_us))

    def threshold_us(self, tenant: int) -> float | None:
        """Hedge-fire delay for the tenant; None while under-sampled."""
        h = self._hists.get(tenant)
        if h is None or h.n < self.min_samples:
            return None
        return h.percentile(self.quantile)

    def snapshot(self) -> dict:
        """Per-tenant learned thresholds (None = still warming up)."""
        return {
            t: self.threshold_us(t) for t in sorted(self._hists)
        }
