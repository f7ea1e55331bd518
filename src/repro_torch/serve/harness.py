"""Asyncio multi-worker serving harness: `simulate()` against a real clock.

The discrete-event simulator *prices* queueing; this module *runs* it.
``harness_simulate()`` takes the same inputs as
:func:`repro_torch.serve.simulator.simulate` (cluster, pathset, latency model,
arrival process, batching config) and serves the same routed access trees
through **real** concurrency primitives on a wall clock:

* every server is an ``asyncio.Semaphore(concurrency)`` — real contention,
  real FIFO-ish waiting, no modeled queues;
* every access is a real ``asyncio.sleep`` of its service time scaled by
  ``time_scale`` (real seconds per model microsecond, default ``5e-4``:
  a 60 us remote hop sleeps 30 ms, so event-loop scheduling slop of ~1 ms
  is ~2 us of model time — small against the latencies being validated);
* batched dispatch is a real per-server collector task: the first pending
  access arms a window timer, the flush takes a ladder rung and serves the
  whole batch under ONE semaphore slot with one amortized ``dispatch_us``
  — the same plane the simulator models, backed by actual tasks.

The harness returns the same :class:`~repro_torch.serve.simulator.SimReport`,
so simulator percentiles diff against wall-clock measurements directly
(measured p99 within a stated error band of the simulator on the
low-load regime, and the batched-vs-per-query win demonstrated on real
time).  Its one device step is the routing walk of the access trees
(``_build_variant``); the clock runs on the host.

What is validated is the *model*, not the random draws: the harness uses
the same arrival process and jitter distributions under the same seed,
but service completion order emerges from the live event loop, so
agreement is distributional (p50/p99 bands), not per-query.
"""
from __future__ import annotations

import asyncio

import numpy as np

from repro_torch.core.paths import PathSet
from repro_torch.distsys.cluster import Cluster
from repro_torch.distsys.executor import LatencyModel
from repro_torch.engine.backends import resolve_backend
from repro_torch.engine.streaming import resolve_device
from repro_torch.serve.batching import BatchingConfig, BatchStats
from repro_torch.serve.simulator import SimReport, _build_variant

__all__ = ["harness_simulate"]


def harness_simulate(
    cluster: Cluster,
    pathset: PathSet,
    rate_qps: float = 1e4,
    model: LatencyModel | None = None,
    arrivals_us: np.ndarray | None = None,
    concurrency: int = 32,
    seed: int = 0,
    slo=None,
    policy=None,
    batching: BatchingConfig | None = None,
    time_scale: float = 5e-4,
    device=None,
    backend: str | None = None,
) -> SimReport:
    """Serve the workload on a real asyncio clock; same report as simulate().

    ``time_scale`` converts model microseconds to real seconds.  Larger
    values run slower but drown event-loop scheduling slop (the harness's
    measurement noise floor) further below the service times; the default
    ``5e-4`` keeps a ~1 ms slop at ~2 us of model time.

    Open-loop only: arrivals keep their schedule (Poisson at ``rate_qps``
    under ``seed``, or the explicit ``arrivals_us`` trace) no matter how
    slow the system is — the coordinated-omission-free measurement mode.

    ``device`` (default ``"cuda"``; without a card it raises unless
    ``device="cpu"``) and ``backend`` (``kernel`` on CUDA, ``torch`` on
    the CPU by default) pick where the one routing walk runs, as in
    :func:`~repro_torch.serve.simulator.simulate`; the rest is a real
    clock on the host.
    """
    from repro_torch.engine.routing import resolve_policy

    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)

    model = model or LatencyModel()
    rng = np.random.default_rng(seed)
    alive = np.asarray([s.alive for s in cluster.servers], bool)
    S = cluster.n_servers
    nq = pathset.n_queries
    hop_policy = resolve_policy(policy)
    hop_load = cluster.queue_depths() if hop_policy.uses_load else None
    tenant_of = None
    tenant_names: tuple[str, ...] = ()
    if slo is not None:
        assert slo.n_queries == nq
        tenant_of = np.asarray(slo.tenant_of, np.int32)
        tenant_names = tuple(ts.name for ts in slo.tenants)
    if nq == 0:
        return SimReport(
            latency_us=np.zeros(0), arrival_us=np.zeros(0),
            query_failed=np.zeros(0, bool), busy_us=np.zeros(S),
            queue_wait_us=0.0, duration_us=0.0, offered_qps=rate_qps,
            concurrency=concurrency, tenant_of=tenant_of,
            tenant_names=tenant_names, policy=hop_policy.name,
        )

    trees, dead = _build_variant(
        pathset, cluster, model, alive, None, hop_policy, hop_load, dev,
        backend,
    )
    if arrivals_us is None:
        arrivals_us = np.cumsum(rng.exponential(1e6 / rate_qps, size=nq))
    else:
        arrivals_us = np.asarray(arrivals_us, np.float64)
        assert arrivals_us.shape == (nq,)

    scale = float(time_scale)
    busy_us = np.zeros(S, np.float64)
    completion = np.full(nq, -1.0)
    n_waits = 0
    wait_us = 0.0
    batch_stats = BatchStats() if batching is not None else None

    def jitter() -> float:
        return rng.lognormal(0.0, model.jitter_sigma)

    async def _run() -> None:
        nonlocal n_waits, wait_us
        loop = asyncio.get_running_loop()
        sems = [asyncio.Semaphore(concurrency) for _ in range(S)]
        t0 = loop.time()

        def now_us() -> float:
            return (loop.time() - t0) / scale

        # --- batched dispatch: per-server collector --------------------
        pending: list[list] = [[] for _ in range(S)]
        serve_tasks: set = set()

        async def _serve_batch(s: int, members: list) -> None:
            nonlocal n_waits, wait_us
            tq0 = now_us()
            async with sems[s]:
                n_waits += 1
                wait_us += now_us() - tq0
                svc = (
                    model.dispatch_us + sum(b for _, b in members)
                ) * jitter()
                busy_us[s] += svc
                await asyncio.sleep(svc * scale)
            for fut, _ in members:
                if not fut.done():
                    fut.set_result(None)

        async def _flush_later(s: int) -> None:
            await asyncio.sleep(batching.window_us * scale)
            while pending[s]:
                take = batching.ladder.pick(len(pending[s]))
                members = pending[s][:take]
                del pending[s][:take]
                batch_stats.observe(len(members))
                task = asyncio.ensure_future(_serve_batch(s, members))
                serve_tasks.add(task)
                task.add_done_callback(serve_tasks.discard)

        def submit(s: int, base: float):
            fut = loop.create_future()
            pending[s].append((fut, base))
            if len(pending[s]) == 1:
                task = asyncio.ensure_future(_flush_later(s))
                serve_tasks.add(task)
                task.add_done_callback(serve_tasks.discard)
            return fut

        # --- the routed walk, one coroutine per access-tree node -------
        async def run_node(q: int, nodes: list, i: int) -> None:
            nonlocal n_waits, wait_us
            s, base, _obj, children = nodes[i]
            if s < 0:
                # no alive copy: degraded completion, no queueing
                await asyncio.sleep(model.remote_us * scale)
            elif batching is not None:
                await submit(s, base)
            else:
                tq0 = now_us()
                async with sems[s]:
                    n_waits += 1
                    wait_us += now_us() - tq0
                    svc = (base + model.dispatch_us) * jitter()
                    busy_us[s] += svc
                    await asyncio.sleep(svc * scale)
            if children:
                await asyncio.gather(
                    *(run_node(q, nodes, c) for c in children)
                )

        async def run_query(q: int) -> None:
            target = t0 + arrivals_us[q] * scale
            delay = target - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            nodes, roots = trees[q]
            if roots:
                await asyncio.gather(*(run_node(q, nodes, r) for r in roots))
            completion[q] = now_us() + model.coordinator_us

        await asyncio.gather(*(run_query(q) for q in range(nq)))
        if serve_tasks:
            await asyncio.gather(*serve_tasks)

    asyncio.run(_run())

    assert (completion >= 0).all(), "harness leaked queries"
    return SimReport(
        latency_us=completion - arrivals_us,
        arrival_us=arrivals_us,
        query_failed=dead,
        busy_us=busy_us,
        queue_wait_us=wait_us / n_waits if n_waits else 0.0,
        duration_us=float(completion.max() - arrivals_us.min()),
        offered_qps=rate_qps,
        concurrency=concurrency,
        tenant_of=tenant_of,
        tenant_names=tenant_names,
        policy=hop_policy.name,
        batch_stats=batch_stats,
    )
