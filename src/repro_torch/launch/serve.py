"""Serving launcher: replica-aware distributed query serving (torch port of
``repro.launch.serve``).

This launcher ties the whole paper stack together end-to-end on a live
(simulated) cluster:

  1. build a data graph + sharding,
  2. analyze the workload into causal access paths,
  3. run the greedy latency-bound replication algorithm for a target t,
  4. serve the queries through the replica-aware executor with the
     calibrated RPC latency model, reporting mean/p99 latency + throughput,
  5. optionally inject a server failure: the §5.4 incremental update (RM
     transfer of a single-target drain, then one ``repair_paths`` pass)
     re-establishes the bound where it can, and ``post_fault_feasible``
     says whether it did.

``device`` (default CUDA; raises without a card unless "cpu") and
``backend`` (``kernel`` | ``torch``, default from the device) go to every
step that takes them: the feasibility checks (the
``path_latency`` walk), the executor (``routed_walk``) and the repair.
``replicate_workload`` runs the greedy on the device's engine.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --scale 10 --queries 20000 \\
      --t 1 --fail-server 0              # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core import (
    ReshardingMap,
    is_latency_feasible,
    repair_paths,
    replicate_workload,
)
from repro_torch.core.reshard import drain_server
from repro_torch.distsys import Cluster, LatencyModel, execute_workload
from repro_torch.engine.streaming import resolve_device
from repro_torch.graph import make_sharding, snb_like
from repro_torch.workload import snb_workload_materialized, trace_objects


@dataclasses.dataclass
class ServeReport:
    t: int
    feasible: bool
    overhead: float
    mean_us: float
    p99_us: float
    qps: float
    post_fault_feasible: bool | None = None


def serve(
    t: int = 1,
    n_servers: int = 6,
    scale: int = 1,
    n_queries: int = 2000,
    sharding: str = "hash",
    fail_server: int | None = None,
    hedge: bool = False,
    seed: int = 0,
    device=None,
    backend: str | None = None,
    return_scheme: bool = False,
):
    """The paper's pipeline on one workload; returns the ``ServeReport``
    (with ``return_scheme``, also the final scheme)."""
    dev = resolve_device(device)
    snb = snb_like(scale, seed=seed)
    g = snb.graph
    f = g.object_sizes()
    ps = snb_workload_materialized(snb, n_queries=n_queries, seed=seed)
    traces = trace_objects(ps) if sharding in ("hypergraph", "hmetis") else None
    shard = make_sharding(sharding, g, n_servers, traces, seed=seed)

    scheme, stats = replicate_workload(
        ps, shard, n_servers, t=t, f=f.astype(np.float32), track_rm=True,
        policy_backend=backend, device=dev)
    feasible = is_latency_feasible(ps, scheme, t, device=dev, backend=backend)

    cluster = Cluster(scheme, f=f)
    report = execute_workload(cluster, ps, LatencyModel(), seed=seed,
                              hedge_replicas=hedge, device=dev, backend=backend)
    s = report.summary()
    out = ServeReport(
        t=t, feasible=feasible,
        overhead=scheme.replication_overhead(f),
        mean_us=s["mean_us"], p99_us=s["p99_us"], qps=s["throughput_qps"])

    if fail_server is not None:
        rmap = ReshardingMap.from_entries(stats.rm, scheme.shard)
        cluster.fail_server(fail_server)
        drain_server(scheme, rmap, fail_server, f, strategy="single")
        repair_paths(scheme, rmap, ps, t, f, device=dev, backend=backend)
        out.post_fault_feasible = is_latency_feasible(ps, scheme, t, device=dev,
                                                      backend=backend)
    return (out, scheme) if return_scheme else out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=int, default=1)
    ap.add_argument("--servers", type=int, default=6)
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--sharding", default="hash",
                    choices=["hash", "mincut", "hypergraph"])
    ap.add_argument("--fail-server", type=int, default=None)
    ap.add_argument("--hedge", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None, choices=["kernel", "torch"])
    args = ap.parse_args()
    rep = serve(args.t, args.servers, args.scale, args.queries,
                args.sharding, args.fail_server, args.hedge,
                device=args.device, backend=args.backend)
    print(f"[serve] t={rep.t} feasible={rep.feasible} "
          f"overhead={rep.overhead:.3f} mean={rep.mean_us:.0f}us "
          f"p99={rep.p99_us:.0f}us qps={rep.qps:.0f} "
          f"post_fault_feasible={rep.post_fault_feasible}")


if __name__ == "__main__":
    main()
