"""Quickstart on the PyTorch port: tune the tail latency of a distributed
graph workload.

Builds a social graph, samples an interactive short-read workload, and
walks the latency/replication trade-off of the paper (Fig 1/6): for each
latency bound t, the greedy replication algorithm produces a scheme, and
the simulated cluster reports latency percentiles + storage overhead.
The same table as ``examples/quickstart.py``; the walks run on the card
(the ``path_latency`` and ``routed_walk`` kernels) unless ``--device cpu``.

Run:  PYTHONPATH=src python3 examples/torch_quickstart.py [--device cpu]
"""
import argparse
import pathlib
import sys

import numpy as np

N_SERVERS = 6
BOUNDS = (0, 1, 2, 3)


def table(device=None, backend=None):
    """One row per bound t: feasible, overhead, mean_us, p99_us, replicas
    (and the scheme).  ``backend`` picks the engine's evaluator for the
    feasibility check and the executor's walk (default from the device)."""
    from repro_torch.core import is_latency_feasible, replicate_workload
    from repro_torch.distsys import Cluster, LatencyModel, execute_workload
    from repro_torch.graph import hash_partition, snb_like
    from repro_torch.workload import snb_workload_materialized

    snb = snb_like(scale=1, seed=0)
    graph = snb.graph
    workload = snb_workload_materialized(snb, n_queries=1500, seed=0)
    shard = hash_partition(graph.n_nodes, N_SERVERS)
    sizes = graph.object_sizes()
    rows = []
    for t in BOUNDS:
        scheme, stats = replicate_workload(
            workload, shard, N_SERVERS, t=t, f=sizes.astype(np.float32),
            device=device, policy_backend=backend)
        ok = is_latency_feasible(workload, scheme, t, device=device, backend=backend)
        report = execute_workload(Cluster(scheme, f=sizes), workload, LatencyModel(), seed=0,
                                  device=device, backend=backend)
        s = report.summary()
        rows.append({"t": t, "feasible": ok, "overhead": scheme.replication_overhead(sizes),
                     "mean_us": s["mean_us"], "p99_us": s["p99_us"],
                     "replicas": stats.replicas, "scheme": scheme, "summary": s})
    return graph, workload, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="latency-bound replication quickstart (torch)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    print("== latency-bound replication quickstart ==")
    graph, workload, rows = table(device=args.device)
    print(f"graph: {graph.n_nodes:,} vertices, {graph.n_edges:,} edges")
    print(f"workload: {workload.n_queries:,} queries -> "
          f"{workload.n_paths:,} causal access paths")
    print(f"\n{'t':>4} {'feasible':>8} {'overhead':>9} {'mean_us':>8} "
          f"{'p99_us':>8} {'replicas':>9}")
    for r in rows:
        print(f"{r['t']:>4} {str(r['feasible']):>8} {r['overhead']:>9.3f} "
              f"{r['mean_us']:>8.1f} {r['p99_us']:>8.1f} "
              f"{r['replicas']:>9,}")
    print("\nReading the table: tightening t cuts latency but multiplies "
          "storage;\nthe sweet spot (paper §6) is where overhead flattens "
          "while latency stays bounded.")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))
    sys.exit(main())
