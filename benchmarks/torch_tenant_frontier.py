"""Multi-tenant replication-cost frontier on the PyTorch port.

The frontier part of ``benchmarks/tenant_frontier.py``, run on
``repro_torch``: a two-tenant workload (SNB short reads + GNN sampling
over the same scale-1 graph and object space, 6 hash-sharded servers,
``f = object_sizes()``) whose GNN tenant's t_Q tightens 3 -> 2 -> 1 -> 0
while SNB's holds at 1.  For each budget it records the replicas, the
f-weighted storage overhead and the failed paths of
``replicate_workload(..., SLOSpec)``, checks the scheme feasible per
tenant budget, and requires the overhead to rise monotonically (the
cost-of-SLO curve a capacity planner reads).  The drift part (per-tenant
p99 under the adaptive controller) needs the serving controller, which
is not ported yet.

Writes ``BENCH_torch_tenants.json`` (or the path given).

Usage:  PYTHONPATH=src python3 benchmarks/torch_tenant_frontier.py
        [--device cpu] [--out BENCH_torch_tenants.json]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

N_SERVERS = 6
T_SNB = 1                      # the holding tenant's budget
GNN_SWEEP = (3, 2, 1, 0)       # the tightening tenant's budgets


def frontier_workload():
    """(PathSet of SNB, PathSet of GNN, shard, f) at scale 1, seed 0."""
    from repro_torch.graph import make_sharding, snb_like
    from repro_torch.workload import gnn_workload_materialized, snb_workload_materialized

    snb = snb_like(1, seed=0)
    g = snb.graph
    f = g.object_sizes().astype(np.float32)
    shard = make_sharding("hash", g, N_SERVERS, seed=0)
    rng = np.random.default_rng(0)
    sps = snb_workload_materialized(snb, n_queries=500, seed=0)
    gps = gnn_workload_materialized(g, rng.integers(0, g.n_nodes, 250), (6, 4), seed=0)
    return sps, gps, shard, f


def frontier(device=None, backend=None) -> tuple[list, dict]:
    """Rows per GNN budget and the schemes by budget.  Each scheme is
    checked feasible against its ``SLOSpec`` on ``device`` (default
    ``"cuda"``) with ``backend`` (default from the device)."""
    import repro_torch.core as T
    from repro_torch.workload import multi_tenant_workload

    sps, gps, shard, f = frontier_workload()
    rows, schemes = [], {}
    prev = -1.0
    for t_gnn in GNN_SWEEP:
        ps, slo = multi_tenant_workload(
            [("snb", sps), ("gnn", gps)], budgets={"snb": T_SNB, "gnn": t_gnn}
        )
        t0 = time.perf_counter()
        scheme, stats = T.replicate_workload(ps, shard, N_SERVERS, slo, f=f, device=device,
                                             policy_backend=backend)
        seconds = time.perf_counter() - t0
        feasible = T.is_latency_feasible(ps, scheme, slo, device=device, backend=backend)
        overhead = scheme.replication_overhead(f)
        rows.append({"t_snb": T_SNB, "t_gnn": t_gnn, "overhead": overhead,
                     "replicas": stats.replicas, "failed_paths": stats.failed_paths,
                     "feasible": feasible, "seconds": seconds})
        if not feasible or stats.failed_paths:
            raise AssertionError(f"t_gnn={t_gnn}: infeasible scheme or failed paths")
        if overhead < prev - 1e-9:
            raise AssertionError("replication cost dropped as one tenant's t_Q tightened")
        prev = overhead
        schemes[t_gnn] = scheme
    return rows, schemes


def run(out_path: str = "BENCH_torch_tenants.json", device=None) -> dict:
    rows, _ = frontier(device=device)
    on_card = (device or "cuda") == "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip() if on_card else "cpu"
    result = {
        "n_servers": N_SERVERS,
        "device": str(device or "cuda"),
        "card": card,  # name and power limit, as nvidia-smi gives them
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "frontier": rows,
        "frontier_monotone": True,
    }
    with open(out_path, "w") as fh:
        json.dump(result, fh, indent=2)
    for r in rows:
        print(f"t_snb={r['t_snb']} t_gnn={r['t_gnn']} replicas={r['replicas']} "
              f"overhead={r['overhead']:.4f} failed={r['failed_paths']}")
    print(f"# wrote {out_path}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_tenants.json")
    args = ap.parse_args(argv)
    run(args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))
    sys.exit(main())
