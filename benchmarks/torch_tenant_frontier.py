"""Multi-tenant replication-cost frontier on the PyTorch port.

The frontier part of ``benchmarks/tenant_frontier.py``, run on
``repro_torch``: a two-tenant workload (SNB short reads + GNN sampling
over the same scale-1 graph and object space, 6 hash-sharded servers,
``f = object_sizes()``) whose GNN tenant's t_Q tightens 3 -> 2 -> 1 -> 0
while SNB's holds at 1.  For each budget it records the replicas, the
f-weighted storage overhead and the failed paths of
``replicate_workload(..., SLOSpec)``, checks the scheme feasible per
tenant budget, and requires the overhead to rise monotonically (the
cost-of-SLO curve a capacity planner reads).  The drift part: both
tenants' hotspots move (``snb_drift`` / ``gnn_drift``, 3 phases); the
phases are served in interleaved batches at 20,000 qps through the
serving simulator on a cluster repaired by the arbitrating multi-tenant
``AdaptiveController`` (capacity 2.5x the static scheme's fullest
server), and the drifted phase is served on the static phase-0 scheme
and on the repaired one: the controller must lower every tenant's p99.

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
QUERIES_PER_PHASE = 400
BATCH_QUERIES = 100
DRIFT_RATE_QPS = 20_000.0


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


def drift(device=None, backend=None) -> dict:
    """Per-tenant p99 on the drifted phase: static vs controller-on.  The
    simulator's walks, the controller's engine and its repairs run on
    ``device`` with ``backend`` (default from the device)."""
    from repro_torch.core import PathSet, SLOSpec, replicate_workload
    from repro_torch.distsys import Cluster, LatencyModel
    from repro_torch.graph import make_sharding, snb_like
    from repro_torch.serve import (
        AdaptiveController,
        ControllerConfig,
        gnn_drift,
        simulate,
        snb_drift,
    )
    from repro_torch.workload import multi_tenant_workload

    snb = snb_like(1, seed=0)
    g = snb.graph
    f = g.object_sizes().astype(np.float32)
    shard = make_sharding("hash", g, N_SERVERS, seed=0)
    model = LatencyModel()
    dev_kw = dict(device=device, backend=backend)

    s_phases = snb_drift(snb, n_phases=3, queries_per_phase=QUERIES_PER_PHASE, seed=0)
    g_phases = gnn_drift(g, n_phases=3, queries_per_phase=QUERIES_PER_PHASE // 2,
                         fanouts=(6, 4), seed=0)
    # gnn serves at budget 1 here: its 2-hop sampling paths are trivially
    # within the family default t=2, which would leave the drifted phase
    # with nothing to repair (and nothing to measure)
    phases = [
        multi_tenant_workload([("snb", sp.pathset), ("gnn", gp.pathset)],
                              budgets={"snb": T_SNB, "gnn": 1})
        for sp, gp in zip(s_phases, g_phases)
    ]

    ps0, slo0 = phases[0]
    static_scheme, _ = replicate_workload(ps0, shard, N_SERVERS, slo0, f=f, device=device,
                                          policy_backend=backend)
    static_cluster = Cluster(static_scheme, f=f)
    ctl_scheme = static_scheme.copy()
    ctl_cluster = Cluster(ctl_scheme, f=f)
    # finite capacity headroom => simultaneous tenant repairs arbitrate
    cap = float(static_scheme.storage_per_server(f).max() * 2.5)
    controller = AdaptiveController(
        ctl_cluster,
        ControllerConfig(window=4 * BATCH_QUERIES, min_queries=BATCH_QUERIES // 2,
                         capacity=cap, demote_after=3, tenants=tuple(slo0.tenants)),
        f=f, **dev_kw,
    )
    deferrals = 0
    adaptations = 0
    for (ps, slo), sp, gp in zip(phases, s_phases, g_phases):
        # interleave the tenants within each served batch: one snb slice
        # and one gnn slice per round, so both windows fill together and
        # their repairs contend for the capacity headroom
        n_s = sp.pathset.n_queries
        n_g = gp.pathset.n_queries
        rounds = max(1, -(-n_s // BATCH_QUERIES))
        bs_g = max(1, -(-n_g // rounds))
        for r in range(rounds):
            s_lo, s_hi = r * BATCH_QUERIES, min((r + 1) * BATCH_QUERIES, n_s)
            g_lo = n_s + r * bs_g
            g_hi = n_s + min((r + 1) * bs_g, n_g)
            sections = [
                (ps.select_queries(s_lo, s_hi), slo.select_queries(s_lo, s_hi)),
                (ps.select_queries(g_lo, g_hi), slo.select_queries(g_lo, g_hi)),
            ]
            batch = PathSet.concatenate([p for p, _ in sections])
            # align each section's spec to its pathset before the concat
            # (a slice whose trailing queries are pathless is undercounted)
            batch_slo = SLOSpec.concat([s.align_to(p) for p, s in sections])
            assert batch_slo.n_queries == batch.n_queries
            if batch.n_paths == 0:
                continue
            rep = simulate(ctl_cluster, batch, rate_qps=DRIFT_RATE_QPS, model=model, seed=r,
                           slo=batch_slo, **dev_kw)
            act = controller.observe(batch, latency_us=rep.latency_us, slo=batch_slo)
            if act is not None:
                adaptations += 1
                deferrals += len(act.deferred)

    drifted_ps, drifted_slo = phases[-1]
    per_tenant = []
    for name, cluster in (("static", static_cluster), ("controller", ctl_cluster)):
        rep = simulate(cluster, drifted_ps, rate_qps=DRIFT_RATE_QPS, model=model, seed=7,
                       slo=drifted_slo, **dev_kw)
        per_tenant.append({"scheme": name, **rep.summary()["per_tenant"]})
    static_row, ctl_row = per_tenant
    improved = {t: ctl_row[t]["p99_us"] < static_row[t]["p99_us"] for t in ("snb", "gnn")}
    if not all(improved.values()):
        raise AssertionError(f"controller must lower every tenant's drifted-phase p99: "
                             f"{improved}")
    return {"adaptations": adaptations, "arbitration_deferrals": deferrals,
            "per_tenant_p99": per_tenant, "controller_beats_static": improved}


def run(out_path: str = "BENCH_torch_tenants.json", device=None) -> dict:
    rows, _ = frontier(device=device)
    drift_block = drift(device=device)
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
        "drift": drift_block,
    }
    with open(out_path, "w") as fh:
        json.dump(result, fh, indent=2)
    for r in rows:
        print(f"t_snb={r['t_snb']} t_gnn={r['t_gnn']} replicas={r['replicas']} "
              f"overhead={r['overhead']:.4f} failed={r['failed_paths']}")
    for row in drift_block["per_tenant_p99"]:
        print(f"drift {row['scheme']}: " + " ".join(
            f"{t} p99={row[t]['p99_us']:.1f}us" for t in ("snb", "gnn")))
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
