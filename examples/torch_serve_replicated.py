"""Serve a replicated graph store under live traffic with an adaptive SLO
loop, on the PyTorch port.

The full online story on top of the paper's offline algorithm:

  1. replicate the observed workload for an SLO of t distributed traversals,
  2. serve Poisson traffic through the discrete-event simulator
     (per-server FIFO queues, hop sequences from the engine's access trace),
  3. let the workload DRIFT (the root hotspot moves),
  4. watch the adaptive controller detect the p99/feasibility violation and
     repair the scheme *incrementally* (warm-started greedy against the
     engine's packed words on the card, no rebuild),
  5. keep serving: the drifted phase is back inside the SLO.

The same lines as ``examples/serve_replicated.py`` (the adaptation's
seconds aside); the walks, the repairs and the window re-checks run on the
card (``routed_walk``, the UPDATE batches, ``path_latency``) unless
``--device cpu``.

Run:  PYTHONPATH=src python3 examples/torch_serve_replicated.py [--device cpu]
"""
import argparse
import pathlib
import sys

import numpy as np

T, N_SERVERS, RATE_QPS = 1, 6, 20_000


def run(device=None):
    """Drive the three drift phases; one dict per phase (its report, the
    controller's adaptation or None, the phase's feasibility) and the final
    overhead."""
    from repro_torch.core import is_latency_feasible, replicate_workload
    from repro_torch.distsys import Cluster, LatencyModel
    from repro_torch.graph import make_sharding, snb_like
    from repro_torch.serve import (
        AdaptiveController,
        ControllerConfig,
        drift_stream,
        simulate,
        snb_drift,
    )

    snb = snb_like(1, seed=0)
    f = snb.graph.object_sizes().astype(np.float32)
    shard = make_sharding("hash", snb.graph, N_SERVERS, seed=0)
    phases = snb_drift(snb, n_phases=3, queries_per_phase=600, seed=0)

    scheme, stats, engine = replicate_workload(
        phases[0].pathset, shard, N_SERVERS, t=T, f=f, return_engine=True,
        device=device)
    cluster = Cluster(scheme, f=f)
    controller = AdaptiveController(
        cluster, ControllerConfig(t=T, window=400, min_queries=100),
        f=f, engine=engine)

    model = LatencyModel()
    rows = []
    for delta in drift_stream(phases):
        rep = simulate(cluster, delta.pathset, rate_qps=RATE_QPS, model=model,
                       seed=delta.phase, device=device)
        act = controller.observe(delta.pathset, latency_us=rep.latency_us)
        feas = is_latency_feasible(delta.pathset, cluster.scheme, T, device=device)
        rows.append({"delta": delta, "report": rep, "adaptation": act,
                     "feasible": feas})
    return rows, cluster.scheme.replication_overhead(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="online serving with drift adaptation (torch)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    print(f"== online serving with latency SLO t={T} ({N_SERVERS} servers, "
          f"{RATE_QPS:,} qps offered) ==")
    rows, overhead = run(device=args.device)
    for r in rows:
        delta, rep, act = r["delta"], r["report"], r["adaptation"]
        line = (f"phase {delta.phase}: +{delta.added.n_paths} new paths | "
                f"p50 {rep.p50_us:5.0f}us p99 {rep.p99_us:5.0f}us | "
                f"util {rep.utilization().max():.2f}")
        if act is not None:
            line += (f" | ADAPTED: {act.replicas_added} replicas "
                     f"({act.bytes_added:.0f} bytes) in {act.runtime_s:.2f}s")
        print(line + f" | feasible={r['feasible']}")
        assert r["feasible"], "controller failed to restore the latency bound"

    print(f"\nreplication overhead now: {overhead:.3f}x original data")
    print("online serving + drift adaptation OK")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))
    sys.exit(main())
