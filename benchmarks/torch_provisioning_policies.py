"""Policy-aware greedy provisioning on the PyTorch port, SNB family.

The SNB part of ``benchmarks/provisioning_policies.py``, run on
``repro_torch``: SNB-like scale 1 (6 hash-sharded servers, ``f =
object_sizes()``, t = 1) drifts through three phases (``snb_drift``, 320
queries per phase, hot probability 0.9, seed 0).  Phase 0 is provisioned
from scratch, later phases ship ``replicate_delta`` over the paths that
appeared, under two pipelines with equal budgets:

  ``hf`` / ``hf_prune``  home-first greedy, then a ``nearest_copy`` prune
                of the union workload after the sequence (it refunds
                resident storage, not the bytes already shipped);
  ``policy``    the same sequence priced under ``nearest_copy``
                (``policy_prune=False`` per step), pruned once at the end.

Metrics, at ``nearest_copy`` feasibility over the phase-union workload:
shipped bytes (every replica ever provisioned, construction + deltas)
and resident bytes (final storage over the originals).  With numpy 2.0.2
the figures equal ``BENCH_provisioning.json``'s SNB row (``--check``);
seeded SNB graphs differ between numpy versions (2.3.5 gives others), so
on another numpy they need not.

Writes ``BENCH_torch_provisioning.json`` (or the path given).

Usage:  PYTHONPATH=src python3 benchmarks/torch_provisioning_policies.py
        [--device cpu] [--out BENCH_torch_provisioning.json] [--check]
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
T = 1
SCORE_POLICY = "nearest_copy"
QUERIES_PER_PHASE = 320
# BENCH_provisioning.json's SNB row (the JAX package's run of the same
# sequence): shipped and resident bytes per pipeline
BENCH_SNB = {"hf": (5654.5, 5654.5), "hf_prune": (5654.5, 3656.8),
             "policy": (5641.6, 3654.3)}


def snb_family():
    """(drift phases, shard, f) of the SNB family at scale 1, seed 0."""
    from repro_torch.graph import make_sharding, snb_like
    from repro_torch.serve import snb_drift

    snb = snb_like(1, seed=0)
    g = snb.graph
    f = g.object_sizes().astype(np.float32)
    shard = make_sharding("hash", g, N_SERVERS, seed=0)
    phases = snb_drift(snb, n_phases=3, queries_per_phase=QUERIES_PER_PHASE,
                       hot_prob=0.9, seed=0)
    return phases, shard, f


def drift_sequence(deltas, shard, f, policy, device=None, backend=None):
    """Provision phase 0, ship deltas for later phases; returns (scheme,
    engine, shipped bytes, routed skips)."""
    import repro_torch.core as C

    f64 = np.asarray(f, np.float64)
    kw = {"policy": policy, "policy_prune": False} if policy else {}
    scheme, stats, eng = C.replicate_workload(
        deltas[0].pathset, shard, N_SERVERS, t=T, f=f, return_engine=True,
        device=device, policy_backend=backend, **kw,
    )
    repl = scheme.mask.copy()
    repl[np.arange(scheme.n_objects), scheme.shard] = False
    shipped = float(f64[np.nonzero(repl)[0]].sum())
    skips = stats.routed_skips
    for d in deltas[1:]:
        if d.added.n_paths == 0:
            continue
        st, (add_obj, _) = C.replicate_delta(d.added, eng, T, f=f, policy=policy,
                                             policy_backend=backend)
        shipped += float(f64[add_obj].sum())
        skips += st.routed_skips
    return scheme, eng, shipped, skips


def snb_row(device=None, backend=None) -> dict:
    """The SNB family's figures: shipped / resident bytes and nearest_copy
    feasibility of ``hf``, ``hf_prune`` and ``policy``."""
    from repro_torch.core.paths import PathSet
    from repro_torch.core.replication import prune_scheme_replicas
    from repro_torch.engine import LatencyEngine
    from repro_torch.serve import drift_stream

    phases, shard, f = snb_family()
    deltas = list(drift_stream(phases))
    union = PathSet.concatenate([p.pathset for p in phases])
    orig = float(np.asarray(f, np.float64).sum())

    def resident(scheme):
        return round(float(scheme.storage_per_server(f).sum()) - orig, 1)

    def feas(scheme):
        slack = LatencyEngine(scheme, device=device, backend=backend).query_slack(
            union, T, policy=SCORE_POLICY)
        return round(float((slack >= 0).mean()), 4)

    row: dict = {"paths": union.n_paths, "queries": union.n_queries, "phases": len(deltas)}
    t0 = time.perf_counter()
    s_hf, _, shipped_hf, _ = drift_sequence(deltas, shard, f, None, device, backend)
    row["hf"] = {"shipped_bytes": round(shipped_hf, 1), "resident_bytes": resident(s_hf),
                 "feasible_frac": feas(s_hf), "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    s_pr = s_hf.copy()
    n_dropped, _ = prune_scheme_replicas(s_pr, union, T, policy=SCORE_POLICY, f=f,
                                         device=device)
    row["hf_prune"] = {"shipped_bytes": round(shipped_hf, 1), "resident_bytes": resident(s_pr),
                       "feasible_frac": feas(s_pr), "replicas_dropped": n_dropped,
                       "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    s_pa, _, shipped_pa, skips = drift_sequence(deltas, shard, f, SCORE_POLICY, device,
                                                backend)
    n_pa_drop, _ = prune_scheme_replicas(s_pa, union, T, policy=SCORE_POLICY, f=f,
                                         device=device)
    row["policy"] = {"shipped_bytes": round(shipped_pa, 1), "resident_bytes": resident(s_pa),
                     "feasible_frac": feas(s_pa), "routed_skips": skips,
                     "replicas_dropped": n_pa_drop, "seconds": time.perf_counter() - t0}
    row["matches_bench_provisioning"] = all(
        (row[k]["shipped_bytes"], row[k]["resident_bytes"]) == v for k, v in BENCH_SNB.items()
    )
    return row


def run(out_path: str = "BENCH_torch_provisioning.json", device=None, check=False) -> dict:
    row = snb_row(device=device)
    on_card = (device or "cuda") == "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip() if on_card else "cpu"
    result = {"t": T, "score_policy": SCORE_POLICY, "n_servers": N_SERVERS,
              "device": str(device or "cuda"), "card": card,
              "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"), "families": {"snb": row}}
    with open(out_path, "w") as fh:
        json.dump(result, fh, indent=2)
    for k in ("hf", "hf_prune", "policy"):
        print(f"snb {k}: shipped {row[k]['shipped_bytes']} resident {row[k]['resident_bytes']} "
              f"feasible {row[k]['feasible_frac']}")
    print(f"snb equals BENCH_provisioning.json: {row['matches_bench_provisioning']}")
    print(f"# wrote {out_path}")
    if check and not row["matches_bench_provisioning"]:
        raise AssertionError(f"SNB figures differ from BENCH_provisioning.json: {BENCH_SNB}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_provisioning.json")
    ap.add_argument("--check", action="store_true",
                    help="fail unless the figures equal BENCH_provisioning.json's SNB row")
    args = ap.parse_args(argv)
    run(args.out, device=args.device, check=args.check)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))
    sys.exit(main())
