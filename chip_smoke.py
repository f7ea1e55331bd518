"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one JSON line; any failed check exits non-zero):
  build   compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
          sm_90a) and print the card, its power limit and the TF32 flag.
  parity  each kernel against its plain torch version, exactly, on 1 M
          seeded random paths (L in {1, 6, 9}, 6 / 40 / 128 servers, bit 31
          set, -1 padding and empty rows; the routed walk under
          home_first, nearest_copy and queue_aware with tied loads).
  main    the paper's pipeline on SNB scale 10: greedy replication under
          ``nearest_copy`` for t = 1 and 2, the feasibility check and the
          home-first latencies, on the kernel backend; the kernels' launch
          counters are zeroed just before and read just after.  The t = 1
          run is repeated with the torch gate and must give the same mask.
  sweep   the engine's hot primitive at deployment scale (SNB scale 100,
          150,000 queries, ~1.4 M paths, 128 servers): kernel vs plain,
          exact, then each timed as the median of 5 runs after a warm-up.
The last two lines are the kernels' JSON summary and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def gpu_name_and_power() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip()


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power()
    print(smi, flush=True)
    out = {
        "phase": "build", "seconds": time.perf_counter() - t0,
        "nvcc_seconds": build.BUILD_SECONDS, "library": str(build.library_path()),
        "nvidia_smi": smi,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "torch": torch.__version__, "cuda": torch.version.cuda, "numpy": np.__version__,
    }
    emit(out)
    return out


def random_case(seed: int, P: int, L: int, n_srv: int, n_obj: int, dev):
    """Seeded random kernel inputs on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)
    W = (n_srv + 31) // 32
    shard = torch.randint(0, n_srv, (n_obj,), generator=g, device=dev, dtype=torch.int32)
    hold = torch.rand((n_obj, W * 32), generator=g, device=dev) < 0.1
    hold[:, n_srv:] = False
    hold[torch.arange(n_obj, device=dev), shard.long()] = True
    hold[:, 31] |= torch.rand(n_obj, generator=g, device=dev) < 0.5   # the sign bit
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    w64 = (hold.view(n_obj, W, 32).long() << shifts).sum(-1)
    w32 = torch.where(w64 >= 2**31, w64 - 2**32, w64).to(torch.int32)
    words = torch.cat([w32, torch.zeros((1, W), dtype=torch.int32, device=dev)])
    # a few homes are -1 (no alive copy): clamped by the home-first walk,
    # a dead server for the routed walk
    shard[torch.rand(n_obj, generator=g, device=dev) < 0.01] = -1
    lengths = torch.randint(0, L + 1, (P,), generator=g, device=dev, dtype=torch.int32)
    objects = torch.randint(0, n_obj, (P, L), generator=g, device=dev, dtype=torch.int32)
    objects[torch.arange(L, device=dev)[None, :] >= lengths[:, None]] = -1
    start = torch.randint(-1, n_srv, (P,), generator=g, device=dev, dtype=torch.int32)
    load = torch.zeros(W * 32, dtype=torch.float32, device=dev)
    load[:n_srv] = torch.randint(0, 3, (n_srv,), generator=g, device=dev).float()  # ties
    return objects, lengths, words, shard, start, load


def phase_parity(pl, rw, dev, P: int) -> dict:
    t0 = time.perf_counter()
    cases = []
    max_err = {"path_latency": 0, "routed_walk": 0}
    for L in (1, 6, 9):
        for n_srv in (6, 40, 128):
            objects, lengths, words, shard, start, load = random_case(
                L * 1000 + n_srv, P, L, n_srv, 500_000, dev)
            got = pl.path_latency(objects, lengths, words, shard)
            want = pl.path_latency_plain(objects, lengths, words, shard)
            err = int((got - want).abs().max())
            max_err["path_latency"] = max(max_err["path_latency"], err)
            check(torch.equal(got, want), f"path_latency L={L} S={n_srv}")
            for mode, lv in (("home_first", load), ("nearest_copy", torch.zeros_like(load)),
                             ("queue_aware", load)):
                kw = dict(home_first=mode == "home_first", lookahead=mode != "home_first")
                s, loc = rw.routed_walk(objects, lengths, words, shard, start, lv, **kw)
                ws, wl = rw.routed_walk_plain(objects, lengths, words, shard, start, lv, **kw)
                err = int((s - ws).abs().max()) + int((loc != wl).sum())
                max_err["routed_walk"] = max(max_err["routed_walk"], err)
                check(torch.equal(s, ws) and torch.equal(loc, wl),
                      f"routed_walk {mode} L={L} S={n_srv}")
            cases.append({"L": L, "n_servers": n_srv, "mean_h": float(got.float().mean())})
    torch.cuda.synchronize()
    out = {"phase": "parity", "seconds": time.perf_counter() - t0, "paths": P,
           "cases": cases, "max_abs_err": max_err, "exact": True}
    emit(out)
    return out


def phase_main(T, pl, rw, graph_mod, workload_mod, engine_mod, scale: int, n_queries: int) -> dict:
    t0 = time.perf_counter()
    snb = graph_mod.snb_like(scale=scale, seed=0)
    ps = workload_mod.snb_workload_materialized(snb, n_queries=n_queries, seed=0)
    n = snb.graph.n_nodes
    shard = graph_mod.hash_partition(n, 6)
    f = snb.graph.object_sizes().astype(np.float32)
    setup_s = time.perf_counter() - t0
    runs = {}
    schemes = {}
    # the main path: counters zeroed just before, read just after
    pl.LAUNCHES = 0
    rw.LAUNCHES = 0
    engine_mod.TRANSFER.reset()
    for t in (1, 2):
        ts = time.perf_counter()
        scheme, st = T.replicate_workload(ps, shard, 6, t, f=f, policy="nearest_copy")
        greedy_s = time.perf_counter() - ts
        tf = time.perf_counter()
        feasible = T.is_latency_feasible(ps, scheme, t, policy="nearest_copy")
        feas_s = time.perf_counter() - tf
        th = time.perf_counter()
        h = T.path_latencies(ps, scheme)
        h_s = time.perf_counter() - th
        check(feasible, f"t={t}: scheme not feasible under nearest_copy")
        check(st.failed_paths == 0, f"t={t}: {st.failed_paths} failed paths")
        check(st.routed_violations == 0, f"t={t}: {st.routed_violations} routed violations")
        check(h.shape == (ps.n_paths,) and h.dtype == np.int32 and int(h.min()) >= 0,
              f"t={t}: home-first latencies malformed")
        schemes[t] = scheme
        runs[t] = {
            "replicas": st.replicas, "pruned": st.pruned_replicas,
            "overhead": scheme.replication_overhead(f.astype(np.float64)),
            "failed_paths": st.failed_paths, "routed_violations": st.routed_violations,
            "routed_skips": st.routed_skips, "fallback_paths": st.fallback_paths,
            "paths_processed": st.paths_processed, "feasible": feasible,
            "home_first_max_h": int(h.max()), "home_first_mean_h": float(h.mean()),
            "greedy_s": greedy_s,
            "stage_s": dict(st.stage_s, feasibility=feas_s, home_first_latencies=h_s),
        }
    launches = {"path_latency": pl.LAUNCHES, "routed_walk": rw.LAUNCHES}
    transfer = engine_mod.TRANSFER.snapshot()
    check(launches["path_latency"] > 0, "path_latency kernel not launched on the main path")
    check(launches["routed_walk"] > 0, "routed_walk kernel not launched on the main path")
    # the t = 1 run with the plain torch gate must give the same mask
    tt = time.perf_counter()
    scheme_t, st_t = T.replicate_workload(ps, shard, 6, 1, f=f, policy="nearest_copy",
                                          policy_backend="torch")
    torch_gate_s = time.perf_counter() - tt
    check(np.array_equal(scheme_t.mask, schemes[1].mask), "t=1 torch-gate mask differs")
    # a small reference check: kernel engine vs the pure-python oracle
    small = ps.select(np.arange(min(2000, ps.n_paths)))
    for pol in ("home_first", "nearest_copy"):
        k = engine_mod.LatencyEngine(schemes[1]).path_latencies(small, policy=pol)
        r = engine_mod.LatencyEngine(schemes[1], backend="reference").path_latencies(small, policy=pol)
        check(np.array_equal(k, r), f"kernel engine vs reference oracle ({pol})")
    out = {
        "phase": "main", "seconds": time.perf_counter() - t0, "setup_s": setup_s,
        "scale": scale, "n_queries": n_queries, "objects": int(n),
        "edges": int(snb.graph.n_edges), "paths": ps.n_paths, "max_len": ps.max_len,
        "n_servers": 6, "policy": "nearest_copy", "runs": runs, "launches": launches,
        "transfer": transfer,
        "torch_gate_t1_identical": True, "torch_gate_t1_s": torch_gate_s,
        "torch_gate_t1_stage_s": st_t.stage_s,
    }
    emit(out)
    return out


def time_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_sweep(pl, rw, graph_mod, workload_mod, engine_mod, backends, scale: int,
                n_queries: int, dev, launches: dict) -> dict:
    t0 = time.perf_counter()
    snb = graph_mod.snb_like(scale=scale, seed=0)
    ps = workload_mod.snb_workload_materialized(snb, n_queries=n_queries, seed=0)
    n = snb.graph.n_nodes
    n_srv = 128
    shard = graph_mod.hash_partition(n, n_srv)
    rng = np.random.default_rng(1)
    W = (n_srv + 31) // 32
    words = np.zeros((n + 1, W), np.uint32)
    s = shard.astype(np.int64)
    words[np.arange(n), s // 32] |= np.uint32(1) << (s % 32).astype(np.uint32)
    extra = np.nonzero(rng.random(n) < 0.25)[0]
    es = rng.integers(0, n_srv, len(extra))
    np.bitwise_or.at(words, (extra, es // 32), np.uint32(1) << (es % 32).astype(np.uint32))
    packed = engine_mod.PackedScheme.from_numpy(words, shard, device=dev, n_servers=n_srv)
    load = rng.integers(0, 4, n_srv).astype(np.float32)  # ties
    eng_k = engine_mod.LatencyEngine(packed=packed, backend="kernel")
    eng_t = engine_mod.LatencyEngine(packed=packed, backend="torch")
    dp = eng_k.prepare(ps)
    setup_s = time.perf_counter() - t0
    objects, lengths = dp.objects, dp.lengths
    wd, sd = packed.words, packed.shard
    start = backends._root_home(objects, sd)
    zero = backends._load_vector(None, wd)
    qload = backends._load_vector(load, wd)

    # exact comparison through the engines, per policy
    h = {}
    for pol in ("home_first", "nearest_copy", "queue_aware"):
        hk = eng_k.path_latencies(dp, policy=pol, load=load)
        ht = eng_t.path_latencies(dp, policy=pol, load=load)
        check(np.array_equal(hk, ht), f"sweep {pol}: kernel vs plain")
        h[pol] = hk
    # bytes each walk must move (each input byte read once, each output
    # byte written once; only what this data needs)
    valid = torch.arange(ps.max_len, device=dev)[None, :] < lengths[:, None]
    sum_len = int(lengths.long().sum())
    touched = int(torch.unique(objects[valid]).numel())
    P, L = ps.n_paths, ps.max_len
    bytes_pl = 4 * P + 4 * sum_len + 8 * touched + 4 * P
    bytes_rw = 8 * P + 4 * sum_len + (4 * W + 4) * touched + 4 * W * 32 + 5 * P * L
    timings = {
        "path_latency": {
            "kernel_ms": time_ms(lambda: pl.path_latency(objects, lengths, wd, sd)),
            "plain_ms": time_ms(lambda: pl.path_latency_plain(objects, lengths, wd, sd)),
            "bytes": bytes_pl,
        }
    }
    for pol, lv, kw in (("home_first", zero, dict(home_first=True, lookahead=False)),
                        ("nearest_copy", zero, dict(home_first=False, lookahead=True)),
                        ("queue_aware", qload, dict(home_first=False, lookahead=True))):
        timings[f"routed_walk/{pol}"] = {
            "kernel_ms": time_ms(lambda: rw.routed_walk(objects, lengths, wd, sd, start, lv, **kw)),
            "plain_ms": time_ms(lambda: rw.routed_walk_plain(objects, lengths, wd, sd, start, lv, **kw)),
            "bytes": bytes_rw,
        }
    for name, v in timings.items():
        v["bound_ms"] = v["bytes"] / HBM_BYTES_PER_S * 1e3
        v["launches"] = launches[name.split("/")[0]]  # on the main path
    out = {
        "phase": "sweep", "seconds": time.perf_counter() - t0, "setup_s": setup_s,
        "scale": scale, "n_queries": n_queries, "objects": int(n), "paths": P,
        "max_len": L, "sum_len": sum_len, "touched_objects": touched,
        "n_servers": n_srv, "extra_copies": int(len(extra)),
        "mean_h": {k: float(v.mean()) for k, v in h.items()},
        "exact": True, "timings": timings,
        "library_ms": None,
        "library_note": "no single PyTorch call computes this data-dependent walk",
    }
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import repro_torch.core as T
    from repro_torch import engine as engine_mod
    from repro_torch import graph as graph_mod
    from repro_torch import workload as workload_mod
    from repro_torch.engine import backends
    from repro_torch.kernels import build
    from repro_torch.kernels import path_latency as pl
    from repro_torch.kernels import routed_walk as rw

    dev = torch.device("cuda")
    t_all = time.perf_counter()
    b = phase_build(build)
    par = phase_parity(pl, rw, dev, P=1_000_000)
    main_out = phase_main(T, pl, rw, graph_mod, workload_mod, engine_mod,
                          scale=10, n_queries=20_000)
    sw = phase_sweep(pl, rw, graph_mod, workload_mod, engine_mod, backends,
                     scale=100, n_queries=150_000, dev=dev, launches=main_out["launches"])
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    print(b["nvidia_smi"], flush=True)
    nc = sw["timings"]["routed_walk/nearest_copy"]
    hf = sw["timings"]["path_latency"]
    emit({"kernels": [
        {"name": "path_latency", "route": "cuda",
         "source": "src/repro_torch/csrc/path_latency.cu",
         "replaces": "src/repro/kernels/path_latency.py:68",
         "launches": main_out["launches"]["path_latency"],
         "max_abs_err": par["max_abs_err"]["path_latency"],
         "ms": hf["kernel_ms"], "plain_ms": hf["plain_ms"], "bound_ms": hf["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "routed_walk", "route": "cuda",
         "source": "src/repro_torch/csrc/routed_walk.cu",
         "replaces": "src/repro/kernels/routed_walk.py:121",
         "launches": main_out["launches"]["routed_walk"],
         "max_abs_err": par["max_abs_err"]["routed_walk"],
         "ms": nc["kernel_ms"], "plain_ms": nc["plain_ms"], "bound_ms": nc["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
