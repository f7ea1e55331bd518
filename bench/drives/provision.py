"""The provisioning drive: the operator's run on one workload.

``replicate_workload(..., policy=<the configuration's routing>,
fused=True)`` on the device's default backend (the kernels on a card),
then ``is_latency_feasible`` of the scheme it returns, on a fresh
``PathSet`` in the drive's own order and a fresh scheme built from the
bare sharding.

``judge`` decides ``correct`` once the window has closed, against the
plain reference (``bench/reference/``), which works everything out again
from the inputs:

* every drive's scheme: its paths over t under the reference's walk, its
  home copies, the overhead it reported against the one recomputed from
  its mask and f, and its feasibility answer against the walk's;
* a sample of the drives, drawn from the run's seed (the traffic file's
  ``reference_drives``): the whole mask against the reference's greedy
  and prune run on that drive's order.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from bench import gen
from bench.reference import check, greedy

FAILED = "paths_over_t"  # the check that counts the paths the schemes leave over t


def _nospan(name):
    return contextlib.nullcontext()


def run(core, inputs, paths, device, counters, span=_nospan) -> dict:
    """One drive on ``paths``; the scheme, what the program said of it,
    the drive's spans and the differences of the program's counters."""
    ps = core.PathSet(paths.objects, paths.lengths, paths.query_ids)
    c0 = counters()
    t0 = time.perf_counter()
    with span("bench.replicate_workload"):
        scheme, stats = core.replicate_workload(
            ps, inputs.home, inputs.n_servers, inputs.t, f=inputs.f, policy=inputs.policy,
            fused=True, device=device)
    t1 = time.perf_counter()
    with span("bench.is_latency_feasible"):
        ok = core.is_latency_feasible(ps, scheme, inputs.t, policy=inputs.policy, device=device)
    t2 = time.perf_counter()
    c1 = counters()
    return {"scheme": scheme, "feasible": bool(ok), "paths": ps.n_paths,
            "start": t0, "end": t2, "replicate_s": t1 - t0, "feasible_s": t2 - t1,
            "stage_s": dict(stats.stage_s), **{k: c1[k] - c0[k] for k in c0}}


def settle(drive: dict, inputs) -> None:
    """After the window: the drive's scheme as its mask, the overhead the
    program reports of it, and the overhead recomputed from the mask."""
    scheme = drive.pop("scheme")
    drive["reported"] = float(scheme.replication_overhead(inputs.f))
    drive["mask"] = np.array(scheme.mask, dtype=bool, copy=True)
    drive["overhead"] = check.overhead(drive["mask"], inputs.f)


def reference(inputs, paths, device, tf32: bool = False) -> dict:
    """The plain reference's provisioning of ``paths``."""
    out = greedy.provision(paths.objects, paths.lengths, inputs.home, inputs.n_servers,
                           inputs.t, inputs.f, device, policy=inputs.policy,
                           precision=inputs.cost_precision, tf32=tf32)
    out["objects"] = paths.objects
    return out


def judge(inputs, drives: list, seed: int, n_sample: int, device) -> tuple[dict, list]:
    """The numbers ``check.NAMES`` over the settled ``drives`` and the
    reference's account of each sampled drive."""
    rng = np.random.default_rng([seed & (2**64 - 1), 5])
    sample = sorted(rng.choice(len(drives), size=min(n_sample, len(drives)),
                               replace=False).tolist())
    refs = {i: reference(inputs, gen.order(inputs, seed, i), device) for i in sample}
    p = inputs.pool
    checks = check.judge(p.objects, p.lengths, inputs.home, inputs.f, inputs.t,
                         [d["mask"] for d in drives], [d["reported"] for d in drives],
                         [d["feasible"] for d in drives],
                         {i: r["mask"] for i, r in refs.items()}, torch.device(device))
    return checks, list(refs.values())
