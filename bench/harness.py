"""One run of one benchmark cell of the PyTorch/CUDA port (``repro_torch``).

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file, ``bench/traffic/<traffic>.json``,
``bench/limits/<cell>.json``, the drive the traffic names
(``bench/drives/<drive>.py``), the program's counters
(``bench/counters/*.json``, one file per counter source) and one reader
per metric (``bench/metrics/<metric>.py``).

Set-up makes the inputs and runs one drive (in the pool's own order) to
warm every shape; the window then runs drives back to back (closed loop),
each on the pool's paths in an order of its own drawn from the run's seed
and the drive's index, until ``seconds`` have passed, and closes at the
end of the last drive.  After the window the program's state is freed and
the drive module judges the drives against the plain reference.  With
``trace`` the window runs under ``torch.profiler`` and the cell's
per-layer metrics are read; without it its end-to-end metrics.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import pathlib
import resource
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    reference_drives: int
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files and metrics."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]
    limits = json.loads((root / "bench" / "limits" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / cfg_entry["file"]).read_text()),
        traffic=json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=limits["limits"], reference_drives=int(limits["reference_drives"]),
        end_to_end=e2e, per_layer=per_layer,
    )


def reader(metric: str, root: pathlib.Path = ROOT):
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def drive_module(traffic: dict):
    """``bench/drives/<drive>.py`` of the traffic file's ``drive``."""
    name = traffic["drive"]
    if not name.isidentifier():
        raise ValueError(f"bad drive name {name!r}")
    return importlib.import_module(f"bench.drives.{name}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# counters the program keeps
# ---------------------------------------------------------------------------
def counter_reader(root: pathlib.Path = ROOT):
    """A function that reads every counter of ``bench/counters/*.json``
    (each file one source: ``module``, a dotted ``attr`` in it, and the
    ``counter`` it adds to) and returns their sums by counter."""
    sources = []
    for path in sorted((root / "bench" / "counters").glob("*.json")):
        spec = json.loads(path.read_text())
        sources.append((spec["counter"], importlib.import_module(spec["module"]),
                        spec["attr"].split(".")))

    def read() -> dict:
        out: dict = {}
        for counter, mod, attrs in sources:
            v = mod
            for a in attrs:
                v = getattr(v, a)
            out[counter] = out.get(counter, 0) + v
        return out

    return read


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------
def _short(name: str) -> str:
    """A device op's name without its return type, namespaces, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    for stop in ("<", "("):
        name = name.split(stop)[0]
    return name.rsplit("::", 1)[-1].strip()[:64]


def read_trace(prof) -> dict:
    """Device operations and harness spans of a profiled window, in
    seconds: each device op (kernel, copy, set) in the window, the busy
    time (their union), the window, the top device ops by total time and
    the longest idle gaps, named by the device op they follow and the
    harness spans in which they start and end."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof.events():
        if e.name.startswith("bench."):
            # the harness's spans, also mirrored on the device's timeline
            if e.device_type != DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            ops.append((e.time_range.start, e.time_range.end, e.name))
    drives = [s for s in spans if s[2] == "bench.replicate_workload"]
    lo = min(s[0] for s in drives)
    hi = max(s[1] for s in spans)
    ops = sorted((max(a, lo), min(b, hi), n) for a, b, n in ops if b > lo and a < hi)
    busy, gaps, end, last = 0.0, [], lo, "window start"
    for a, b, n in ops:
        if a > end:
            gaps.append((a - end, end, last))
        if b > end:
            busy += b - max(a, end)
            end = b
            last = _short(n)
    if hi > end:
        gaps.append((hi - end, end, last))
    gaps = [(g, s, after, s + g) for g, s, after in gaps]
    totals: dict = {}
    for a, b, n in ops:
        totals[_short(n)] = totals.get(_short(n), 0.0) + (b - a) * 1e-6

    def where(t_us):
        inside = [s for s in spans if s[0] <= t_us < s[1]]
        return inside[-1][2][len("bench."):] if inside else "between drives"

    gaps.sort(reverse=True)
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy * 1e-6,
        "ops": [(n, (b - a) * 1e-6) for a, b, n in ops],
        "device_ops": sorted(([k, v] for k, v in totals.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": [[f"after {after}, {where(s)} -> {where(e)}", g * 1e-6]
                      for g, s, after, e in gaps[:10]],
    }


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Run:
    """What the metric readers read: the inputs, each drive's record
    (spans, stage seconds, counter deltas, the overheads), the trace (None
    untraced), the reference's account of each sampled drive, the window's
    and the set-up's seconds."""

    inputs: object
    drives: list
    trace: dict | None
    references: list
    window_s: float = 0.0
    setup_s: float = 0.0


class _GcClock:
    """Seconds the interpreter spent in garbage collection while on."""

    def __init__(self):
        self.s, self.n, self._t = 0.0, 0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t
            self.n += 1


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=None) -> dict:
    """Set up, warm, run the window, judge it; returns the result line's
    fields (``checks`` last).  ``t_start`` is the process's start on the
    ``time.perf_counter`` clock; ``log`` takes progress lines (default:
    standard error)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    import torch

    import repro_torch.core as core
    from bench import gen

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drive = drive_module(cell.traffic)
    counters = counter_reader()
    inputs = gen.make_inputs(cell.config, cell.traffic, dev)
    log(f"inputs {json.dumps(inputs.facts)} (set-up {time.perf_counter() - t_start:.3f} s)")
    drive.run(core, inputs, inputs.pool, dev, counters)  # warm-up: every kernel and shape
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    prof = None
    span = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function
    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    load0 = os.getloadavg()
    drives = []
    w0 = time.perf_counter()
    while not drives or time.perf_counter() - w0 < seconds:
        paths = gen.order(inputs, seed, len(drives))
        drives.append(drive.run(core, inputs, paths, dev, counters, *([span] if span else [])))
        del paths
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    load1 = os.getloadavg()
    gc.callbacks.remove(gc_clock)
    window_s = drives[-1]["end"] - drives[0]["start"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if prof is not None:
        prof.__exit__(None, None, None)
    tr = read_trace(prof) if prof is not None and dev.type == "cuda" else None
    prof = None
    log(f"window {window_s} s, {len(drives)} drives, {sum(d['paths'] for d in drives)} paths")
    log("drive s " + " ".join(f"{d['end'] - d['start']:.3f}" for d in drives))
    log(f"host in the window: user {ru1.ru_utime - ru0.ru_utime:.3f} s, system "
        f"{ru1.ru_stime - ru0.ru_stime:.3f} s, minor faults {ru1.ru_minflt - ru0.ru_minflt}, "
        f"involuntary switches {ru1.ru_nivcsw - ru0.ru_nivcsw}, voluntary "
        f"{ru1.ru_nvcsw - ru0.ru_nvcsw}, gc {gc_clock.s:.3f} s in {gc_clock.n}; load average "
        f"{load0[0]:.2f} -> {load1[0]:.2f} on {os.cpu_count()} cores")

    for d in drives:
        drive.settle(d, inputs)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    checks, refs = drive.judge(inputs, drives, seed, cell.reference_drives, dev)
    log(f"reference {time.perf_counter() - r0} s over {len(refs)} drives")

    run = Run(inputs, drives, tr, refs, window_s, setup_s)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    judged = {k: {"value": checks[k], "limit": cell.limits[k]} for k in checks}
    out = {
        "correct": all(v["value"] <= v["limit"] for v in judged.values()),
        "attempted": sum(d["paths"] for d in drives),
        "failed": checks[drive.FAILED],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if tr is not None:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = judged
    return out
