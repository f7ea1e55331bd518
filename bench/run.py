#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port on this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The process runs its host work on one thread.  Prints progress and, as
its last lines on standard error, each number the correctness check
compared beside its limit; the last line of standard
output is the result as one JSON object.  Exits 2 without a result when
the machine lacks the CUDA devices the cell asks for, and 3 when JAX,
Flax or the JAX package ``repro`` was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with one compute thread: the program's host work (numpy,
# torch's CPU ops, BLAS) runs single-threaded, so a run takes one core of
# the host and its readings do not hang on how many others are free
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: the cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START,
                           log=lambda msg: print(f"bench: {msg}", file=sys.stderr, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
