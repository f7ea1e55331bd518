#!/usr/bin/env python3
"""The lower-precision control of the correctness check.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...] [--device cuda]

The cell's inputs are made as a run makes them; for each seed, on the
paths in the order of that seed's first drive, the plain reference is
put in the program's place computed one precision below the
configuration's float32 candidate costs: the sizes rounded to TF32 (10
mantissa bits), and the storage overhead it reports summed in float32.  Its scheme is judged by the comparison a run makes against the
float32 reference (``bench.reference.check``), and each number is printed
beside the cell's limit: the control has to come out not correct.  The
benchmark's own runs never run this.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def control_checks(cell, inputs, seed: int, device) -> dict:
    """The numbers the check compares, for the control on the first
    drive's order under ``seed``."""
    import numpy as np
    import torch

    from bench import gen
    from bench.drives import provision
    from bench.reference import check
    from bench.reference.walk import hops

    dev = torch.device(device)
    paths = gen.order(inputs, seed, 0)
    ref = provision.reference(inputs, paths, dev)
    ctl = provision.reference(inputs, paths, dev, tf32=True)
    f32 = inputs.f.astype(np.float32)
    counts = ctl["mask"].sum(1).astype(np.float32)
    orig = np.sum(f32, dtype=np.float32)
    reported = float((np.sum(f32 * counts, dtype=np.float32) - orig) / orig)
    p = inputs.pool
    h = hops(torch.from_numpy(p.objects).to(dev), torch.from_numpy(p.lengths).to(dev),
             torch.from_numpy(ctl["mask"]).to(dev),
             torch.from_numpy(inputs.home.astype(np.int64)).to(dev))
    return check.judge(p.objects, p.lengths, inputs.home, inputs.f, inputs.t, [ctl["mask"]],
                       [reported], [bool((h <= inputs.t).all())], {0: ref["mask"]}, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from bench import harness

    import torch

    from bench import gen

    cell = harness.load_cell(args.workload)
    inputs = gen.make_inputs(cell.config, cell.traffic, torch.device(args.device))
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control_checks(cell, inputs, seed, args.device)
        judged = {k: {"value": v, "limit": cell.limits[k]} for k, v in got.items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": all(v["value"] <= v["limit"] for v in judged.values()),
                          "seconds": time.perf_counter() - t0, "checks": judged}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
