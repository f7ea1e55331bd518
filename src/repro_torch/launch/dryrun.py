"""One-card dry-run: count every (arch x shape) cell of the registry
(torch port of ``repro.launch.dryrun``).

The JAX dry-run lowers and compiles each cell for 256 / 512 TPU chips on
placeholder host devices and reads the compiled artifact's memory and
cost analyses.  The port targets one H100 and compiles nothing ahead of
time; for each of the same 36 cells it:

  1. builds the step's full-size arguments (parameters, AdamW moments,
     batch or cache) as ``meta`` tensors: nothing is allocated;
  2. runs the step on them once under an op census
     (:func:`repro_torch.analysis.hlo.count_step`): the matmul FLOPs by
     ``FlopCounterMode``'s formulas (``hlo_flops``), the input + output
     bytes of every aten op but views (``hlo_bytes``), the op census, and
     the peak of the live tensor bytes during the run, arguments included
     (``peak_mem_gb``);
  3. builds the ``Roofline`` row (``mesh`` "h100x1", one chip, no
     collective term) with the analytic model FLOPs, and whether the step
     fits the card (``fits_80gb``).

Most full-depth LM cells do not fit one card (qwen2-7b's ``decode_32k``
bf16 cache alone is ~240 GB); the dry-run reports it, it cuts nothing.
A ``--mesh`` of TPU pods is refused (one card).

Usage (host only, no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from torch.utils._pytree import tree_flatten

from repro_torch.analysis import roofline as R
from repro_torch.analysis.hlo import count_step
from repro_torch.configs import arch_ids, get_arch
from repro_torch.engine.sharding import refuse_multi_card

MESH = "h100x1"


def model_flops_for(bundle, shape_id: str) -> float:
    cell = bundle.cells[shape_id]
    m = cell.meta
    if bundle.family == "lm":
        cfg = bundle.config
        if cell.kind == "train":
            return R.lm_model_flops(cfg, m["batch"] * m["seq"], "train",
                                    kv_len=m["seq"])
        if cell.kind == "prefill":
            return R.lm_model_flops(cfg, m["batch"] * m["seq"], "prefill",
                                    kv_len=m["seq"])
        return R.lm_model_flops(cfg, m["batch"], "decode", kv_len=m["seq"])
    if bundle.family == "gnn":
        from repro_torch.configs.gnn_family import cfg_for_cell

        cfg = cfg_for_cell(bundle, shape_id)
        if shape_id == "minibatch_lg":
            B = m["batch"]
            f1, f2 = m["fanouts"]
            n, e = B * (1 + f1 + f1 * f2), B * (f1 + f1 * f2)
        elif shape_id == "molecule":
            n, e = m["batch"] * m["n"], m["batch"] * m["e"]
        else:
            n, e = m["n"], m["e"]
        return R.gnn_model_flops(cfg, n, e, "train")
    # recsys
    cfg = bundle.config
    if cell.kind == "train":
        return R.mind_model_flops(cfg, m["batch"], m["batch"], "train")
    if cell.kind == "serve":
        from repro_torch.configs.recsys_family import N_CANDIDATES_ONLINE

        return R.mind_model_flops(cfg, m["batch"], N_CANDIDATES_ONLINE,
                                  "serve")
    return R.mind_model_flops(cfg, m["batch"], m["n_candidates"], "serve")


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0]
               if hasattr(x, "element_size"))


def run_cell(arch: str, shape_id: str, verbose: bool = True) -> dict:
    """The dry-run row of one cell (see the module docstring)."""
    bundle = get_arch(arch)
    t0 = time.perf_counter()
    args = bundle.abstract_args(shape_id)
    step = bundle.step_fn(shape_id)
    t_args = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = count_step(step, args)
    t_count = time.perf_counter() - t0
    rf = R.analyze(arch, shape_id, MESH, 1, counts, model_flops_for(bundle, shape_id))
    row = rf.row()
    row.update({
        "hlo_bytes": rf.hlo_bytes,
        "arg_gb": tree_bytes(args) / 2**30,
        "t_args_s": round(t_args, 3),
        "t_count_s": round(t_count, 3),
        "collectives": rf.collectives,
        "ops": rf.ops,
        "status": "ok",
    })
    if verbose:
        print(f"--- {arch} x {shape_id} x {MESH} ---")
        print(json.dumps({k: row[k] for k in (
            "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
            "useful_frac", "roofline_frac", "peak_mem_gb", "fits_80gb")}, default=str))
    return row


def cell_row(cell: tuple[str, str]) -> dict:
    """The row of one (arch, shape) cell; a failure becomes a "FAIL: ..." row."""
    arch, shape = cell
    try:
        return run_cell(arch, shape, verbose=False)
    except Exception as e:
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": MESH,
                "status": f"FAIL: {type(e).__name__}: {e}"}


def run_cells(cells: list[tuple[str, str]], workers: int = 1):
    """Yield the rows of ``cells`` in order, each counted in one of
    ``workers`` host processes (``spawn``: they never touch a card); a
    failed cell's row has ``status`` "FAIL: ..."."""
    if workers <= 1:
        yield from map(cell_row, cells)
        return
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(workers) as pool:
        yield from pool.imap(cell_row, cells)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=[MESH, "single", "multi", "both"], default=MESH,
                    help="h100x1 (one card); the JAX dry-run's TPU pod meshes are refused")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--workers", type=int, default=1, help="host processes counting cells")
    args = ap.parse_args()
    if args.mesh != MESH:
        refuse_multi_card(f"--mesh {args.mesh} (TPU v5e pods)")

    cells: list[tuple[str, str]] = []
    if args.all or args.arch is None:
        for a in arch_ids():
            for s in get_arch(a).shape_ids():
                cells.append((a, s))
    else:
        shapes = ([args.shape] if args.shape
                  else get_arch(args.arch).shape_ids())
        cells = [(args.arch, s) for s in shapes]

    rows = []
    for row in run_cells(cells, args.workers):
        rows.append(row)
        print(json.dumps(row, default=str), flush=True)
    failures = sum(1 for r in rows if r.get("status") != "ok")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as fh:
            for r in rows:
                fh.write(json.dumps(r, default=str) + "\n")
    ok = sum(1 for r in rows if r.get("status") == "ok")
    print(f"\ndry-run cells: {ok} ok / {len(rows)} total")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
