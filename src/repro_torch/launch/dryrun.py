"""Dry-run: count every (arch x shape) cell of the registry on one card or
as one rank of a 256 / 512-card mesh (torch port of
``repro.launch.dryrun``).

The JAX dry-run lowers and compiles each cell for 256 / 512 TPU chips on
placeholder host devices and reads the compiled per-chip program's memory
and cost analyses.  The port compiles nothing ahead of time; for each of
the same 36 cells it:

  1. builds the step's full-size arguments (parameters, AdamW moments,
     batch or cache) as ``meta`` tensors: nothing is allocated;
  2. runs the step on them once under an op census
     (:func:`repro_torch.analysis.hlo.count_step`): the matmul FLOPs by
     ``FlopCounterMode``'s formulas (``hlo_flops``), the input + output
     bytes of every aten op but views (``hlo_bytes``), the op census, and
     the peak of the live tensor bytes during the run, arguments included
     (``peak_mem_gb``);
  3. builds the ``Roofline`` row with the analytic model FLOPs, and
     whether the step fits the card (``fits_80gb``).

``--mesh h100x1`` (the default) counts the step on one card: no
collective.  ``single`` / ``multi`` count it per rank on the production
meshes, (16, 16) ``("data", "model")`` ("h100x16x16", 256 cards) and
(2, 16, 16) ``("pod", "data", "model")`` ("h100x2x16x16", 512 cards), as
rank 0 computes it: each cell in a spawned host process that brings up a
placeholder group of 256 / 512 ranks (``launch.mesh.init_placeholder_ranks``,
torch's ``fake`` backend), places the ``meta`` arguments by the bundle's
``shardings`` (each rank's slice, rank 0 holding the largest chunk of an
uneven split) and counts the step on that mesh; the row's collective term
prices each collective by the links its group spans
(``analysis.roofline``).  No cluster is run.

Most full-depth LM cells do not fit one card (qwen2-7b's ``decode_32k``
bf16 cache alone is ~240 GB); the dry-run reports it, it cuts nothing.

Usage (host only, no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --workers 6
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
import traceback

from torch.utils._pytree import tree_flatten

import torch.distributed as dist

from repro_torch.analysis import roofline as R
from repro_torch.analysis.hlo import count_step
from repro_torch.configs import arch_ids, get_arch
from repro_torch.launch.mesh import init_placeholder_ranks, make_production_mesh
from repro_torch.models.parallel import local, place_tree, use_mesh

MESH = "h100x1"
# --mesh -> (row name, cards, multi_pod)
POD_MESHES = {"single": ("h100x16x16", 256, False), "multi": ("h100x2x16x16", 512, True)}


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
    """Bytes of a tree's tensors, a DTensor by its local shard."""
    return sum(local(x).numel() * x.element_size() for x in tree_flatten(tree)[0]
               if hasattr(x, "element_size"))


def _count(bundle, shape_id: str, mesh: str):
    """(arguments as counted, census, seconds building them, seconds
    counting) of the cell on ``mesh``; a pod mesh brings up its
    placeholder group in this process and takes it down after."""
    if mesh == MESH:
        t0 = time.perf_counter()
        args = bundle.abstract_args(shape_id)
        step = bundle.step_fn(shape_id)
        t_args = time.perf_counter() - t0
        t0 = time.perf_counter()
        counts = count_step(step, args)
        return args, counts, t_args, time.perf_counter() - t0
    _, chips, multi_pod = POD_MESHES[mesh]
    # DTensor warns at each redistribute over two mesh dims in turn (the
    # data axes of the multi-pod mesh, or every axis): the layout wanted
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    init_placeholder_ranks(chips)
    try:
        t0 = time.perf_counter()
        m = make_production_mesh(multi_pod=multi_pod, device="cpu")
        in_specs, _ = bundle.shardings(shape_id, multi_pod)
        args = place_tree(bundle.abstract_args(shape_id, multi_pod), in_specs, m)
        step = bundle.step_fn(shape_id, multi_pod)
        t_args = time.perf_counter() - t0
        t0 = time.perf_counter()
        with use_mesh(m):
            counts = count_step(step, args)
        return args, counts, t_args, time.perf_counter() - t0
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_id: str, mesh: str = MESH, verbose: bool = True) -> dict:
    """The dry-run row of one cell on ``mesh`` ("h100x1", "single" or
    "multi"; see the module docstring).  A pod mesh brings up a process
    group in this process: call it where no other group is up (the
    dry-run's spawned workers)."""
    bundle = get_arch(arch)
    name, chips = (MESH, 1) if mesh == MESH else POD_MESHES[mesh][:2]
    args, counts, t_args, t_count = _count(bundle, shape_id, mesh)
    rf = R.analyze(arch, shape_id, name, chips, counts, model_flops_for(bundle, shape_id))
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
        print(f"--- {arch} x {shape_id} x {name} ---")
        print(json.dumps({k: row[k] for k in (
            "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
            "useful_frac", "roofline_frac", "peak_mem_gb", "fits_80gb")}, default=str))
    return row


def cell_row(cell: tuple) -> dict:
    """The row of one (arch, shape[, mesh]) cell; a failure becomes a
    "FAIL: ..." row."""
    arch, shape, mesh = (*cell, MESH)[:3]
    try:
        return run_cell(arch, shape, mesh, verbose=False)
    except Exception as e:
        traceback.print_exc()
        return {"arch": arch, "shape": shape,
                "mesh": MESH if mesh == MESH else POD_MESHES[mesh][0],
                "status": f"FAIL: {type(e).__name__}: {e}"}


def run_cells(cells: list[tuple], workers: int = 1):
    """Yield the rows of ``cells`` ((arch, shape) or (arch, shape, mesh))
    in order, each counted in one of ``workers`` host processes (``spawn``:
    they never touch a card; a pod cell always goes to one, so the
    caller's process never holds a placeholder group); a failed cell's row
    has ``status`` "FAIL: ..."."""
    pods = any(len(c) > 2 and c[2] != MESH for c in cells)
    if workers <= 1 and not pods:
        yield from map(cell_row, cells)
        return
    import multiprocessing as mp

    # one cell per worker process: a placeholder group and a cell's
    # allocations end with the process
    with mp.get_context("spawn").Pool(max(workers, 1), maxtasksperchild=1) as pool:
        yield from pool.imap(cell_row, cells)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=[MESH, "single", "multi", "both"], default=MESH,
                    help="h100x1 (one card), or per rank on the (16, 16) / (2, 16, 16) "
                         "meshes of 256 / 512 cards (single / multi / both)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--workers", type=int, default=1, help="host processes counting cells")
    args = ap.parse_args()
    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])

    pairs: list[tuple[str, str]] = []
    if args.all or args.arch is None:
        for a in arch_ids():
            for s in get_arch(a).shape_ids():
                pairs.append((a, s))
    else:
        shapes = ([args.shape] if args.shape
                  else get_arch(args.arch).shape_ids())
        pairs = [(args.arch, s) for s in shapes]
    cells = [(a, s, m) for m in meshes for a, s in pairs]

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
