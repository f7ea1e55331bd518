"""The comparison that decides ``correct``: the numbers judged, each
against the limit the cell's limits file gives it.

Of every drive in the window the returned scheme and what the program
said of it are judged against the plain reference:

* ``mask_cells_off``: (object, server) cells where a sampled drive's mask
  and the reference's mask for that drive's order differ, the most over
  the sampled drives;
* ``paths_over_t``: paths whose traversal count under the drive's mask,
  by the reference's walk, exceeds t, summed over the drives;
* ``homes_missing``: objects whose home copy the mask lacks, summed;
* ``overhead_gap``: the largest relative gap between the storage overhead
  the program reported and the one recomputed from the mask and f;
* ``feasible_off``: drives whose feasibility answer differs from the
  reference walk's.

A path's traversal count depends on the mask alone, not on the order the
paths came in, so every drive's paths are walked in the pool's order.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference.walk import hops

NAMES = ("mask_cells_off", "paths_over_t", "homes_missing", "overhead_gap", "feasible_off")


def overhead(mask: np.ndarray, f: np.ndarray) -> float:
    """Replicated bytes over original bytes (the paper's Fig 2d / 6
    quantity), float64."""
    orig = float(np.sum(f, dtype=np.float64))
    return (float(np.dot(f.astype(np.float64), mask.sum(1))) - orig) / orig


def judge(objects: np.ndarray, lengths: np.ndarray, home: np.ndarray, f: np.ndarray, t: int,
          masks: list, reported: list, feasible: list, ref_masks: dict, device) -> dict:
    """The five numbers over the drives' ``masks`` (bool [n, S] each), the
    overheads they ``reported`` and their ``feasible`` answers;
    ``ref_masks`` maps a sampled drive's index to the reference's mask for
    its order."""
    dev = torch.device(device)
    o = torch.from_numpy(objects).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    home_d = torch.from_numpy(home.astype(np.int64)).to(dev)
    n = home.shape[0]
    out = dict.fromkeys(NAMES, 0)
    out["overhead_gap"] = 0.0
    for i, (mask, rep, ok) in enumerate(zip(masks, reported, feasible)):
        if i in ref_masks:
            out["mask_cells_off"] = max(out["mask_cells_off"],
                                        int(np.count_nonzero(mask != ref_masks[i])))
        over = int((hops(o, ln, torch.from_numpy(mask).to(dev), home_d) > t).sum())
        out["paths_over_t"] += over
        out["homes_missing"] += int(n - np.count_nonzero(mask[np.arange(n), home]))
        want = overhead(mask, f)
        out["overhead_gap"] = max(out["overhead_gap"], abs(rep - want) / max(abs(want), 1e-300))
        out["feasible_off"] += int(bool(ok) != (over == 0))
    return out
