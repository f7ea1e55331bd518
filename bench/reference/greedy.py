"""Latency-bound greedy replication (paper Alg 1 + Alg 2) with the
``nearest_copy`` gate and prune, written plainly in torch and Python.

The procedure a provisioning drive must follow, step by step:

1. Paths that share their root's server, their length and every access
   after the root are one constraint (paper §5.3): keep the first of each.
2. Every object starts with its home copy only.  A path's subpaths are its
   maximal runs on one home server (Def 5.1); h under d is their number
   less one.
3. The paths over budget under the ``nearest_copy`` walk are priced in
   batches of 256 against the scheme as it stands before the batch.  A
   path whose walk is within ``t`` against that snapshot, or whose h under
   d is, buys nothing.  Otherwise each of its C(h, t) retained-subpath
   sets is a candidate: every access x in a dropped subpath is copied to
   the server of each subpath k with j <= k < seg(x), j the last retained
   subpath at or before seg(x), where that server lacks it.  A candidate's
   cost is the float32 sum of f over those copies, added in order of x,
   then k; the cheapest candidate wins, the lowest index on ties.  All
   winners' copies land after the batch is priced.
4. Up to two more rounds re-run step 3 over the paths still over budget.
5. If no path is then over budget, the replicas (copies other than the
   home) are visited largest f first (ties in (object, server) order), and
   each is dropped when every path through its object stays within ``t``
   without it.

This module imports nothing of the program.  The greedy prices the sizes
f in float32; ``tf32=True`` rounds them to TF32 (10 mantissa bits)
first: the lower-precision control.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from bench.reference.walk import bits_of, hops, hops_one

BATCH = 256
MAX_CANDIDATES = 2048
REVALIDATE_ROUNDS = 2
_INF = 1e30


def round_tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to nearest (ties to even) at TF32's 10
    mantissa bits."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~np.uint64(0x1FFF)
    return b.astype(np.uint32).view(np.float32)


def n_candidates(h: int, t: int) -> int:
    return 1 if h <= t else math.comb(h, t)


def candidate_tables(H: int, t: int) -> tuple[np.ndarray, np.ndarray]:
    """bool [H + 1, C, H + 1] retained-subpath sets for each h (subpath 0
    always retained; one all-retained row for h <= t), padded with True
    rows, and int32 [H + 1] counts."""
    per_h = []
    for h in range(H + 1):
        if h <= t:
            per_h.append(np.ones((1, h + 1), bool))
            continue
        rows = []
        for subset in itertools.combinations(range(1, h + 1), t):
            sel = np.zeros(h + 1, bool)
            sel[0] = True
            sel[list(subset)] = True
            rows.append(sel)
        per_h.append(np.stack(rows))
    C = max(x.shape[0] for x in per_h)
    tables = np.ones((H + 1, C, H + 1), bool)
    counts = np.zeros(H + 1, np.int32)
    for h, x in enumerate(per_h):
        tables[h, : x.shape[0], : h + 1] = x
        counts[h] = x.shape[0]
    return tables, counts


def subpaths(objects: torch.Tensor, lengths: torch.Tensor, home: torch.Tensor):
    """(seg int32 [P, L] subpath index per access, -1 pad; h int32 [P])."""
    P, L = objects.shape
    dev = objects.device
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < lengths[:, None]
    hm = torch.where(valid, home[objects.clamp_min(0).long()], -1)
    prev = torch.cat([torch.full((P, 1), -2, dtype=hm.dtype, device=dev), hm[:, :-1]], 1)
    seg = torch.where(valid, torch.cumsum((valid & (pos > 0) & (hm != prev)).int(), 1), -1)
    return seg.int(), torch.where(valid, seg, 0).amax(1).int()


def _price_batch(mask, o, ln, home, f, tables, counts, t: int) -> int:
    """Step 3 for one batch against ``mask`` (bool [n, S], updated in
    place); returns the number of (access, server) copies chosen."""
    B, L = o.shape
    Hc, C, Hp1 = tables.shape
    dev = o.device
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < ln[:, None]
    safe = o.clamp_min(0).long()
    hm = torch.where(valid, home[safe], -1)
    seg, h = subpaths(o, ln, home)
    ar = torch.arange(Hp1, device=dev)
    srv = torch.stack([torch.where(valid & (seg == k), hm + 1, 0).amax(1) - 1
                       for k in range(Hp1)], 1)  # [B, Hp1]
    gate = (h > t) & (hops(o, ln, mask, home) > t)
    srv_c = srv.clamp_min(0)
    present = mask[safe[:, :, None], srv_c[:, None, :]]
    needed = ~present & (srv >= 0)[:, None, :] & valid[:, :, None]
    h_cl = h.long().clamp(0, Hp1 - 1)
    in_tab = h_cl < Hc
    h_tab = h_cl.clamp(max=Hc - 1)
    n_cand = torch.where(in_tab, counts[h_tab], 0)
    sel = tables[h_tab] & in_tab[:, None, None]
    last_kept = torch.cummax(torch.where(sel, ar, -1), dim=2).values  # [B, C, Hp1]
    seg_e = seg.long().clamp(0, Hp1 - 1)[:, None, :].expand(B, C, L)
    j = last_kept.gather(2, seg_e)
    window = ((ar >= j[..., None]) & (ar < seg_e[..., None])
              & valid[:, None, :, None] & gate[:, None, None, None])
    add = window & needed[:, None]  # [B, C, L, Hp1]
    fx = f[safe] * valid.float()
    cost = torch.zeros((B, C), dtype=torch.float32, device=dev)
    for x in range(L):
        for k in range(Hp1):
            cost = cost + torch.where(add[:, :, x, k], fx[:, x, None], 0.0)
    cost = torch.where(torch.arange(C, device=dev)[None, :] < n_cand[:, None], cost, _INF)
    best = torch.argmin(cost, 1)
    none = cost.gather(1, best[:, None])[:, 0] >= _INF
    chosen = add[torch.arange(B, device=dev), best] & ~none[:, None, None]
    obj = safe[:, :, None].expand(B, L, Hp1)[chosen]
    mask[obj, srv_c[:, None, :].expand(B, L, Hp1)[chosen]] = True
    return int(chosen.sum())


def _run_class(mask, o, ln, home, f, t: int, record: list | None) -> None:
    """Step 3 over the rows ``o`` / ``ln`` (device) of one budget."""
    _, h = subpaths(o, ln, home)
    kept = torch.nonzero(hops(o, ln, mask, home) > t)[:, 0]
    if kept.numel() == 0:
        return
    h_kept = h[kept]
    H_needed = int(h_kept.max())
    H_vec = 0
    for hh in range(H_needed + 1):
        if n_candidates(hh, t) > MAX_CANDIDATES:
            break
        H_vec = hh
    if bool((h_kept > H_vec).any()):
        raise NotImplementedError(
            f"paths with h > {H_vec} need the exact sequential UPDATE, which this "
            "reference does not carry")
    tables_np, counts_np = candidate_tables(max(H_vec, t, 1), t)
    tables = torch.from_numpy(tables_np).to(o.device)
    counts = torch.from_numpy(counts_np).to(o.device)
    vo, vl = o[kept], ln[kept]
    adds = [_price_batch(mask, vo[i : i + BATCH], vl[i : i + BATCH], home, f, tables, counts, t)
            for i in range(0, vo.shape[0], BATCH)]
    if record is not None:
        record.append({"objects": vo.cpu().numpy(), "lengths": vl.cpu().numpy(),
                       "tables": tables_np.shape, "additions": adds})


def dedup_paths(objects: np.ndarray, lengths: np.ndarray, home: np.ndarray, t: int):
    """Step 1: row indices of the first path of each equivalence class."""
    root = home[np.maximum(objects[:, 0], 0)].astype(np.int64)
    key = np.concatenate([root[:, None], lengths[:, None].astype(np.int64),
                          objects[:, 1:].astype(np.int64),
                          np.full((len(objects), 1), t, np.int64)], 1)
    _, first = np.unique(key, axis=0, return_index=True)
    return np.sort(first)


def path_index(objects: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR object -> path rows (with multiplicity): (starts int64 [n + 1],
    rows int32 [nnz]), rows of one object in path order."""
    valid = objects >= 0
    flat_v = objects[valid].astype(np.int64)
    flat_p = np.repeat(np.arange(objects.shape[0]), objects.shape[1])[valid.ravel()]
    order = np.argsort(flat_v, kind="stable")
    return np.searchsorted(flat_v[order], np.arange(n + 1)), flat_p[order].astype(np.int32)


def serial_prune(mask: np.ndarray, home: np.ndarray, objects: np.ndarray,
                 lengths: np.ndarray, t: int, f64: np.ndarray):
    """Step 5 on ``mask`` (bool [n, S], pruned in place).  Returns the
    candidates in visiting order (object, server int32) and which were
    dropped."""
    n = mask.shape[0]
    repl = mask.copy()
    repl[np.arange(n), home] = False
    vs, ss = np.nonzero(repl)
    order = np.argsort(-f64[vs], kind="stable")
    cand_v, cand_s = vs[order].astype(np.int32), ss[order].astype(np.int32)
    starts, rows = path_index(objects, n)
    st, rw = starts.tolist(), rows.tolist()
    paths = [row[:k] for row, k in zip(objects.tolist(), lengths.tolist())]
    bits = bits_of(mask)
    hl = home.tolist()
    dropped = np.zeros(len(cand_v), bool)
    for c, (v, s) in enumerate(zip(cand_v.tolist(), cand_s.tolist())):
        before = bits[v]
        bits[v] = before & ~(1 << s)
        if all(hops_one(paths[p], bits, hl, t) <= t for p in rw[st[v] : st[v + 1]]):
            dropped[c] = True
        else:
            bits[v] = before
    mask[cand_v[dropped], cand_s[dropped]] = False
    return cand_v, cand_s, dropped, starts, rows


POLICIES = ("nearest_copy",)
PRECISIONS = ("float32",)


def provision(objects: np.ndarray, lengths: np.ndarray, home: np.ndarray, n_servers: int,
              t: int, f: np.ndarray, device, policy: str = "nearest_copy",
              precision: str = "float32", tf32: bool = False) -> dict:
    """Steps 1-5 for one workload under the routing ``policy`` with the
    candidate costs in ``precision`` (only ``nearest_copy`` and float32
    are written here: any other is refused).  Returns the final ``mask``
    (bool [n, S]), ``pre_prune`` (the mask before step 5), ``violations``
    (paths over budget after step 4), ``classes`` (per UPDATE pass: its
    rows, table shape and copies per batch) and ``prune`` (the step-5
    candidates and index)."""
    if policy not in POLICIES:
        raise ValueError(f"the reference has no routing policy {policy!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"the reference has no cost precision {precision!r}")
    f32 = np.asarray(f, np.float32)
    if tf32:
        f32 = round_tf32(f32)
    n = home.shape[0]
    dev = torch.device(device)
    home_d = torch.from_numpy(home.astype(np.int64)).to(dev)
    f_d = torch.from_numpy(f32).to(dev)
    keep = dedup_paths(objects, lengths, home, t)
    o = torch.from_numpy(objects[keep]).to(dev)
    ln = torch.from_numpy(lengths[keep]).to(dev)
    mask = torch.zeros((n, n_servers), dtype=torch.bool, device=dev)
    mask[torch.arange(n, device=dev), home_d] = True
    classes: list = []
    _run_class(mask, o, ln, home_d, f_d, t, classes)
    viol = torch.nonzero(hops(o, ln, mask, home_d) > t)[:, 0]
    for _ in range(REVALIDATE_ROUNDS):
        if viol.numel() == 0:
            break
        _run_class(mask, o[viol], ln[viol], home_d, f_d, t, classes)
        viol = torch.nonzero(hops(o, ln, mask, home_d) > t)[:, 0]
    out = {"pre_prune": mask.cpu().numpy(), "violations": int(viol.numel()),
           "classes": classes, "prune": None}
    final = out["pre_prune"].copy()
    all_ok = bool((hops(torch.from_numpy(objects).to(dev), torch.from_numpy(lengths).to(dev),
                        mask, home_d) <= t).all())
    if all_ok:
        cand_v, cand_s, dropped, starts, rows = serial_prune(
            final, home, objects, lengths, t, f32.astype(np.float64))
        out["prune"] = {"cand_v": cand_v, "cand_s": cand_s, "dropped": dropped,
                        "starts": starts, "rows": rows}
    out["mask"] = final
    return out
