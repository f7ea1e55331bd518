"""The fused greedy UPDATE (paper Alg 2 hot loop): one round over a path
batch, or a whole budget class in snapshot batches.

Replaces the TPU kernel ``fused_update_pallas`` in
``src/repro/kernels/provision_update.py`` (``_make_kernel``) and the
greedy's per-batch loop around it.  Per path, against one snapshot of
the packed words: the policy-routed gate walk, the server-local subpaths
under d (Def 5.1), the needed bit-tests, and the strict argmin over the
C(h, t) candidates' float32 costs; the winner's additions are then
OR-ed into the words before the next batch prices.

The CUDA source is ``repro_torch/csrc/provision_update.cu``: one
cooperative launch per class (:func:`fused_update_class`; one per round
for :func:`fused_update`, the one-batch case) that loops over the
batches with a grid-wide barrier after pricing a batch and another after
OR-ing its additions in with ``atomicOr``.  One warp per path, lanes
striding over the candidates, a shuffle reduction for the argmin (ties
-> lowest index).  It takes any L and W: a path of at most ``SHARED_L``
positions keeps its state in shared memory, a longer one in a device
scratch for one batch that this wrapper allocates.  Gate modes: ``none``
(``pol=None``), ``routed`` (with or without lookahead; ``rank`` is the
``[W*32]`` holder rank) and ``scored`` (``nearest_copy_dp``: the kernel
rebuilds each path's DP hop values from its words, so no score plane is
built; the plain version computes the DP tables with torch ops, as the
JAX package does before its kernel).

Bound on the card: bytes (objects, touched words, homes and sizes, the
``[B, L, Hp1]`` chosen plane); the candidate loop's sum_b n_cand(h_b) * L
mask operations are far below the card's integer rate at the C(h, t)
sizes the greedy vectorises.

Each candidate's cost is summed x-major over ``[L, Hp1]`` in float32, in
the kernel (``__fadd_rn``) and in :func:`fused_update_plain` alike, so the
two agree exactly.  The JAX package's kernel reduces in XLA's order: its
costs equal these exactly when every sum is exact (sizes that are
multiples of 1/8, for instance) and to float32 rounding otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.backends import _dp_depth, _dp_score_tables
from repro_torch.engine.packed import scatter_or_pairs, test_bits
from repro_torch.kernels.build import check_launch, load_library
from repro_torch.kernels.routed_walk import routed_walk_plain, scored_walk_plain

LAUNCHES = 0

_INF = 1e30
# the kernel's shared-memory tier (csrc kSmallL): L and Hp1 up to 64, one
# 64-bit mask per position over the subpaths; longer paths use the scratch
SHARED_L = 64

_GATE = {"none": 0, "routed": 1, "scored": 2}


def _gate_mode(pol) -> str:
    if pol is None:
        return "none"
    return "scored" if pol.name == "nearest_copy_dp" else "routed"


def fused_update_plain(words, objects, lengths, shard, f, tables, counts, t,
                       rank, pol=None):
    """Plain torch version: ``(words, applied_cost, no_solution, chosen,
    srv, skipped)``; OR-s the chosen additions into ``words`` in place.

    ``words`` int32 [(n+1), W] (sacrificial last row), ``objects`` int32
    [B, L] (-1 pad), ``lengths`` / ``t`` int32 [B], ``shard`` int32 [n],
    ``f`` float32 [n], ``tables`` bool [Hc, C, Hp1] candidate retained
    sets, ``counts`` int32 [Hc], ``rank`` float32 [W*32] (the gate's
    holder rank), ``pol`` a resolved non-home-first policy or None (no
    gate).  Mirrors the TPU kernel op for op: ``srv[k]`` from the
    positions with ``seg == k``, ``h`` clipped to ``Hp1 - 1``, ``n_cand``
    = ``counts[h]`` (0 beyond ``Hc``), strict argmin with ties to the
    lowest candidate, costs summed x-major over ``[L, Hp1]``.
    """
    B, L = objects.shape
    Hc, C, Hp1 = tables.shape
    dev = objects.device
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < lengths[:, None]
    safe = objects.clamp_min(0).long()
    home = torch.where(valid, shard[safe], -1).int()
    fpos = f[safe] * valid.to(torch.float32)
    start = shard[objects[:, 0].clamp_min(0).long()].int()

    # subpath structure under d (Def 5.1)
    prev = torch.cat(
        [torch.full((B, 1), -2, dtype=torch.int32, device=dev), home[:, :-1]], dim=1
    )
    boundary = valid & (pos > 0) & (home != prev)
    seg = torch.where(valid, torch.cumsum(boundary.int(), dim=1, dtype=torch.int32), -1)
    h = torch.where(valid, seg, 0).amax(dim=1)
    h_cl = h.clamp(0, Hp1 - 1).long()
    seg_cl = seg.clamp(0, Hp1 - 1).long()
    srv = torch.stack(
        [torch.where(valid & (seg == k), home + 1, 0).amax(dim=1) - 1 for k in range(Hp1)],
        dim=1,
    ).int()  # [B, Hp1]; -1 for absent subpaths

    # policy-routed gate walk against the snapshot
    over = h > t
    mode = _gate_mode(pol)
    if mode == "none":
        gate_ok = over
        skipped = torch.zeros_like(over)
    else:
        if mode == "scored":
            scores = _dp_score_tables(objects, lengths, words, _dp_depth(pol))
            _, local = scored_walk_plain(objects, lengths, words, shard, start, scores)
        else:
            _, local = routed_walk_plain(objects, lengths, words, shard, start, rank,
                                         lookahead=pol.lookahead)
        h_routed = (valid & ~local).sum(dim=1, dtype=torch.int32)
        gate_ok = over & (h_routed > t)
        skipped = over & (h_routed <= t)

    # needed(x, k): no copy of objects[x] at srv[k] yet
    srv_c = srv.clamp_min(0)
    present = test_bits(words, safe[:, :, None], srv_c[:, None, :])
    needed = ~present & (srv >= 0)[:, None, :] & valid[:, :, None]

    # every candidate's interval mask: additions x -> k iff j(seg_x) <= k < seg_x
    in_tab = h_cl < Hc
    h_tab = h_cl.clamp(max=Hc - 1)
    n_cand = torch.where(in_tab, counts[h_tab], 0)
    sel = tables[h_tab] & in_tab[:, None, None]  # [B, C, Hp1]
    ar_h = torch.arange(Hp1, device=dev)
    prev_sel = torch.cummax(torch.where(sel, ar_h, -1), dim=2).values
    seg_e = seg_cl[:, None, :].expand(B, C, L)
    j_of_x = prev_sel.gather(2, seg_e)  # [B, C, L]
    window = (
        (ar_h >= j_of_x[..., None])
        & (ar_h < seg_e[..., None])
        & valid[:, None, :, None]
        & gate_ok[:, None, None, None]
    )
    add = window & needed[:, None]  # [B, C, L, Hp1]

    # float32 costs, summed x-major over [L, Hp1] (the kernel's order)
    cost = torch.zeros((B, C), dtype=torch.float32, device=dev)
    for x in range(L):
        fx = fpos[:, x, None]
        for k in range(Hp1):
            cost = cost + torch.where(add[:, :, x, k], fx, 0.0)
    cost = torch.where(torch.arange(C, device=dev)[None, :] < n_cand[:, None], cost, _INF)
    best = torch.argmin(cost, dim=1)  # ties -> lowest index
    best_cost = cost.gather(1, best[:, None])[:, 0]
    no_solution = best_cost >= _INF
    chosen = add[torch.arange(B, device=dev), best] & ~no_solution[:, None, None]

    obj_w = torch.where(chosen, safe[:, :, None], -1)
    srv_w = srv_c[:, None, :].expand_as(chosen)
    words = scatter_or_pairs(words, obj_w, srv_w)
    applied = torch.where(no_solution, 0.0, best_cost)
    return words, applied, no_solution, chosen, srv, skipped


def _check(words, objects, lengths, shard, f, tables, counts, t, rank):
    dev = objects.device
    for name, x, dt in (("words", words, torch.int32), ("objects", objects, torch.int32),
                        ("lengths", lengths, torch.int32), ("shard", shard, torch.int32),
                        ("f", f, torch.float32), ("tables", tables, torch.bool),
                        ("counts", counts, torch.int32), ("t", t, torch.int32),
                        ("rank", rank, torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, objects on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if objects.dim() != 2 or objects.shape[1] < 1:
        raise ValueError(f"objects must be [B, L] with L >= 1, got {tuple(objects.shape)}")
    B = objects.shape[0]
    if lengths.shape != (B,) or t.shape != (B,):
        raise ValueError("lengths and t must be [B]")
    if words.dim() != 2 or words.shape[0] != shard.shape[0] + 1 or f.shape != shard.shape:
        raise ValueError("words must be [n + 1, W], shard and f [n]")
    if tables.dim() != 3 or counts.shape != (tables.shape[0],):
        raise ValueError("tables must be [Hc, C, Hp1] and counts [Hc]")
    if rank.shape != (words.shape[1] * 32,):
        raise ValueError(f"rank must be [W*32] = [{words.shape[1] * 32}]")


def fused_update_class_plain(words, objects, lengths, shard, f, tables, counts, t, rank,
                             acc, batch_size=256, pol=None):
    """Plain torch version of :func:`fused_update_class`: a loop of
    :func:`fused_update_plain` over the ``batch_size``-row snapshot
    batches, each priced against the words after the batches before it.
    Returns the class's ``(words, applied_cost, no_solution, chosen, srv,
    skipped)``, rows in order, and adds the class's (cost, failed,
    skipped) into ``acc`` (float32 [3], or None), each summed in row order
    in float32 steps, as the kernel does."""
    B, L = objects.shape
    Hp1 = tables.shape[2]
    dev = objects.device
    outs = []
    for i in range(0, B, batch_size):
        sl = slice(i, i + batch_size)
        words, *rest = fused_update_plain(words, objects[sl], lengths[sl], shard, f, tables,
                                          counts, t[sl], rank, pol=pol)
        outs.append(rest)
    if outs:
        cost, no_sol, chosen, srv, skipped = (torch.cat(x) for x in zip(*outs))
    else:
        cost = torch.zeros((0,), dtype=torch.float32, device=dev)
        no_sol = skipped = torch.zeros((0,), dtype=torch.bool, device=dev)
        chosen = torch.zeros((0, L, Hp1), dtype=torch.bool, device=dev)
        srv = torch.zeros((0, Hp1), dtype=torch.int32, device=dev)
    if acc is not None and B:
        cols = torch.stack([cost, no_sol.float(), skipped.float()], dim=1).cpu().numpy()
        # np.cumsum adds in row order, rounding each step to float32
        acc += torch.from_numpy(np.cumsum(cols, axis=0, dtype=np.float32)[-1]).to(acc.device)
    return words, cost, no_sol, chosen, srv, skipped


def _cut_wide_tables(run, words, objects, lengths, shard, f, tables, counts, t, *rest):
    """A path has h <= L - 1 subpath boundaries, so table rows and subpath
    columns past L are never read: tables wider than L (a budget t >= L)
    are cut to L columns for ``run`` and ``chosen`` / ``srv`` padded back
    (False / -1)."""
    B, L = objects.shape
    Hp1 = tables.shape[2]
    if Hp1 <= L:
        return run(words, objects, lengths, shard, f, tables, counts, t, *rest)
    rows = min(tables.shape[0], L)
    words, cost, no_sol, chosen, srv, skipped = run(
        words, objects, lengths, shard, f, tables[:rows, :, :L].contiguous(),
        counts[:rows].contiguous(), t, *rest,
    )
    chosen = torch.cat([chosen, chosen.new_zeros((B, L, Hp1 - L))], dim=2)
    srv = torch.cat([srv, srv.new_full((B, Hp1 - L), -1)], dim=1)
    return words, cost, no_sol, chosen, srv, skipped


def fused_update_class(words, objects, lengths, shard, f, tables, counts, t, rank, acc,
                       batch_size=256, pol=None):
    """The fused UPDATE of a whole budget class: the CUDA kernel on CUDA
    tensors (one cooperative launch), the plain version
    (:func:`fused_update_class_plain`) on CPU tensors.

    ``objects`` [N, L] are priced in snapshot batches of ``batch_size``
    rows: every row of a batch against the same words, each batch against
    the words after the batches before it.  ``words`` is updated in place
    and returned with the class's per-row ``(applied_cost, no_solution,
    chosen, srv, skipped)``; the class's (cost, failed, skipped), each
    summed in row order, are added into ``acc`` (float32 [3]).  Tables
    wider than L are cut as in :func:`fused_update`.
    """
    _check(words, objects, lengths, shard, f, tables, counts, t, rank)
    if acc.device != objects.device or acc.dtype != torch.float32 or acc.shape != (3,):
        raise ValueError("acc must be float32 [3] on the objects' device")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    return _cut_wide_tables(_fused_update_class, words, objects, lengths, shard, f, tables,
                            counts, t, rank, acc, batch_size, pol)


def fused_update(words, objects, lengths, shard, f, tables, counts, t, rank,
                 pol=None):
    """One fused UPDATE round: every row against one snapshot.  The class
    kernel with one batch on CUDA tensors, the plain version on CPU
    tensors.  Same contract as :func:`fused_update_plain`; ``words`` is
    updated in place and returned.  Tables wider than L are cut to L
    columns before the round and ``chosen`` / ``srv`` padded back.
    """
    _check(words, objects, lengths, shard, f, tables, counts, t, rank)
    return _cut_wide_tables(_fused_update_class, words, objects, lengths, shard, f, tables,
                            counts, t, rank, None, max(objects.shape[0], 1), pol)


def _fused_update_class(words, objects, lengths, shard, f, tables, counts, t, rank, acc,
                        batch_size, pol):
    global LAUNCHES
    if objects.device.type == "cpu":
        return fused_update_class_plain(words, objects, lengths, shard, f, tables, counts,
                                        t, rank, acc, batch_size=batch_size, pol=pol)
    if objects.device.type != "cuda":
        raise ValueError(f"unsupported device {objects.device}")
    N, L = objects.shape
    W = words.shape[1]
    Hc, C, Hp1 = tables.shape
    dev = objects.device
    mode = _gate_mode(pol)
    chosen = torch.empty((N, L, Hp1), dtype=torch.uint8, device=dev)
    srv = torch.empty((N, Hp1), dtype=torch.int32, device=dev)
    cost = torch.empty((N,), dtype=torch.float32, device=dev)
    no_sol = torch.empty((N,), dtype=torch.uint8, device=dev)
    skipped = torch.empty((N,), dtype=torch.uint8, device=dev)
    need_g = state_g = None
    if max(L, Hp1) > SHARED_L:
        # each row of a batch: its needed masks and its int32 state
        # (objects, homes, subpaths, sizes, hop values, subpath servers)
        rows = min(N, batch_size)
        need_g = torch.empty((rows, L, -(-Hp1 // 64)), dtype=torch.int64, device=dev)
        state_g = torch.empty((rows, 5 * L + Hp1), dtype=torch.int32, device=dev)
    if N:
        lib = load_library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fused_update_class_launch(
                objects.data_ptr(), lengths.data_ptr(), shard.data_ptr(), f.data_ptr(),
                tables.view(torch.uint8).data_ptr(), counts.data_ptr(), t.data_ptr(),
                rank.data_ptr(), N, L, W, Hc, C, Hp1, batch_size, _GATE[mode],
                int(mode == "routed" and pol.lookahead),
                _dp_depth(pol) if mode == "scored" else -1, words.data_ptr(),
                None if need_g is None else need_g.data_ptr(),
                None if state_g is None else state_g.data_ptr(), chosen.data_ptr(),
                srv.data_ptr(), cost.data_ptr(), no_sol.data_ptr(), skipped.data_ptr(),
                None if acc is None else acc.data_ptr(), stream,
            )
        check_launch("fused_update", err)
        LAUNCHES += 1
    return (words, cost, no_sol.view(torch.bool), chosen.view(torch.bool), srv,
            skipped.view(torch.bool))
