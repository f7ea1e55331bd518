"""Vectorized greedy latency-bound replication (paper Alg 1 + Alg 2), torch.

Paths are processed in *batches*; every path in a batch evaluates its
candidate subsets against the same snapshot of the replication scheme,
and all chosen additions are applied with one scatter-OR into the packed
device words.  Replica additions are monotone 0->1 flips, and Thm 5.3
(latency-robustness) guarantees that additions made concurrently for
other paths never break a bound an earlier UPDATE established.

Per batch, for each path we compute
  * the server-local subpath structure under d (Def 5.1),
  * for every candidate retained-set (precomputed C(h, t) tables), the
    upward-replication + latency-robustness additions (Alg 2 lines 11-19)
    as a [positions x subpaths] interval mask,
  * the marginal cost of each candidate against the snapshot,
  * optionally the per-candidate marginal server loads for the capacity /
    balance constraints (Alg 2 line 20),
and apply the argmin candidate's additions.  Paths whose subpath count
exceeds the enumeration budget fall back to the exact sequential UPDATE
(``repro_torch.core.reference``).

Latency constraints are vector-valued (Def 4.4 is per query): ``t`` may
be an int, a per-query vector, or an :class:`~repro_torch.core.slo.SLOSpec`.
Paths are bucketed by distinct budget, tightest first.

The float32 candidate costs are ``torch.einsum`` products.  On CUDA a
TF32 product would round them and flip strict argmins, so
``replicate_workload`` refuses to run while
``torch.backends.cuda.matmul.allow_tf32`` is set.

``fused=True`` runs the gate, the candidate scoring and the scatter-OR as
one fused step: on the ``kernel`` backend (without capacity checking) a
whole budget class is one ``fused_update_class`` CUDA launch that loops
over the batches itself (:func:`_run_update_class`); elsewhere each batch
is one :func:`_fused_update_batch`, the gate walk and
:func:`_update_batch_core` back to back.  Batch statistics stay on the
device and are read once per budget class.  The kernel sums each
candidate's cost in its own fixed order, not the einsum's, so with
non-integer sizes a near-tie can resolve differently from ``fused=False``
(ROADMAP trap c); with unit sizes every cost is exact and both agree.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import combi
from repro_torch.core.paths import PathSet
from repro_torch.core.reference import update_exact
from repro_torch.core.replication import ReplicationScheme, subpath_structure
from repro_torch.engine import LatencyEngine, PackedScheme
from repro_torch.engine import backends as _backends
from repro_torch.engine.packed import scatter_or_pairs, storage_per_server, test_bits
from repro_torch.engine.streaming import resolve_device, to_device, to_host
from repro_torch.kernels.provision_update import fused_update_class

_INF = 1e30


def _update_batch_core(
    words: torch.Tensor,      # int32 [(n+1), W] — packed scheme, sacrificial row
    objects: torch.Tensor,    # int32 [B, L]
    lengths: torch.Tensor,    # int32 [B]
    shard: torch.Tensor,      # int32 [n]
    f: torch.Tensor,          # float32 [n]
    tables: torch.Tensor,     # bool [H+1, C, H+1]
    counts: torch.Tensor,     # int32 [H+1]
    t: torch.Tensor,          # int32 [B] per-path latency budgets t_q
    h_routed: torch.Tensor,   # int32 [B] routed path latency vs the snapshot
    load: torch.Tensor,       # float32 [S] current storage per server
    capacity: torch.Tensor,   # float32 [S] (ignored unless check_capacity)
    epsilon: torch.Tensor,    # float32 scalar
    check_capacity: bool,
    routed_gate: bool,
):
    """One UPDATE round over a batch; scatter-ORs the chosen additions
    into ``words`` in place.  Returns ``(words, applied_cost, no_solution,
    chosen, srv, skipped)``.

    The JAX package also returns an incremental load estimate; its batch loop
    overwrites that estimate with the exact load after every batch
    whenever capacity is checked, and reads it nowhere else, so the port
    leaves it out.
    """
    B, L = objects.shape
    Hp1 = tables.shape[2]
    C = tables.shape[1]
    S = load.shape[0]
    dev = objects.device

    home, seg, h = subpath_structure(objects, lengths, shard)
    valid = seg >= 0
    h_cl = h.clamp(0, Hp1 - 1).long()

    # server of each subpath: all positions of a subpath share one home.
    seg_cl = seg.clamp(0, Hp1 - 1).long()
    srv = torch.zeros((B, Hp1), dtype=torch.int32, device=dev).scatter_reduce(
        1, seg_cl, torch.where(valid, home + 1, 0), "amax", include_self=True
    ) - 1  # [B, Hp1]; -1 for absent subpaths

    # candidate tables for each path's h: sel [B, C, Hp1]
    sel = tables[h_cl]
    n_cand = counts[h_cl]  # [B]

    # prev_sel[b, c, k] = largest selected subpath index <= k
    ar_h = torch.arange(Hp1, device=dev)
    idx = torch.where(sel, ar_h[None, None, :], -1)
    prev_sel = torch.cummax(idx, dim=2).values  # [B, C, Hp1]

    # per-position selected-predecessor j(seg_x): gather over k = seg_x
    seg_e = seg_cl[:, None, :].expand(B, C, L)  # [B, C, L]
    j_of_x = prev_sel.gather(2, seg_e)  # [B, C, L]

    # interval mask: additions (x -> subpath k) iff j(seg_x) <= k < seg_x
    k_r = ar_h[None, None, None, :]
    window = (k_r >= j_of_x[..., None]) & (k_r < seg_e[..., None])  # [B,C,L,Hp1]
    window = (
        window
        & valid[:, None, :, None]
        & (h > t)[:, None, None, None]  # each path vs its OWN budget t_q
    )
    if routed_gate:
        # a path the routed walk already serves within its budget against
        # the same snapshot buys no replicas at all
        window = window & (h_routed > t)[:, None, None, None]
        skipped = (h > t) & (h_routed <= t)
    else:
        skipped = torch.zeros_like(t, dtype=torch.bool)

    # needed(x, k): no copy of objects[x] at srv[k] yet (snapshot bit-test)
    safe_obj = objects.clamp_min(0)
    safe_srv = srv.clamp_min(0)
    present = test_bits(words, safe_obj[:, :, None], safe_srv[:, None, :])  # [B, L, Hp1]
    needed = (~present) & (srv[:, None, :] >= 0) & valid[:, :, None]

    fx = f[safe_obj.long()] * valid.to(torch.float32)  # [B, L]
    add = window & needed[:, None, :, :]  # [B, C, L, Hp1]
    add_f = add.to(torch.float32)
    cost = torch.einsum("bclk,bl->bc", add_f, fx)

    cand_valid = torch.arange(C, device=dev)[None, :] < n_cand[:, None]
    cost_m = torch.where(cand_valid, cost, _INF)

    if check_capacity:
        # marginal load per candidate per server: scatter f over srv[k]
        contrib = torch.einsum("bclk,bl->bck", add_f, fx)
        marg = torch.zeros((B, C, S + 1), dtype=torch.float32, device=dev)
        bi = torch.arange(B, device=dev)[:, None, None].expand(B, C, Hp1)
        ci = torch.arange(C, device=dev)[None, :, None].expand(B, C, Hp1)
        si = safe_srv.clamp(0, S).long()[:, None, :].expand(B, C, Hp1)
        marg.index_put_((bi, ci, si), contrib, accumulate=True)
        marg = marg[..., :S]
        # snapshot load; within-batch interactions ignored (lock-free
        # semantics).  Feasibility is re-validated exactly by the caller.
        new_load = load[None, None, :] + marg
        ok_cap = torch.all(new_load <= capacity[None, None, :] + 1e-6, dim=-1)
        mean = torch.mean(new_load, dim=-1)
        ok_bal = torch.amax(new_load, dim=-1) <= (1.0 + epsilon) * mean + 1e-6
        cost_m = torch.where(ok_cap & ok_bal, cost_m, _INF)

    best = torch.argmin(cost_m, dim=1)  # [B] ties -> lowest index
    best_cost = cost_m.gather(1, best[:, None])[:, 0]
    no_solution = best_cost >= _INF

    chosen = add[torch.arange(B, device=dev), best]  # [B, L, Hp1]
    chosen = chosen & ~no_solution[:, None, None]

    # scatter-OR into the packed words; masked-out writes go to the
    # sacrificial row
    obj_w = torch.where(chosen, safe_obj[:, :, None], -1)
    srv_w = safe_srv[:, None, :].expand_as(chosen)
    words = scatter_or_pairs(words, obj_w, srv_w)

    applied_cost = torch.where(no_solution, 0.0, best_cost)
    return words, applied_cost, no_solution, chosen, srv, skipped


def _first_obj_of_subpaths(objects, lengths, shard, Hp1):
    """[B, Hp1] first object of each subpath (resharding-map representative;
    garbage where the subpath is absent)."""
    B, L = objects.shape
    _, seg, _ = subpath_structure(objects, lengths, shard)
    valid = seg >= 0
    seg_cl = seg.clamp(0, Hp1 - 1).long()
    big = 2**30
    pos = torch.arange(L, device=objects.device, dtype=torch.int32)[None, :]
    first_pos = torch.full((B, Hp1), big, dtype=torch.int32, device=objects.device)
    first_pos = first_pos.scatter_reduce(
        1, seg_cl, torch.where(valid, pos, big), "amin", include_self=True
    )
    return objects.gather(1, first_pos.clamp(0, L - 1).long())


def _fused_update_batch(
    words, acc, objects, lengths, shard, f, tables, counts, t, rank, load,
    capacity, epsilon, check_capacity: bool, pol, backend: str,
):
    """One *fused* UPDATE round off the class kernel's route (the
    ``torch`` backend, or capacity checking): the routed gate
    (``backends.gate_counts`` against the words snapshot) feeds
    :func:`_update_batch_core` (whose capacity check needs the full
    ``[B, C, S]`` marginal-load plane the kernel never builds), with the
    batch statistics added into ``acc`` (float32 [3]: cost, failed,
    skipped) on the device instead of read back per batch.  Returns
    ``(words, chosen, srv)``; ``words`` and ``acc`` are updated in place.
    """
    if pol is None:
        h_routed = torch.zeros_like(t)
    else:
        h_routed = _backends.gate_counts(
            objects, lengths, words, shard, pol, rank, backend=backend
        )
    words, costs, failed, chosen, srv, skipped = _update_batch_core(
        words, objects, lengths, shard, f, tables, counts, t, h_routed,
        load, capacity, epsilon, check_capacity, pol is not None,
    )
    acc += torch.stack(
        [costs.sum(), failed.sum(dtype=torch.float32), skipped.sum(dtype=torch.float32)]
    )
    return words, chosen, srv


@dataclasses.dataclass
class GreedyStats:
    total_cost: float = 0.0
    failed_paths: int = 0
    paths_processed: int = 0
    fallback_paths: int = 0
    replicas: int = 0
    runtime_s: float = 0.0
    rm: list | None = None
    # paths the routed walk already served within budget (policy-aware
    # greedy only): structurally infeasible under d, zero replicas bought
    routed_skips: int = 0
    # replicas dropped by the final same-policy prune sweep
    pruned_replicas: int = 0
    # paths still over budget under the routed policy after the bounded
    # revalidation rounds — 0 means the scheme is routed-feasible
    routed_violations: int = 0
    # candidate-table residency: the largest host-resident block of
    # C(h, t) selection rows ever built at once, and the total rows shipped
    table_peak_rows: int = 0
    table_total_rows: int = 0
    # path rows the revalidation rounds did NOT re-walk
    revalidate_rows_saved: int = 0
    # streamed ingestion (replicate_stream): the largest number of paths
    # ever host-resident at once, and the host seconds of chunk
    # materialization hidden behind in-flight device work
    peak_resident_paths: int = 0
    ingest_overlap_s: float = 0.0
    # per-budget-class provisioning telemetry (obs-gated; None when the
    # telemetry plane is disabled): dicts of {budget, n_vec, n_seq,
    # n_candidates, routed_skips} in processing order
    timeline: list | None = None
    # k-resilience (resilience=...): (loss case, path) pairs still over
    # budget after the bounded repair rounds (0 = the scheme survives
    # every loss case) and the masked repair rounds that ran
    resilient_violations: int = 0
    resilience_rounds: int = 0
    # orphans the repair rounds re-homed (objects of violating paths whose
    # home a loss case took down, copied to the rotation failover home)
    resilience_orphans: int = 0
    # host seconds per stage (gate, update, revalidate, prune; the one-call
    # prune sweep also books its call as prune_walk, the batched prune its
    # grouping as prune_plan and its group steps as prune_steps, all inside
    # prune)
    stage_s: dict = dataclasses.field(default_factory=dict)


class DeviceStatsAcc:
    """Device-side accumulation of the fused UPDATE's batch statistics.

    The fused driver adds (cost, failed, skipped) into the device float32
    [3] ``acc`` per batch (the class kernel once per class); :meth:`drain`
    does the one blocking readback, folds the totals into a
    :class:`GreedyStats` and zeroes ``acc``.  The drivers drain once per
    budget class; a holder passed to :func:`replicate_delta`
    (``stats_acc=``) is carried across calls instead and drained once by
    the caller, so streamed chunks never block on a readback.
    """

    def __init__(self, device):
        self.acc = torch.zeros((3,), dtype=torch.float32, device=device)
        self.used = False

    def drain(self, stats: GreedyStats) -> None:
        if not self.used:
            return
        a = to_host(self.acc)
        stats.total_cost += float(a[0])
        stats.failed_paths += int(a[1])
        stats.routed_skips += int(a[2])
        self.acc.zero_()
        self.used = False
        if obs.enabled():
            obs.REGISTRY.counter("repro.greedy.stat_readbacks").inc()


def _obs_record_class(stats, b, n_vec, n_seq, counts, n_skip) -> None:
    """Per-budget-class provisioning telemetry (no-op when obs is off)."""
    if not obs.enabled():
        return
    n_cand = int(to_host(counts).sum()) if counts is not None else 0
    if stats.timeline is None:
        stats.timeline = []
    stats.timeline.append({
        "budget": int(b),
        "n_vec": int(n_vec),
        "n_seq": int(n_seq),
        "n_candidates": n_cand,
        "routed_skips": int(n_skip),
    })
    reg = obs.REGISTRY
    reg.counter("repro.greedy.classes").inc()
    reg.counter("repro.greedy.vec_paths").inc(n_vec)
    reg.counter("repro.greedy.seq_paths").inc(n_seq)
    reg.counter("repro.greedy.candidates").inc(n_cand)
    reg.counter("repro.greedy.routed_skips").inc(n_skip)


def _tick(stats: GreedyStats, stage: str, t0: float, device, sync: bool = True) -> float:
    """Add the seconds since ``t0`` to ``stats.stage_s[stage]`` (after the
    device has caught up, unless ``sync`` is False: a deferred stream books
    host seconds only) and return the new start time."""
    if sync and device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    stats.stage_s[stage] = stats.stage_s.get(stage, 0.0) + now - t0
    return now


def _device_load(packed: PackedScheme, f_d) -> torch.Tensor:
    """float32 [S] storage per server from the packed words, on the device."""
    return storage_per_server(packed.words, f_d)[: packed.n_servers]


def _run_update_batches(
    packed: PackedScheme,
    vec_objects: np.ndarray,
    vec_lengths: np.ndarray,
    shard_d,
    f_d,
    tables,
    counts,
    t_vec: np.ndarray,
    load,
    cap_d,
    eps_d,
    check_capacity: bool,
    batch_size: int,
    stats: GreedyStats,
    track_rm: bool,
    routed_fn=None,
    fused: bool = False,
    pol=None,
    rank=None,
    backend: str = "torch",
    collect_additions: bool = False,
    acc_holder: DeviceStatsAcc | None = None,
):
    """The batched UPDATE loop over vectorizable paths of one budget class.

    ``routed_fn`` (policy-aware greedy, separate-dispatch path) maps a
    device (objects, lengths) batch to its routed path latencies against
    the *current* packed snapshot; paths within budget under the routed
    walk are gated out of the UPDATE.

    ``fused`` runs each batch as one :func:`_fused_update_batch` step
    instead: the gate under ``pol`` (``rank`` the padded holder rank) runs
    against the same snapshot inside the step, on ``backend``, and the
    statistics are read back (and the stage clock synchronised) once at
    the end of the class.  On the ``kernel`` backend without capacity
    checking the whole class is one launch instead
    (:func:`_run_update_class`).  ``acc_holder`` (fused only) defers the
    statistics readback: the device accumulator is carried in the holder
    and drained by the caller, so the stats components stay 0 here.

    Mutates ``packed`` and ``stats``; returns the load and, with
    ``collect_additions``, the applied (object, server) pairs as two int64
    arrays in row order (else None).
    """
    if fused and backend == "kernel" and not check_capacity:
        additions = _run_update_class(
            packed, vec_objects, vec_lengths, shard_d, f_d, tables, counts, t_vec,
            batch_size, stats, track_rm, pol, rank, collect_additions, acc_holder)
        return load, additions
    device = packed.device
    if fused:
        acc = acc_holder if acc_holder is not None else DeviceStatsAcc(device)
        acc.used = True
    add_obj: list[np.ndarray] = []
    add_srv: list[np.ndarray] = []
    t_class = time.perf_counter()
    for i in range(0, len(vec_objects), batch_size):
        t0 = time.perf_counter()
        # the JAX package pads the last batch to a fixed jit shape; rows are
        # independent (pad rows buy nothing), so the port does not
        o = vec_objects[i : i + batch_size]
        o_d = to_device(o, device)
        l_d = to_device(vec_lengths[i : i + batch_size], device)
        t_d = to_device(t_vec[i : i + batch_size], device)
        if fused:
            packed.words, chosen, srv = _fused_update_batch(
                packed.words, acc.acc, o_d, l_d, shard_d, f_d, tables, counts, t_d,
                rank, load, cap_d, eps_d, check_capacity, pol, backend,
            )
        else:
            if routed_fn is not None:
                # routed latency against the snapshot the batch prices on
                h_rt = routed_fn(o_d, l_d)
                t0 = _tick(stats, "gate", t0, device)
            else:
                h_rt = torch.zeros(len(o), dtype=torch.int32, device=device)
            packed.words, costs, failed, chosen, srv, skipped = _update_batch_core(
                packed.words, o_d, l_d, shard_d, f_d, tables, counts, t_d, h_rt,
                load, cap_d, eps_d, check_capacity, routed_fn is not None,
            )
            stats.total_cost += float(to_host(costs).sum())
            stats.failed_paths += int(failed.sum())
            stats.routed_skips += int(skipped.sum())
        if check_capacity:
            # exact load from the packed words (the UPDATE's estimate can
            # over-count duplicate additions within a batch)
            load = _device_load(packed, f_d)
        if track_rm:
            _append_rm(stats, o, o_d, l_d, shard_d, chosen, srv)
        if collect_additions:
            _collect(add_obj, add_srv, o, chosen, srv)
        if not fused:
            _tick(stats, "update", t0, device)
    if fused:
        # one readback and one device sync per class, not per batch (none
        # at all while a caller holds the accumulator)
        if acc_holder is None:
            acc.drain(stats)
        _tick(stats, "update", t_class, device, sync=acc_holder is None)
    return load, _additions(add_obj, add_srv) if collect_additions else None


def _collect(add_obj: list, add_srv: list, o: np.ndarray, chosen, srv) -> None:
    """Append the (object, server) pairs of ``chosen`` (rows ``o``)."""
    bb, xx, kk = np.nonzero(to_host(chosen))
    add_obj.append(np.asarray(o)[bb, xx].astype(np.int64))
    add_srv.append(to_host(srv)[bb, kk].astype(np.int64))


def _additions(add_obj: list, add_srv: list):
    return (
        np.concatenate(add_obj) if add_obj else np.zeros(0, np.int64),
        np.concatenate(add_srv) if add_srv else np.zeros(0, np.int64),
    )


def _append_rm(stats: GreedyStats, o: np.ndarray, o_d, l_d, shard_d, chosen, srv) -> None:
    """Append the resharding-map entries (u, v, s) of the chosen additions
    of rows ``o`` (host) / ``o_d``, ``l_d`` (device), in row order."""
    ch = to_host(chosen)
    sv = to_host(srv)
    fo = to_host(_first_obj_of_subpaths(o_d, l_d, shard_d, chosen.shape[2]))
    for b, x, kk in zip(*np.nonzero(ch)):
        stats.rm.append((int(fo[b, kk]), int(o[b, x]), int(sv[b, kk])))


def _run_update_class(packed: PackedScheme, vec_objects: np.ndarray,
                      vec_lengths: np.ndarray, shard_d, f_d, tables, counts,
                      t_vec: np.ndarray, batch_size: int, stats: GreedyStats,
                      track_rm: bool, pol, rank, collect_additions: bool = False,
                      acc_holder: DeviceStatsAcc | None = None):
    """The fused UPDATE of one budget class on the ``kernel`` backend: the
    class uploaded once and one ``fused_update_class`` launch, which prices
    it in ``batch_size``-row snapshot batches on the device, as the batch
    loop does; the resharding map and the additions built afterwards (rows
    are independent, so their entries come in the loop's order) and the
    statistics read once (or left in ``acc_holder``).  Mutates ``packed``
    and ``stats``; returns the additions as :func:`_run_update_batches`."""
    device = packed.device
    acc = acc_holder if acc_holder is not None else DeviceStatsAcc(device)
    acc.used = True
    add_obj: list[np.ndarray] = []
    add_srv: list[np.ndarray] = []
    t0 = time.perf_counter()
    N = len(vec_objects)
    if N:
        # one upload: objects, lengths and budgets side by side
        L = vec_objects.shape[1]
        buf = to_device(np.concatenate(
            [np.ravel(vec_objects), vec_lengths, t_vec]).astype(np.int32, copy=False), device)
        o_d, l_d, t_d = buf[: N * L].view(N, L), buf[N * L : N * L + N], buf[N * L + N :]
        packed.words, _, _, chosen, srv, _ = fused_update_class(
            packed.words, o_d, l_d, shard_d, f_d, tables, counts, t_d, rank, acc.acc,
            batch_size=batch_size, pol=pol,
        )
        if track_rm:
            _append_rm(stats, vec_objects, o_d, l_d, shard_d, chosen, srv)
        if collect_additions:
            _collect(add_obj, add_srv, vec_objects, chosen, srv)
    if acc_holder is None:
        acc.drain(stats)
    _tick(stats, "update", t0, device, sync=acc_holder is None)
    return _additions(add_obj, add_srv) if collect_additions else None


# host-residency bound on candidate-table construction: a budget class
# whose padded C(h, t) table holds more rows than this is assembled on
# the device from streamed chunks instead of one host materialization
_TABLE_STREAM_ROWS = 2048


def _tables_to_device(H: int, b: int, device, stats: GreedyStats | None = None):
    """Device candidate tables for budget b, streaming when they are big."""
    counts_np = np.array(
        [combi.n_candidates(h, b) for h in range(H + 1)], np.int32
    )
    c_max = int(counts_np.max())
    if c_max <= _TABLE_STREAM_ROWS:
        tables_np, counts_full = combi.stacked_tables(H, b)
        if stats is not None:
            stats.table_peak_rows = max(stats.table_peak_rows, (H + 1) * c_max)
            stats.table_total_rows += int(counts_np.sum())
        return to_device(tables_np, device), to_device(counts_full, device)
    tables = torch.ones((H + 1, c_max, H + 1), dtype=torch.bool, device=device)
    peak = 0
    total = 0
    for h in range(H + 1):
        r0 = 0
        for chunk in combi.iter_comb_rows(h, b, _TABLE_STREAM_ROWS):
            rows = chunk.shape[0]
            tables[h, r0 : r0 + rows, : h + 1] = to_device(chunk, device)
            r0 += rows
            peak = max(peak, rows)
            total += rows
    if stats is not None:
        stats.table_peak_rows = max(stats.table_peak_rows, peak)
        stats.table_total_rows += total
    return tables, to_device(counts_np, device)


def _budget_class_plan(
    ps: PathSet,
    t_path: np.ndarray,
    shard_d,
    max_candidates: int,
    skip_tables: bool = False,
    stats: GreedyStats | None = None,
):
    """Bucket paths by distinct latency budget (ascending, tightest first).

    Yields ``(budget, class_pathset, vec_idx, seq_idx, h_all, tables,
    counts)`` per class.  ``skip_tables`` (policy-aware runs) yields
    None tables: the routed class filter rebuilds them on the surviving
    paths anyway.
    """
    device = shard_d.device
    plan = []
    for b in np.unique(t_path):
        b = int(b)
        idx = np.nonzero(t_path == b)[0]
        cls = ps.select(idx)
        _, _, h_all = subpath_structure(
            to_device(np.asarray(cls.objects, np.int32), device),
            to_device(np.asarray(cls.lengths, np.int32), device),
            shard_d,
        )
        h_all = to_host(h_all)
        H_needed = int(h_all.max()) if cls.n_paths else 0
        H_vec = combi.max_h_within_budget(b, max_candidates, H_needed)
        vec_idx = np.nonzero(h_all <= H_vec)[0]
        seq_idx = np.nonzero(h_all > H_vec)[0]
        if skip_tables:
            tables = counts = None
        else:
            tables, counts = _tables_to_device(max(H_vec, b, 1), b, device, stats)
        plan.append((b, cls, vec_idx, seq_idx, h_all, tables, counts))
    return plan


def _routed_host(routed_fn, objects: np.ndarray, lengths: np.ndarray, device) -> np.ndarray:
    """Routed h (int64, host) of host path rows."""
    h = routed_fn(
        to_device(np.asarray(objects, np.int32), device),
        to_device(np.asarray(lengths, np.int32), device),
    )
    return to_host(h).astype(np.int64)


def _routed_violation_idx(routed_fn, ps: PathSet, t_path: np.ndarray, device):
    """Indices of paths over budget under the routed policy (one eval)."""
    h_rt = _routed_host(routed_fn, ps.objects, ps.lengths, device)
    return np.nonzero(h_rt > t_path)[0]


def _routed_eval_rows(routed_fn, ps, rows: np.ndarray, device) -> np.ndarray:
    """Routed h for a compacted subset of ``ps``'s rows.  (The JAX package
    pads the block to 128 rows to bound its jit traces; pad rows score
    h = 0 and are dropped, so the port walks the rows as they are.)"""
    return _routed_host(
        routed_fn, np.asarray(ps.objects)[rows], np.asarray(ps.lengths)[rows], device
    )


def _revalidate_routed(routed_fn, ps, t_path, run_classes, stats, device,
                       index=None) -> None:
    """Bounded re-validation after a policy-aware pass.

    Receding-horizon walks are not monotone under foreign replica
    additions, so a path gated out early can regress by the end of the
    pass: re-run UPDATE over the violating paths for up to
    ``_POLICY_REVALIDATE`` rounds and record the residue in
    ``stats.routed_violations``.  With ``index`` (a ``PathIndex`` over
    ``ps``) each round re-walks only the rows the UPDATE could have
    changed.
    """
    viol = _routed_violation_idx(routed_fn, ps, t_path, device)
    for _ in range(_POLICY_REVALIDATE):
        if not len(viol):
            break
        run_classes(ps.select(viol), t_path[viol])
        if index is not None:
            cand = index.dirty_paths(np.asarray(ps.objects)[viol])
            stats.revalidate_rows_saved += int(ps.n_paths - len(cand))
            h = _routed_eval_rows(routed_fn, ps, cand, device)
            viol = cand[h > t_path[cand]]
        else:
            viol = _routed_violation_idx(routed_fn, ps, t_path, device)
    stats.routed_violations = int(len(viol))


def _routed_gate_fn(packed: PackedScheme, pol, backend: str, load=None):
    """Routed-latency evaluator over the evolving packed snapshot.

    Returns ``fn(objects, lengths) -> int32 [B]`` on the device, computing
    h(p, r, rho; policy) against ``packed``'s *current* words, or None
    when no gating is wanted (``pol`` is None).  ``backend`` picks the
    implementation: ``torch`` (plain walk), ``kernel`` (the routed-walk
    CUDA kernel) or ``reference`` (the pure-python oracle against a
    per-call readback).  ``load`` is the forecast per-server load a
    ``queue_aware`` policy prices the gate with.
    """
    if pol is None:
        return None
    device = packed.device
    if backend == "reference":
        from repro_torch.core.reference import (  # lazy: no cycle at import
            routed_path_latencies_reference,
        )

        def fn(objects, lengths):
            h = routed_path_latencies_reference(
                to_host(objects), to_host(lengths), packed.unpack(),
                to_host(packed.shard), policy=pol, load=load,
            )
            return to_device(h, device)

        return fn
    if backend not in ("torch", "kernel"):
        raise ValueError(
            f"unknown policy_backend {backend!r}; use reference | torch | kernel"
        )
    rank = _backends._load_vector(load if pol.uses_load else None, packed.words)

    def fn(objects, lengths):
        return _backends.gate_counts(
            objects, lengths, packed.words, packed.shard, pol, rank, backend=backend
        )

    return fn


def _routed_class_filter(
    cls: PathSet, b: int, h_all: np.ndarray, routed_fn, max_candidates: int,
    device, stats: GreedyStats | None = None,
):
    """Rebuild one budget class's plan on the routed walk.

    Evaluates the class's paths under the routed policy against the
    current snapshot, drops the ones already within budget, and re-derives
    H_vec + the C(h, t) tables from the *surviving* paths only.  Returns
    ``(vec_idx, seq_idx, tables, counts, n_skipped)``.
    """
    h_rt = _routed_host(routed_fn, cls.objects, cls.lengths, device)
    kept = np.nonzero(h_rt > b)[0]
    # only structurally-infeasible paths the routed walk rescued count as
    # skips (h <= b paths were no-ops under the closed form too)
    n_skipped = int(((h_all > b) & (h_rt <= b)).sum())
    H_needed = int(h_all[kept].max()) if len(kept) else 0
    H_vec = combi.max_h_within_budget(b, max_candidates, H_needed)
    vec_idx = kept[h_all[kept] <= H_vec]
    seq_idx = kept[h_all[kept] > H_vec]
    tables, counts = _tables_to_device(max(H_vec, b, 1), b, device, stats)
    return vec_idx, seq_idx, tables, counts, n_skipped


def _capacity_arrays(n_servers: int, capacity, epsilon, device):
    check = capacity is not None or epsilon is not None
    cap_arr = np.full((n_servers,), np.inf, np.float32)
    if capacity is not None:
        cap_arr = np.broadcast_to(
            np.asarray(capacity, np.float32), (n_servers,)
        ).copy()
    eps = np.float32(epsilon if epsilon is not None else np.inf)
    return check, to_device(cap_arr, device), torch.tensor(eps, device=device)


# routed-feasibility re-validation rounds after a policy-aware pass
_POLICY_REVALIDATE = 2


# masked-repair rounds for the k-resilience gate: with rotation-failover
# homes the home_first masked walk is monotone per loss case (one round
# closes each case for good — Thm 5.3 applies case by case), so extra
# rounds only serve the receding-horizon policies, as _POLICY_REVALIDATE
_RESILIENCE_ROUNDS = 3


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is refused: the port targets one card and has no mesh type; "
            "multi-card path sharding of the fused driver is still to do "
            "(the batch row quantum still rounds by the device count, "
            "repro_torch.engine.sharding.round_up_rows)"
        )


def _run_exact_fallback(host_scheme, cls, seq_idx, b, f_arr, capacity, epsilon,
                        pol, load, stats: GreedyStats, track_rm: bool):
    """The exact sequential UPDATE of the enumeration-heavy paths
    ``seq_idx`` of one class against ``host_scheme``; returns the applied
    (objects, servers) lists."""
    fb_obj: list[int] = []
    fb_srv: list[int] = []
    for i in seq_idx:
        res = update_exact(
            host_scheme, cls.path(int(i)), b, f_arr, capacity, epsilon,
            policy=pol, load=load,
        )
        stats.fallback_paths += 1
        if res.feasible:
            stats.total_cost += res.cost
            fb_obj.extend(v for v, _ in res.additions)
            fb_srv.extend(s for _, s in res.additions)
            if track_rm:
                stats.rm.extend(res.rm_entries)
        else:
            stats.failed_paths += 1
    return fb_obj, fb_srv


def _repair_loss_case(packed: PackedScheme, sub_ps: PathSet, t_sub: np.ndarray,
                      fshard: np.ndarray, cmask_words: np.ndarray, orphans: np.ndarray,
                      pol, policy_backend: str, f_arr: np.ndarray, f_d, capacity,
                      epsilon, cap_d, eps_d, check_capacity: bool, batch_size: int,
                      max_candidates: int, stats: GreedyStats, load, fused: bool,
                      track_rm: bool):
    """One masked UPDATE pass: provision ``sub_ps`` as if the loss case had
    already happened.

    Builds a temporary :class:`PackedScheme` — the live words with the lost
    servers' holder bits cleared, sharded by the case's rotation-failover
    homes — and runs the same batched UPDATE machinery (routed gate
    included; on ``kernel`` with ``fused`` one ``fused_update_class``
    launch per budget class) against it.  ``orphans`` (the violating
    paths' objects whose home the case took down and whose failover home
    holds no copy yet) are re-homed first: the UPDATE's cost model prices
    every object as free at its own home, which the masked scheme breaks
    exactly at the orphans.  Every candidate server is a failover home,
    hence alive under the case.  Returns the applied (object, server)
    additions, orphan re-homes included, for the caller to replay into
    the live scheme (Thm 5.3).
    """
    device = packed.device
    masked = PackedScheme(
        words=_backends.mask_case_words(packed.words, to_device(cmask_words, device)),
        shard=to_device(np.asarray(fshard, np.int32), device),
        n_servers=packed.n_servers,
    )
    if len(orphans):
        masked.add(orphans, np.asarray(fshard)[orphans])
    routed_fn = _routed_gate_fn(masked, pol, policy_backend, load=load)
    fused_c = fused and policy_backend != "reference"
    rank = _backends._load_vector(
        load if (pol is not None and pol.uses_load) else None, masked.words
    ) if fused_c else None
    srv_load = _device_load(masked, f_d)
    host_scheme: ReplicationScheme | None = None
    add_obj: list[np.ndarray] = []
    add_srv: list[np.ndarray] = []
    if len(orphans):
        add_obj.append(np.asarray(orphans, np.int64))
        add_srv.append(np.asarray(fshard, np.int64)[orphans])
    for b, cls, vec_idx, seq_idx, h_all, tables, counts in _budget_class_plan(
        sub_ps, t_sub, masked.shard, max_candidates,
        skip_tables=routed_fn is not None, stats=stats,
    ):
        if routed_fn is not None and cls.n_paths:
            vec_idx, seq_idx, tables, counts, n_skip = _routed_class_filter(
                cls, b, h_all, routed_fn, max_candidates, device, stats=stats
            )
            stats.routed_skips += n_skip
        srv_load, additions = _run_update_batches(
            masked, cls.objects[vec_idx], cls.lengths[vec_idx], masked.shard, f_d,
            tables, counts, np.full(len(vec_idx), b, np.int32), srv_load, cap_d, eps_d,
            check_capacity, batch_size, stats, track_rm,
            routed_fn=None if fused_c else routed_fn, fused=fused_c, pol=pol,
            rank=rank, backend=policy_backend, collect_additions=True,
        )
        add_obj.append(additions[0])
        add_srv.append(additions[1])
        if len(seq_idx):
            # exact fallback against the masked host view; additions are
            # replayed into the masked words so later classes see them
            if host_scheme is None:
                host_scheme = ReplicationScheme(masked.unpack(), np.asarray(fshard, np.int32))
            else:
                host_scheme.mask = masked.unpack()
            fb_obj, fb_srv = _run_exact_fallback(
                host_scheme, cls, seq_idx, b, f_arr, capacity, epsilon, pol, load,
                stats, track_rm)
            if fb_obj:
                masked.add(np.asarray(fb_obj), np.asarray(fb_srv))
                add_obj.append(np.asarray(fb_obj, np.int64))
                add_srv.append(np.asarray(fb_srv, np.int64))
                if check_capacity:
                    srv_load = _device_load(masked, f_d)
    return _additions(add_obj, add_srv)


def _enforce_resilience(packed: PackedScheme, ps: PathSet, t_path: np.ndarray, res, pol,
                        policy_backend: str, f_arr: np.ndarray, f_d, capacity, epsilon,
                        cap_d, eps_d, check_capacity: bool, batch_size: int,
                        max_candidates: int, stats: GreedyStats, load, fused: bool,
                        track_rm: bool):
    """The k-resilience gate: repair every loss case until none violates.

    Per bounded round: evaluate h under every loss case of ``res`` (one
    masked re-walk, ``backends.case_latencies``), then for each violating case
    run the masked UPDATE over its violating paths and scatter-OR the
    chosen additions into the LIVE words, so later cases and rounds price
    against them.  The surviving (case, path) violations land in
    ``stats.resilient_violations``.  Stage seconds: ``resilience_eval``
    (the case walks) and ``resilience_repair`` (the masked UPDATE).
    Returns the applied (object, server) additions.
    """
    from repro_torch.engine.resilience import (  # lazy: no cycle at import
        case_word_mask,
        failover_shard,
    )

    device = packed.device
    n_servers = packed.n_servers
    shard_host = to_host(packed.shard)
    cases = res.loss_cases(n_servers)
    homes = [failover_shard(shard_host, c, n_servers) for c in cases]
    W = packed.n_words
    all_obj: list[np.ndarray] = []
    all_srv: list[np.ndarray] = []
    objects = np.asarray(ps.objects)
    for rnd in range(_RESILIENCE_ROUNDS + 1):
        te = time.perf_counter()
        h_cases = _backends.case_latencies(
            packed, ps.objects, ps.lengths, cases, homes, pol, load, policy_backend
        )
        _tick(stats, "resilience_eval", te, device)
        viol = h_cases > t_path[None, :]
        total = int(viol.sum())
        if total == 0 or rnd == _RESILIENCE_ROUNDS:
            stats.resilient_violations = total
            break
        stats.resilience_rounds += 1
        tr = time.perf_counter()
        mask_host = packed.unpack()
        for d, c in enumerate(cases):
            idx = np.nonzero(viol[d])[0]
            if not len(idx):
                continue
            # objects the case orphans: homed on a lost server, no copy at
            # the rotation failover home yet — re-homed by the repair
            vobj = np.unique(objects[idx])
            vobj = vobj[vobj >= 0]
            dead = np.zeros(n_servers, bool)
            dead[np.asarray(c)] = True
            orphans = vobj[dead[shard_host[vobj]] & ~mask_host[vobj, homes[d][vobj]]]
            stats.resilience_orphans += int(len(orphans))
            obj, srv = _repair_loss_case(
                packed, ps.select(idx), t_path[idx], homes[d], case_word_mask(c, W),
                orphans, pol, policy_backend, f_arr, f_d, capacity, epsilon, cap_d,
                eps_d, check_capacity, batch_size, max_candidates, stats, load, fused,
                track_rm,
            )
            if len(obj):
                # replay into the live scheme: monotone adds, all targets
                # alive under the case (failover homes by construction)
                packed.add(obj, srv)
                mask_host[obj, srv] = True  # keep later cases' orphan filter exact
                all_obj.append(obj)
                all_srv.append(srv)
        _tick(stats, "resilience_repair", tr, device)
    return _additions(all_obj, all_srv)


def replicate_workload(
    pathset: PathSet,
    shard: np.ndarray,
    n_servers: int,
    t,
    f: np.ndarray | None = None,
    capacity: np.ndarray | float | None = None,
    epsilon: float | None = None,
    batch_size: int = 256,
    max_candidates: int = 2048,
    prune: bool = True,
    track_rm: bool = False,
    return_engine: bool = False,
    policy=None,
    policy_backend: str | None = None,
    policy_prune: bool = True,
    load: np.ndarray | None = None,
    fused: bool = False,
    mesh=None,
    resilience=None,
    device=None,
):
    """Alg 1 over a workload with the vectorized batched UPDATE.

    Args mirror Def 4.4: ``t`` is the latency constraint — an int, a
    per-query int vector, or an :class:`~repro_torch.core.slo.SLOSpec`;
    ``f`` the storage cost function, ``capacity`` M_s, ``epsilon`` the
    load imbalance bound.  ``track_rm`` additionally accumulates the §5.4
    resharding map entries (u, v, s).

    ``policy`` (str | ``RoutingPolicy``) prices every candidate under that
    *routed* walk: per budget class the C(h, t) tables are rebuilt on the
    paths the routed walk cannot already serve, every batch gates
    additions on h(p, r, rho; policy) <= t_q against the snapshot it costs
    candidates on (``stats.routed_skips``), the routed feasibility of the
    whole workload is re-validated in bounded rounds, and with
    ``policy_prune=True`` one prune sweep under the same policy drops the
    within-batch redundancy (``stats.pruned_replicas``).
    ``policy_backend`` selects the gate's evaluator (``torch`` |
    ``kernel`` | ``reference``; default from the device).  The prune
    resolves its backend from the device as well.

    ``fused`` runs every batch as one fused step (gate + candidate
    scoring + bit-test + scatter-OR, statistics reduced on the device; on
    the ``kernel`` backend one ``fused_update_class`` launch per budget
    class) and the final prune with ``fused=True``: one sweep launch on
    the ``kernel`` backend, the batched independent-group sweep on
    ``torch`` (see
    :func:`~repro_torch.core.replication.prune_scheme_replicas`).  Under
    ``policy_backend="reference"`` it runs the separate pipeline, as the
    JAX package does.

    ``resilience`` (int k | :class:`~repro_torch.engine.KResilient` |
    None) adds the k-resilience gate after the pass and the policy prune
    (:func:`_enforce_resilience`): every loss case is re-walked over the
    masked words under rotation-failover homes and each violating (case,
    path) pair re-run through a masked UPDATE whose additions are replayed
    into the live scheme.  ``stats.resilient_violations == 0`` certifies
    the scheme stays feasible under the loss of any k domains.

    ``device`` defaults to ``"cuda"``.  ``mesh`` is refused: the port
    targets one card and has no mesh type.
    """
    from repro_torch.core.slo import normalize_path_budgets  # local: no cycle
    from repro_torch.engine.incremental import PathIndex
    from repro_torch.engine.resilience import resolve_resilience
    from repro_torch.engine.routing import resolve_policy

    _refuse_mesh(mesh)
    res = resolve_resilience(resilience)
    device = resolve_device(device)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: TF32 candidate "
            "costs would flip strict argmins; set it to False"
        )
    policy_backend = _backends.resolve_backend(policy_backend, device)
    t0 = time.perf_counter()
    n = shard.shape[0]
    pol = resolve_policy(policy)
    pol = None if pol.name == "home_first" else pol
    t_path = normalize_path_budgets(t, pathset)
    if prune:
        # the budget joins the §5.3 dedup key: a tight-budget path must not
        # be merged into a loose-budget duplicate
        ps, keep = pathset.prune_redundant(
            shard, extra_key=t_path, return_index=True
        )
        t_path = t_path[keep]
    else:
        ps = pathset
    scheme = ReplicationScheme.from_sharding(shard, n_servers)
    stats = GreedyStats(rm=[] if track_rm else None)
    stats.paths_processed = ps.n_paths
    if ps.n_paths == 0:
        stats.runtime_s = time.perf_counter() - t0
        if return_engine:
            return scheme, stats, LatencyEngine(scheme, device=device)
        return scheme, stats

    f_arr = np.ones((n,), np.float32) if f is None else f.astype(np.float32)
    packed = PackedScheme.from_sharding(scheme.shard, n_servers, device)
    shard_d = packed.shard
    f_d = to_device(f_arr, device)

    check_capacity, cap_d, eps_d = _capacity_arrays(n_servers, capacity, epsilon, device)
    srv_load = to_device(scheme.storage_per_server(f_arr).astype(np.float32), device)
    routed_fn = _routed_gate_fn(packed, pol, policy_backend, load=load)
    fused = fused and policy_backend != "reference"
    # the fused gate's padded holder rank
    rank = _backends._load_vector(
        load if (pol is not None and pol.uses_load) else None, packed.words
    ) if fused else None

    def run_classes(ps_run: PathSet, t_run: np.ndarray) -> None:
        nonlocal srv_load
        for b, cls, vec_idx, seq_idx, h_all, tables, counts in _budget_class_plan(
            ps_run, t_run, shard_d, max_candidates,
            skip_tables=routed_fn is not None, stats=stats,
        ):
            n_skip = 0
            if routed_fn is not None and cls.n_paths:
                tg = time.perf_counter()
                vec_idx, seq_idx, tables, counts, n_skip = _routed_class_filter(
                    cls, b, h_all, routed_fn, max_candidates, device, stats=stats
                )
                stats.routed_skips += n_skip
                _tick(stats, "gate", tg, device)
            _obs_record_class(stats, b, len(vec_idx), len(seq_idx), counts, n_skip)
            srv_load, _ = _run_update_batches(
                packed,
                cls.objects[vec_idx],
                cls.lengths[vec_idx],
                shard_d,
                f_d,
                tables,
                counts,
                np.full(len(vec_idx), b, np.int32),
                srv_load,
                cap_d,
                eps_d,
                check_capacity,
                batch_size,
                stats,
                track_rm,
                routed_fn=None if fused else routed_fn,
                fused=fused,
                pol=pol,
                rank=rank,
                backend=policy_backend,
            )

            # Exact fallback for enumeration-heavy paths, against a freshly
            # synced host mask; additions are replayed into the packed words
            # so later classes see them.
            if len(seq_idx):
                tu = time.perf_counter()
                scheme.mask = packed.unpack()
                fb_obj, fb_srv = _run_exact_fallback(
                    scheme, cls, seq_idx, b, f_arr, capacity, epsilon, pol, load,
                    stats, track_rm)
                if fb_obj:
                    packed.add(np.asarray(fb_obj), np.asarray(fb_srv))
                    if check_capacity:
                        srv_load = _device_load(packed, f_d)
                _tick(stats, "update", tu, device)

    run_classes(ps, t_path)
    if routed_fn is not None:
        tr = time.perf_counter()
        _revalidate_routed(
            routed_fn, ps, t_path, run_classes, stats, device,
            index=PathIndex(np.asarray(ps.objects), packed.n_objects),
        )
        _tick(stats, "revalidate", tr, device)

    # single host readback of the packed words
    scheme.mask = packed.unpack()

    if pol is not None and policy_prune and stats.paths_processed:
        from repro_torch.core.replication import prune_scheme_replicas

        tp = time.perf_counter()
        stats.pruned_replicas, _ = prune_scheme_replicas(
            scheme, pathset, t, policy=pol, f=f_arr, load=load, fused=fused,
            device=device, stage_s=stats.stage_s,
        )
        if stats.pruned_replicas:
            # removals are not monotone: the packed words are stale
            packed = PackedScheme.from_mask(scheme.mask, scheme.shard, device)
        _tick(stats, "prune", tp, device)

    if res is not None:
        # after the prune: pruning decides on the non-resilient criterion,
        # so it must not run after the resilience replicas land
        _enforce_resilience(
            packed, ps, t_path, res, pol, policy_backend, f_arr, f_d, capacity,
            epsilon, cap_d, eps_d, check_capacity, batch_size, max_candidates, stats,
            load, fused, track_rm,
        )
        scheme.mask = packed.unpack()

    stats.replicas = scheme.replica_count()
    stats.runtime_s = time.perf_counter() - t0
    if return_engine:
        return scheme, stats, LatencyEngine(scheme, packed=packed)
    return scheme, stats


def replicate_delta(
    pathset: PathSet,
    engine: LatencyEngine,
    t,
    f: np.ndarray | None = None,
    capacity: np.ndarray | float | None = None,
    epsilon: float | None = None,
    batch_size: int = 256,
    max_candidates: int = 2048,
    prune: bool = True,
    track_rm: bool = False,
    policy=None,
    policy_backend: str | None = None,
    load: np.ndarray | None = None,
    fused: bool = False,
    mesh=None,
    collect_additions: bool = True,
    stats_acc: DeviceStatsAcc | None = None,
    sync_host: bool = True,
    resilience=None,
):
    """Warm-start incremental UPDATE over *delta* paths (online serving).

    Runs the batched Alg 2 UPDATE of :func:`replicate_workload`, but
    against the scheme an existing :class:`LatencyEngine` already holds on
    its device — no rebuild, no re-upload.  The additions are scatter-ORed
    into the engine's ``PackedScheme`` (on ``kernel`` with ``fused=True``
    one ``fused_update_class`` launch per budget class against those
    words), mirrored into the engine's host scheme (when it has one), and
    reported to the engine's incremental latency cache (``note_changed``).

    ``t`` is an int, a per-query vector or an ``SLOSpec`` aligned with
    ``pathset``; vector budgets run one pass per budget class, tightest
    first.  ``policy`` prices the delta under the routed walk, as in
    :func:`replicate_workload`; ``policy_backend`` defaults from the
    engine's device.  By Thm 5.3 warm-starting over a path delta is as
    sound as processing those paths later in a longer from-scratch run:
    with batch boundaries aligned the two give identical schemes.

    Returns ``(stats, (objects, servers))``: the delta's stats and the
    applied replica additions as two int64 arrays, deduplicated.  With
    ``collect_additions=False`` (streamed ingestion) the per-class
    chosen-mask readbacks are skipped and the arrays are empty.
    ``stats_acc`` (fused runs) keeps the device stat accumulator live
    across calls: the returned stats' cost / failed / skipped stay 0 until
    the caller drains it.  ``sync_host=False`` also skips the end-of-call
    host-mask refresh.  ``resilience`` runs the k-resilience gate over the
    delta paths after the pass; its additions join the returned delta.
    ``mesh`` is refused (one card).
    """
    from repro_torch.core.slo import normalize_path_budgets  # local: no cycle
    from repro_torch.engine.incremental import PathIndex
    from repro_torch.engine.resilience import resolve_resilience
    from repro_torch.engine.routing import resolve_policy

    _refuse_mesh(mesh)
    t0 = time.perf_counter()
    packed = engine.packed
    device = packed.device
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: TF32 candidate "
            "costs would flip strict argmins; set it to False"
        )
    policy_backend = _backends.resolve_backend(policy_backend, device)
    shard = engine.host_shard()
    n = packed.n_objects
    n_servers = packed.n_servers
    pol = resolve_policy(policy)
    pol = None if pol.name == "home_first" else pol
    res = resolve_resilience(resilience)
    t_path = normalize_path_budgets(t, pathset)
    shard_d = packed.shard
    if prune:
        ps, keep = pathset.prune_redundant(shard, extra_key=t_path, return_index=True)
        t_path = t_path[keep]
    else:
        ps = pathset
    stats = GreedyStats(rm=[] if track_rm else None)
    stats.paths_processed = ps.n_paths
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    if ps.n_paths == 0:
        stats.runtime_s = time.perf_counter() - t0
        return stats, empty

    f_arr = np.ones((n,), np.float32) if f is None else f.astype(np.float32)
    f_d = to_device(f_arr, device)
    check_capacity, cap_d, eps_d = _capacity_arrays(n_servers, capacity, epsilon, device)
    srv_load = _device_load(packed, f_d)
    routed_fn = _routed_gate_fn(packed, pol, policy_backend, load=load)
    fused = fused and policy_backend != "reference"
    rank = _backends._load_vector(
        load if (pol is not None and pol.uses_load) else None, packed.words
    ) if fused else None

    add_obj = np.zeros(0, np.int64)
    add_srv = np.zeros(0, np.int64)

    def run_classes(ps_run: PathSet, t_run: np.ndarray) -> None:
        nonlocal srv_load, add_obj, add_srv
        for b, cls, vec_idx, seq_idx, h_all, tables, counts in _budget_class_plan(
            ps_run, t_run, shard_d, max_candidates,
            skip_tables=routed_fn is not None, stats=stats,
        ):
            n_skip = 0
            if routed_fn is not None and cls.n_paths:
                tg = time.perf_counter()
                vec_idx, seq_idx, tables, counts, n_skip = _routed_class_filter(
                    cls, b, h_all, routed_fn, max_candidates, device, stats=stats
                )
                stats.routed_skips += n_skip
                _tick(stats, "gate", tg, device)
            _obs_record_class(stats, b, len(vec_idx), len(seq_idx), counts, n_skip)
            srv_load, additions = _run_update_batches(
                packed, cls.objects[vec_idx], cls.lengths[vec_idx], shard_d, f_d,
                tables, counts, np.full(len(vec_idx), b, np.int32), srv_load, cap_d,
                eps_d, check_capacity, batch_size, stats, track_rm,
                routed_fn=None if fused else routed_fn, fused=fused, pol=pol, rank=rank,
                backend=policy_backend, collect_additions=collect_additions,
                acc_holder=stats_acc if fused else None,
            )
            # mirror the class's additions into the host scheme FIRST: the
            # exact fallback below prices against the host mask
            if collect_additions:
                cls_obj, cls_srv = additions
                if engine.scheme is not None and len(cls_obj):
                    engine.scheme.mask[cls_obj, cls_srv] = True
                add_obj = np.concatenate([add_obj, cls_obj])
                add_srv = np.concatenate([add_srv, cls_srv])
            elif engine.scheme is not None and len(seq_idx):
                # no per-pair readback: refresh the host mask from the
                # packed truth right before the fallback consumes it
                engine.scheme.mask = packed.unpack()
                if obs.enabled():
                    obs.REGISTRY.counter("repro.greedy.mask_syncs").inc()
            if len(seq_idx):
                tu = time.perf_counter()
                host = engine.scheme if engine.scheme is not None else engine.to_scheme()
                fb_obj, fb_srv = _run_exact_fallback(
                    host, cls, seq_idx, b, f_arr, capacity, epsilon, pol, load, stats,
                    track_rm)
                if fb_obj:
                    packed.add(np.asarray(fb_obj), np.asarray(fb_srv))
                    if collect_additions:
                        add_obj = np.concatenate([add_obj, np.asarray(fb_obj, np.int64)])
                        add_srv = np.concatenate([add_srv, np.asarray(fb_srv, np.int64)])
                    if check_capacity:
                        srv_load = _device_load(packed, f_d)
                _tick(stats, "update", tu, device)

    run_classes(ps, t_path)
    if routed_fn is not None:
        tr = time.perf_counter()
        _revalidate_routed(
            routed_fn, ps, t_path, run_classes, stats, device,
            index=PathIndex(np.asarray(ps.objects), packed.n_objects),
        )
        _tick(stats, "revalidate", tr, device)

    if res is not None:
        r_obj, r_srv = _enforce_resilience(
            packed, ps, t_path, res, pol, policy_backend, f_arr, f_d, capacity,
            epsilon, cap_d, eps_d, check_capacity, batch_size, max_candidates, stats,
            load, fused, track_rm,
        )
        if len(r_obj):
            if engine.scheme is not None:
                engine.scheme.mask[r_obj, r_srv] = True
            add_obj = np.concatenate([add_obj, r_obj])
            add_srv = np.concatenate([add_srv, r_srv])

    # the UPDATE scatter-ORs into packed.words, bypassing add_replicas:
    # report the touched objects so the engine's incremental cache
    # invalidates its exact dirty set (without the per-class readbacks the
    # conservative superset is every object of the processed paths)
    if collect_additions:
        engine.note_changed(add_obj)
    else:
        engine.note_changed(np.asarray(ps.objects))

    if not collect_additions and sync_host and engine.scheme is not None:
        engine.scheme.mask = packed.unpack()
        if obs.enabled():
            obs.REGISTRY.counter("repro.greedy.mask_syncs").inc()

    # dedupe: a batch can choose the same (v, s) for several paths; the
    # returned delta is the exact set of new copies
    if len(add_obj):
        pairs = np.unique(np.stack([add_obj, add_srv], axis=1), axis=0)
        add_obj, add_srv = pairs[:, 0], pairs[:, 1]

    stats.replicas = int(len(add_obj))
    stats.runtime_s = time.perf_counter() - t0
    return stats, (add_obj, add_srv)


def replicate_stream(
    stream,
    shard: np.ndarray,
    n_servers: int,
    t=None,
    f: np.ndarray | None = None,
    capacity: np.ndarray | float | None = None,
    epsilon: float | None = None,
    batch_size: int = 256,
    max_candidates: int = 2048,
    prune: bool = True,
    policy=None,
    policy_backend: str | None = None,
    load: np.ndarray | None = None,
    fused: bool = True,
    mesh=None,
    return_engine: bool = False,
    device=None,
):
    """Alg 1 over a *streamed* workload — the full path set is never
    host-resident.

    ``stream`` is a :class:`~repro_torch.engine.streaming.PathStream` (or
    any iterable of ``PathSet`` chunks / ``(PathSet, budgets)`` tuples,
    which is wrapped in one): host residency peaks at one chunk
    (``stats.peak_resident_paths``).  Each chunk runs
    :func:`replicate_delta` against one device-resident packed scheme; by
    Thm 5.3 chunked provisioning is as sound as one long run with other
    batch boundaries.  ``t`` is the default budget for chunks yielded
    without one.

    Ingestion is double-buffered (:func:`~repro_torch.engine.streaming.
    double_buffer`): each chunk's UPDATE is dispatched with the stat
    readback deferred to a device accumulator and the host-mask sync
    skipped, so the producer builds chunk ``i + 1`` while chunk ``i``
    computes (CUDA launches are asynchronous, and the chunk uploads are
    pinned, ``non_blocking`` copies).  The overlapped
    producer seconds land in ``stats.ingest_overlap_s`` (and the
    ``repro.stream.*`` gauges when obs is on).

    Returns ``(scheme, stats)``; ``return_engine=True`` appends the
    device-resident :class:`LatencyEngine`.  ``device`` defaults to
    ``"cuda"``; ``mesh`` is refused (one card).
    """
    from repro_torch.engine.streaming import PathStream, double_buffer  # lazy

    _refuse_mesh(mesh)
    t0 = time.perf_counter()
    if not isinstance(stream, PathStream):
        stream = PathStream(stream)
    device = resolve_device(device)
    scheme = ReplicationScheme.from_sharding(shard, n_servers)
    engine = LatencyEngine(scheme, device=device)
    policy_backend = _backends.resolve_backend(policy_backend, device)
    stats = GreedyStats()
    fused = fused and policy_backend != "reference"
    acc_holder = DeviceStatsAcc(device) if fused else None

    def dispatch(item):
        ps, t_chunk = item
        budgets = t if t_chunk is None else t_chunk
        if budgets is None:
            raise ValueError("no latency budget: pass t= or stream (PathSet, t) tuples")
        cstats, _ = replicate_delta(
            ps, engine, budgets, f=f, capacity=capacity, epsilon=epsilon,
            batch_size=batch_size, max_candidates=max_candidates, prune=prune,
            policy=policy, policy_backend=policy_backend, load=load, fused=fused,
            collect_additions=False, stats_acc=acc_holder, sync_host=False,
        )
        # cost / failed / skipped of fused runs live in the deferred device
        # accumulator and drain once after the stream
        stats.total_cost += cstats.total_cost
        stats.failed_paths += cstats.failed_paths
        stats.paths_processed += cstats.paths_processed
        stats.fallback_paths += cstats.fallback_paths
        stats.routed_skips += cstats.routed_skips
        stats.routed_violations += cstats.routed_violations
        stats.table_peak_rows = max(stats.table_peak_rows, cstats.table_peak_rows)
        stats.table_total_rows += cstats.table_total_rows
        for k, v in cstats.stage_s.items():
            stats.stage_s[k] = stats.stage_s.get(k, 0.0) + v
        if cstats.timeline:
            stats.timeline = (stats.timeline or []) + cstats.timeline

    overlap_s = double_buffer(stream, dispatch)
    if acc_holder is not None:
        acc_holder.drain(stats)
    stats.ingest_overlap_s = stream.stats.ingest_overlap_s = overlap_s
    # the one end-of-stream host sync the per-chunk sync_host=False deferred
    scheme.mask = engine.packed.unpack()
    stats.replicas = scheme.replica_count()
    stats.peak_resident_paths = stream.stats.peak_resident_paths
    stream.stats.peak_resident_table_rows = stats.table_peak_rows
    stream.stats.total_table_rows = stats.table_total_rows
    stats.runtime_s = time.perf_counter() - t0
    if obs.enabled():
        obs.REGISTRY.gauge("repro.stream.ingest_overlap_s").set(overlap_s)
        obs.REGISTRY.gauge("repro.stream.peak_resident_paths").set(stats.peak_resident_paths)
        obs.REGISTRY.counter("repro.stream.chunks").inc(stream.stats.chunks)
    if return_engine:
        return scheme, stats, engine
    return scheme, stats
