"""The three latency-evaluation backends behind ``LatencyEngine``.

All backends compute the same quantity — h(p, r, rho), the number of
distributed traversals of a path under the access function (paper
Eqns 1-2) — with identical integer semantics:

  ``reference``  pure-python oracle (``repro_torch.core.reference``), host mask.
  ``torch``      plain torch ops over the packed device words; the walk
                 over the L positions is a Python loop.
  ``kernel``     the hand-written CUDA kernels (``repro_torch.kernels``);
                 CUDA devices only.

``resolve_backend`` fills in the default from the device: ``kernel`` on
CUDA, ``torch`` on the CPU.  Asking for ``kernel`` on the CPU raises.
``nearest_copy_dp`` scores holders with the suffix-DP tables of
:func:`_dp_score_tables` (torch ops on either backend) and walks with the
scored pick (``scored_walk`` on ``kernel``, its plain version on
``torch``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.packed import test_bits, unpack_bits
from repro_torch.engine.routing import resolve_policy
from repro_torch.engine.streaming import to_device, to_host
from repro_torch.kernels.path_latency import path_latency, path_latency_plain
from repro_torch.kernels import prune_walk as _prune_walk
from repro_torch.kernels.routed_walk import (
    routed_walk,
    routed_walk_plain,
    scored_walk,
    scored_walk_plain,
)

BACKENDS = ("reference", "torch", "kernel")

# float32 elements of one DP score plane [rows, L, W*32]: a DP walk over
# more rows than this is split into row chunks (256 MiB per plane)
DP_PLANE_ELEMS = 1 << 26


def resolve_backend(backend, device: torch.device) -> str:
    """``None`` -> ``kernel`` on CUDA, ``torch`` on the CPU."""
    if backend is None:
        return "kernel" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use {BACKENDS}")
    if backend == "kernel" and device.type != "cuda":
        raise ValueError("the kernel backend needs a CUDA device")
    return backend


def _valid(objects, lengths):
    L = objects.shape[1]
    return torch.arange(L, device=objects.device)[None, :] < lengths[:, None]


# ---------------------------------------------------------------------------
# Home-first evaluation.
# ---------------------------------------------------------------------------
# The torch scan of the access function over the packed words.  The JAX
# package fills pad homes with 0 where its kernel prep uses -1 and clamps;
# both give the same counts, and the plain version clamps.
words_scan = path_latency_plain


def bool_scan(objects, lengths, mask, shard):
    """The same walk over an unpacked bool [n, S] mask instead of packed
    words (the JAX package's legacy ``bool_scan``); an independent check
    of the packed formulation."""
    L = objects.shape[1]
    valid = _valid(objects, lengths)
    safe = objects.clamp_min(0).long()
    home = torch.where(valid, shard[safe], 0).long()
    server = home[:, 0]
    cost = torch.zeros(objects.shape[0], dtype=torch.int32, device=objects.device)
    for i in range(1, L):
        miss = valid[:, i] & ~mask[safe[:, i], server]
        cost += miss.int()
        server = torch.where(miss, home[:, i], server)
    return cost


def kernel_eval(objects, lengths, words, shard):
    """Home-first h per path through the CUDA kernel."""
    return path_latency(objects, lengths, words, shard)


def reference_eval(objects, lengths, mask, shard, policy=None, load=None) -> np.ndarray:
    """Pure-python oracle over a host mask (``repro_torch.core.reference``):
    the home-first walk, or the routed walk under any other ``policy``
    (``load`` the forecast a ``queue_aware`` policy prices with)."""
    from repro_torch.core.reference import (  # lazy: no cycle
        path_latencies_reference,
        routed_path_latencies_reference,
    )

    pol = resolve_policy(policy)
    if pol.name == "home_first":
        return path_latencies_reference(objects, lengths, mask, shard)
    return routed_path_latencies_reference(
        objects, lengths, mask, shard, policy=pol, load=load
    )


# ---------------------------------------------------------------------------
# Policy-parameterized walk: the per-hop target is a function of (current
# server, object words, home, load) instead of the constant ``home[obj]``.
# ---------------------------------------------------------------------------
def _root_home(objects, home):
    return home[objects[:, 0].clamp_min(0).long()].int()


def _load_vector(load, words) -> torch.Tensor:
    """Pad a per-server load vector to the words' W*32 bit width.

    Bits past ``n_servers`` are never set in the packed words, so the pad
    value is irrelevant (padded servers are never candidates).
    """
    width = words.shape[1] * 32
    out = np.zeros(width, np.float32)
    if load is not None:
        lv = np.asarray(load, np.float32)
        out[: lv.shape[0]] = lv
    return to_device(out, words.device)


# ---------------------------------------------------------------------------
# Depth-k suffix DP (``nearest_copy_dp``): score every server by the optimal
# paid-hop count over the next k accesses, then walk with the scored pick.
# ---------------------------------------------------------------------------
def _dp_score_tables(objects, lengths, words, depth: int) -> torch.Tensor:
    """``E[p, pos, s]``: optimal paid hops over the next ``depth`` accesses.

    The port of the JAX package's ``backends._dp_score_tables`` (the
    batched twin of ``routing.dp_suffix_scores``; the dead -1 state is
    tracked in a separate ``D`` plane).  A hop may land on any holder of
    the hopped-to object; an object with no holder sends the walk to the
    dead state, from which nothing is local but later hops still revive.
    ``depth < 0`` scores the whole suffix (one backward loop over the
    positions); ``depth >= 0`` runs ``depth`` window-widening sweeps.
    Values are small integers in float32, so every backend agrees
    exactly.  Returns float32 ``[P, L, W*32]``.
    """
    P, L = objects.shape
    dev = objects.device
    valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    hold = unpack_bits(words[objects.clamp_min(0).long()]) & valid[:, :, None]
    Sp = hold.shape[2]
    if L == 1:
        return torch.zeros((P, L, Sp), dtype=torch.float32, device=dev)

    def hop_cost(hold_next, V_next, D_next):
        vmin = torch.where(hold_next, V_next, torch.inf).amin(dim=-1)
        return 1.0 + torch.where(hold_next.any(dim=-1), vmin, D_next)

    if depth < 0:
        # full suffix: one backward pass, carry = (V at pos + 1, dead value)
        V = torch.zeros((P, Sp), dtype=torch.float32, device=dev)
        D = torch.zeros((P,), dtype=torch.float32, device=dev)
        rows = [V]
        for pos in range(L - 2, -1, -1):
            hold_next, v_next = hold[:, pos + 1], valid[:, pos + 1]
            hop = hop_cost(hold_next, V, D)
            V = torch.where(v_next[:, None], torch.where(hold_next, V, hop[:, None]), 0.0)
            D = torch.where(v_next, hop, 0.0)
            rows.append(V)
        return torch.stack(rows[::-1], dim=1)

    # window-widening sweeps: E_m[pos] from E_{m-1}[pos + 1] (position shift)
    E = torch.zeros((P, L, Sp), dtype=torch.float32, device=dev)
    D = torch.zeros((P, L), dtype=torch.float32, device=dev)
    hold_next = torch.cat([hold[:, 1:], torch.zeros_like(hold[:, :1])], dim=1)
    v_next = torch.cat([valid[:, 1:], torch.zeros_like(valid[:, :1])], dim=1)
    for _ in range(depth):
        E_next = torch.cat([E[:, 1:], torch.zeros_like(E[:, :1])], dim=1)
        D_next = torch.cat([D[:, 1:], torch.zeros_like(D[:, :1])], dim=1)
        hop = hop_cost(hold_next, E_next, D_next)  # [P, L]
        E = torch.where(v_next[:, :, None],
                        torch.where(hold_next, E_next, hop[:, :, None]), 0.0)
        D = torch.where(v_next, hop, 0.0)
    return E


def _dp_depth(pol) -> int:
    return -1 if pol.depth is None else int(pol.depth)


def _dp_trace(objects, lengths, words, home, start, depth: int, backend: str):
    """Scored walk over the DP tables, in row chunks of at most
    ``DP_PLANE_ELEMS`` score elements (rows are independent)."""
    walk = scored_walk if backend == "kernel" else scored_walk_plain
    P, L = objects.shape
    step = max(1, DP_PLANE_ELEMS // (L * words.shape[1] * 32))
    servers, local = [], []
    for r in range(0, max(P, 1), step):
        o, ln = objects[r : r + step], lengths[r : r + step]
        scores = _dp_score_tables(o, ln, words, depth)
        s, l = walk(o, ln, words, home, start[r : r + step], scores)
        servers.append(s)
        local.append(l)
    return torch.cat(servers), torch.cat(local)


def _trace(objects, lengths, words, home, pol, rank, start, backend):
    """Policy-routed trace: the CUDA kernels on ``kernel``, their plain
    versions on ``torch``.  ``rank`` is the padded ``[W*32]`` load vector
    (unused by ``nearest_copy_dp``, whose scores are the DP tables)."""
    if backend not in ("torch", "kernel"):
        raise ValueError(f"device walks run on torch | kernel, got {backend!r}")
    if start is None:
        start = _root_home(objects, home)
    if pol.name == "nearest_copy_dp":
        return _dp_trace(objects, lengths, words, home, start, _dp_depth(pol), backend)
    walk = routed_walk if backend == "kernel" else routed_walk_plain
    return walk(objects, lengths, words, home, start, rank,
                lookahead=pol.lookahead, home_first=pol.name == "home_first")


def access_trace(objects, lengths, words, home, start=None, policy=None,
                 load=None, backend: str = "torch"):
    """Walk Eqn 1 recording the visited server and locality per position.

    ``home`` is a per-object routing target (may be -1); ``start``
    optionally overrides the per-path start server (default
    ``home[root]``); ``policy`` selects the remote-hop rule and ``load``
    is the per-server vector a ``queue_aware`` policy ranks holders by.
    Returns (servers int32 [P, L], local bool [P, L]); position 0 counts
    as local when the path is non-empty.
    """
    pol = resolve_policy(policy)
    rank = _load_vector(load if pol.uses_load else None, words)
    return _trace(objects, lengths, words, home, pol, rank, start, backend)


def gate_counts(objects, lengths, words, shard, pol, rank, backend: str = "torch"):
    """Routed h per path for a resolved policy and a padded ``[W*32]``
    holder-rank vector ``rank`` (``_load_vector`` of the load for
    ``queue_aware``, zeros otherwise)."""
    _, local = _trace(objects, lengths, words, shard, pol, rank, None, backend)
    return (_valid(objects, lengths) & ~local).sum(dim=1, dtype=torch.int32)


def prune_sweep(words, cand_v, cand_s, starts, rows, objects, lengths, t_path, home,
                pol, rank, backend: str = "torch"):
    """The serial prune's whole candidate sequence for a resolved policy:
    keep bool [C], ``words`` pruned in place.  On ``kernel`` one launch of
    ``prune_walk`` (``prune_walk_scored`` under ``nearest_copy_dp``, at the
    policy's depth); on ``torch`` their plain per-candidate loops.  ``rank``
    is unused by ``nearest_copy_dp``."""
    if backend not in ("torch", "kernel"):
        raise ValueError(f"the prune sweep runs on torch | kernel, got {backend!r}")
    args = (words, cand_v, cand_s, starts, rows, objects, lengths, t_path, home)
    kernel = backend == "kernel"
    if pol.name == "nearest_copy_dp":
        sweep = (_prune_walk.prune_walk_scored if kernel
                 else _prune_walk.prune_walk_scored_plain)
        return sweep(*args, depth=_dp_depth(pol))
    sweep = _prune_walk.prune_walk if kernel else _prune_walk.prune_walk_plain
    return sweep(*args, rank, home_first=pol.name == "home_first", lookahead=pol.lookahead)


def routed_counts(objects, lengths, words, shard, policy, load=None,
                  backend: str = "torch"):
    """h(p, r, rho) per path under a routing policy."""
    pol = resolve_policy(policy)
    rank = _load_vector(load if pol.uses_load else None, words)
    return gate_counts(objects, lengths, words, shard, pol, rank, backend)


def kernel_routed_eval(objects, lengths, words, shard, policy, load=None):
    """Distributed-traversal counts from the routed-walk kernel."""
    return routed_counts(objects, lengths, words, shard, policy, load, backend="kernel")


# ---------------------------------------------------------------------------
# k-resilient evaluation: the masked re-walk over every loss case.
# ---------------------------------------------------------------------------
def mask_case_words(words, case_mask):
    """Clear one loss case's holder bits: ``words & ~case_mask`` per row
    (int32 words and mask, see ``resilience.case_word_mask``)."""
    return words & ~case_mask[None, :]


def _case_counts(objects, lengths, words, home, pol, rank, backend):
    """h per path for one (possibly masked) word table and home vector."""
    if pol.name == "home_first":
        fn = kernel_eval if backend == "kernel" else words_scan
        return fn(objects, lengths, words, home)
    return gate_counts(objects, lengths, words, home, pol, rank, backend)


def resilient_counts(objects, lengths, words, case_masks, case_homes, policy=None,
                     load=None, backend: str = "torch"):
    """h(p, r - case, rho; policy) per (loss case, path): int32 [D, P].

    For each case the lost servers' holder bits are cleared from the
    packed words (``case_masks`` int32 [D, W]) and the walk runs under the
    case's rotation-failover homes (``case_homes`` int32 [D, n]).  On
    ``kernel`` each case is one launch of the existing walk over its
    masked words (``path_latency``, ``routed_walk``, or ``scored_walk``
    under ``nearest_copy_dp``).  On ``torch`` all D cases are one batched
    evaluation: the D masked tables are stacked into one ``[D*(n+1), W]``
    table, each case's object ids offset into its block, and the plain
    walk runs once over the ``[D*P, L]`` rows (rows are independent, so
    each row's count is the per-case walk's).  The reference loop is
    :func:`case_latencies`'.
    """
    if backend not in ("torch", "kernel"):
        raise ValueError(f"resilient_counts runs on torch | kernel, got {backend!r}")
    pol = resolve_policy(policy)
    rank = _load_vector(load if pol.uses_load else None, words)
    D = case_masks.shape[0]
    if backend == "kernel":
        return torch.stack([
            _case_counts(objects, lengths, mask_case_words(words, case_masks[d]),
                         case_homes[d], pol, rank, backend)
            for d in range(D)
        ])
    R = words.shape[0]  # n + 1: each case's block keeps its sacrificial row
    P = objects.shape[0]
    w_all = (words[None] & ~case_masks[:, None, :]).reshape(D * R, -1)
    pad = torch.zeros((D, 1), dtype=case_homes.dtype, device=case_homes.device)
    h_all = torch.cat([case_homes, pad], dim=1).reshape(-1)
    off = (torch.arange(D, device=objects.device, dtype=torch.int32) * R)[:, None, None]
    o_all = torch.where(objects[None] >= 0, objects[None] + off, -1).reshape(D * P, -1)
    l_all = lengths.repeat(D)
    return _case_counts(o_all, l_all, w_all, h_all, pol, rank, backend).reshape(D, P)


def case_latencies(packed, objects, lengths, cases, homes, policy=None, load=None,
                   backend: str = "torch") -> np.ndarray:
    """h per (loss case, path) against ``packed``'s current words, int32
    [D, P] on the host: loss case d (server ids ``cases[d]``) clears its
    servers' holder bits and walks under the rotation-failover homes
    ``homes[d]``.  ``torch`` and ``kernel`` run :func:`resilient_counts`;
    ``reference`` loops the host oracle over per-case masks.  ``objects``
    and ``lengths`` are host arrays."""
    from repro_torch.engine.resilience import case_word_mask  # lazy: no cycle

    objects = np.asarray(objects, np.int32)
    lengths = np.asarray(lengths, np.int32)
    if backend == "reference":
        mask = packed.unpack()
        rows = []
        for c, fs in zip(cases, homes):
            m = mask.copy()
            m[:, np.asarray(c)] = False
            rows.append(reference_eval(objects, lengths, m, fs, policy, load))
        return np.stack(rows).astype(np.int32)
    device = packed.device
    case_masks = np.stack([case_word_mask(c, packed.n_words) for c in cases])
    out = resilient_counts(
        to_device(objects, device),
        to_device(lengths, device),
        packed.words,
        to_device(case_masks, device),
        to_device(np.stack(homes).astype(np.int32), device),
        policy=policy,
        load=load,
        backend=backend,
    )
    return to_host(out).astype(np.int32)


def query_slack(path_lats, query_ids, t_q):
    """Per-query slack t_Q - l_Q on the device (int32 [nq]).

    l_Q is the max over the query's paths (Def 4.3); queries with no paths
    have l_Q = 0 (slack = budget).
    """
    lq = torch.zeros_like(t_q).scatter_reduce(
        0, query_ids.long(), path_lats.to(t_q.dtype), "amax", include_self=True
    )
    return t_q - lq


def margin_cost(words, f, objects, servers):
    """Marginal storage cost of candidate (object, server) additions.

    Snapshot semantics against the device words: each pair whose bit is
    not yet set contributes ``f[v]``; duplicates count once per
    occurrence.  Negative pairs are ignored.  Reduces over the last axis.
    """
    ok = (objects >= 0) & (servers >= 0)
    o = objects.clamp_min(0)
    s = servers.clamp_min(0)
    need = ok & ~test_bits(words, o, s)
    return torch.where(need, f[o.long()], 0.0).sum(dim=-1)
