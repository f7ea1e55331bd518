"""Policy-routed access walk (Eqn 1 + a routing policy), full trace.

Replaces the TPU kernels ``routed_walk_pallas`` and ``scored_walk_pallas``
in ``src/repro/kernels/routed_walk.py`` (``_make_kernel``,
``_make_scored_kernel``, ``_pick``, ``_unpack``).  The CUDA sources are
``repro_torch/csrc/routed_walk.cu`` and ``scored_walk.cu``, sharing the
holder pick of ``walk_common.cuh``: one thread per path; a remote hop's
pick walks the set bits of the object's W words with ``__ffs`` (holders
of the next object first under ``lookahead``) instead of unpacking the
``[W*32, block]`` plane the TPU kernels build.  The routed walk ranks
holders by a per-server load vector staged in shared memory
(``home_first`` and ``lookahead`` are template flags); the scored walk
(``nearest_copy_dp``) ranks them by the path's own score row
``scores[p, i, :]`` and has no lookahead.

Bound on the card: bytes.  Per path the walk reads the objects and the
length once, the start server, and per valid position the object's W
words, its home and (under lookahead) the next object's W words; it
writes the ``[P, L]`` int32 server trace and the ``[P, L]`` uint8
locality trace.  The integer work per byte is small, so device-memory
bandwidth is the ceiling; the trace writes dominate for short paths.

The scored walk adds, per remote hop, one 4-byte score read for every
holder of the hopped-to object; its score plane ``[P, L, W*32]`` is the
largest input, but only the holders' entries are read.

Semantics (kept exactly): ``server0 = len > 0 ? start : 0`` and position 0
is local iff ``len > 0``; a -1 server is never local at the next
position; the pick takes the lowest load (score), home wins ties (when
``home >= 0``), then the lowest id; no holder gives -1.
"""
from __future__ import annotations

import torch

from repro_torch.engine.packed import unpack_bits
from repro_torch.kernels.build import check_launch, load_library

LAUNCHES = 0
SCORED_LAUNCHES = 0


def pick_targets(cand, home, load):
    """Lowest-load holder per lane; home wins ties, then the lowest id.

    ``cand`` bool [P, Sp], ``home`` int32 [P] (may be -1), ``load`` float32
    [Sp] (one shared rank per server) or [P, Sp] (a per-lane score row).
    Returns int32 [P]; -1 when a lane has no candidate.  The scalar twins
    are ``repro_torch.engine.routing.pick_holder_host`` and
    ``pick_holder_scored``.
    """
    any_c = cand.any(dim=1)
    lv = torch.where(cand, load.expand_as(cand), torch.inf)
    m = lv.min(dim=1).values
    best = cand & (lv <= m[:, None])
    hc = home.clamp_min(0).long()
    home_ok = (home >= 0) & best.gather(1, hc[:, None])[:, 0]
    first = best.to(torch.uint8).argmax(dim=1).int()
    tgt = torch.where(home_ok, home.int(), first)
    return torch.where(any_c, tgt, -1)


def routed_walk_plain(objects, lengths, words, home, start, load,
                      lookahead: bool = True, home_first: bool = False):
    """Plain torch version: (servers int32 [P, L], local bool [P, L]).

    The port of the JAX package's ``backends._routed_trace_impl`` (and,
    with ``home_first=True``, of its ``_access_trace_impl``); the torch
    backend walks with it.  ``objects`` int32 [P, L] (-1 pad),
    ``lengths`` int32 [P], ``words`` int32 [n + 1, W], ``home`` int32 [n]
    per-object routing target (may be -1), ``start`` int32 [P], ``load``
    float32 [W*32].
    """
    P, L = objects.shape
    dev = objects.device
    valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    safe = objects.clamp_min(0).long()
    hrows = home[safe]  # [P, L]
    server = torch.where(valid[:, 0], start, 0).int()
    servers = [server]
    locals_ = [valid[:, 0]]
    for i in range(1, L):
        w_t = words[safe[:, i]]  # [P, W]
        srv_c = server.clamp_min(0).long()
        word = w_t.gather(1, (srv_c // 32)[:, None])[:, 0]
        has_local = ((word >> (srv_c % 32)) & 1).bool() & (server >= 0)
        if home_first:
            tgt = hrows[:, i]
        else:
            cand = unpack_bits(w_t)
            tgt = pick_targets(cand, hrows[:, i], load)
            if lookahead and i + 1 < L:
                nxt_ok = valid[:, i + 1, None]
                la = cand & unpack_bits(words[safe[:, i + 1]]) & nxt_ok
                pref = pick_targets(la, hrows[:, i], load)
                tgt = torch.where(la.any(dim=1), pref, tgt)
        nxt = torch.where(has_local, server, tgt.int())
        server = torch.where(valid[:, i], nxt, server)
        servers.append(server)
        locals_.append(has_local & valid[:, i])
    return torch.stack(servers, dim=1), torch.stack(locals_, dim=1)


def scored_walk_plain(objects, lengths, words, home, start, scores):
    """Plain torch version of the scored walk: (servers, local).

    The port of the JAX package's ``backends._scored_walk``: the routed
    walk without lookahead whose remote-hop pick ranks holders by
    ``scores[:, i, :]`` (float32 [P, L, W*32], the ``nearest_copy_dp``
    cost-to-go) instead of a shared load vector.  Other arguments as in
    :func:`routed_walk_plain`.
    """
    P, L = objects.shape
    dev = objects.device
    valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    safe = objects.clamp_min(0).long()
    hrows = home[safe]
    server = torch.where(valid[:, 0], start, 0).int()
    servers = [server]
    locals_ = [valid[:, 0]]
    for i in range(1, L):
        w_t = words[safe[:, i]]
        srv_c = server.clamp_min(0).long()
        word = w_t.gather(1, (srv_c // 32)[:, None])[:, 0]
        has_local = ((word >> (srv_c % 32)) & 1).bool() & (server >= 0)
        tgt = pick_targets(unpack_bits(w_t), hrows[:, i], scores[:, i])
        nxt = torch.where(has_local, server, tgt.int())
        server = torch.where(valid[:, i], nxt, server)
        servers.append(server)
        locals_.append(has_local & valid[:, i])
    return torch.stack(servers, dim=1), torch.stack(locals_, dim=1)


def _check(objects, lengths, words, home, start, load, scored: bool = False):
    dev = objects.device
    for name, t, dt in (("objects", objects, torch.int32),
                        ("lengths", lengths, torch.int32),
                        ("words", words, torch.int32),
                        ("home", home, torch.int32),
                        ("start", start, torch.int32),
                        ("scores" if scored else "load", load, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, objects on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if objects.dim() != 2 or objects.shape[1] < 1:
        raise ValueError(f"objects must be [P, L] with L >= 1, got {tuple(objects.shape)}")
    P = objects.shape[0]
    if lengths.shape != (P,) or start.shape != (P,):
        raise ValueError("lengths and start must be [P]")
    if words.dim() != 2 or home.dim() != 1 or words.shape[0] != home.shape[0] + 1:
        raise ValueError("words must be [n + 1, W] and home [n]")
    Sp = words.shape[1] * 32
    if scored and load.shape != (P, objects.shape[1], Sp):
        raise ValueError(f"scores must be [P, L, W*32] = [{P}, {objects.shape[1]}, {Sp}]")
    if not scored and load.shape != (Sp,):
        raise ValueError(f"load must be [W*32] = [{Sp}]")


def routed_walk(objects, lengths, words, home, start, load,
                lookahead: bool = True, home_first: bool = False):
    """(servers, local): the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor.  See :func:`routed_walk_plain`."""
    global LAUNCHES
    _check(objects, lengths, words, home, start, load)
    if objects.device.type == "cpu":
        return routed_walk_plain(objects, lengths, words, home, start, load,
                                 lookahead=lookahead, home_first=home_first)
    if objects.device.type != "cuda":
        raise ValueError(f"unsupported device {objects.device}")
    P, L = objects.shape
    servers = torch.empty((P, L), dtype=torch.int32, device=objects.device)
    local = torch.empty((P, L), dtype=torch.uint8, device=objects.device)
    if P == 0:
        return servers, local.view(torch.bool)
    lib = load_library()
    with torch.cuda.device(objects.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.routed_walk_launch(
            objects.data_ptr(), lengths.data_ptr(), words.data_ptr(),
            home.data_ptr(), start.data_ptr(), load.data_ptr(),
            P, L, words.shape[1], int(home_first), int(lookahead),
            servers.data_ptr(), local.data_ptr(), stream,
        )
    check_launch("routed_walk", err)
    LAUNCHES += 1
    return servers, local.view(torch.bool)


def scored_walk(objects, lengths, words, home, start, scores):
    """(servers, local): the scored-walk CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor.  See :func:`scored_walk_plain`."""
    global SCORED_LAUNCHES
    _check(objects, lengths, words, home, start, scores, scored=True)
    if objects.device.type == "cpu":
        return scored_walk_plain(objects, lengths, words, home, start, scores)
    if objects.device.type != "cuda":
        raise ValueError(f"unsupported device {objects.device}")
    P, L = objects.shape
    servers = torch.empty((P, L), dtype=torch.int32, device=objects.device)
    local = torch.empty((P, L), dtype=torch.uint8, device=objects.device)
    if P == 0:
        return servers, local.view(torch.bool)
    lib = load_library()
    with torch.cuda.device(objects.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.scored_walk_launch(
            objects.data_ptr(), lengths.data_ptr(), words.data_ptr(),
            home.data_ptr(), start.data_ptr(), scores.data_ptr(),
            P, L, words.shape[1], servers.data_ptr(), local.data_ptr(), stream,
        )
    check_launch("scored_walk", err)
    SCORED_LAUNCHES += 1
    return servers, local.view(torch.bool)
