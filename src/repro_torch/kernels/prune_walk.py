"""The serial prune sweep of the policy-routed and scored walks, in one launch.

Replaces, for the serial prune (``prune_scheme_replicas``), the
per-candidate launches of the TPU kernels ``routed_walk_pallas`` and (under
``nearest_copy_dp``) ``scored_walk_pallas`` (``src/repro/kernels/
routed_walk.py``) that the JAX package's prune makes through
``routed_counts``.  The CUDA source is ``repro_torch/csrc/prune_walk.cu``:
one block of 1024 threads runs the whole candidate sequence, each decision
a clear of one bit, a re-walk of the candidate's paths and a restore on a
violation, so no host round trip separates two candidates.  ``prune_walk``
walks with ``walk_path`` (``walk_common.cuh``, shared with
``routed_walk.cu``); ``prune_walk_scored`` walks with ``nearest_copy_dp``'s
scored pick (``dp_gate``), rebuilding each affected path's DP scores from
the current words inside the walk instead of a ``[P, L, W*32]`` plane.

Bound on the card: neither bytes nor operations but the chain of
dependent decisions.  Each reads a few words from L2 (the prune's working
set fits in it) and crosses two block barriers; the bytes the sweep must
move (the candidates, their CSR ranges and rows, the paths' objects and
budgets, the objects' homes and words, one word written per candidate and
the keep flags) take microseconds at the memory rate.

``words`` is mutated in place: on return it holds the pruned scheme.
Both kernels take any L and W: ``prune_walk`` reads its rank vector from
device memory past the 12,288 servers it stages in shared memory;
``prune_walk_scored`` keeps a path's DP hop values in a per-thread array
up to ``SCORED_REG_L`` positions and, past that, in a device scratch this
wrapper allocates.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, load_library

LAUNCHES = 0
SCORED_LAUNCHES = 0
# the scored kernel's block (csrc kThreads) and its longest path with the
# hop values in a per-thread array (csrc kDpMaxL)
_THREADS = 1024
SCORED_REG_L = 64


def _gate_ok(rows, objects, lengths, t_path, walk):
    """Whether every path in ``rows`` stays within its budget: the count of
    non-local positions 1 .. len - 1 of ``walk(o, ln)``'s locality trace
    (from ``home[objects[p, 0]]``, as ``backends.gate_counts`` walks)
    against ``t_path``."""
    o, ln = objects[rows], lengths[rows]
    _, local = walk(o, ln)
    valid = torch.arange(o.shape[1], device=o.device)[None, :] < ln[:, None]
    h = (valid & ~local).sum(dim=1, dtype=torch.int32)
    return not bool((h > t_path[rows]).any())


def _plain_sweep(words, cand_v, cand_s, starts, rows, objects, lengths, t_path, walk):
    """The per-candidate loop of both plain versions (see
    :func:`prune_walk_plain`); ``walk(o, ln)`` walks rows against ``words``."""
    C = cand_v.shape[0]
    keep = torch.ones(C, dtype=torch.bool, device=words.device)
    st = starts.tolist()
    for c, (v, s) in enumerate(zip(cand_v.tolist(), cand_s.tolist())):
        cell = words[v, s // 32]
        bit = -(2**31) if s % 32 == 31 else 1 << (s % 32)  # int32 with bit s % 32 set
        cell &= ~bit
        r = rows[st[v]: st[v + 1]].long()
        if len(r) and not _gate_ok(r, objects, lengths, t_path, walk):
            cell |= bit
            keep[c] = False
    return keep


def _root_start(o, home):
    return home[o[:, 0].clamp_min(0).long()]


def prune_walk_plain(words, cand_v, cand_s, starts, rows, objects, lengths, t_path,
                     home, rank, home_first: bool = False, lookahead: bool = True):
    """Plain torch version: keep bool [C], and ``words`` pruned in place.

    For each candidate replica ``(cand_v[c], cand_s[c])`` in order: clear
    its bit in ``words`` (int32 [n + 1, W]); walk every path row in
    ``rows[starts[v] : starts[v + 1]]`` (the CSR index of
    ``engine.incremental.PathIndex``) under the policy with
    :func:`~repro_torch.kernels.routed_walk.routed_walk_plain`; keep the
    removal when no path's count exceeds ``t_path`` (int32 [P]), else
    restore the bit.  ``objects`` int32 [P, L] (-1 pad), ``lengths``
    int32 [P], ``home`` int32 [n] (the shard), ``rank`` float32 [W*32]
    (the load vector for ``queue_aware``, zeros otherwise).
    """
    # local: routed_walk imports the engine, whose backends import this module
    from repro_torch.kernels.routed_walk import routed_walk_plain

    def walk(o, ln):
        return routed_walk_plain(o, ln, words, home, _root_start(o, home), rank,
                                 lookahead=lookahead, home_first=home_first)

    return _plain_sweep(words, cand_v, cand_s, starts, rows, objects, lengths, t_path, walk)


def prune_walk_scored_plain(words, cand_v, cand_s, starts, rows, objects, lengths, t_path,
                            home, depth: int = -1):
    """Plain torch version of the scored sweep (``nearest_copy_dp``): keep
    bool [C], and ``words`` pruned in place.

    As :func:`prune_walk_plain`, but each candidate's affected rows are
    walked with :func:`~repro_torch.kernels.routed_walk.scored_walk_plain`
    over their DP tables (``backends._dp_score_tables`` of depth ``depth``,
    -1 for the full suffix) rebuilt from the words after the clear.
    """
    from repro_torch.engine.backends import _dp_score_tables
    from repro_torch.kernels.routed_walk import scored_walk_plain

    def walk(o, ln):
        scores = _dp_score_tables(o, ln, words, depth)
        return scored_walk_plain(o, ln, words, home, _root_start(o, home), scores)

    return _plain_sweep(words, cand_v, cand_s, starts, rows, objects, lengths, t_path, walk)


def _check(words, cand_v, cand_s, starts, rows, objects, lengths, t_path, home, rank=None):
    dev = words.device
    args = [("words", words, torch.int32), ("cand_v", cand_v, torch.int32),
            ("cand_s", cand_s, torch.int32), ("starts", starts, torch.int32),
            ("rows", rows, torch.int32), ("objects", objects, torch.int32),
            ("lengths", lengths, torch.int32), ("t_path", t_path, torch.int32),
            ("home", home, torch.int32)]
    if rank is not None:
        args.append(("rank", rank, torch.float32))
    for name, t, dt in args:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, words on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if words.dim() != 2 or home.dim() != 1 or words.shape[0] != home.shape[0] + 1:
        raise ValueError("words must be [n + 1, W] and home [n]")
    n, W = home.shape[0], words.shape[1]
    if cand_v.dim() != 1 or cand_s.shape != cand_v.shape:
        raise ValueError("cand_v and cand_s must be [C]")
    if starts.shape != (n + 1,) or rows.dim() != 1:
        raise ValueError(f"starts must be [n + 1] = [{n + 1}] and rows [nnz]")
    if objects.dim() != 2 or objects.shape[1] < 1:
        raise ValueError(f"objects must be [P, L] with L >= 1, got {tuple(objects.shape)}")
    P = objects.shape[0]
    if lengths.shape != (P,) or t_path.shape != (P,):
        raise ValueError("lengths and t_path must be [P]")
    if rank is not None and rank.shape != (W * 32,):
        raise ValueError(f"rank must be [W*32] = [{W * 32}]")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if cand_v.shape[0]:
        lo = torch.stack([cand_v.min(), cand_s.min()])
        hi = torch.stack([cand_v.max() - n, cand_s.max() - W * 32])
        if bool((lo < 0).any() | (hi >= 0).any()):
            raise ValueError("candidates must have 0 <= v < n and 0 <= s < W*32")


def prune_walk(words, cand_v, cand_s, starts, rows, objects, lengths, t_path, home, rank,
               home_first: bool = False, lookahead: bool = True):
    """keep bool [C]: the CUDA kernel on a CUDA tensor (one launch for the
    whole sequence), the plain version on a CPU tensor.  ``words`` is
    pruned in place.  See :func:`prune_walk_plain`."""
    global LAUNCHES
    _check(words, cand_v, cand_s, starts, rows, objects, lengths, t_path, home, rank)
    args = (words, cand_v, cand_s, starts, rows, objects, lengths, t_path, home, rank)
    if words.device.type == "cpu":
        return prune_walk_plain(*args, home_first=home_first, lookahead=lookahead)
    W = words.shape[1]
    C = cand_v.shape[0]
    keep = torch.empty(C, dtype=torch.uint8, device=words.device)
    if C == 0:
        return keep.view(torch.bool)
    lib = load_library()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.prune_walk_launch(
            cand_v.data_ptr(), cand_s.data_ptr(), C, starts.data_ptr(), rows.data_ptr(),
            objects.data_ptr(), lengths.data_ptr(), t_path.data_ptr(), words.data_ptr(),
            home.data_ptr(), rank.data_ptr(), objects.shape[1], W, int(home_first),
            int(lookahead), keep.data_ptr(), stream,
        )
    check_launch("prune_walk", err)
    LAUNCHES += 1
    return keep.view(torch.bool)


def prune_walk_scored(words, cand_v, cand_s, starts, rows, objects, lengths, t_path, home,
                      depth: int = -1):
    """keep bool [C] of the ``nearest_copy_dp`` sweep (``depth`` -1 for the
    full suffix): the scored CUDA kernel on a CUDA tensor (one launch for
    the whole sequence), the plain version on a CPU tensor.  ``words`` is
    pruned in place.  See :func:`prune_walk_scored_plain`."""
    global SCORED_LAUNCHES
    _check(words, cand_v, cand_s, starts, rows, objects, lengths, t_path, home)
    args = (words, cand_v, cand_s, starts, rows, objects, lengths, t_path, home)
    if words.device.type == "cpu":
        return prune_walk_scored_plain(*args, depth=depth)
    L = objects.shape[1]
    C = cand_v.shape[0]
    keep = torch.empty(C, dtype=torch.uint8, device=words.device)
    if C == 0:
        return keep.view(torch.bool)
    # each thread's hop values for a path past SCORED_REG_L positions
    gscratch = (torch.empty(_THREADS * L, dtype=torch.int32, device=words.device)
                if L > SCORED_REG_L else None)
    lib = load_library()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.prune_walk_scored_launch(
            cand_v.data_ptr(), cand_s.data_ptr(), C, starts.data_ptr(), rows.data_ptr(),
            objects.data_ptr(), lengths.data_ptr(), t_path.data_ptr(), words.data_ptr(),
            home.data_ptr(), L, words.shape[1], int(depth),
            None if gscratch is None else gscratch.data_ptr(), keep.data_ptr(), stream,
        )
    check_launch("prune_walk_scored", err)
    SCORED_LAUNCHES += 1
    return keep.view(torch.bool)
