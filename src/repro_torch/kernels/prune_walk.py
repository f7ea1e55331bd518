"""The serial prune sweep of the policy-routed walk, in one launch.

Replaces, for the serial prune (``prune_scheme_replicas`` with
``fused=False``), the per-candidate launches of the TPU kernel
``routed_walk_pallas`` (``src/repro/kernels/routed_walk.py``) that the JAX
package's prune makes through ``routed_counts``.  The CUDA source is
``repro_torch/csrc/prune_walk.cu``: one block of 1024 threads runs the
whole candidate sequence, each decision a clear of one bit, a re-walk of
the candidate's paths (``walk_path`` of ``walk_common.cuh``, shared with
``routed_walk.cu``) and a restore on a violation, so no host round trip
separates two candidates.

Bound on the card: neither bytes nor operations but the chain of
dependent decisions.  Each reads a few words from L2 (the prune's working
set fits in it) and crosses two block barriers; the bytes the sweep must
move (the candidates, their CSR ranges and rows, the paths' objects and
budgets, the objects' homes and words, one word written per candidate and
the keep flags) take microseconds at the memory rate.

``words`` is mutated in place: on return it holds the pruned scheme.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, load_library

LAUNCHES = 0
# the [W*32] rank vector sits in the kernel's shared memory (48 KiB)
MAX_W = 384


def _gate_ok(rows, objects, lengths, t_path, words, home, rank, home_first, lookahead):
    """Whether every path in ``rows`` stays within its budget: the routed
    count of non-local positions 1 .. len - 1 from ``home[objects[p, 0]]``
    (``backends.gate_counts``) against ``t_path``."""
    # local: routed_walk imports the engine, whose backends import this module
    from repro_torch.kernels.routed_walk import routed_walk_plain

    o, ln = objects[rows], lengths[rows]
    start = home[o[:, 0].clamp_min(0).long()]
    _, local = routed_walk_plain(o, ln, words, home, start, rank,
                                 lookahead=lookahead, home_first=home_first)
    valid = torch.arange(o.shape[1], device=o.device)[None, :] < ln[:, None]
    h = (valid & ~local).sum(dim=1, dtype=torch.int32)
    return not bool((h > t_path[rows]).any())


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
    C = cand_v.shape[0]
    keep = torch.ones(C, dtype=torch.bool, device=words.device)
    st = starts.tolist()
    for c, (v, s) in enumerate(zip(cand_v.tolist(), cand_s.tolist())):
        cell = words[v, s // 32]
        bit = -(2**31) if s % 32 == 31 else 1 << (s % 32)  # int32 with bit s % 32 set
        cell &= ~bit
        r = rows[st[v]: st[v + 1]].long()
        if len(r) and not _gate_ok(r, objects, lengths, t_path, words, home, rank,
                                   home_first, lookahead):
            cell |= bit
            keep[c] = False
    return keep


def _check(words, cand_v, cand_s, starts, rows, objects, lengths, t_path, home, rank):
    dev = words.device
    for name, t, dt in (("words", words, torch.int32), ("cand_v", cand_v, torch.int32),
                        ("cand_s", cand_s, torch.int32), ("starts", starts, torch.int32),
                        ("rows", rows, torch.int32), ("objects", objects, torch.int32),
                        ("lengths", lengths, torch.int32), ("t_path", t_path, torch.int32),
                        ("home", home, torch.int32), ("rank", rank, torch.float32)):
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
    if rank.shape != (W * 32,):
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
    if W > MAX_W:
        raise ValueError(f"prune_walk takes W <= {MAX_W} words ({MAX_W * 32} servers), got {W}")
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
