"""Path latency h(p, r, rho) under home-first routing (paper Eqns 1-2).

Replaces the TPU kernel ``path_latency_pallas`` in
``src/repro/kernels/path_latency.py`` (body ``_kernel``).  The CUDA source
is ``repro_torch/csrc/path_latency.cu``: one thread per path, looping over
the L positions.  Each thread gathers ``shard[obj]`` and the single word
``words[obj, server // 32]`` it tests, so the ``[P, L, W]`` gather the TPU
layout pre-materialises is never built.

Bound on the card: bytes.  The walk reads each path's objects and length
once and one word plus one shard entry per valid position, and writes one
int32 per path; it does a handful of integer operations per byte, so
device-memory bandwidth (3.35 TB/s on an H100 SXM) is the ceiling.
Neighbouring threads read ``objects`` with a stride of L; a transposed
layout that coalesces those reads is left for a later change.

Semantics (kept exactly): ``server0 = max(home[0], 0)`` (0 for an empty
path); position ``i`` counts only when ``i < len``; on a miss the walk
moves to ``max(home[i], 0)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, load_library

LAUNCHES = 0


def path_latency_plain(objects, lengths, words, shard) -> torch.Tensor:
    """Plain torch version: int32 [P] distributed traversals per path.

    ``objects`` int32 [P, L] (-1 pad), ``lengths`` int32 [P], ``words``
    int32 [n + 1, W] packed holder bits, ``shard`` int32 [n].
    """
    P, L = objects.shape
    dev = objects.device
    valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    safe = objects.clamp_min(0).long()
    home = shard[safe].clamp_min(0).long()  # [P, L]
    server = torch.where(valid[:, 0], home[:, 0], 0)
    cost = torch.zeros(P, dtype=torch.int32, device=dev)
    for i in range(1, L):
        word = words[safe[:, i], server // 32]
        local = ((word >> (server % 32)) & 1).bool()
        miss = valid[:, i] & ~local
        cost += miss.int()
        server = torch.where(miss, home[:, i], server)
    return cost


def _check(objects, lengths, words, shard):
    dev = objects.device
    for name, t in (("objects", objects), ("lengths", lengths),
                    ("words", words), ("shard", shard)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, objects on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if objects.dim() != 2 or objects.shape[1] < 1:
        raise ValueError(f"objects must be [P, L] with L >= 1, got {tuple(objects.shape)}")
    if lengths.shape != (objects.shape[0],):
        raise ValueError("lengths must be [P]")
    if words.dim() != 2 or shard.dim() != 1 or words.shape[0] != shard.shape[0] + 1:
        raise ValueError("words must be [n + 1, W] and shard [n]")


def path_latency(objects, lengths, words, shard) -> torch.Tensor:
    """h per path: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor.  See :func:`path_latency_plain` for the arguments."""
    global LAUNCHES
    _check(objects, lengths, words, shard)
    if objects.device.type == "cpu":
        return path_latency_plain(objects, lengths, words, shard)
    if objects.device.type != "cuda":
        raise ValueError(f"unsupported device {objects.device}")
    P, L = objects.shape
    out = torch.empty(P, dtype=torch.int32, device=objects.device)
    if P == 0:
        return out
    lib = load_library()
    with torch.cuda.device(objects.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.path_latency_launch(
            objects.data_ptr(), lengths.data_ptr(), words.data_ptr(),
            shard.data_ptr(), P, L, words.shape[1], out.data_ptr(), stream,
        )
    check_launch("path_latency", err)
    LAUNCHES += 1
    return out
