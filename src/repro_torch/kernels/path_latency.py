"""Path latency h(p, r, rho) under home-first routing (paper Eqns 1-2).

Replaces the TPU kernel ``path_latency_pallas`` in
``src/repro/kernels/path_latency.py:93`` (body ``_kernel``).  The CUDA
source is ``repro_torch/csrc/path_latency.cu``: one thread per path.  The
block copies its rows of ``objects`` (one contiguous span) into shared
memory with 16-byte ``cp.async``; each thread loads the home entries its
walk can move to and, for up to 128 servers (W <= 4 words), each object's
whole word row ahead of the walk, a ring of :data:`GROUP` positions in
flight, and the walk itself is a bit test and a select per position in
registers.  So
the ``[P, L, W]`` gather the TPU layout pre-materialises is never built,
and no load waits on the previous position's server.  :func:`launch_plan`
picks the block size (64 rows, so the main path's 8,192-row chunk reaches
128 of the H100's 132 SMs) and whether the span is staged.

Bound on the card: bytes.  The walk reads each path's objects and length
once and one word plus one shard entry per valid position, and writes one
int32 per path; it does a handful of integer operations per byte, so
device-memory bandwidth (3.35 TB/s on an H100 SXM) is the ceiling.  Its
gathers are random, so each moves at least one 32-byte sector.

Semantics (kept exactly): ``server0 = max(home[0], 0)`` (0 for an empty
path); position ``i`` counts only when ``i < len``; on a miss the walk
moves to ``max(home[i], 0)``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.build import check_launch, load_library

LAUNCHES = 0
THREADS = 64  # rows (threads) per block
GROUP = 8  # positions whose loads are in flight at once: the kernel's ring, kGroup
# dynamic shared memory a block may take without opting in (CUDA's default)
SHARED_BUDGET = 48 * 1024


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    threads: int  # rows (threads) per block
    group: int  # positions whose loads are in flight at once
    prefetch_row: bool  # the object's whole word row loaded ahead (W <= 4)
    staged: bool  # the block's rows copied into shared memory first


def _span_bytes(threads: int, L: int) -> int:
    """Shared memory of a staged block: its rows and a 16-byte shift."""
    return (threads * L + 4) * 4


def launch_plan(P: int, L: int, W: int) -> LaunchPlan:
    """The launch of ``P`` paths of ``L`` positions over ``W`` words.

    Blocks of :data:`THREADS` rows at every ``P``, so the main path's
    8,192-row chunk spreads over 128 of the H100's 132 SMs.  The block's
    rows are staged while they fit :data:`SHARED_BUDGET` (L <= 191) and read
    in place past it.  The whole word row is loaded ahead for W <= 4; a
    wider row gives only its one word at walk time.  ``group`` is the
    kernel's ring of :data:`GROUP` positions, the same at every shape.
    """
    return LaunchPlan(THREADS, GROUP, W <= 4, _span_bytes(THREADS, L) <= SHARED_BUDGET)


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
    W = words.shape[1]
    out = torch.empty(P, dtype=torch.int32, device=objects.device)
    if P == 0:
        return out
    plan = launch_plan(P, L, W)
    lib = load_library()
    with torch.cuda.device(objects.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.path_latency_launch(
            objects.data_ptr(), lengths.data_ptr(), words.data_ptr(),
            shard.data_ptr(), P, L, W, plan.threads, int(plan.prefetch_row),
            int(plan.staged), out.data_ptr(), stream,
        )
    check_launch("path_latency", err)
    LAUNCHES += 1
    return out
