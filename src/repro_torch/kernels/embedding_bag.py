"""EmbeddingBag: sum- or mean-pool the table rows each bag names.

Replaces the TPU kernel ``embedding_bag_pallas`` in
``src/repro/kernels/embedding_bag.py`` (body ``_kernel``).  The CUDA source
is ``repro_torch/csrc/embedding_bag.cu``: one warp per bag, lanes over the
row's d columns; the warp reads 32 of the bag's ids at once and
broadcasts each with a shuffle, so each row is one coalesced read and the
``[B, L, d]`` gather is never built.

Bound on the card: bytes.  Each non-padding row is read once for one add
per element, and the ids and the ``[B, d]`` output move once.

Semantics (kept): table [N, d] f32 or bf16, ids int32 [B, L] with -1 as
padding; the output f32 [B, d] sums the bag's non-padding rows in f32 in
order l = 0 .. L-1 and, for ``mode="mean"``, divides by max(count, 1), so
an all-padding bag gives 0.  An id >= N reads the last row, as the TPU
kernel's clamped block index does (outside the contract; the oracle
``embedding_bag_ref`` does not define it), so no id reads outside the table.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODES, PLAIN_DEVICES, check_launch, load_library,
                                      refuse_grad)

LAUNCHES = 0
MODES = ("mean", "sum")


def embedding_bag_plain(table, ids, mode: str = "mean") -> torch.Tensor:
    """Plain torch version (the port of ``kernels/ref.embedding_bag_ref``,
    with ids >= N clamped to the last row)."""
    rows = table[ids.clamp(0, table.shape[0] - 1).long()]  # [B, L, d]
    m = (ids >= 0).float()[..., None]
    s = (rows.float() * m).sum(dim=1)
    if mode == "mean":
        s = s / m.sum(dim=1).clamp_min(1.0)
    return s


def _check(table, ids, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if table.dim() != 2 or table.shape[0] < 1 or ids.dim() != 2:
        raise ValueError("table must be [N >= 1, d] and ids [B, L]")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if ids.device != table.device:
        raise ValueError(f"ids is on {ids.device}, table on {table.device}")
    if table.dtype not in DTYPE_CODES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")


def embedding_bag(table, ids, mode: str = "mean") -> torch.Tensor:
    """Pooled rows f32 [B, d]: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU or ``meta`` tensor.  See :func:`embedding_bag_plain`."""
    global LAUNCHES
    _check(table, ids, mode)
    refuse_grad("embedding_bag", table)
    if table.device.type in PLAIN_DEVICES:
        return embedding_bag_plain(table, ids, mode)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    for name, t in (("table", table), ("ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    (N, d), (B, L) = table.shape, ids.shape
    out = torch.empty((B, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.embedding_bag_launch(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), N, d, B, L,
            int(mode == "mean"), DTYPE_CODES[table.dtype], stream,
        )
    check_launch("embedding_bag", err)
    LAUNCHES += 1
    return out
