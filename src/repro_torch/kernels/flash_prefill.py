"""Causal GQA flash attention for prefill, with an optional sliding window.

Replaces the TPU kernel ``flash_prefill_pallas`` in
``src/repro/kernels/flash_prefill.py`` (body ``_kernel``).  The CUDA source
is ``repro_torch/csrc/flash_prefill.cu`` with the online-softmax step of
``csrc/attention_common.cuh``: one block per (batch, kv head, tile of 64
query rows), the rows ordered position-major (row = pos * G + g) so any
group size G fits; lanes run over hd, so hd need not be a multiple of 32.
The K and V tiles are staged in shared memory once for all the G query
heads of a kv head, and the tiles above the diagonal and before the window
are never loaded.

Bound on the card: operations.  The causal product is 4 * B * H * hd
flops per (query, key) pair that the mask keeps, against a few bytes per
element of q, k, v and the output; far above the tensor cores' flops per
byte.  This first kernel runs on the f32 CUDA cores with a shuffle-reduced
dot product per score, so it is well off that bound; tensor cores are a
later change.

Semantics (kept): q [B, S, KV, G, hd], k/v [B, S, KV, hd], f32 or bf16;
query head h = kv * G + g; position i attends to keys j <= i with
i - j < window when window > 0; scores (q . k) / sqrt(hd) and the softmax
in f32; output [B, S, KV, G, hd] in q's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check_launch, load_library

LAUNCHES = 0
MAX_HD = 128  # four f32 accumulators per lane


def flash_prefill_plain(q, k, v, window: int = 0) -> torch.Tensor:
    """Plain torch version (the port of ``kernels/ref.flash_prefill_ref``):
    masked softmax attention in f32, output in ``q.dtype``."""
    B, S, KV, G, hd = q.shape
    s = torch.einsum("bqkgh,btkh->bkgqt", q.float(), k.float()) / (hd ** 0.5)
    qp = torch.arange(S, device=q.device)
    mask = qp[:, None] >= qp[None, :]
    if window > 0:
        mask &= (qp[:, None] - qp[None, :]) < window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", p, v.float())
    return out.to(q.dtype)


def _check(q, k, v):
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, S, KV, G, hd] and k, v [B, S, KV, hd]")
    B, S, KV, G, hd = q.shape
    if k.shape != (B, S, KV, hd):
        raise ValueError(f"k, v must be [{B}, {S}, {KV}, {hd}], got {tuple(k.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")


def flash_prefill(q, k, v, window: int = 0) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor.  See
    :func:`flash_prefill_plain`."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, S, KV, G, hd = q.shape
    if hd > MAX_HD:
        raise ValueError(f"flash_prefill kernel takes hd <= {MAX_HD}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, KV, G, hd, int(window), DTYPE_CODES[q.dtype], stream,
        )
    check_launch("flash_prefill", err)
    LAUNCHES += 1
    return out
