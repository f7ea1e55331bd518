"""GQA flash-decode: one query token per sequence over a KV cache.

Replaces the TPU kernel ``decode_attention_pallas`` in
``src/repro/kernels/decode_attention.py`` (body ``_kernel``).  The CUDA
source is ``repro_torch/csrc/decode_attention.cu`` with the online-softmax
step of ``csrc/attention_common.cuh``: one block per (batch, kv head), one
warp per query head of the group; the G heads share each K/V tile staged
in shared memory, and tiles past the sequence's length are never loaded.

Bound on the card: bytes.  Each valid cache element is read once for
2 * G flops, far below the tensor cores' flops per byte.  With one block
per (batch, kv head) a small batch leaves most SMs idle; splitting the
cache across blocks is a later change.

Semantics (kept): q [B, KV, G, hd], k/v [B, T, KV, hd], f32 or bf16,
lengths int32 [B]; row (b, kv, g) attends to positions t < lengths[b] with
f32 scores (q . k) / sqrt(hd) and softmax; output [B, KV, G, hd] in q's
dtype.  A length <= 0 follows the oracle ``decode_attention_ref``
(``src/repro/kernels/ref.py``): every score is masked, so the row is the
mean of v over the T cache rows.  The TPU kernel averages over its padded
cache there instead; for every length in [1, T] the two agree.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check_launch, load_library

LAUNCHES = 0
MAX_HD = 128  # four f32 accumulators per lane
MAX_G = 32    # one warp per query head, at most 1,024 threads a block


def decode_attention_plain(q, k, v, lengths) -> torch.Tensor:
    """Plain torch version (the port of ``kernels/ref.decode_attention_ref``):
    masked softmax over the cache in f32, output in ``q.dtype``."""
    B, KV, G, hd = q.shape
    T = k.shape[1]
    s = torch.einsum("bkgh,btkh->bkgt", q.float(), k.float()) / (hd ** 0.5)
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]  # [B, T]
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    return out.to(q.dtype)


def _check(q, k, v, lengths):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, KV, G, hd] and k, v [B, T, KV, hd]")
    B, KV, G, hd = q.shape
    if k.shape[0] != B or k.shape[2:] != (KV, hd) or k.shape[1] < 1:
        raise ValueError(f"k, v must be [{B}, T >= 1, {KV}, {hd}], got {tuple(k.shape)}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 [{B}]")
    for name, t in (("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")


def decode_attention(q, k, v, lengths) -> torch.Tensor:
    """One-token GQA attention over a KV cache: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor.  See
    :func:`decode_attention_plain`."""
    global LAUNCHES
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, KV, G, hd = q.shape
    if hd > MAX_HD or G > MAX_G:
        raise ValueError(f"decode_attention kernel takes hd <= {MAX_HD} and G <= {MAX_G}, "
                         f"got hd={hd}, G={G}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, k.shape[1], KV, G, hd, DTYPE_CODES[q.dtype], stream,
        )
    check_launch("decode_attention", err)
    LAUNCHES += 1
    return out
