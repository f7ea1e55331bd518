"""Causal GQA flash attention for prefill, with an optional sliding window.

Replaces the TPU kernel ``flash_prefill_pallas`` in
``src/repro/kernels/flash_prefill.py`` (body ``_kernel``).  The CUDA source
is ``repro_torch/csrc/flash_prefill.cu``; it holds two hand-written
kernels, and :func:`kernel_route` picks one by dtype:

- ``"wgmma"`` (bf16, hd a multiple of 8): Hopper's tensor cores.  A block
  of two consumer warpgroups and a producer warp takes 128 query rows of
  one (batch, kv head), ordered position-major (row = pos * G + g) so any
  G fits and each K/V tile serves all G heads; K and V stream through a
  3-stage TMA ring of 64-key tiles; S = Q K^T and O += P V run as
  ``wgmma`` with P in bf16 registers; the online softmax works on the
  accumulator fragment, one quad shuffle per row per tile.
- ``"cuda_core"`` (f32, and bf16 with hd not a multiple of 8, which TMA's
  16-byte rows need): the f32 CUDA-core kernel with the online-softmax step
  of ``csrc/attention_common.cuh``.  Neither bf16 nor TF32 products meet
  the f32 tolerance (2e-5 against the plain version).

Tiles above the diagonal and before the window are never loaded.

Bound on the card: operations.  The causal product is 4 * B * H * hd
flops per (query, key) pair that the mask keeps, against a few bytes per
element of q, k, v and the output; far above the tensor cores' flops per
byte.

Semantics (kept): q [B, S, KV, G, hd], k/v [B, S, KV, hd], f32 or bf16;
query head h = kv * G + g; position i attends to keys j <= i with
i - j < window when window > 0; scores (q . k) / sqrt(hd) and the softmax
in f32; output [B, S, KV, G, hd] in q's dtype.  The wgmma route rounds P
to bf16 before the P V product, as the model's torch-op attention does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODES, PLAIN_DEVICES, check_launch, load_library,
                                      refuse_grad)

LAUNCHES = 0     # kernel launches, both routes
TC_LAUNCHES = 0  # of them, the tensor-core (wgmma) route's
MAX_HD = 128     # wgmma: hd padded to 128; CUDA cores: four f32 accumulators per lane


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


def kernel_route(q, k, v) -> str:
    """The CUDA kernel that takes these (checked) inputs on a card:
    ``"wgmma"`` for bf16 with hd a multiple of 8, else ``"cuda_core"``.
    Raises for hd > MAX_HD or a non-contiguous input."""
    hd = q.shape[-1]
    if hd > MAX_HD:
        raise ValueError(f"flash_prefill kernel takes hd <= {MAX_HD}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return "wgmma" if q.dtype == torch.bfloat16 and hd % 8 == 0 else "cuda_core"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied if its data does not start on 16 bytes (TMA and the
    16-byte loads need it; a fresh allocation always does)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_prefill(q, k, v, window: int = 0) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention: a CUDA kernel on a CUDA
    tensor (see :func:`kernel_route`), the plain version on a CPU or ``meta`` tensor.
    See :func:`flash_prefill_plain`."""
    global LAUNCHES, TC_LAUNCHES
    _check(q, k, v)
    refuse_grad("flash_prefill", q, k, v)
    if q.device.type in PLAIN_DEVICES:
        return flash_prefill_plain(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    route = kernel_route(q, k, v)
    B, S, KV, G, hd = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            q, k, v = _aligned(q), _aligned(k), _aligned(v)
            err = lib.flash_prefill_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, KV, G, hd, int(window), stream,
            )
        else:
            err = lib.flash_prefill_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, KV, G, hd, int(window), DTYPE_CODES[q.dtype], stream,
            )
    check_launch(f"flash_prefill ({route})", err)
    LAUNCHES += 1
    TC_LAUNCHES += route == "wgmma"
    return out
