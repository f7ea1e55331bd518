"""Gradient compression for a cross-node all-reduce (torch port of
``repro.optim.compress``).

int8 block quantization:

  * a per-block scale (max-abs / 127) over flattened 1024-element blocks,
  * optional stochastic rounding (uniform noise in [-0.5, 0.5) from an
    explicit ``torch.Generator``) to keep the estimator unbiased,
  * decompress -> float32.

``compressed_psum`` is the collective: quantize locally, agree on the
largest scale, re-quantize against it, sum the int32 words, rescale.  The
JAX package runs it inside ``shard_map`` over a mesh axis (``pmax`` /
``psum``); here the participants are a ``torch.distributed`` process group
(``all_reduce`` with MAX on the scales and SUM on the words).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


class Compressed(NamedTuple):
    q: torch.Tensor       # int8 [padded]
    scale: torch.Tensor   # float32 [n_blocks]
    n: int                # original element count


BLOCK = 1024


def compress(x: torch.Tensor, stochastic: bool = False,
             generator: torch.Generator | None = None) -> Compressed:
    """Quantize ``x`` to int8 in blocks of ``BLOCK``; ``stochastic`` adds
    uniform noise in [-0.5, 0.5) drawn from ``generator`` before rounding
    (half to even, as ``jnp.round``)."""
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    blocks = F.pad(flat, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    y = blocks / scale.clamp_min(1e-12)[:, None]
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding needs a generator")
        y = y + (torch.rand(y.shape, generator=generator, device=y.device) - 0.5)
    q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return Compressed(q=q.reshape(-1), scale=scale, n=n)


def decompress(c: Compressed, shape, dtype=torch.float32) -> torch.Tensor:
    blocks = c.q.reshape(-1, BLOCK).float()
    out = (blocks * c.scale[:, None]).reshape(-1)[: c.n]
    return out.reshape(shape).to(dtype)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-compressed all-reduce of ``x`` over the process group ``group``
    (every participant calls it with a tensor of the same shape).

    Quantizes locally, takes the largest scale of each block over the
    participants, re-quantizes against it so the integer sum is coherent,
    sums the words widened to int32 (no overflow for <= 2^23
    participants) and rescales.  The error is at most one quantization
    step per participant.  With ``group=None`` there is one participant
    (the result is ``x`` through one round of quantization)."""
    c = compress(x)
    scale_max = c.scale.clone()
    if group is not None:
        dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    rel = c.scale / scale_max.clamp_min(1e-12)
    total = torch.round(c.q.reshape(-1, BLOCK).float() * rel[:, None]).to(torch.int32)
    if group is not None:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    out = (total.float() * scale_max[:, None]).reshape(-1)[: c.n]
    return out.reshape(x.shape).to(x.dtype)
