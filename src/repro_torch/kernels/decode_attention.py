"""GQA flash-decode: one query token per sequence over a KV cache.

Replaces the TPU kernel ``decode_attention_pallas`` in
``src/repro/kernels/decode_attention.py`` (body ``_kernel``).  The CUDA
source is ``repro_torch/csrc/decode_attention.cu``: split-cache
flash-decoding in two launches.  The first runs one block per (split, kv
head, batch row), each over a chunk of the cache (:func:`split_plan`
picks the chunk so that B * KV * splits fills the card), staging K and V
with 16-byte ``cp.async`` loads once for all G query heads and writing an
f32 partial (m, l, acc[hd]); the second rescales the partials by
exp(m_s - m) and divides by the summed l.  Chunks past a sequence's length
load nothing.  The wrapper allocates the partials; neither kernel does.

Bound on the card: bytes.  Each valid cache element is read once for
2 * G flops, far below the tensor cores' flops per byte.

Semantics (kept): q [B, KV, G, hd], k/v [B, T, KV, hd], f32 or bf16,
lengths int32 [B]; row (b, kv, g) attends to positions t < lengths[b] with
f32 scores (q . k) / sqrt(hd) and softmax; output [B, KV, G, hd] in q's
dtype.  A length <= 0 follows the oracle ``decode_attention_ref``
(``src/repro/kernels/ref.py``): every score is masked, so the row is the
mean of v over the T cache rows.  The TPU kernel averages over its padded
cache there instead; for every length in [1, T] the two agree.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import (DTYPE_CODES, PLAIN_DEVICES, check_launch, load_library,
                                      refuse_grad)

LAUNCHES = 0     # wrapper calls that launched the kernels (two launches each)
MAX_HD = 128     # one thread per dim in the P V step
MAX_G = 32       # f32 accumulators per thread
CHUNK_MIN = 64   # keys per split at least: one shared-memory tile
BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=1024)
def split_plan(B: int, KV: int, T: int, n_sm: int) -> tuple[int, int]:
    """(chunk, splits) for a cache of T rows: about ``BLOCKS_PER_SM * n_sm``
    blocks over the B * KV (batch row, kv head) pairs, each split a chunk of
    a multiple of CHUNK_MIN keys; split s covers rows [s * chunk,
    min((s + 1) * chunk, T)), so the splits cover every row once."""
    want = max(1, -(-BLOCKS_PER_SM * n_sm // (B * KV)))
    per = -(-T // want)
    chunk = max(CHUNK_MIN, -(-per // CHUNK_MIN) * CHUNK_MIN)
    return chunk, -(-T // chunk)


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


def decode_attention_split_plain(q, k, v, lengths, chunk: int) -> torch.Tensor:
    """The kernels' arithmetic as torch ops: an f32 partial (m, l, acc) per
    chunk of ``chunk`` cache rows, then the rescaled combine.  A length <= 0
    zeroes the query, so every chunk is uniform over its rows of all T.
    Equal to :func:`decode_attention_plain`; used by tests."""
    B, KV, G, hd = q.shape
    T = k.shape[1]
    splits = -(-T // chunk)
    uniform = lengths <= 0
    hi = torch.where(uniform, T, lengths.clamp(max=T))
    qf = torch.where(uniform[:, None, None, None], 0.0, q.float())
    s = torch.einsum("bkgh,btkh->bkgt", qf, k.float()) / (hd ** 0.5)
    valid = torch.arange(T, device=q.device)[None, :] < hi[:, None]       # [B, T]
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    pad = splits * chunk - T
    s = torch.nn.functional.pad(s, (0, pad), value=-torch.inf).reshape(B, KV, G, splits, chunk)
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad)).reshape(B, splits, chunk, KV, hd)
    m = s.amax(-1)                                                        # [B, KV, G, splits]
    p = torch.exp(s - torch.where(m == -torch.inf, 0.0, m)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgsc,bsckh->bkgsh", p, vp)
    w = torch.where(m == -torch.inf, 0.0, torch.exp(m - m.amax(-1, keepdim=True)))
    out = (w[..., None] * acc).sum(-2) / (w * l).sum(-1).clamp(min=1e-30)[..., None]
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


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_attention(q, k, v, lengths) -> torch.Tensor:
    """One-token GQA attention over a KV cache: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU or ``meta`` tensor.  See
    :func:`decode_attention_plain`."""
    global LAUNCHES
    _check(q, k, v, lengths)
    refuse_grad("decode_attention", q, k, v)
    if q.device.type in PLAIN_DEVICES:
        return decode_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return decode_attention(q, k, v, lengths)
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
    T = k.shape[1]
    chunk, splits = split_plan(B, KV, T, _sm_count(q.device))
    # the partials: acc f32 [B, KV, splits, G, hd], then (m, l) f32 [B, KV, splits, G, 2]
    n_acc = B * KV * splits * G * hd
    scratch = torch.empty(n_acc + B * KV * splits * G * 2, dtype=torch.float32, device=q.device)
    # A decode call's kernels take ~0.02 ms, so the host's enqueue is most of
    # its cost: the raw stream handle skips building a torch Stream object.
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    part = scratch.data_ptr()
    err = load_library().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), part, part + 4 * n_acc,
        out.data_ptr(), B, T, KV, G, hd, chunk, splits, DTYPE_CODES[q.dtype], stream,
    )
    check_launch("decode_attention", err)
    LAUNCHES += 1
    return out
