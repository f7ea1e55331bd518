"""Public wrappers for the kernels, with the JAX package's signatures
(``repro.kernels.ops``).

Each attention and embedding wrapper dispatches by the device of the
tensors it is given: the CUDA kernel for a CUDA tensor, the plain torch
version for a CPU or ``meta`` tensor.  ``path_latency`` adapts a PathSet and a
ReplicationScheme to the port's latency engine, whose backend follows the
device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import flash_prefill as _flash


def path_latency(pathset, scheme, device=None) -> np.ndarray:
    """h(p, r, rho) per path under home-first routing, through the engine
    (the ``path_latency`` kernel on a card, torch ops with ``device="cpu"``)."""
    from repro_torch.engine import LatencyEngine  # lazy: the engine imports the kernels

    return LatencyEngine(scheme, device=device).path_latencies(pathset)


def decode_attention(q, k, v, lengths, block_t: int = 256):
    """Flash-decode GQA attention (see ``kernels.decode_attention``).

    ``block_t`` is the TPU kernel's cache tile; the CUDA kernel tiles the
    cache itself and its result does not depend on it."""
    del block_t
    return _decode.decode_attention(q, k, v, lengths)


def embedding_bag(table, ids, mode: str = "mean"):
    """TBE-style embedding bag (see ``kernels.embedding_bag``)."""
    return _bag.embedding_bag(table, ids, mode)


def flash_prefill(q, k, v, block_q: int = 128, block_k: int = 128, window: int = 0):
    """Causal flash attention for prefill (see ``kernels.flash_prefill``).

    As in the JAX package, S must be a multiple of ``block_q`` and
    ``block_k``; the CUDA kernel tiles the sequence itself."""
    S = q.shape[1]
    if S % block_q or S % block_k:
        raise ValueError(f"S = {S} must be a multiple of block_q = {block_q} "
                         f"and block_k = {block_k}")
    return _flash.flash_prefill(q, k, v, window)
