"""The arithmetic around the port's redesigned attention kernels, on the CPU.

``decode_attention`` splits the cache across blocks (flash-decoding): the
split plan must cover every cache row exactly once, and the partial-and-
combine arithmetic (``decode_attention_split_plain``, the kernels' steps as
torch ops) must equal the plain softmax within 1e-6 in f32, lengths 0 and
the chunk edges included.  ``flash_prefill`` picks one of its two CUDA
kernels by dtype (``kernel_route``) and refuses what neither takes.  The
inputs are made with numpy from a seed.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_prefill as fp


@pytest.mark.parametrize("B,KV,n_sm", [(4, 4, 132), (1, 1, 132), (64, 8, 132), (3, 2, 7)])
def test_split_plan_covers_every_key_once(B, KV, n_sm):
    for T in range(1, 5001):
        chunk, splits = da.split_plan(B, KV, T, n_sm)
        assert chunk >= da.CHUNK_MIN and chunk % da.CHUNK_MIN == 0
        starts = np.arange(splits) * chunk
        ends = np.minimum(starts + chunk, T)
        # contiguous, disjoint, non-empty chunks from 0 to T
        assert starts[0] == 0 and ends[-1] == T
        assert np.all(ends > starts) and np.all(starts[1:] == ends[:-1])


def test_split_plan_fills_the_card_at_the_lm_shape():
    """qwen2-7b decode: 4 sequences x 4 kv heads over a 1,040-row cache on
    132 SMs: 17 chunks of 64 keys, 272 blocks."""
    assert da.split_plan(4, 4, 1040, 132) == (64, 17)
    chunk, splits = da.split_plan(1, 1, 100_000, 132)
    assert 4 * 132 > splits >= 132


def _decode_inputs(rng, B, KV, G, hd, T):
    def f32(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return f32((B, KV, G, hd)), f32((B, T, KV, hd)), f32((B, T, KV, hd))


@pytest.mark.parametrize("hd", [120, 128])
@pytest.mark.parametrize("G", [1, 7, 16])
def test_split_combine_equals_plain(G, hd, rng):
    KV, T = 2, 1040
    chunk, splits = da.split_plan(6, KV, T, 132)
    assert splits > 1
    lengths = torch.tensor([0, 1, chunk - 1, chunk, chunk + 1, T], dtype=torch.int32)
    q, k, v = _decode_inputs(rng, lengths.numel(), KV, G, hd, T)
    got = da.decode_attention_split_plain(q, k, v, lengths, chunk)
    want = da.decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    # length 0: the mean of v over all T rows
    torch.testing.assert_close(got[0], v[0].mean(0)[:, None].expand(KV, G, hd),
                               atol=1e-6, rtol=1e-6)


def test_split_combine_with_a_ragged_last_chunk(rng):
    """T not a multiple of the chunk: the last chunk is short."""
    B, KV, G, hd, T, chunk = 3, 1, 7, 128, 77, 64
    q, k, v = _decode_inputs(rng, B, KV, G, hd, T)
    lengths = torch.tensor([63, 65, 77], dtype=torch.int32)
    torch.testing.assert_close(da.decode_attention_split_plain(q, k, v, lengths, chunk),
                               da.decode_attention_plain(q, k, v, lengths),
                               atol=1e-6, rtol=1e-6)


def _flash_inputs(hd, dtype, G=7):
    q = torch.zeros(1, 128, 2, G, hd, dtype=dtype)
    k = torch.zeros(1, 128, 2, hd, dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 120, "wgmma"),
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 36, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 64, "cuda_core"),
])
def test_flash_route_by_dtype(dtype, hd, route):
    assert fp.kernel_route(*_flash_inputs(hd, dtype)) == route


def test_flash_route_refuses_wide_heads_and_strided_inputs():
    with pytest.raises(ValueError, match="hd <= 128"):
        fp.kernel_route(*_flash_inputs(136, torch.bfloat16))
    q, k, v = _flash_inputs(128, torch.bfloat16)
    with pytest.raises(ValueError, match="k must be contiguous"):
        fp.kernel_route(q, k.transpose(1, 2), v)
    with pytest.raises(ValueError, match="q must be contiguous"):
        fp.kernel_route(q[..., ::2], k[..., ::2], v[..., ::2])
