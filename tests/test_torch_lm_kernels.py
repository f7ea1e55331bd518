"""The port's attention and embedding-bag kernels against the JAX package.

On the CPU each plain torch version (``*_plain``, what the wrappers run
for a CPU tensor) is held against the JAX Pallas kernel in interpret mode
and against its oracle in ``repro.kernels.ref``, on the shape sweeps of
``tests/test_kernels.py`` plus a GQA group of 7 (qwen2) and hd = 120
(danube), at that file's tolerances: f32 2e-5; bf16 3e-2 (flash) and 2e-2
(decode); the bag 1e-5.  The inputs are made with numpy from a seed; bf16
inputs are rounded once by JAX and carried over exactly.

The tests marked ``cuda`` hold each CUDA kernel against its plain version
on the card and skip where there is none:
``PYTHONPATH=src python -m pytest -q tests/test_torch_lm_kernels.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import ops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's Pallas kernels (interpret mode) and oracles.  JAX
    is imported here and not at the top, so that on a machine without JAX
    (the card's) only the tests of this file that need JAX skip."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import decode_attention, embedding_bag, flash_prefill, ref
    return types.SimpleNamespace(
        jnp=jnp, decode_attention_pallas=decode_attention.decode_attention_pallas,
        embedding_bag_pallas=embedding_bag.embedding_bag_pallas,
        flash_prefill_pallas=flash_prefill.flash_prefill_pallas,
        decode_attention_ref=ref.decode_attention_ref,
        embedding_bag_ref=ref.embedding_bag_ref, flash_prefill_ref=ref.flash_prefill_ref)


def _pair(jx, rng, shape, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jx.jnp.asarray(rng.normal(size=shape), getattr(jx.jnp, dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(DTYPES[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


DECODE_SHAPES = [  # B, KV, G, hd, T, block_t
    (2, 2, 4, 64, 300, 128),
    (1, 1, 8, 128, 1024, 256),
    (3, 4, 1, 64, 77, 64),
    (2, 4, 7, 128, 300, 128),   # qwen2's group
    (2, 2, 3, 120, 77, 64),     # danube's head dim
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,KV,G,hd,T,bt", DECODE_SHAPES)
def test_decode_attention_plain_matches_jax(jx, B, KV, G, hd, T, bt, dtype, rng):
    qj, q = _pair(jx, rng, (B, KV, G, hd), dtype)
    kj, k = _pair(jx, rng, (B, T, KV, hd), dtype)
    vj, v = _pair(jx, rng, (B, T, KV, hd), dtype)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    got = ops.decode_attention(q, k, v, torch.from_numpy(lens), block_t=bt)
    assert got.dtype == q.dtype and got.shape == (B, KV, G, hd)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    pallas = jx.decode_attention_pallas(qj, kj, vj, jx.jnp.asarray(lens), block_t=bt,
                                        interpret=True)
    _close(_f32(got), pallas, tol)
    _close(_f32(got), jx.decode_attention_ref(qj, kj, vj, jx.jnp.asarray(lens)), tol)


def test_decode_attention_length_zero_follows_the_oracle(jx, rng):
    """lengths = 0 masks every score: the oracle's softmax is uniform, so the
    row is the mean of v over the T cache rows.  The port's kernel and plain
    version follow it; the TPU kernel averages over its padded cache
    (T = 77 padded to 128 here), which counts the zero rows."""
    B, KV, G, hd, T, bt = 2, 2, 3, 64, 77, 64
    qj, q = _pair(jx, rng, (B, KV, G, hd), "float32")
    kj, k = _pair(jx, rng, (B, T, KV, hd), "float32")
    vj, v = _pair(jx, rng, (B, T, KV, hd), "float32")
    lens = np.array([0, 5], np.int32)
    got = _f32(da.decode_attention(q, k, v, torch.from_numpy(lens)))
    want = np.asarray(jx.decode_attention_ref(qj, kj, vj, jx.jnp.asarray(lens)))
    _close(got, want, 2e-5)
    mean_v = np.asarray(vj)[0].mean(axis=0)                       # [KV, hd]
    _close(got[0], np.broadcast_to(mean_v[:, None], (KV, G, hd)), 2e-5)
    pallas = np.asarray(jx.decode_attention_pallas(qj, kj, vj, jx.jnp.asarray(lens), block_t=bt,
                                                interpret=True))
    _close(pallas[0], np.broadcast_to(mean_v[:, None] * T / 128, (KV, G, hd)), 2e-5)
    _close(got[1], pallas[1], 2e-5)


FLASH_SHAPES = [  # B, S, KV, G, hd, block_q, block_k, window
    (2, 256, 2, 4, 64, 64, 64, 0),
    (1, 128, 1, 8, 32, 32, 64, 0),
    (2, 256, 4, 2, 64, 128, 64, 48),
    (1, 128, 2, 7, 128, 128, 128, 0),   # qwen2's group and head dim
    (1, 256, 2, 2, 120, 64, 128, 40),   # danube's head dim, windowed
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,KV,G,hd,bq,bk,win", FLASH_SHAPES)
def test_flash_prefill_plain_matches_jax(jx, B, S, KV, G, hd, bq, bk, win, dtype, rng):
    qj, q = _pair(jx, rng, (B, S, KV, G, hd), dtype)
    kj, k = _pair(jx, rng, (B, S, KV, hd), dtype)
    vj, v = _pair(jx, rng, (B, S, KV, hd), dtype)
    got = ops.flash_prefill(q, k, v, block_q=bq, block_k=bk, window=win)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    pallas = jx.flash_prefill_pallas(qj, kj, vj, block_q=bq, block_k=bk, window=win,
                                  interpret=True)
    _close(_f32(got), pallas, tol)
    _close(_f32(got), jx.flash_prefill_ref(qj, kj, vj, win), tol)


def test_flash_prefill_block_contract():
    q = torch.zeros(1, 96, 1, 2, 32)
    k = torch.zeros(1, 96, 1, 32)
    with pytest.raises(ValueError, match="multiple of block_q"):
        ops.flash_prefill(q, k, k)
    assert ops.flash_prefill(q, k, k, block_q=32, block_k=32).shape == q.shape


BAG_SHAPES = [(4, 3, 50, 16), (16, 7, 500, 32), (1, 1, 10, 8), (64, 50, 1000, 64)]


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("B,L,N,d", BAG_SHAPES)
def test_embedding_bag_plain_matches_jax(jx, B, L, N, d, mode, rng):
    tj, table = _pair(jx, rng, (N, d), "float32")
    ids = rng.integers(-1, N, (B, L)).astype(np.int32)
    got = ops.embedding_bag(table, torch.from_numpy(ids), mode=mode)
    assert got.dtype == torch.float32 and got.shape == (B, d)
    _close(got.numpy(),
           jx.embedding_bag_pallas(tj, jx.jnp.asarray(ids), mode=mode, interpret=True), 1e-5)
    _close(got.numpy(), jx.embedding_bag_ref(tj, jx.jnp.asarray(ids), mode), 1e-5)


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_embedding_bag_bf16_table_and_padding(jx, mode, rng):
    """A bf16 table pools in f32; an all-padding bag gives 0; an id >= N
    reads the last row, as the TPU kernel's clamped block index does."""
    N, d = 40, 16
    tj, table = _pair(jx, rng, (N, d), "bfloat16")
    ids = rng.integers(-1, N, (6, 5)).astype(np.int32)
    ids[2] = -1
    in_range = ids.copy()
    got = eb.embedding_bag(table, torch.from_numpy(ids), mode)
    _close(got.numpy(), jx.embedding_bag_ref(tj, jx.jnp.asarray(ids), mode), 1e-5)
    assert np.all(got.numpy()[2] == 0.0)
    ids[4, 1] = N + 3
    got_oob = eb.embedding_bag(table, torch.from_numpy(ids), mode)
    _close(got_oob.numpy(), jx.embedding_bag_pallas(tj, jx.jnp.asarray(ids), mode=mode,
                                                 interpret=True), 1e-5)
    in_range[4, 1] = N - 1
    _close(got_oob.numpy(), eb.embedding_bag(table, torch.from_numpy(in_range), mode).numpy(),
           0.0)


def test_wrappers_check_their_inputs():
    q = torch.zeros(1, 2, 3, 32)
    k = torch.zeros(1, 5, 2, 32)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, k, k, torch.zeros(1, dtype=torch.int64))
    with pytest.raises(TypeError):
        da.decode_attention(q.double(), k.double(), k.double(), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="mode"):
        eb.embedding_bag(torch.zeros(4, 2), torch.zeros(1, 1, dtype=torch.int32), "max")
    with pytest.raises(TypeError):
        fp.flash_prefill(torch.zeros(1, 4, 1, 1, 8), torch.zeros(1, 4, 1, 8).bfloat16(),
                         torch.zeros(1, 4, 1, 8))


# --- on the card: each CUDA kernel against its plain version ---------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, shape, dtype, dev):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,KV,G,hd,win", [
    (2, 256, 2, 4, 64, 0), (1, 128, 1, 8, 32, 0), (2, 256, 4, 2, 64, 48),
    (1, 512, 4, 7, 128, 0), (1, 512, 2, 16, 128, 0), (1, 640, 2, 4, 120, 200),
    (1, 4096, 2, 7, 128, 0), (1, 2048, 2, 16, 128, 700), (1, 384, 2, 5, 32, 0),
    (1, 256, 2, 3, 36, 0),   # hd not a multiple of 8: bf16 takes the CUDA-core kernel
])
def test_flash_prefill_kernel_matches_plain(cuda, B, S, KV, G, hd, win, dtype):
    g = torch.Generator(device=cuda).manual_seed(S + G + hd)
    tdt = DTYPES[dtype]
    q = _randn(g, (B, S, KV, G, hd), tdt, cuda)
    k = _randn(g, (B, S, KV, hd), tdt, cuda)
    v = _randn(g, (B, S, KV, hd), tdt, cuda)
    before, tc_before = fp.LAUNCHES, fp.TC_LAUNCHES
    got = fp.flash_prefill(q, k, v, win)
    torch.cuda.synchronize()
    assert fp.LAUNCHES == before + 1
    assert fp.TC_LAUNCHES == tc_before + (fp.kernel_route(q, k, v) == "wgmma")
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), fp.flash_prefill_plain(q, k, v, win).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("KV,G,hd,T", [(2, 4, 64, 300), (1, 8, 128, 1024), (4, 1, 64, 77),
                                       (4, 7, 128, 4100), (2, 16, 120, 1040),
                                       (4, 7, 128, 1040), (1, 32, 128, 4100),
                                       (2, 3, 36, 77)])  # element loads: 36 * 2 B rows
def test_decode_attention_kernel_matches_plain(cuda, KV, G, hd, T, dtype):
    g = torch.Generator(device=cuda).manual_seed(T + G)
    tdt = DTYPES[dtype]
    # chunk edges: the splits are multiples of 64 keys
    lengths = torch.tensor([0, 1, 2, 31, 32, 33, 63, 64, 65, 129, T // 2, T - 1, T, T + 5],
                           dtype=torch.int32, device=cuda)
    B = lengths.numel()
    q = _randn(g, (B, KV, G, hd), tdt, cuda)
    k = _randn(g, (B, T, KV, hd), tdt, cuda)
    v = _randn(g, (B, T, KV, hd), tdt, cuda)
    before = da.LAUNCHES
    got = da.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 1
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), da.decode_attention_plain(q, k, v, lengths).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("B,L,N,d", [(4, 3, 50, 16), (300, 50, 100_000, 64), (7, 70, 1000, 40)])
def test_embedding_bag_kernel_matches_plain(cuda, B, L, N, d, mode, dtype):
    g = torch.Generator(device=cuda).manual_seed(B * L + d)
    table = _randn(g, (N, d), DTYPES[dtype], cuda)
    ids = torch.randint(-1, N + 2, (B, L), generator=g, device=cuda, dtype=torch.int32)
    ids[0] = -1  # an all-padding bag
    before = eb.LAUNCHES
    got = eb.embedding_bag(table, ids, mode)
    torch.cuda.synchronize()
    assert eb.LAUNCHES == before + 1
    assert torch.all(got[0] == 0)
    torch.testing.assert_close(got, eb.embedding_bag_plain(table, ids, mode),
                               atol=1e-5, rtol=1e-5)
