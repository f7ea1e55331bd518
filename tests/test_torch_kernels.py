"""The CUDA kernels against their plain torch versions (needs a card).

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False; on a machine with an NVIDIA GPU
run ``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py``.
Comparisons are exact: every output is an integer or a bool.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.engine import LatencyEngine
from repro_torch.engine.packed import pack_bool_mask
from repro_torch.kernels import path_latency as pl_mod
from repro_torch.kernels import routed_walk as rw_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, P, L, n_srv, device):
    rng = np.random.default_rng(seed)
    n_obj = 5000
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    mask = rng.random((n_obj, n_srv)) < 0.1
    mask[np.arange(n_obj), shard] = True
    mask[:, 31 if n_srv > 31 else n_srv - 1] |= rng.random(n_obj) < 0.5
    words = np.zeros((n_obj + 1, (n_srv + 31) // 32), np.uint32)
    words[:n_obj] = pack_bool_mask(mask)
    lengths = rng.integers(0, L + 1, P).astype(np.int32)
    objects = rng.integers(0, n_obj, (P, L)).astype(np.int32)
    objects[np.arange(L)[None, :] >= lengths[:, None]] = -1
    start = rng.integers(-1, n_srv, P).astype(np.int32)
    load = np.zeros(words.shape[1] * 32, np.float32)
    load[:n_srv] = rng.integers(0, 3, n_srv)
    arrs = dict(objects=objects, lengths=lengths, words=words.view(np.int32),
                shard=shard, start=start, load=load)
    return {k: torch.from_numpy(v).to(device) for k, v in arrs.items()}


@pytest.mark.parametrize("L,n_srv", [(1, 6), (6, 40), (9, 128)])
def test_path_latency_kernel_matches_plain(cuda, L, n_srv):
    x = _inputs(L, 20_000, L, n_srv, cuda)
    before = pl_mod.LAUNCHES
    got = pl_mod.path_latency(x["objects"], x["lengths"], x["words"], x["shard"])
    torch.cuda.synchronize()
    assert pl_mod.LAUNCHES == before + 1
    want = pl_mod.path_latency_plain(x["objects"], x["lengths"], x["words"], x["shard"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["home_first", "nearest_copy", "no_lookahead"])
@pytest.mark.parametrize("L,n_srv", [(1, 6), (6, 40), (9, 128)])
def test_routed_walk_kernel_matches_plain(cuda, mode, L, n_srv):
    x = _inputs(L * 7, 20_000, L, n_srv, cuda)
    kw = dict(lookahead=mode == "nearest_copy", home_first=mode == "home_first")
    args = (x["objects"], x["lengths"], x["words"], x["shard"], x["start"], x["load"])
    before = rw_mod.LAUNCHES
    s, l = rw_mod.routed_walk(*args, **kw)
    torch.cuda.synchronize()
    assert rw_mod.LAUNCHES == before + 1
    ws, wl = rw_mod.routed_walk_plain(*args, **kw)
    assert torch.equal(s, ws)
    assert torch.equal(l, wl)


def test_wrapper_rejects_bad_inputs(cuda):
    x = _inputs(0, 100, 4, 6, cuda)
    with pytest.raises(TypeError):
        pl_mod.path_latency(x["objects"].long(), x["lengths"], x["words"], x["shard"])
    with pytest.raises(ValueError):
        pl_mod.path_latency(x["objects"].t(), x["lengths"], x["words"], x["shard"])
    with pytest.raises(ValueError):
        rw_mod.routed_walk(x["objects"], x["lengths"], x["words"], x["shard"],
                           x["start"], x["load"][:5])


def test_kernel_backend_greedy_matches_torch(cuda):
    from conftest import random_workload

    ps, shard = random_workload(np.random.default_rng(0))
    ps = T.PathSet(ps.objects, ps.lengths, ps.query_ids)
    for policy in (None, "nearest_copy"):
        a, sa = T.replicate_workload(ps, shard, 5, 1, policy=policy)
        b, sb = T.replicate_workload(ps, shard, 5, 1, policy=policy, policy_backend="torch")
        c, _ = T.replicate_workload(ps, shard, 5, 1, policy=policy, device="cpu")
        assert np.array_equal(a.mask, b.mask) and np.array_equal(a.mask, c.mask)
        assert LatencyEngine(a).backend == "kernel"
        assert T.is_latency_feasible(ps, a, 1, policy=policy)
