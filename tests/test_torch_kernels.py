"""The CUDA kernels against their plain torch versions (needs a card).

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False; on a machine with an NVIDIA GPU
run ``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py``.
Comparisons are exact: every output is an integer or a bool, and the
fused UPDATE's float32 costs are summed in the same order by the kernel
and its plain version.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import combi
from repro_torch.engine import LatencyEngine, resolve_policy
from repro_torch.engine.backends import _dp_score_tables
from repro_torch.engine.packed import pack_bool_mask
from repro_torch.engine.routing import NearestCopy, nearest_copy_dp
from repro_torch.kernels import path_latency as pl_mod
from repro_torch.kernels import provision_update as pu_mod
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


def _path_latency_exact(x, objects=None, lengths=None, words=None):
    """One launch of the kernel against the plain version, exact."""
    args = (x["objects"] if objects is None else objects,
            x["lengths"] if lengths is None else lengths,
            x["words"] if words is None else words, x["shard"])
    before = pl_mod.LAUNCHES
    got = pl_mod.path_latency(*args)
    torch.cuda.synchronize()
    assert pl_mod.LAUNCHES == before + 1
    assert torch.equal(got, pl_mod.path_latency_plain(*args))


@pytest.mark.parametrize("n_srv", [6, 40, 80, 128, 160, 400])
@pytest.mark.parametrize("L", [1, 8, 9, 16, 17, 65, 200])
def test_path_latency_kernel_route_boundaries(cuda, L, n_srv):
    """The ring's edges (L = GROUP, GROUP + 1, 2 GROUP, 2 GROUP + 1), long
    paths (65; 200 is past the staging budget, read in place) and word
    rows W = 1, 2, 3, 4 (loaded whole ahead), 5 and 13 (one word at walk
    time)."""
    W = (n_srv + 31) // 32
    plan = pl_mod.launch_plan(20_000, L, W)
    assert plan.prefetch_row == (W <= 4) and plan.staged == (L < 192)
    _path_latency_exact(_inputs(L * 1000 + n_srv, 20_000, L, n_srv, cuda))


@pytest.mark.parametrize("L,n_srv", [(6, 6), (9, 128)])
@pytest.mark.parametrize("P", [1, 255, 8_192, 20_000])
def test_path_latency_kernel_row_counts(cuda, P, L, n_srv):
    """A last block of one row, a block size not dividing P, the main
    path's 8,192-row chunk and a last block of 32 rows (20,000)."""
    _path_latency_exact(_inputs(P + L, P, L, n_srv, cuda))


@pytest.mark.parametrize("L", [5, 6, 17])
@pytest.mark.parametrize("n_srv", [6, 40, 128])
def test_path_latency_kernel_unaligned_inputs(cuda, L, n_srv):
    """``objects`` and ``lengths`` as row slices from an odd row (the staged
    span starts off a 16-byte boundary: plain loads for its head and
    tail), and the words at a 4-byte offset (no vector row loads)."""
    x = _inputs(L + n_srv, 20_001, L, n_srv, cuda)
    objects, lengths = x["objects"][1:], x["lengths"][1:]
    assert objects.is_contiguous() and objects.data_ptr() % 16 != 0
    _path_latency_exact(x, objects=objects, lengths=lengths)
    n, W = x["words"].shape
    flat = torch.zeros(n * W + 1, dtype=torch.int32, device=cuda)
    words = flat[1:].view(n, W)
    words.copy_(x["words"])
    _path_latency_exact(x, objects=objects, lengths=lengths, words=words)


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


@pytest.mark.parametrize("depth", [None, 2])
@pytest.mark.parametrize("L,n_srv", [(1, 6), (6, 40), (9, 128)])
def test_scored_walk_kernel_matches_plain(cuda, depth, L, n_srv):
    x = _inputs(L * 11, 20_000, L, n_srv, cuda)
    scores = _dp_score_tables(x["objects"], x["lengths"], x["words"],
                              -1 if depth is None else depth)
    args = (x["objects"], x["lengths"], x["words"], x["shard"], x["start"], scores)
    before = rw_mod.SCORED_LAUNCHES
    s, l = rw_mod.scored_walk(*args)
    torch.cuda.synchronize()
    assert rw_mod.SCORED_LAUNCHES == before + 1
    ws, wl = rw_mod.scored_walk_plain(*args)
    assert torch.equal(s, ws)
    assert torch.equal(l, wl)


FUSED_GATES = {
    "none": None,
    "routed": resolve_policy("nearest_copy"),
    "no_lookahead": NearestCopy(lookahead=False),
    "queue_aware": resolve_policy("queue_aware"),
    "scored": nearest_copy_dp(),
    "scored_depth2": nearest_copy_dp(2),
}


def _fused_inputs(seed, B, L, n_srv, device, t_budget):
    x = _inputs(seed, B, L, n_srv, device)
    x["shard"] = x["shard"].clamp_min(0)
    rng = np.random.default_rng(seed + 1)
    n = x["shard"].shape[0]
    x["f"] = torch.from_numpy((rng.integers(1, 24, n) / 8).astype(np.float32)).to(device)
    tables, counts = combi.stacked_tables(max(L - 1, 1), t_budget)
    x["tables"] = torch.from_numpy(tables).to(device)
    x["counts"] = torch.from_numpy(counts).to(device)
    x["t"] = torch.from_numpy(rng.integers(0, 3, B).astype(np.int32)).to(device)
    return x


@pytest.mark.parametrize("gate", list(FUSED_GATES))
@pytest.mark.parametrize("L,n_srv,B,t_budget", [
    (1, 6, 20_000, 1), (6, 40, 20_000, 1), (9, 128, 20_000, 2),
    # the device-memory tiers: paths past the 64 positions kept in shared
    # memory (subpath masks of two words), rank vectors past the 8,192
    # servers staged there (W 257)
    (70, 6, 160, 1), (9, 65 * 32, 160, 2), (9, 257 * 32, 160, 2),
])
def test_fused_update_kernel_matches_plain(cuda, gate, L, n_srv, B, t_budget):
    x = _fused_inputs(L * 13, B, L, n_srv, cuda, t_budget)
    pol = FUSED_GATES[gate]
    rank = x["load"] if gate == "queue_aware" else torch.zeros_like(x["load"])
    args = (x["objects"], x["lengths"], x["shard"], x["f"], x["tables"],
            x["counts"], x["t"], rank)
    before = pu_mod.LAUNCHES
    got = pu_mod.fused_update(x["words"].clone(), *args, pol=pol)
    torch.cuda.synchronize()
    assert pu_mod.LAUNCHES == before + 1
    want = pu_mod.fused_update_plain(x["words"].clone(), *args, pol=pol)
    # the words without the sacrificial last row (a write sink)
    assert torch.equal(got[0][:-1], want[0][:-1])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    assert bool(got[3].any()) or L == 1


def test_fused_update_kernel_wide_tables(cuda):
    """Tables wider than the kernel's 64 subpath columns (a budget t >= L)
    are cut to L columns: the kernel equals the plain version on the full
    tables."""
    x = _fused_inputs(5, 2_000, 9, 40, cuda, 1)
    tables, counts = combi.stacked_tables(69, 1)             # Hp1 = 70 > 64
    args = (x["objects"], x["lengths"], x["shard"], x["f"],
            torch.from_numpy(tables).to(cuda), torch.from_numpy(counts).to(cuda),
            x["t"], torch.zeros_like(x["load"]))
    pol = resolve_policy("nearest_copy")
    got = pu_mod.fused_update(x["words"].clone(), *args, pol=pol)
    want = pu_mod.fused_update_plain(x["words"].clone(), *args, pol=pol)
    assert torch.equal(got[0][:-1], want[0][:-1])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


def test_fused_update_rejects_beyond_limits(cuda):
    """The kernel has no shape limit left (L 65 once raised): it takes a
    65-position batch and equals the plain version, and it still rejects
    malformed input."""
    x = _fused_inputs(3, 64, 65, 6, cuda, 1)
    args = (x["objects"], x["lengths"], x["shard"], x["f"], x["tables"], x["counts"],
            x["t"], x["load"])
    with pytest.raises(ValueError, match="rank must be"):
        pu_mod.fused_update(x["words"], *args[:-1], x["load"][:-1])
    got = pu_mod.fused_update(x["words"].clone(), *args)
    want = pu_mod.fused_update_plain(x["words"].clone(), *args)
    assert torch.equal(got[0][:-1], want[0][:-1])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("policy", [None, "nearest_copy", "nearest_copy_dp"])
def test_kernel_backend_fused_greedy_matches_torch(cuda, policy):
    """Unit sizes make every candidate cost exact, so the fused kernel's
    summation order cannot flip an argmin: all three runs agree."""
    from conftest import random_workload

    ps, shard = random_workload(np.random.default_rng(1))
    ps = T.PathSet(ps.objects, ps.lengths, ps.query_ids)
    before = pu_mod.LAUNCHES
    a, sa = T.replicate_workload(ps, shard, 5, 1, policy=policy, fused=True)
    assert pu_mod.LAUNCHES > before
    b, sb = T.replicate_workload(ps, shard, 5, 1, policy=policy, fused=True,
                                 policy_backend="torch")
    c, _ = T.replicate_workload(ps, shard, 5, 1, policy=policy, device="cpu")
    assert np.array_equal(a.mask, b.mask) and np.array_equal(a.mask, c.mask)
    assert sa.failed_paths == sb.failed_paths == 0
    assert T.is_latency_feasible(ps, a, 1, policy=policy)
