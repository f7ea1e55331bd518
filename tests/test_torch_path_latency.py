"""The launch plan of the ``path_latency`` kernel, on the CPU.

``launch_plan`` is plain Python, so its choices are checked here; the
kernel itself is held against ``path_latency_plain`` by the ``cuda`` tests
of ``tests/test_torch_kernels.py``.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import path_latency as pl_mod

LS = (1, 6, 8, 9, 16, 17, 47, 48, 65, 95, 96, 191, 192, 1000)
WS = (1, 2, 3, 4, 5, 13, 65)


@pytest.mark.parametrize("P", [1, 255, 8_192, 20_000, 146_907, 1_427_515])
def test_launch_plan_covers_every_shape(P):
    for L in LS:
        for W in WS:
            plan = pl_mod.launch_plan(P, L, W)
            assert plan.group >= 1
            assert plan.threads == pl_mod.THREADS and plan.threads % 32 == 0
            assert plan.prefetch_row == (W <= 4)
            assert plan.staged == (pl_mod._span_bytes(plan.threads, L) <= pl_mod.SHARED_BUDGET)


def test_launch_plan_main_and_sweep_shapes():
    # the main path's 8,192-row chunk spreads over 128 of the 132 SMs
    main = pl_mod.launch_plan(8_192, 6, 1)
    assert -(-8_192 // main.threads) == 128
    assert main.prefetch_row and main.staged
    # the 1.4 M-row sweep at 128 servers (W = 4): the whole row ahead
    sweep = pl_mod.launch_plan(1_427_515, 6, 4)
    assert sweep.prefetch_row and sweep.staged
    # 160 servers: one word at walk time
    assert not pl_mod.launch_plan(1_427_515, 6, 5).prefetch_row


def test_launch_plan_long_paths():
    # a block's 64 rows fit the shared-memory budget up to 191 positions;
    # past that they are read in place
    assert pl_mod.launch_plan(1_000_000, 191, 1).staged
    assert not pl_mod.launch_plan(1_000_000, 192, 1).staged
    assert pl_mod._span_bytes(pl_mod.THREADS, 191) <= pl_mod.SHARED_BUDGET


@pytest.mark.parametrize("L,n_srv", [(17, 6), (9, 160), (65, 400)])
def test_wrapper_on_the_cpu_runs_the_plain_version(L, n_srv):
    """A CPU tensor, a row slice from an odd row included, gets the plain
    version, which equals a per-path walk written out in numpy."""
    rng = np.random.default_rng(L + n_srv)
    n_obj, P = 200, 301
    W = (n_srv + 31) // 32
    shard = rng.integers(-1, n_srv, n_obj).astype(np.int32)
    hold = rng.random((n_obj, W * 32)) < 0.2
    hold[:, n_srv:] = False
    bits = (hold.reshape(n_obj, W, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64))
    words = np.zeros((n_obj + 1, W), np.uint32)
    words[:n_obj] = bits.sum(-1).astype(np.uint32)
    lengths = rng.integers(0, L + 1, P).astype(np.int32)
    objects = rng.integers(0, n_obj, (P, L)).astype(np.int32)
    objects[np.arange(L)[None, :] >= lengths[:, None]] = -1
    want = np.zeros(P, np.int32)
    for p in range(P):
        server = int(max(shard[max(objects[p, 0], 0)], 0)) if lengths[p] > 0 else 0
        for i in range(1, min(lengths[p], L)):
            v = max(objects[p, i], 0)
            if not (int(words[v, server // 32]) >> (server % 32)) & 1:
                server = int(max(shard[v], 0))
                want[p] += 1
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    before = pl_mod.LAUNCHES
    got = pl_mod.path_latency(t(objects)[1:], t(lengths)[1:], t(words.view(np.int32)), t(shard))
    assert pl_mod.LAUNCHES == before
    assert np.array_equal(got.numpy(), want[1:])


def test_group_is_the_kernels_ring():
    """``launch_plan`` reports the ring the kernel is compiled with."""
    src = (Path(pl_mod.__file__).parents[1] / "csrc" / "path_latency.cu").read_text()
    ring = re.search(r"constexpr int kGroup = (\d+);", src)
    assert ring is not None and int(ring.group(1)) == pl_mod.GROUP
