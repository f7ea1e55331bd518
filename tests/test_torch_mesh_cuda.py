"""The path-sharded fused greedy's kernel backend on the card.

On a mesh of several shards the ``kernel`` backend runs ``fused_update``'s
one-round launch per shard and batch (the class launch cannot take the
other shards' additions between its batches); a 1-shard mesh keeps the
single-card class launch.  Their masks, additions and integer stats
must equal the single-card kernel backend's class launch, on 4 shards of
one card, on a 1-shard mesh and, where the machine shows several cards,
on a mesh of every card (the pairs then cross between cards).  Sizes are
multiples of 1/8, so every cost sum is exact and ``total_cost`` is equal
too.  No JAX here: the CPU parity with the JAX package is
``tests/test_torch_mesh.py``'s.  Skips without a card.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.engine import sharding as S

pytestmark = pytest.mark.cuda

BATCH = 64


@pytest.fixture
def meshes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (fused_update per shard)")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"4 shards on one card": S.ProvisioningMesh(("cuda:0",) * 4),
           "1 shard": S.provisioning_mesh(1)}
    if torch.cuda.device_count() > 1:
        out["every card"] = S.provisioning_mesh()
    return out


def _workload(seed, n_obj=90, n_srv=5, n_paths=400, max_len=6):
    rng = np.random.default_rng(seed)
    paths = [rng.integers(0, n_obj, rng.integers(1, max_len + 1)).tolist()
             for _ in range(n_paths)]
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    f = rng.integers(4, 17, n_obj).astype(np.float32) / 8
    return T.PathSet.from_lists(paths), shard, f


def _same(a, sa, b, sb):
    assert np.array_equal(a.mask, b.mask)
    for c in ("replicas", "failed_paths", "routed_skips", "routed_violations",
              "pruned_replicas", "fallback_paths", "total_cost"):
        assert getattr(sa, c) == getattr(sb, c), c


@pytest.mark.parametrize("policy", (None, "nearest_copy", "nearest_copy_dp"))
def test_kernel_backend_on_a_mesh_equals_one_card(monkeypatch, meshes, policy):
    from repro_torch.core import greedy
    from repro_torch.kernels import provision_update

    ps, shard, f = _workload(8)
    one, os_ = T.replicate_workload(ps, shard, 5, 2, f=f, policy=policy, fused=True,
                                    batch_size=BATCH, track_rm=True)
    calls = {"rounds": 0, "class": 0}
    fu, fuc = greedy.fused_update, greedy.fused_update_class

    def round_(words, objects, *a, **k):
        calls["rounds"] += bool(objects.shape[0])
        return fu(words, objects, *a, **k)

    def class_(*a, **k):
        calls["class"] += 1
        return fuc(*a, **k)

    monkeypatch.setattr(greedy, "fused_update", round_)
    monkeypatch.setattr(greedy, "fused_update_class", class_)
    for name, mesh in meshes.items():
        before = provision_update.LAUNCHES
        calls["rounds"] = calls["class"] = 0
        got, gs = T.replicate_workload(ps, shard, 5, 2, f=f, policy=policy, fused=True,
                                       mesh=mesh, batch_size=BATCH, track_rm=True)
        if mesh.size == 1:
            # the single-card class launch, once per budget class
            assert provision_update.LAUNCHES - before == calls["class"] > 0, name
            assert calls["rounds"] == 0, name
        else:
            # one launch per shard and batch, none of the class launch
            assert provision_update.LAUNCHES - before == calls["rounds"] >= mesh.size, name
            assert calls["class"] == 0, name
        _same(got, gs, one, os_)
        assert gs.rm == os_.rm, name


def test_kernel_backend_delta_and_stream_on_a_mesh_equal_one_card(meshes):
    ps, shard, f = _workload(9)
    extra, _, _ = _workload(10, n_paths=160)
    t_vec = np.random.default_rng(4).integers(0, 3, extra.n_queries).astype(np.int32)
    outs = []
    for mesh in [None, *meshes.values()]:
        _, _, eng = T.replicate_workload(ps, shard, 5, 2, f=f, return_engine=True)
        stats, add = T.replicate_delta(extra, eng, t_vec, f=f, fused=True,
                                       policy="nearest_copy", batch_size=BATCH, mesh=mesh)
        chunks = [ps.select(np.arange(i, min(i + 100, ps.n_paths)))
                  for i in range(0, ps.n_paths, 100)]
        scheme, sst = T.replicate_stream(chunks, shard, 5, t=1, f=f, mesh=mesh,
                                         batch_size=BATCH)
        outs.append((eng.host_mask(), stats, add, scheme, sst))
    for got in outs[1:]:
        assert np.array_equal(got[0], outs[0][0])
        assert (got[1].failed_paths, got[1].routed_skips, got[1].total_cost) == (
            outs[0][1].failed_paths, outs[0][1].routed_skips, outs[0][1].total_cost)
        for a, b in zip(got[2], outs[0][2]):
            assert np.array_equal(a, b)
        _same(got[3], got[4], outs[0][3], outs[0][4])
