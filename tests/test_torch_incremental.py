"""The port's dirty-set incremental evaluation against the JAX package's.

``LatencyEngine.path_latencies(incremental=True)`` must equal a full
evaluation and the JAX package's engine (its ``jnp`` backend, which its
own tests pin to ``pallas``) bit for bit under the ``reference`` and
``torch`` backends x four policies x add / remove / mixed deltas; the
cache books only the compacted index vector as ``gathered_bytes``,
``refresh`` / dead entries / ``queue_aware`` slots / ``replicate_delta``
/ a fail event keep it exact.  The ``cuda`` cases hold the ``kernel``
backend's re-walk against ``torch`` on a card.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import numpy as np
import pytest
import torch

import repro.core as R
import repro.distsys as RD
import repro.engine as RE
import repro_torch.core as T
import repro_torch.distsys as TD
from conftest import random_workload
from repro_torch.engine import TRANSFER, LatencyEngine, PathIndex, nearest_copy_dp, round_up_rows

CPU = "cpu"
POLICIES = ("home_first", "nearest_copy", "queue_aware", "nearest_copy_dp")
STEPS = ("seed", "add", "remove", "mixed")


def to_port(ps):
    return T.PathSet(ps.objects, ps.lengths, ps.query_ids)


def _pol(name, mod):
    return mod.nearest_copy_dp(2) if name == "nearest_copy_dp" else name


def _case():
    ps, shard = random_workload(np.random.default_rng(0), n_obj=100, n_srv=5, n_paths=120,
                                n_queries=40)
    mask = np.zeros((100, 5), bool)
    mask[np.arange(100), shard] = True
    load = np.random.default_rng(1).random(5).astype(np.float32)
    return ps, shard, mask, load


def _deltas(shard):
    """The seeded delta sequence: (step, [(op, objects, servers), ...])."""
    rng = np.random.default_rng(2)
    ao = rng.integers(0, 100, 6)
    alt = (shard[ao] + 1) % 5
    return [
        ("seed", []),
        ("add", [("add", rng.integers(0, 100, 10), rng.integers(0, 5, 10))]),
        ("remove", [("add", ao, alt), ("remove", ao[:3], alt[:3])]),
        ("mixed", [("add", rng.integers(0, 100, 5), rng.integers(0, 5, 5)),
                   ("remove", ao[3:], alt[3:])]),
    ]


def _drive(eng, ps, pol, load):
    """Per step: (incremental, full) latencies after applying the step."""
    out = {}
    for step, ops in _deltas(np.asarray(eng.host_shard())):
        for op, o, s in ops:
            (eng.add_replicas if op == "add" else eng.remove_replicas)(o, s)
        inc = eng.path_latencies(ps, policy=pol, load=load, incremental=True)
        out[step] = (inc, eng.path_latencies(ps, policy=pol, load=load))
    return out


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's incremental and full latencies, once per policy."""
    ps, shard, mask, load = _case()
    ref = {}
    for name in POLICIES:
        eng = RE.LatencyEngine.from_arrays(mask.copy(), shard, backend="jnp")
        ref[name] = _drive(eng, ps, _pol(name, RE), load if name == "queue_aware" else None)
    return ref


def test_round_up_rows_quantum():
    from repro.engine.sharding import round_up_rows as jax_round_up

    for n in (0, 1, 127, 128, 129, 1000):
        assert round_up_rows(n, device=CPU) == jax_round_up(n)
    assert round_up_rows(0, device=CPU) == 128
    assert round_up_rows(129, 64, device=CPU) == 192


def test_path_index_dirty_paths_match_repro():
    ps, _ = random_workload(np.random.default_rng(3), n_obj=60, n_paths=80)
    a, b = PathIndex(np.asarray(ps.objects), 60), RE.PathIndex(np.asarray(ps.objects), 60)
    changed = np.random.default_rng(4).integers(-5, 70, 25)
    assert np.array_equal(a.dirty_paths(changed), b.dirty_paths(changed))
    assert a.dirty_paths([-1, 65]).size == 0


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("backend", ["reference", "torch"])
def test_incremental_bit_identity(jax_reference, backend, policy, step):
    ps, shard, mask, load = _case()
    eng = LatencyEngine.from_arrays(mask.copy(), shard, backend=backend, device=CPU)
    got = _drive(eng, to_port(ps), _pol(policy, _PortPolicies),
                 load if policy == "queue_aware" else None)
    inc, full = got[step]
    j_inc, j_full = jax_reference[policy][step]
    assert np.array_equal(inc, full)
    assert np.array_equal(inc, j_inc) and np.array_equal(full, j_full)


class _PortPolicies:
    nearest_copy_dp = staticmethod(nearest_copy_dp)


def _engine(seed=0, backend="torch"):
    ps, shard = random_workload(np.random.default_rng(seed), n_obj=100, n_srv=5,
                                n_paths=120, n_queries=40)
    mask = np.zeros((100, 5), bool)
    mask[np.arange(100), shard] = True
    return LatencyEngine.from_arrays(mask, shard, backend=backend, device=CPU), to_port(ps)


def test_incremental_slack_and_feasibility_budget_kinds():
    eng, ps = _engine()
    eng.path_latencies(ps, incremental=True)
    eng.add_replicas(np.arange(0, 100, 9), np.arange(0, 100, 9) % 5)
    vec = np.random.default_rng(5).integers(0, 4, ps.n_queries).astype(np.int32)
    for t in (1, vec, T.SLOSpec.uniform(2, ps.n_queries)):
        assert np.array_equal(eng.query_slack(ps, t, incremental=True), eng.query_slack(ps, t))
        assert eng.is_feasible(ps, t, incremental=True) == eng.is_feasible(ps, t)


def test_queue_aware_load_gets_its_own_slot():
    eng, ps = _engine()
    la = np.zeros(5, np.float32)
    lb = np.asarray([9.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    eng.add_replicas(np.arange(100), np.full(100, 1))
    for load in (la, lb, la):
        inc = eng.path_latencies(ps, policy="queue_aware", load=load, incremental=True)
        assert np.array_equal(inc, eng.path_latencies(ps, policy="queue_aware", load=load))
    assert len(next(iter(eng.incremental.caches.values())).slots) == 2


def test_gathered_bytes_book_only_the_index_vector():
    eng, ps = _engine()
    eng.path_latencies(ps, incremental=True)
    with TRANSFER.scope():
        h = eng.path_latencies(ps, incremental=True)  # clean hit
        assert TRANSFER.h2d_bytes == 0 and TRANSFER.gathered_bytes == 0
    eng.note_changed([100_000])  # no path touches it: still a hit
    with TRANSFER.scope():
        assert np.array_equal(eng.path_latencies(ps, incremental=True), h)
        assert TRANSFER.gathered_bytes == 0
    v = int(ps.objects[0, 0])
    eng.add_replicas([v], [(int(eng.host_shard()[v]) + 1) % 5])
    dirty = len(eng.incremental.caches[id(ps)].index.dirty_paths([v]))
    with TRANSFER.scope():
        eng.path_latencies(ps, incremental=True)
        assert TRANSFER.gathered_bytes == 4 * dirty
        # the compacted vector's pad lanes are padding, not payload
        assert TRANSFER.h2d_bytes == TRANSFER.gathered_bytes
        assert TRANSFER.padded_bytes == 4 * (round_up_rows(dirty, device=CPU) - dirty)
        assert TRANSFER.h2d_bytes < np.asarray(ps.objects, np.int32).nbytes


def test_refresh_whole_and_by_objects():
    eng, ps = _engine()
    eng.path_latencies(ps, incremental=True)
    eng.scheme.mask[:, 2] = True  # bypasses add_replicas
    eng.refresh()
    assert not eng.incremental.caches
    assert np.array_equal(eng.path_latencies(ps, incremental=True), eng.path_latencies(ps))
    cache = eng.incremental.caches[id(ps)]
    objs = np.arange(0, 100, 7)
    eng.scheme.mask[objs, 3] = True
    eng.refresh(objects=objs)  # exact: only paths touching objs go dirty
    slot = next(iter(cache.slots.values()))
    assert np.array_equal(np.nonzero(slot.dirty)[0], cache.index.dirty_paths(objs))
    assert np.array_equal(eng.path_latencies(ps, incremental=True), eng.path_latencies(ps))


def test_dead_pathset_entries_are_purged():
    eng, ps = _engine()
    eng.path_latencies(ps, incremental=True)
    dead = T.PathSet.from_lists([[0, 1], [2, 3]])
    eng.path_latencies(dead, incremental=True)
    assert len(eng.incremental.caches) == 2
    del dead
    eng.note_changed([0])
    assert len(eng.incremental.caches) == 1


def test_replicate_delta_notifies_engine_cache():
    ps, shard = random_workload(np.random.default_rng(6), n_obj=150, n_srv=5, n_paths=150)
    extra, _ = random_workload(np.random.default_rng(3), n_obj=150, n_srv=5, n_paths=60)
    _, _, eng = T.replicate_workload(to_port(ps), shard, 5, t=2, return_engine=True,
                                     device=CPU)
    _, _, jeng = R.replicate_workload(ps, shard, 5, t=2, return_engine=True)
    tp, tx = to_port(ps), to_port(extra)
    eng.path_latencies(tp, incremental=True)
    for fused in (False, True):
        T.replicate_delta(tx, eng, 1, fused=fused)
        R.replicate_delta(extra, jeng, 1, fused=fused)
        inc = eng.path_latencies(tp, incremental=True)
        assert np.array_equal(inc, eng.path_latencies(tp))
        assert np.array_equal(inc, jeng.path_latencies(ps))
        assert np.array_equal(eng.path_latencies(tx, incremental=True), eng.path_latencies(tx))


def test_fail_event_keeps_the_cache_bit_identical():
    ps, shard = random_workload(np.random.default_rng(7), n_obj=150, n_srv=6, n_paths=200)
    outs = []
    for C, D, p, kw in ((T, TD, to_port(ps), {"device": CPU}), (R, RD, ps, {})):
        scheme, stats = C.replicate_workload(p, shard.copy(), 6, 1, track_rm=True, **kw)
        rmap = C.ReshardingMap.from_entries(stats.rm, scheme.shard)
        cluster = D.Cluster(scheme)
        eng = (LatencyEngine if C is T else RE.LatencyEngine)(scheme, **kw)
        eng.path_latencies(p, incremental=True)
        rep = D.apply_event(cluster, rmap, D.Event("fail", 3, 1), engine=eng)
        assert not rep.get("skipped") and rep["dirty_objects"] > 0
        inc = eng.path_latencies(p, incremental=True)
        fresh = (LatencyEngine if C is T else RE.LatencyEngine)(cluster.scheme, **kw)
        assert np.array_equal(inc, fresh.path_latencies(p))
        outs.append(inc)
    assert np.array_equal(outs[0], outs[1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel backend's re-walk)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_kernel_incremental_rewalk_equals_torch(cuda, policy):
    ps, shard, mask, load = _case()
    pol = _pol(policy, _PortPolicies)
    ld = load if policy == "queue_aware" else None
    outs = []
    for backend, dev in (("kernel", "cuda"), ("torch", CPU)):
        eng = LatencyEngine.from_arrays(mask.copy(), shard, backend=backend, device=dev)
        outs.append(_drive(eng, to_port(ps), pol, ld))
    for step in STEPS:
        for a, b in zip(outs[0][step], outs[1][step]):
            assert np.array_equal(a, b), step
