"""The port's fused provisioning path against its separate pipeline and
against the JAX package's fused path.

The contracts of ``tests/test_provision_scale.py`` (fused parity, the
reference-backend downgrade, batched prune == serial prune), held across
the two packages: for every routing policy the port's
``replicate_workload(fused=True)`` gives the mask of its own
``fused=False`` and of ``repro``'s ``fused=True`` on the ``jnp`` and
``pallas`` (interpret) backends.  Masks and integer counters are exact;
``total_cost`` is a float32 sum accumulated in another order by each
pipeline, so it is compared with ``rtol=1e-5`` as the JAX package's own
test compares it.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from conftest import random_workload

CPU = "cpu"
POLICIES = [None, "nearest_copy", "queue_aware", "nearest_copy_dp"]
COUNTERS = ("replicas", "failed_paths", "routed_skips", "routed_violations",
            "pruned_replicas", "fallback_paths", "paths_processed")


def _case(seed, n_paths=110):
    rng = np.random.default_rng(seed)
    ps, shard = random_workload(rng, n_obj=90, n_srv=5, n_paths=n_paths, max_len=6)
    f = rng.uniform(0.5, 2.0, 90).astype(np.float32)
    return ps, T.PathSet(ps.objects, ps.lengths, ps.query_ids), shard, 5, f


def _same(a, sa, b, sb, what):
    assert np.array_equal(a.mask, b.mask), what
    for c in COUNTERS:
        assert getattr(sa, c) == getattr(sb, c), (what, c)
    assert np.isclose(sa.total_cost, sb.total_cost, rtol=1e-5), what


@pytest.mark.parametrize("policy", POLICIES)
def test_fused_parity_all_backends(policy):
    ps, tps, shard, n_srv, f = _case(0)
    sep, ss = T.replicate_workload(tps, shard, n_srv, 2, f=f, policy=policy, device=CPU)
    fus, fs = T.replicate_workload(tps, shard, n_srv, 2, f=f, policy=policy,
                                   fused=True, device=CPU)
    _same(sep, ss, fus, fs, "port fused vs port separate")
    if policy is not None:
        assert {"prune_plan", "prune_steps"} <= set(fs.stage_s)
    for backend in ("jnp", "pallas"):
        jf, jfs = R.replicate_workload(ps, shard, n_srv, t=2, f=f, policy=policy,
                                       policy_backend=backend, fused=True)
        _same(fus, fs, jf, jfs, f"port fused vs repro fused ({backend})")


@pytest.mark.parametrize("policy", ["nearest_copy", "nearest_copy_dp"])
@pytest.mark.parametrize("budget", ["vector", "capacity"])
def test_fused_parity_vector_budgets_and_capacity(policy, budget):
    ps, tps, shard, n_srv, f = _case(1)
    if budget == "vector":
        kw = {"t": np.random.default_rng(2).integers(1, 4, ps.n_queries).astype(np.int32)}
    else:
        kw = {"t": 2, "capacity": 60.0}
    sep, ss = T.replicate_workload(tps, shard, n_srv, f=f, policy=policy, device=CPU, **kw)
    fus, fs = T.replicate_workload(tps, shard, n_srv, f=f, policy=policy, fused=True,
                                   device=CPU, **kw)
    _same(sep, ss, fus, fs, "port fused vs port separate")
    jf, jfs = R.replicate_workload(ps, shard, n_srv, f=f, policy=policy, fused=True, **kw)
    _same(fus, fs, jf, jfs, "port fused vs repro fused")


def test_fused_reference_backend_downgrades():
    """fused needs a device backend; reference runs the separate pipeline."""
    ps, tps, shard, n_srv, f = _case(2, n_paths=40)
    ref, rs = T.replicate_workload(tps, shard, n_srv, 2, f=f, policy="nearest_copy",
                                   policy_backend="reference", fused=True, device=CPU)
    sep, ss = T.replicate_workload(tps, shard, n_srv, 2, f=f, policy="nearest_copy",
                                   device=CPU)
    assert np.array_equal(ref.mask, sep.mask)
    assert "prune_steps" not in rs.stage_s  # the prune stayed serial
    jr, _ = R.replicate_workload(ps, shard, n_srv, t=2, f=f, policy="nearest_copy",
                                 policy_backend="reference", fused=True)
    assert np.array_equal(ref.mask, jr.mask)


@pytest.mark.parametrize("policy", ["nearest_copy", "queue_aware", "nearest_copy_dp"])
@pytest.mark.parametrize("group_max", [512, 3])
def test_fused_prune_decision_identical(policy, group_max):
    """Batched independent groups make exactly the serial sweep's
    decisions: identical masks and identical (dropped, bytes_saved)."""
    ps, tps, shard, n_srv, f = _case(3)
    scheme, _ = T.replicate_workload(tps, shard, n_srv, 1, f=f, policy=policy,
                                     policy_prune=False, fused=True, device=CPU)
    serial = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    batched = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    stage_s = {}
    n_s = T.prune_scheme_replicas(serial, tps, 1, policy=policy, f=f, device=CPU)
    n_b = T.prune_scheme_replicas(batched, tps, 1, policy=policy, f=f, fused=True,
                                  device=CPU, group_max=group_max, stage_s=stage_s)
    assert np.array_equal(serial.mask, batched.mask)
    assert n_s == n_b
    assert n_s[0] > 0 and set(stage_s) == {"prune_plan", "prune_steps"}
    jscheme = R.ReplicationScheme(scheme.mask.copy(), shard)
    n_j = R.prune_scheme_replicas(jscheme, ps, 1, policy=policy, f=f, fused=True,
                                  group_max=group_max)
    assert np.array_equal(jscheme.mask, batched.mask)
    assert n_j == n_b


def test_independent_groups_match_jax():
    """The port's grouping (which stops scanning a round once its group is
    full) gives the JAX package's groups."""
    from repro.core.replication import _independent_groups as j_groups
    from repro_torch.core.replication import _independent_groups as t_groups
    from repro_torch.engine import PathIndex

    rng = np.random.default_rng(4)
    ps, _ = random_workload(rng, n_obj=60, n_srv=4, n_paths=200, max_len=5)
    affected = PathIndex(np.asarray(ps.objects), 60).paths_of
    vs = rng.integers(0, 60, 300)
    order = rng.permutation(300)
    for group_max in (1, 4, 512):
        assert t_groups(order, vs, affected, ps.n_paths, group_max) == \
            j_groups(order, vs, affected, ps.n_paths, group_max)
