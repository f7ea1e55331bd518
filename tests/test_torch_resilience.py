"""The port's k-resilience gate against the JAX package's.

``KResilient`` / ``failover_shard`` / ``case_word_mask`` equal ``repro``'s;
``resilient_path_latencies`` (``reference`` and ``torch``) equals
``repro``'s ``jnp`` engine under ``home_first`` / ``nearest_copy`` /
``nearest_copy_dp``; ``replicate_workload(resilience=1)`` gives
``repro``'s masks with 0 violations while the k = 0 scheme violates;
``replicate_delta(resilience=...)`` gives ``repro``'s delta.  The
``cuda`` cases hold ``resilient_counts``' per-case launches against the
batched ``torch`` evaluation on a card.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import numpy as np
import pytest
import torch

import repro.core as R
import repro.engine as RE
import repro_torch.core as T
from conftest import random_workload
from repro_torch.engine import (
    KResilient,
    LatencyEngine,
    case_word_mask,
    failover_shard,
    nearest_copy_dp,
    resolve_resilience,
)
from repro_torch.engine import backends

CPU = "cpu"
T_BUDGET = 2
POLICIES = ("home_first", "nearest_copy", "nearest_copy_dp")


def to_port(ps):
    return T.PathSet(ps.objects, ps.lengths, ps.query_ids)


def _pol(name, dp):
    return dp(2) if name == "nearest_copy_dp" else name


def _case():
    return random_workload(np.random.default_rng(0), n_obj=120, n_srv=5, n_paths=150)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's k = 0 / k = 1 schemes and case latencies, once."""
    ps, shard = _case()
    out = {"k0": R.replicate_workload(ps, shard.copy(), 5, T_BUDGET)[0].mask}
    for pol in (None, "nearest_copy"):
        scheme, stats = R.replicate_workload(ps, shard.copy(), 5, T_BUDGET, resilience=1,
                                             policy=pol)
        out[pol] = (scheme.mask, stats)
    eng = RE.LatencyEngine(R.ReplicationScheme(out[None][0].copy(), shard.copy()))
    for name in POLICIES:
        out["h", name] = eng.resilient_path_latencies(ps, 1, policy=_pol(name, RE.nearest_copy_dp))
    return out


def test_kresilient_validation_and_loss_cases():
    for k, doms in ((1, None), (2, None), (1, ((0, 1), (2, 3), (4,))), (2, ((0, 1), (2,), (3, 4)))):
        a = KResilient(k=k, domains=doms).loss_cases(5)
        b = RE.KResilient(k=k, domains=doms).loss_cases(5)
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        KResilient(k=0)
    with pytest.raises(ValueError):
        KResilient(k=1, domains=((0, 1, 2, 3, 4),)).loss_cases(5)
    with pytest.raises(ValueError):
        KResilient(k=1, domains=((0, 7),)).loss_cases(5)
    with pytest.raises(ValueError):
        KResilient(k=1, domains=((),))
    assert resolve_resilience(None) is None
    assert resolve_resilience(2) == KResilient(k=2)
    with pytest.raises(ValueError):
        resolve_resilience("k1")


def test_failover_shard_and_case_word_mask_equal_repro():
    shard = np.random.default_rng(1).integers(0, 70, 500)
    for lost in ([1], [0, 69], [3, 4, 5, 31, 32, 33, 64]):
        lost = np.asarray(lost)
        assert np.array_equal(failover_shard(shard, lost, 70), RE.failover_shard(shard, lost, 70))
        m = case_word_mask(lost, 3)
        assert m.dtype == np.int32
        assert np.array_equal(m.view(np.uint32), RE.case_word_mask(lost, 3))
    fo = failover_shard(np.asarray([0, 1, 2, 0, 1]), np.asarray([1]), 3)
    assert list(fo) == [0, 2, 2, 0, 2]


@pytest.mark.parametrize("backend", ["reference", "torch"])
@pytest.mark.parametrize("policy", POLICIES)
def test_resilient_path_latencies_equal_repro(jax_ref, backend, policy):
    ps, shard = _case()
    eng = LatencyEngine(T.ReplicationScheme(jax_ref[None][0].copy(), shard.copy()),
                        backend=backend, device=CPU)
    h = eng.resilient_path_latencies(to_port(ps), 1, policy=_pol(policy, nearest_copy_dp))
    assert h.shape == (5, ps.n_paths) and h.dtype == np.int32
    assert np.array_equal(h, jax_ref["h", policy])


@pytest.mark.parametrize("policy", [None, "nearest_copy"])
def test_k1_masks_equal_repro_and_survive_every_loss(jax_ref, policy):
    ps, shard = _case()
    tp = to_port(ps)
    scheme, stats = T.replicate_workload(tp, shard.copy(), 5, T_BUDGET, resilience=1,
                                         policy=policy, device=CPU)
    jmask, jstats = jax_ref[policy]
    assert np.array_equal(scheme.mask, jmask)
    assert stats.resilient_violations == jstats.resilient_violations == 0
    assert stats.resilience_rounds == jstats.resilience_rounds >= 1
    assert stats.resilience_orphans > 0
    assert stats.replicas == jstats.replicas
    eng = LatencyEngine(scheme, device=CPU)
    t_q = np.full(ps.n_queries, T_BUDGET, np.int32)
    assert eng.is_resilient_feasible(tp, t_q, KResilient(k=1), policy=policy)
    k0 = LatencyEngine(T.ReplicationScheme(jax_ref["k0"].copy(), shard.copy()), device=CPU)
    assert not k0.is_resilient_feasible(tp, t_q, 1)


def test_fused_k1_and_domains():
    ps, shard = _case()
    tp = to_port(ps)
    res = KResilient(k=1, domains=((0, 1), (2, 3), (4,)))
    fused, st_f = T.replicate_workload(tp, shard.copy(), 5, 3, resilience=res, fused=True,
                                       device=CPU)
    jfused, jst = R.replicate_workload(ps, shard.copy(), 5, 3, fused=True,
                                       resilience=RE.KResilient(k=1, domains=res.domains))
    assert np.array_equal(fused.mask, jfused.mask)
    assert st_f.resilient_violations == jst.resilient_violations == 0
    assert LatencyEngine(fused, device=CPU).is_resilient_feasible(tp, 3, res)


def test_delta_with_resilience_equals_repro():
    ps, shard = _case()
    extra, _ = random_workload(np.random.default_rng(3), n_obj=120, n_srv=5, n_paths=60)
    outs = []
    for C, p, x, kw in ((T, to_port(ps), to_port(extra), {"device": CPU}),
                        (R, ps, extra, {})):
        _, _, eng = C.replicate_workload(p, shard, 5, t=2, return_engine=True, **kw)
        stats, add = C.replicate_delta(x, eng, 2, resilience=1)
        assert stats.resilient_violations == 0
        assert eng.is_resilient_feasible(x, 2, 1)
        outs.append((eng.host_mask(), add, stats.resilience_rounds))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert all(np.array_equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert outs[0][2] == outs[1][2]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES + ("queue_aware",))
def test_resilient_counts_kernel_equals_torch(policy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (resilient_counts' per-case launches)")
    from repro_torch.engine.packed import PackedScheme
    from repro_torch.engine.streaming import to_device

    ps, shard = _case()
    mask = np.zeros((120, 5), bool)
    mask[np.arange(120), shard] = True
    mask[np.arange(0, 120, 3), 2] = True
    load = np.arange(5, dtype=np.float32)
    pol = _pol(policy, nearest_copy_dp)
    cases = KResilient(k=1).loss_cases(5)
    masks = np.stack([case_word_mask(c, 1) for c in cases])
    homes = np.stack([failover_shard(shard, c, 5) for c in cases]).astype(np.int32)
    outs = []
    for dev, backend in ((torch.device("cuda"), "kernel"), (torch.device(CPU), "torch")):
        packed = PackedScheme.from_mask(mask, shard, dev)
        h = backends.resilient_counts(
            to_device(np.asarray(ps.objects, np.int32), dev),
            to_device(np.asarray(ps.lengths, np.int32), dev), packed.words,
            to_device(masks, dev), to_device(homes, dev), policy=pol, load=load,
            backend=backend)
        outs.append(h.cpu().numpy())
    assert np.array_equal(outs[0], outs[1])
