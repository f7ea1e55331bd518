"""The serial prune's one-launch walk (``kernels/prune_walk``) against the
JAX package's serial prune.

On the CPU ``prune_scheme_replicas(fused=False)`` runs the whole candidate
sequence through ``prune_walk_plain``; its masks, ``n_dropped`` and
``bytes_saved`` must equal ``repro``'s serial prune on the ``jnp``
backend exactly (the decisions are integer walks; ``bytes_saved`` is
summed in candidate order by both).  The tests marked ``cuda`` hold the
kernel against ``prune_walk_plain`` (keep flags and final words) and skip
without a card; on a machine with one run
``PYTHONPATH=src python -m pytest -q tests/test_torch_prune_walk.py``.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.graph import hash_partition, snb_like
from repro.workload import snb_workload_materialized
from repro_torch.engine import PathIndex
from repro_torch.engine.packed import pack_bool_mask
from repro_torch.kernels import prune_walk as pw

CPU = "cpu"
N_SRV = 6
POLICIES = ["home_first", "nearest_copy", "queue_aware"]


@pytest.fixture(scope="module")
def snb_case():
    snb = snb_like(scale=1, seed=0)
    ps = snb_workload_materialized(snb, n_queries=150, seed=0)
    shard = hash_partition(snb.graph.n_nodes, N_SRV)
    rng = np.random.default_rng(7)
    t = rng.integers(1, 3, ps.n_queries).astype(np.int32)
    load = rng.integers(0, 3, N_SRV).astype(np.float64)  # ties
    return ps, shard, snb.graph.object_sizes().astype(np.float32), t, load


def _both_prunes(ps, scheme_mask, shard, t, policy, f, load):
    """(port scheme, port result, JAX scheme, JAX result) of the serial prune
    on copies of one scheme."""
    ts = T.ReplicationScheme.from_numpy(scheme_mask, shard)
    tps = T.PathSet(ps.objects, ps.lengths, ps.query_ids)
    got = T.prune_scheme_replicas(ts, tps, t, policy=policy, f=f, load=load, device=CPU)
    js = R.ReplicationScheme(scheme_mask.copy(), shard)
    want = R.prune_scheme_replicas(js, ps, t, policy=policy, f=f, load=load, backend="jnp")
    return ts, got, js, want


@pytest.mark.parametrize("policy", POLICIES)
def test_serial_prune_matches_jax_on_snb(snb_case, policy):
    ps, shard, f, t, load = snb_case
    load = load if policy == "queue_aware" else None
    greedy_pol = None if policy == "home_first" else policy
    scheme, _ = R.replicate_workload(ps, shard, N_SRV, t, f=f, policy=greedy_pol,
                                     policy_prune=False, load=load)
    ts, got, js, want = _both_prunes(ps, scheme.mask, shard, t, policy, f, load)
    assert np.array_equal(ts.mask, js.mask)
    assert got[0] == want[0] and got[0] > 0
    assert got[1] == want[1]  # exactly: both sum in candidate order


def test_prune_edge_cases_match_jax():
    """A path that visits its object twice, an object on no path, and a
    replica the budget needs."""
    shard = np.array([0, 1, 2, 0, 1], np.int32)
    ps = R.PathSet.from_lists([[0, 1, 0, 2], [3, 1], [2, 0]])
    mask = np.zeros((5, 3), bool)
    mask[np.arange(5), shard] = True
    mask[1, 0] = mask[2, 0] = mask[0, 2] = True  # 1 and 2 beside 0; 0 beside 2
    mask[4, 2] = True  # object 4 lies on no path
    f = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    for t in (0, 1):
        for policy in POLICIES:
            ts, got, js, want = _both_prunes(ps, mask, shard, t, policy, f, None)
            assert np.array_equal(ts.mask, js.mask), (t, policy)
            assert got == want, (t, policy)
            assert not ts.mask[4, 2]  # no path needs it


def _csr_case(seed, n_obj, n_srv, P, L, max_cand=1500):
    """Seeded prune inputs as torch CPU tensors: words with extra copies,
    paths (repeats allowed), their CSR index, budgets and at most
    ``max_cand`` candidates."""
    rng = np.random.default_rng(seed)
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    mask = rng.random((n_obj, n_srv)) < min(0.3, 2.5 / n_srv)
    mask[np.arange(n_obj), shard] = True
    words = np.zeros((n_obj + 1, (n_srv + 31) // 32), np.uint32)
    words[:n_obj] = pack_bool_mask(mask)
    lengths = rng.integers(1, L + 1, P).astype(np.int32)
    objects = rng.integers(0, n_obj, (P, L)).astype(np.int32)
    objects[np.arange(L)[None, :] >= lengths[:, None]] = -1
    index = PathIndex(objects, n_obj)
    repl = mask.copy()
    repl[np.arange(n_obj), shard] = False
    vs, ss = np.nonzero(repl)
    order = rng.permutation(len(vs))[:max_cand]
    rank = np.zeros(words.shape[1] * 32, np.float32)
    rank[:n_srv] = rng.integers(0, 3, n_srv)
    arrs = dict(words=words.view(np.int32), cand_v=vs[order].astype(np.int32),
                cand_s=ss[order].astype(np.int32), starts=index.starts.astype(np.int32),
                rows=index.rows, objects=objects, lengths=lengths,
                t_path=rng.integers(L // 2, L, P).astype(np.int32), home=shard, rank=rank)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrs.items()}


def _call(fn, x, policy):
    kw = dict(home_first=policy == "home_first", lookahead=policy != "home_first")
    return fn(x["words"], x["cand_v"], x["cand_s"], x["starts"], x["rows"], x["objects"],
              x["lengths"], x["t_path"], x["home"], x["rank"], **kw)


def test_prune_walk_cpu_runs_plain_without_a_launch():
    x = _csr_case(0, 40, 5, 60, 5)
    before = pw.LAUNCHES
    w0 = x["words"].clone()
    keep = _call(pw.prune_walk, x, "nearest_copy")
    assert pw.LAUNCHES == before
    assert keep.dtype == torch.bool and keep.shape == x["cand_v"].shape
    assert 0 < int(keep.sum()) < len(keep)
    y = dict(x, words=w0)
    assert torch.equal(_call(pw.prune_walk_plain, y, "nearest_copy"), keep)
    assert torch.equal(y["words"], x["words"])


def test_prune_walk_empty_candidates_and_bad_input():
    x = _csr_case(1, 30, 4, 20, 4)
    w0 = x["words"].clone()
    empty = dict(x, cand_v=x["cand_v"][:0], cand_s=x["cand_s"][:0])
    keep = _call(pw.prune_walk, empty, "queue_aware")
    assert keep.shape == (0,) and torch.equal(x["words"], w0)
    with pytest.raises(TypeError, match="t_path"):
        _call(pw.prune_walk, dict(x, t_path=x["t_path"].long()), "nearest_copy")
    with pytest.raises(ValueError, match="candidates"):
        _call(pw.prune_walk, dict(x, cand_s=x["cand_s"] + 32), "nearest_copy")
    meta = {k: v.to("meta") for k, v in x.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        pw.prune_walk(*(meta[k] for k in ("words", "cand_v", "cand_s", "starts", "rows",
                                          "objects", "lengths", "t_path", "home", "rank")))


@pytest.mark.parametrize("backend,called", [("kernel", "prune_walk"),
                                            ("torch", "prune_walk_plain")])
def test_prune_sweep_picks_the_walk_by_backend(monkeypatch, backend, called):
    """``backends.prune_sweep``: the kernel's wrapper on ``kernel``, the plain
    loop on ``torch`` (so the torch backend stays plain torch ops on the
    card); any other backend raises."""
    from repro_torch.engine import backends
    from repro_torch.engine.routing import resolve_policy

    x = _csr_case(2, 40, 5, 60, 5)
    want = _call(pw.prune_walk_plain, dict(x, words=x["words"].clone()), "nearest_copy")
    seen = []
    for name in ("prune_walk", "prune_walk_plain"):
        fn = getattr(pw, name)
        monkeypatch.setattr(pw, name,
                            lambda *a, _n=name, _f=fn, **k: seen.append(_n) or _f(*a, **k))
    args = tuple(x[k] for k in ("words", "cand_v", "cand_s", "starts", "rows", "objects",
                                "lengths", "t_path", "home"))
    pol = resolve_policy("nearest_copy")
    keep = backends.prune_sweep(*args, pol, x["rank"], backend=backend)
    assert seen[0] == called and torch.equal(keep, want)
    with pytest.raises(ValueError, match="runs on torch"):
        backends.prune_sweep(*args, pol, x["rank"], backend="reference")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n_srv,L", [(6, 6), (6, 9), (40, 6)])
def test_prune_walk_kernel_matches_plain(cuda, policy, n_srv, L):
    """Both buckets (W == 1 with L <= 8 in registers; the plain loop)."""
    x = {k: v.to(cuda) for k, v in _csr_case(n_srv * 10 + L, 3000, n_srv, 4000, L).items()}
    y = dict(x, words=x["words"].clone())
    before = pw.LAUNCHES
    keep = _call(pw.prune_walk, x, policy)
    torch.cuda.synchronize()
    assert pw.LAUNCHES == before + 1
    want = _call(pw.prune_walk_plain, y, policy)
    assert torch.equal(keep, want)
    assert torch.equal(x["words"], y["words"])
    assert 0 < int(keep.sum()) < len(keep)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_serial_prune_on_the_card_matches_the_cpu(cuda, snb_case, policy):
    """``prune_scheme_replicas`` launches the kernel once on the card and
    gives the CPU's mask, count and bytes."""
    ps, shard, f, t, load = snb_case
    load = load if policy == "queue_aware" else None
    tps = T.PathSet(ps.objects, ps.lengths, ps.query_ids)
    scheme, _ = T.replicate_workload(tps, shard, N_SRV, t, f=f, load=load, device=CPU,
                                     policy=None if policy == "home_first" else policy,
                                     policy_prune=False)
    on_cpu = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    on_card = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    want = T.prune_scheme_replicas(on_cpu, tps, t, policy=policy, f=f, load=load, device=CPU)
    before = pw.LAUNCHES
    got = T.prune_scheme_replicas(on_card, tps, t, policy=policy, f=f, load=load,
                                  device=cuda)
    assert pw.LAUNCHES == before + 1
    assert np.array_equal(on_card.mask, on_cpu.mask)
    assert got == want and got[0] > 0


@pytest.mark.cuda
def test_serial_prune_on_the_torch_backend_launches_no_kernel(cuda, snb_case):
    """``backend="torch"`` on the card runs the plain loop on the card's
    tensors: no launch, and the CPU's mask, count and bytes."""
    ps, shard, f, t, _ = snb_case
    tps = T.PathSet(ps.objects, ps.lengths, ps.query_ids)
    scheme, _ = T.replicate_workload(tps, shard, N_SRV, t, f=f, device=CPU,
                                     policy="nearest_copy", policy_prune=False)
    on_cpu = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    on_card = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    want = T.prune_scheme_replicas(on_cpu, tps, t, f=f, device=CPU)
    before = pw.LAUNCHES
    got = T.prune_scheme_replicas(on_card, tps, t, f=f, backend="torch", device=cuda)
    assert pw.LAUNCHES == before
    assert np.array_equal(on_card.mask, on_cpu.mask)
    assert got == want and got[0] > 0
