"""The serial prune's one-launch walks (``kernels/prune_walk``) against the
JAX package's serial prune.

On the CPU ``prune_scheme_replicas(fused=False)`` runs the whole candidate
sequence through ``prune_walk_plain`` (``prune_walk_scored_plain`` under
``nearest_copy_dp``); its masks, ``n_dropped`` and ``bytes_saved`` must
equal ``repro``'s serial prune on the ``jnp`` backend exactly (the
decisions are integer walks; ``bytes_saved`` is summed in candidate order
by both).  The routing tests run the ``kernel`` backend's choices on the
CPU, where every wrapper runs its plain version: which sweep, which UPDATE
route and which prune route each shape takes.  The tests marked ``cuda``
hold the kernels against their plain versions (keep flags and final
words) and the kernel backend's wide shapes against ``repro``, and skip
without a card; on a machine with one run
``PYTHONPATH=src python -m pytest -q tests/test_torch_prune_walk.py``.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from conftest import random_workload
from repro.engine import routing as R_routing
from repro.graph import hash_partition, snb_like
from repro.workload import snb_workload_materialized
from repro_torch.engine import LatencyEngine, PathIndex
from repro_torch.engine import routing as T_routing
from repro_torch.engine.packed import pack_bool_mask
from repro_torch.kernels import prune_walk as pw

CPU = "cpu"
N_SRV = 6
POLICIES = ["home_first", "nearest_copy", "queue_aware"]
DP_POLICIES = ["nearest_copy_dp", "nearest_copy_dp(2)"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run each test's torch ops on one thread.  The suite runs several
    workers at once, and the ops of these walks are too small to gain from
    OpenMP: on a loaded machine the wide shapes' ops waited minutes on
    oversubscribed OpenMP barriers.  The thread count changes no result."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pols(name):
    """(the JAX package's policy, the port's) for a policy id;
    "nearest_copy_dp(k)" is ``nearest_copy_dp`` at depth k."""
    if name.startswith("nearest_copy_dp("):
        depth = int(name[len("nearest_copy_dp("):-1])
        return R_routing.nearest_copy_dp(depth), T_routing.nearest_copy_dp(depth)
    return name, name


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
    jpol, tpol = _pols(policy)
    ts = T.ReplicationScheme.from_numpy(scheme_mask, shard)
    tps = T.PathSet(ps.objects, ps.lengths, ps.query_ids)
    got = T.prune_scheme_replicas(ts, tps, t, policy=tpol, f=f, load=load, device=CPU)
    js = R.ReplicationScheme(scheme_mask.copy(), shard)
    want = R.prune_scheme_replicas(js, ps, t, policy=jpol, f=f, load=load, backend="jnp")
    return ts, got, js, want


@pytest.mark.parametrize("policy", POLICIES + DP_POLICIES)
def test_serial_prune_matches_jax_on_snb(snb_case, policy):
    ps, shard, f, t, load = snb_case
    load = load if policy == "queue_aware" else None
    greedy_pol = None if policy == "home_first" else _pols(policy)[0]
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


def _dead_case(seed, n_obj, n_srv, n_paths, max_len, dead, tpol):
    """A seeded workload and scheme in which a share ``dead`` of the objects
    has no holder at all (the DP's dead state), with per-path budgets of
    the port's pre-prune count under ``tpol`` plus 0 or 1, so some
    removals stay and some are restored."""
    rng = np.random.default_rng(seed)
    ps, shard = random_workload(rng, n_obj=n_obj, n_srv=n_srv, n_paths=n_paths,
                                max_len=max_len)
    mask = rng.random((n_obj, n_srv)) < min(0.4, 3.0 / n_srv)
    mask[np.arange(n_obj), shard] = True
    mask[rng.random(n_obj) < dead] = False
    f = rng.uniform(0.5, 2.0, n_obj).astype(np.float32)
    tps = T.PathSet(ps.objects, ps.lengths, ps.query_ids)
    h0 = LatencyEngine(T.ReplicationScheme.from_numpy(mask, shard), device=CPU) \
        .path_latencies(tps, policy=tpol)
    t = (h0 + rng.integers(0, 2, ps.n_paths)).astype(np.int32)  # one query per path
    return ps, shard, mask, f, t


@pytest.mark.parametrize("policy", DP_POLICIES + ["nearest_copy_dp(0)", "nearest_copy_dp(1)"])
@pytest.mark.parametrize("case", ["dead", "length_1", "L9_S40"])
def test_scored_prune_edge_cases_match_jax(policy, case):
    """Objects with no holder, paths of length 1 and L 9 over 40 servers:
    the scored sweep (``prune_walk_scored_plain``) gives ``repro``'s serial
    prune exactly, at the full suffix and depths 0, 1 and 2."""
    args = {"dead": (11, 60, 6, 80, 6, 0.15), "length_1": (12, 40, 6, 60, 2, 0.1),
            "L9_S40": (13, 80, 40, 70, 9, 0.05)}[case]
    jpol, tpol = _pols(policy)
    ps, shard, mask, f, t = _dead_case(*args, tpol)
    ts = T.ReplicationScheme.from_numpy(mask, shard)
    tps = T.PathSet(ps.objects, ps.lengths, ps.query_ids)
    got = T.prune_scheme_replicas(ts, tps, t, policy=tpol, f=f, device=CPU)
    js = R.ReplicationScheme(mask.copy(), shard)
    want = R.prune_scheme_replicas(js, ps, t, policy=jpol, f=f, backend="jnp")
    assert np.array_equal(ts.mask, js.mask)
    assert got == want
    n_repl = int(mask.sum() - mask[np.arange(len(shard)), shard].sum())
    assert 0 < got[0] < n_repl  # some removals stay, some are restored


def _csr_case(seed, n_obj, n_srv, P, L, max_cand=1500, dead=0.0):
    """Seeded prune inputs as torch CPU tensors: words with extra copies
    (and a share ``dead`` of the objects with no holder), paths (repeats
    allowed), their CSR index, budgets and at most ``max_cand``
    candidates."""
    rng = np.random.default_rng(seed)
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    mask = rng.random((n_obj, n_srv)) < min(0.3, 2.5 / n_srv)
    mask[np.arange(n_obj), shard] = True
    if dead:
        mask[rng.random(n_obj) < dead] = False
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


def _call_scored(fn, x, depth):
    return fn(x["words"], x["cand_v"], x["cand_s"], x["starts"], x["rows"], x["objects"],
              x["lengths"], x["t_path"], x["home"], depth=depth)


def test_prune_walk_scored_cpu_runs_plain_without_a_launch():
    x = _csr_case(3, 40, 5, 60, 6, dead=0.1)
    before = pw.SCORED_LAUNCHES
    w0 = x["words"].clone()
    keep = _call_scored(pw.prune_walk_scored, x, -1)
    assert pw.SCORED_LAUNCHES == before
    assert keep.dtype == torch.bool and keep.shape == x["cand_v"].shape
    assert 0 < int(keep.sum()) < len(keep)
    y = dict(x, words=w0)
    assert torch.equal(_call_scored(pw.prune_walk_scored_plain, y, -1), keep)
    assert torch.equal(y["words"], x["words"])


@pytest.mark.parametrize("policy,called", [
    ("nearest_copy_dp", {"kernel": "prune_walk_scored", "torch": "prune_walk_scored_plain"}),
    ("nearest_copy_dp(2)", {"kernel": "prune_walk_scored",
                            "torch": "prune_walk_scored_plain"}),
])
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_prune_sweep_picks_the_scored_walk_by_backend(monkeypatch, policy, called, backend):
    """``backends.prune_sweep`` under ``nearest_copy_dp``: the scored
    kernel's wrapper on ``kernel``, its plain loop on ``torch``, at the
    policy's depth."""
    from repro_torch.engine import backends
    from repro_torch.engine.routing import resolve_policy

    pol = resolve_policy(_pols(policy)[1])
    depth = -1 if pol.depth is None else pol.depth
    x = _csr_case(4, 40, 5, 60, 6, dead=0.1)
    want = _call_scored(pw.prune_walk_scored_plain, dict(x, words=x["words"].clone()), depth)
    seen = []
    for name in ("prune_walk", "prune_walk_plain", "prune_walk_scored",
                 "prune_walk_scored_plain"):
        fn = getattr(pw, name)
        monkeypatch.setattr(pw, name, lambda *a, _n=name, _f=fn, **k:
                            seen.append((_n, k.get("depth"))) or _f(*a, **k))
    args = tuple(x[k] for k in ("words", "cand_v", "cand_s", "starts", "rows", "objects",
                                "lengths", "t_path", "home"))
    keep = backends.prune_sweep(*args, pol, x["rank"], backend=backend)
    assert seen[0] == (called[backend], depth) and torch.equal(keep, want)


def _kernel_on_cpu(monkeypatch):
    """Let the ``kernel`` backend resolve on the CPU: each kernel wrapper
    then runs its plain version, so the kernel backend's routing can be
    watched here."""
    from repro_torch.engine import backends

    resolve = backends.resolve_backend
    monkeypatch.setattr(backends, "resolve_backend",
                        lambda b, d: "kernel" if b in (None, "kernel") else resolve(b, d))


def _spy(monkeypatch, mod, name, seen):
    fn = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: seen.append(name) or fn(*a, **k))


@pytest.mark.parametrize("policy", POLICIES[1:] + DP_POLICIES)
def test_fused_prune_on_the_kernel_backend_is_one_sweep(monkeypatch, policy):
    """``prune_scheme_replicas(fused=True)`` on ``kernel`` makes one
    ``prune_sweep`` call and no batched group step, with the decisions of
    the torch backend's batched prune."""
    from repro_torch.core import replication
    from repro_torch.engine import backends

    rng = np.random.default_rng(6)
    ps, shard = random_workload(rng, n_obj=90, n_srv=5, n_paths=110, max_len=6)
    tps = T.PathSet(ps.objects, ps.lengths, ps.query_ids)
    f = rng.uniform(0.5, 2.0, 90).astype(np.float32)
    load = rng.integers(0, 3, 5).astype(np.float64) if policy == "queue_aware" else None
    tpol = _pols(policy)[1]
    scheme, st = T.replicate_workload(tps, shard, 5, 1, f=f, policy=tpol, load=load,
                                      policy_prune=False, fused=True, device=CPU)
    assert st.routed_violations == 0  # else the prune has nothing to do
    batched = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    want = T.prune_scheme_replicas(batched, tps, 1, policy=tpol, f=f, load=load, fused=True,
                                   device=CPU)
    _kernel_on_cpu(monkeypatch)
    seen = []
    _spy(monkeypatch, backends, "prune_sweep", seen)
    _spy(monkeypatch, replication, "_prune_group_step", seen)
    swept = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    stage_s = {}
    got = T.prune_scheme_replicas(swept, tps, 1, policy=tpol, f=f, load=load, fused=True,
                                  device=CPU, stage_s=stage_s)
    assert seen == ["prune_sweep"] and set(stage_s) == {"prune_walk"}
    assert np.array_equal(swept.mask, batched.mask)
    assert got[0] == want[0] > 0
    assert np.isclose(got[1], want[1], rtol=1e-12)  # the same sizes, summed in another order


# shape id -> (L, servers): a path longer than the 64 positions fused_update
# and the scored sweep keep on chip (their device-scratch tiers), rows
# wider than the 64 words fused_update's first version took, rows wider
# than the 384 words whose rank prune_walk stages in shared memory; and a
# shape that fit every kernel's on-chip tier
WIDE = {"L65": (65, 6), "W65": (6, 65 * 32), "W385": (6, 385 * 32), "fits": (6, 6)}


def _wide_case(shape, seed=21, n_obj=16):
    """A dozen seeded paths: one of the full length L, the others of at most
    6 objects.  Each path visits its objects grouped by home server, so it
    has few subpaths and the greedy enumerates few candidates even at L 65."""
    L, n_srv = WIDE[shape]
    rng = np.random.default_rng(seed)
    # six homes spread over the words, so paths share servers
    shard = rng.choice(np.sort(rng.choice(n_srv, 6, replace=False)), n_obj).astype(np.int32)
    lens = [L] + rng.integers(1, min(L, 6) + 1, 11).tolist()
    paths = [sorted(rng.integers(0, n_obj, n).tolist(), key=lambda v: shard[v]) for n in lens]
    ps = R.PathSet.from_lists(paths)
    f = rng.uniform(0.5, 2.0, n_obj).astype(np.float32)
    return ps, T.PathSet(ps.objects, ps.lengths, ps.query_ids), shard, n_srv, f


@pytest.mark.parametrize("shape", list(WIDE))
@pytest.mark.parametrize("policy", ["nearest_copy", "nearest_copy_dp"])
def test_kernel_backend_routes_wide_shapes(monkeypatch, shape, policy):
    """On ``kernel`` every shape takes the kernels' routes: the fused
    UPDATE (``fused_update_class``, never the torch-op ``_update_batch_core``)
    and one prune sweep (``prune_sweep``, never a batched group step),
    with the torch backend's masks and counts (which the tests above and
    ``test_torch_fused.py`` hold against ``repro``)."""
    from repro_torch.core import greedy, replication
    from repro_torch.engine import backends

    _, tps, shard, n_srv, f = _wide_case(shape)
    fus_t, fs_t = T.replicate_workload(tps, shard, n_srv, 1, f=f, policy=policy, fused=True,
                                       device=CPU)
    scheme, _ = T.replicate_workload(tps, shard, n_srv, 1, f=f, policy=policy,
                                     policy_prune=False, device=CPU)
    ts_t = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    want = T.prune_scheme_replicas(ts_t, tps, 1, policy=policy, f=f, device=CPU)
    _kernel_on_cpu(monkeypatch)
    seen = []
    for mod, name in ((greedy, "fused_update_class"), (greedy, "_update_batch_core"),
                      (backends, "prune_sweep"), (replication, "_prune_group_step")):
        _spy(monkeypatch, mod, name, seen)
    fus, fs = T.replicate_workload(tps, shard, n_srv, 1, f=f, policy=policy, fused=True,
                                   device=CPU)
    assert {"fused_update_class", "prune_sweep"} <= set(seen)
    assert "_update_batch_core" not in seen and "_prune_group_step" not in seen
    assert np.array_equal(fus.mask, fus_t.mask) and fs.pruned_replicas > 0
    assert (fs.replicas, fs.pruned_replicas, fs.failed_paths) == \
        (fs_t.replicas, fs_t.pruned_replicas, fs_t.failed_paths)
    # the serial prune: one sweep
    seen.clear()
    ts = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    assert T.prune_scheme_replicas(ts, tps, 1, policy=policy, f=f, device=CPU) == want
    assert seen == ["prune_sweep"]
    assert np.array_equal(ts.mask, ts_t.mask)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n_srv,L", [(6, 6), (6, 9), (40, 6), (385 * 32, 6)])
def test_prune_walk_kernel_matches_plain(cuda, policy, n_srv, L):
    """Both buckets (W == 1 with L <= 8 in registers; the plain loop), and
    a rank vector too long for shared memory (W 385)."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [-1, 0, 1, 2])
@pytest.mark.parametrize("n_srv,L", [(6, 6), (6, 9), (40, 6), (6, 1), (6, 70)])
def test_prune_walk_scored_kernel_matches_plain(cuda, depth, n_srv, L):
    """Every bucket (W == 1 with L <= 8 staged; the re-read loop; hop
    values in the device scratch past 64 positions), with objects that
    have no holder."""
    x = {k: v.to(cuda) for k, v in _csr_case(n_srv * 10 + L + 7, 1500, n_srv, 2000, L,
                                             max_cand=600, dead=0.05).items()}
    y = dict(x, words=x["words"].clone())
    before = pw.SCORED_LAUNCHES
    keep = _call_scored(pw.prune_walk_scored, x, depth)
    torch.cuda.synchronize()
    assert pw.SCORED_LAUNCHES == before + 1
    want = _call_scored(pw.prune_walk_scored_plain, y, depth)
    assert torch.equal(keep, want)
    assert torch.equal(x["words"], y["words"])
    if L > 1:
        assert 0 < int(keep.sum()) < len(keep)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", DP_POLICIES)
def test_serial_dp_prune_on_the_card_matches_the_cpu(cuda, snb_case, policy):
    """``prune_scheme_replicas`` under ``nearest_copy_dp`` launches the
    scored sweep once on the card and gives the CPU's mask, count and
    bytes."""
    ps, shard, f, t, _ = snb_case
    tpol = _pols(policy)[1]
    tps = T.PathSet(ps.objects, ps.lengths, ps.query_ids)
    scheme, _ = T.replicate_workload(tps, shard, N_SRV, t, f=f, device=CPU, policy=tpol,
                                     policy_prune=False)
    on_cpu = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    on_card = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    want = T.prune_scheme_replicas(on_cpu, tps, t, policy=tpol, f=f, device=CPU)
    before = pw.SCORED_LAUNCHES
    got = T.prune_scheme_replicas(on_card, tps, t, policy=tpol, f=f, device=cuda)
    assert pw.SCORED_LAUNCHES == before + 1
    assert np.array_equal(on_card.mask, on_cpu.mask)
    assert got == want and got[0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["L65", "W65", "W385"])
@pytest.mark.parametrize("policy", ["nearest_copy", "nearest_copy_dp"])
def test_kernel_backend_wide_shapes_match_jax_on_the_card(cuda, shape, policy):
    """The kernel backend on the card at the wide shapes, through the
    kernels' device-memory tiers: ``replicate_workload`` (fused and
    separate) and the serial prune give ``repro``'s masks."""
    ps, tps, shard, n_srv, f = _wide_case(shape)
    for fused in (False, True):
        got, gs = T.replicate_workload(tps, shard, n_srv, 1, f=f, policy=policy,
                                       fused=fused, device=cuda)
        want, ws = R.replicate_workload(ps, shard, n_srv, t=1, f=f, policy=policy,
                                        fused=fused, policy_backend="jnp")
        assert np.array_equal(got.mask, want.mask), fused
        assert (gs.replicas, gs.pruned_replicas) == (ws.replicas, ws.pruned_replicas)
    scheme, _ = R.replicate_workload(ps, shard, n_srv, t=1, f=f, policy=policy,
                                     policy_prune=False)
    ts = T.ReplicationScheme.from_numpy(scheme.mask, shard)
    got = T.prune_scheme_replicas(ts, tps, 1, policy=policy, f=f, device=cuda)
    js = R.ReplicationScheme(scheme.mask.copy(), shard)
    assert got == R.prune_scheme_replicas(js, ps, 1, policy=policy, f=f, backend="jnp")
    assert np.array_equal(ts.mask, js.mask)

