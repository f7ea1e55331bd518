"""The port's path-sharded fused greedy against the JAX package's.

``mesh=`` on ``replicate_workload`` / ``replicate_delta`` /
``replicate_stream`` splits every batch's rows into one block per shard;
each shard prices its block against its own replica of the words, and the
chosen pairs of every shard are OR-ed into every other replica before the
next batch.  The JAX package's sharded driver computes exactly its
single-device fused run at the batch size rounded up to a multiple of the
device count, so every case holds the port's N-shard run (N = 2, 3, 4
shards on the CPU) against ``repro``'s single-device
``fused=True, policy_backend="jnp"`` run at that rounded size: masks,
additions, resharding entries and integer counters exact, ``total_cost``
at ``rtol=1e-5`` (each package sums its float32 costs in its own order)
and exactly with sizes in eighths.  One subprocess case runs ``repro``'s
own sharded driver on 4 forced host devices.  The kernel backend on a
mesh is held against one card in ``tests/test_torch_mesh_cuda.py``.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as R
import repro.engine as RE
import repro_torch.core as T
from conftest import random_workload
from repro_torch.core import greedy
from repro_torch.engine import LatencyEngine, PackedScheme, PathStream, TRANSFER
from repro_torch.engine import backends
from repro_torch.engine import sharding as S

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent
COUNTERS = ("replicas", "failed_paths", "routed_skips", "routed_violations",
            "pruned_replicas", "fallback_paths", "paths_processed")
BATCH = 16
SHARDS = (2, 3, 4)
POLICIES = (None, "nearest_copy", "nearest_copy_dp", "queue_aware")
LOAD = np.array([5.0, 0.0, 40.0, 1.0, 12.0], np.float32)  # the load-aware gate's forecast


def _case(seed=0, n_paths=110, eighths=False):
    """``tests/test_provision_scale.py``'s case: 90 objects, 5 servers,
    paths up to 6 long, f uniform in [0.5, 2) (or multiples of 1/8)."""
    rng = np.random.default_rng(seed)
    ps, shard = random_workload(rng, n_obj=90, n_srv=5, n_paths=n_paths, max_len=6)
    f = rng.uniform(0.5, 2.0, 90).astype(np.float32)
    if eighths:
        f = rng.integers(4, 17, 90).astype(np.float32) / 8
    return ps, T.PathSet(ps.objects, ps.lengths, ps.query_ids), shard, f


def _mesh(n):
    return S.provisioning_mesh(n, device=CPU)


def _rounded(n, batch=BATCH):
    return -(-batch // n) * n


_JAX: dict = {}


def _jax(key, fn):
    """Each JAX reference once per worker (its jit compiles dominate)."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _same(a, sa, b, sb, exact_cost=False):
    assert np.array_equal(a.mask, b.mask)
    for c in COUNTERS:
        assert getattr(sa, c) == getattr(sb, c), c
    if exact_cost:
        assert sa.total_cost == sb.total_cost
    else:
        assert np.isclose(sa.total_cost, sb.total_cost, rtol=1e-5)


@pytest.fixture
def drives(monkeypatch):
    """Every mesh drive a test's drivers build, to read their replicas."""
    seen = []

    class Recorded(greedy._MeshDrive):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    monkeypatch.setattr(greedy, "_MeshDrive", Recorded)
    return seen


def _replicas_equal(drive):
    """Every replica equals the first (the sacrificial last row, which takes
    each shard's masked-out writes, aside)."""
    w0 = drive.words(0)[:-1]
    return all(torch.equal(w0, drive.words(s)[:-1]) for s in range(drive.mesh.size))


# ---------------------------------------------------------------------------
# replicate_workload
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p or "home_first")
def test_mesh_equals_jax_single_device(drives, policy, n):
    ps, tps, shard, f = _case(0)
    load = LOAD if policy == "queue_aware" else None
    got, gs = T.replicate_workload(tps, shard, 5, 2, f=f, policy=policy, load=load, fused=True,
                                   mesh=_mesh(n), batch_size=BATCH, track_rm=True)
    want, ws = _jax(("workload", policy, _rounded(n)), lambda: R.replicate_workload(
        ps, shard, 5, t=2, f=f, policy=policy, load=load, fused=True, policy_backend="jnp",
        batch_size=_rounded(n), track_rm=True))
    _same(got, gs, want, ws)
    assert gs.rm == ws.rm
    assert len(drives) == 1 and drives[0].mesh.size == n
    assert _replicas_equal(drives[0])
    if policy is None:  # no prune: the first replica is the returned scheme
        assert torch.equal(drives[0].words(0)[:-1],  # the sacrificial row takes masked writes
                           PackedScheme.from_mask(got.mask, shard, CPU).words[:-1])


@pytest.mark.parametrize("n", SHARDS)
def test_mesh_equals_jax_with_sizes_in_eighths(n):
    """Every cost sum is exact: total_cost equal to the last bit."""
    ps, tps, shard, f = _case(1, eighths=True)
    got, gs = T.replicate_workload(tps, shard, 5, 2, f=f, policy="nearest_copy", fused=True,
                                   mesh=_mesh(n), batch_size=BATCH)
    want, ws = R.replicate_workload(ps, shard, 5, t=2, f=f, policy="nearest_copy", fused=True,
                                    policy_backend="jnp", batch_size=_rounded(n))
    _same(got, gs, want, ws, exact_cost=True)


@pytest.mark.parametrize("n,jax_batch", [(3, 258), (4, 256)])
def test_default_batch_rounds_to_the_shard_count(n, jax_batch):
    """At the default 256 rows a batch stays 256 on 2 and 4 shards and
    becomes 258 on 3, as in the JAX package."""
    ps, tps, shard, f = _case(2, n_paths=600, eighths=True)
    got, gs = T.replicate_workload(tps, shard, 5, 1, f=f, policy="nearest_copy", fused=True,
                                   mesh=_mesh(n))
    want, ws = R.replicate_workload(ps, shard, 5, t=1, f=f, policy="nearest_copy", fused=True,
                                    policy_backend="jnp", batch_size=jax_batch)
    _same(got, gs, want, ws, exact_cost=True)


@pytest.mark.parametrize("n", (2, 3))
@pytest.mark.parametrize("policy", (None, "nearest_copy_dp"), ids=lambda p: p or "home_first")
def test_mesh_per_path_budgets(policy, n):
    ps, tps, shard, f = _case(3)
    t = np.random.default_rng(5).integers(1, 4, ps.n_queries).astype(np.int32)
    got, gs = T.replicate_workload(tps, shard, 5, t, f=f, policy=policy, fused=True,
                                   mesh=_mesh(n), batch_size=BATCH)
    want, ws = R.replicate_workload(ps, shard, 5, t=t, f=f, policy=policy, fused=True,
                                    policy_backend="jnp", batch_size=_rounded(n))
    _same(got, gs, want, ws)


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("kw", [{"capacity": 60.0}, {"epsilon": 0.6}],
                         ids=["capacity", "epsilon"])
def test_mesh_capacity_and_epsilon(drives, kw, n):
    """Capacity runs recompute the load from the words after each union."""
    ps, tps, shard, f = _case(4)
    got, gs = T.replicate_workload(tps, shard, 5, 2, f=f, policy="nearest_copy", fused=True,
                                   mesh=_mesh(n), batch_size=BATCH, **kw)
    want, ws = R.replicate_workload(ps, shard, 5, t=2, f=f, policy="nearest_copy", fused=True,
                                    policy_backend="jnp", batch_size=_rounded(n), **kw)
    _same(got, gs, want, ws)
    assert _replicas_equal(drives[0])


@pytest.mark.parametrize("n", (2, 3))
def test_mesh_exact_fallback_reaches_every_replica(drives, n):
    """Paths past the enumeration budget run the exact sequential UPDATE;
    its additions reach every replica before the next class."""
    ps, tps, shard, f = _case(5)
    t = np.random.default_rng(6).integers(0, 3, ps.n_queries).astype(np.int32)
    got, gs = T.replicate_workload(tps, shard, 5, t, f=f, fused=True, mesh=_mesh(n),
                                   batch_size=BATCH, max_candidates=4)
    want, ws = R.replicate_workload(ps, shard, 5, t=t, f=f, fused=True, policy_backend="jnp",
                                    batch_size=_rounded(n), max_candidates=4)
    assert gs.fallback_paths > 0
    _same(got, gs, want, ws)
    assert _replicas_equal(drives[0])


def test_mesh_with_resilience_equals_jax():
    """The k-resilience repair runs unsharded after the sharded pass."""
    ps, tps, shard, f = _case(6, n_paths=60, eighths=True)
    got, gs = T.replicate_workload(tps, shard, 5, 2, f=f, policy="nearest_copy", fused=True,
                                   mesh=_mesh(2), batch_size=BATCH, resilience=1)
    want, ws = R.replicate_workload(ps, shard, 5, t=2, f=f, policy="nearest_copy", fused=True,
                                    policy_backend="jnp", batch_size=BATCH, resilience=1)
    _same(got, gs, want, ws, exact_cost=True)
    assert gs.resilient_violations == ws.resilient_violations
    assert gs.resilience_rounds == ws.resilience_rounds


@pytest.mark.parametrize("n", (2, 3))
def test_transfer_books_the_single_device_uploads(n):
    """Each batch row crosses the bus once: the same h2d bytes and calls as
    the single-device run at the rounded batch size."""
    _, tps, shard, f = _case(0)
    books = []
    for kw in ({"batch_size": _rounded(n), "device": CPU},
               {"batch_size": BATCH, "mesh": _mesh(n)}):
        with TRANSFER.scope() as tr:
            scheme, _ = T.replicate_workload(tps, shard, 5, 2, f=f, policy="nearest_copy",
                                             fused=True, **kw)
            books.append((tr.h2d_bytes, tr.h2d_calls, tr.padded_bytes))
        books.append(scheme.mask)
    assert books[0] == books[2]
    assert np.array_equal(books[1], books[3])


def test_exchange_moves_pairs_not_words():
    _, tps, shard, f = _case(0)
    S.EXCHANGE.reset()
    scheme, _ = T.replicate_workload(tps, shard, 5, 2, f=f, fused=True, mesh=_mesh(4),
                                     batch_size=BATCH)
    ex = S.EXCHANGE.snapshot()
    words = PackedScheme.from_mask(scheme.mask, shard, CPU).words
    # the words and the rank vector copied once for each of shards 1-3
    assert ex["replica_bytes"] == 3 * (words.numel() * 4 + words.shape[1] * 32 * 4)
    # every addition sent to the three other replicas, 8 bytes a pair
    assert ex["pairs"] >= 3 * (int(scheme.mask.sum()) - 90)
    assert ex["pair_bytes"] == 8 * ex["pairs"]


# ---------------------------------------------------------------------------
# replicate_delta / replicate_stream
# ---------------------------------------------------------------------------
def _delta_case():
    ps, shard = random_workload(np.random.default_rng(0), n_obj=150, n_srv=5, n_paths=150)
    extra, _ = random_workload(np.random.default_rng(3), n_obj=150, n_srv=5, n_paths=80,
                               n_queries=30)
    t_vec = np.random.default_rng(4).integers(0, 3, extra.n_queries).astype(np.int32)
    return ps, shard, extra, t_vec


def _run_delta(C, ps, shard, extra, t, policy, batch_size, **kw):
    dev = {"device": CPU} if C is T else {}
    _, _, eng = C.replicate_workload(ps, shard, 5, t=2, return_engine=True, **dev)
    stats, add = C.replicate_delta(extra, eng, t, fused=True, policy=policy,
                                   batch_size=batch_size, track_rm=True, **kw)
    return eng.host_mask(), stats, add


@pytest.mark.parametrize("n", (2, 3))
@pytest.mark.parametrize("tk", ("scalar", "vector"))
@pytest.mark.parametrize("policy", (None, "nearest_copy"), ids=lambda p: p or "home_first")
def test_mesh_delta_equals_jax(drives, policy, tk, n):
    ps, shard, extra, t_vec = _delta_case()
    t = 1 if tk == "scalar" else t_vec
    tp = lambda p: T.PathSet(p.objects, p.lengths, p.query_ids)  # noqa: E731
    got = _run_delta(T, tp(ps), shard, tp(extra), t, policy, BATCH, mesh=_mesh(n))
    want = _jax(("delta", policy, tk, _rounded(n)), lambda: _run_delta(
        R, ps, shard, extra, t, policy, _rounded(n), policy_backend="jnp"))
    assert np.array_equal(got[0], want[0])
    for c in COUNTERS:
        assert getattr(got[1], c) == getattr(want[1], c), c
    assert np.isclose(got[1].total_cost, want[1].total_cost, rtol=1e-5)
    assert got[1].rm == want[1].rm
    for a, b in zip(got[2], want[2]):
        assert np.array_equal(a, b)
    assert _replicas_equal(drives[0])


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("policy", (None, "nearest_copy"), ids=lambda p: p or "home_first")
def test_mesh_stream_equals_jax(policy, n):
    ps, shard = random_workload(np.random.default_rng(8), n_paths=150)
    f = np.random.default_rng(9).integers(1, 4, 120).astype(np.float32)
    chunks = [ps.select(np.arange(i, min(i + 50, ps.n_paths))) for i in range(0, 150, 50)]
    stream = PathStream(iter([T.PathSet(c.objects, c.lengths, c.query_ids) for c in chunks]))
    got, gs = T.replicate_stream(stream, shard, 5, t=2, f=f, policy=policy, mesh=_mesh(n),
                                 batch_size=BATCH)
    want, ws = R.replicate_stream(RE.PathStream(iter(chunks)), shard, 5, t=2, f=f,
                                  policy=policy, batch_size=_rounded(n))
    _same(got, gs, want, ws, exact_cost=True)
    assert gs.peak_resident_paths == 50


# ---------------------------------------------------------------------------
# refusals and the mesh type
# ---------------------------------------------------------------------------
MESH_WITHOUT_FUSED = {
    "replicate_workload": lambda ps, shard, sc, m: T.replicate_workload(
        ps, shard, 5, 2, fused=False, mesh=m),
    "replicate_workload(reference)": lambda ps, shard, sc, m: T.replicate_workload(
        ps, shard, 5, 2, fused=True, policy="nearest_copy", policy_backend="reference", mesh=m),
    "replicate_delta": lambda ps, shard, sc, m: T.replicate_delta(
        ps, LatencyEngine(sc, device=CPU), 2, fused=False, mesh=m),
    "replicate_stream": lambda ps, shard, sc, m: T.replicate_stream(
        [ps], shard, 5, 2, fused=False, mesh=m),
}


@pytest.mark.parametrize("name", sorted(MESH_WITHOUT_FUSED))
def test_mesh_requires_fused(name):
    """As in the JAX package: the sharded driver is the fused one (the
    reference backend runs the separate pipeline)."""
    _, tps, shard, _ = _case(0, n_paths=20)
    sc = T.ReplicationScheme.from_sharding(shard, 5)
    with pytest.raises(ValueError, match="mesh"):
        MESH_WITHOUT_FUSED[name](tps, shard, sc, _mesh(2))


def test_mesh_type_and_layout():
    m = _mesh(3)
    assert m.devices == (torch.device(CPU),) * 3 and (m.size, m.axis) == (3, S.PATH_AXIS)
    assert m.round_batch(256) == 258 and _mesh(4).round_batch(256) == 256
    assert S.ProvisioningMesh(["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        S.ProvisioningMesh(("cpu", "cuda"))
    with pytest.raises(ValueError, match="at least one"):
        S.ProvisioningMesh(())
    assert S.shard_bounds(7, m) == [(0, 3), (3, 6), (6, 7)]
    assert S.shard_bounds(2, m) == [(0, 1), (1, 2), (2, 2)]
    x = torch.arange(6, dtype=torch.int32)
    reps = S.replicate(x, m)
    assert reps[0] is x and all(torch.equal(r, x) and r is not x for r in reps[1:])


def test_batch_put_splits_rows_and_books_one_call():
    m = _mesh(3)
    a = np.arange(14, dtype=np.int32).reshape(7, 2)
    with TRANSFER.scope() as tr:
        parts = S.batch_put(m)(a, payload_bytes=40)
        assert (tr.h2d_bytes, tr.padded_bytes, tr.h2d_calls) == (40, 16, 1)
    assert [p.shape[0] for p in parts] == [3, 3, 1]
    assert np.array_equal(np.concatenate([p.numpy() for p in parts]), a)


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a CUDA mesh is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.provisioning_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.ProvisioningMesh(("cuda:0",))


def test_scheme_off_the_mesh_first_device_raises():
    _, tps, shard, _ = _case(0, n_paths=20)
    mesh = S.ProvisioningMesh(("cpu",))
    packed = PackedScheme.from_sharding(shard, 5, CPU)
    packed.words = packed.words.to("meta")
    with pytest.raises(ValueError, match="first device"):
        greedy._MeshDrive(mesh, packed, torch.zeros(32))


# ---------------------------------------------------------------------------
# the kernel backend's route on a mesh, watched on the CPU
# ---------------------------------------------------------------------------
def _kernel_on_cpu(monkeypatch):
    """Let ``kernel`` resolve on the CPU, where each kernel wrapper runs its
    plain version, to watch the kernel backend's route."""
    resolve = backends.resolve_backend
    monkeypatch.setattr(backends, "resolve_backend",
                        lambda b, d: "kernel" if b in (None, "kernel") else resolve(b, d))


@pytest.mark.parametrize("n", (2, 3))
@pytest.mark.parametrize("policy", ("nearest_copy", "nearest_copy_dp"))
def test_kernel_route_is_one_round_per_shard(monkeypatch, policy, n):
    """On ``kernel`` a mesh runs ``fused_update``'s one round per shard and
    batch, never the class launch, and gives the JAX package's masks."""
    _kernel_on_cpu(monkeypatch)
    calls = {"round": [], "class": 0}
    fu, fuc = greedy.fused_update, greedy.fused_update_class

    def round_(words, objects, *a, **k):
        calls["round"].append(objects.shape[0])
        return fu(words, objects, *a, **k)

    def class_(*a, **k):
        calls["class"] += 1
        return fuc(*a, **k)

    monkeypatch.setattr(greedy, "fused_update", round_)
    monkeypatch.setattr(greedy, "fused_update_class", class_)
    ps, tps, shard, f = _case(7, eighths=True)
    got, gs = T.replicate_workload(tps, shard, 5, 2, f=f, policy=policy, fused=True,
                                   mesh=_mesh(n), batch_size=BATCH, device=CPU)
    assert calls["class"] == 0 and calls["round"]
    assert max(calls["round"]) <= _rounded(n) // n
    want, ws = R.replicate_workload(ps, shard, 5, t=2, f=f, policy=policy, fused=True,
                                    policy_backend="jnp", batch_size=_rounded(n))
    _same(got, gs, want, ws, exact_cost=True)


def test_one_shard_keeps_the_class_launch(monkeypatch):
    """On ``kernel`` a 1-shard mesh on the scheme's device launches the
    class as one call per budget class, as without ``mesh=``, and gives the
    same masks, stats and resharding map."""
    _kernel_on_cpu(monkeypatch)
    calls = {"round": 0, "class": 0}
    fu, fuc = greedy.fused_update, greedy.fused_update_class

    def round_(*a, **k):
        calls["round"] += 1
        return fu(*a, **k)

    def class_(*a, **k):
        calls["class"] += 1
        return fuc(*a, **k)

    monkeypatch.setattr(greedy, "fused_update", round_)
    monkeypatch.setattr(greedy, "fused_update_class", class_)
    ps, tps, shard, f = _case(7, eighths=True)
    one, os_ = T.replicate_workload(tps, shard, 5, 2, f=f, policy="nearest_copy",
                                    fused=True, batch_size=BATCH, track_rm=True, device=CPU)
    n_class = calls["class"]
    got, gs = T.replicate_workload(tps, shard, 5, 2, f=f, policy="nearest_copy", fused=True,
                                   mesh=_mesh(1), batch_size=BATCH, track_rm=True,
                                   device=CPU)
    assert n_class > 0 and calls["class"] == 2 * n_class and calls["round"] == 0
    _same(got, gs, one, os_, exact_cost=True)
    assert gs.rm == os_.rm


# ---------------------------------------------------------------------------
# the JAX package's own sharded driver
# ---------------------------------------------------------------------------
_SUBPROC = """
import numpy as np
from repro.core.greedy import replicate_workload
from repro.engine.sharding import device_count, provisioning_mesh
from tests.conftest import random_workload

assert device_count() == 4, device_count()
rng = np.random.default_rng(0)
ps, shard = random_workload(rng, n_obj=90, n_srv=5, n_paths=110, max_len=6)
f = rng.uniform(0.5, 2.0, 90).astype(np.float32)
s, st = replicate_workload(ps, shard, 5, t=2, f=f, policy="nearest_copy",
                           policy_backend="jnp", fused=True, batch_size=16,
                           mesh=provisioning_mesh())
print("MASK", np.packbits(s.mask).tobytes().hex(), st.failed_paths, st.routed_skips)
"""


def test_four_shards_equal_jax_sharded_driver():
    """``repro``'s sharded driver on 4 forced host devices gives the port's
    4-shard mask."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT),
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", _SUBPROC], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("MASK"))
    _, hexmask, failed, skips = line.split()
    _, tps, shard, f = _case(0)
    got, gs = T.replicate_workload(tps, shard, 5, 2, f=f, policy="nearest_copy", fused=True,
                                   mesh=_mesh(4), batch_size=16)
    assert np.packbits(got.mask).tobytes().hex() == hexmask
    assert (gs.failed_paths, gs.routed_skips) == (int(failed), int(skips))
