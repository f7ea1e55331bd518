"""Shared cases and checks of the fused UPDATE of a whole budget class
(``fused_update_class``): the class priced in 256-row snapshot batches,
each batch against the words after the batches before it.

The tests are split by gate over ``tests/test_torch_update_class_{none,
routed,scored,scored_depth2}.py`` so that no one file holds the whole
JAX batch loop (``--dist loadfile`` gives a file to one worker).

* On the CPU, ``fused_update_class_plain`` against the JAX package's batch
  loop (``fused_update_jit`` in interpret mode, called batch by batch on the
  running words, each batch padded to 256 rows of empty paths and to 65
  positions, so one trace serves every N and L) and against a loop of the
  port's ``fused_update_plain``: gates none, routed, scored
  (nearest_copy_dp, depth None and 2); N in {0, 100, 256, 700} (700 leaves
  a partial last batch); L in {6, 65}; W in {1, 3}.  The final words,
  ``chosen``, ``srv``, ``no_solution`` and ``skipped`` are exact; costs are
  exact with sizes in eighths (every partial sum is exact) and within
  ``rtol=1e-6`` with sizes drawn uniformly (the JAX kernel sums in XLA's
  order); the class statistics ``acc`` within ``rtol=1e-5`` (float32 sums
  in another order).
* On the card (``cuda``, skipped without one): the class kernel against
  ``fused_update_class_plain``, exactly, at those shapes and at the
  device tiers (L 70, W 65, W 257), and the in-kernel nearest_copy_dp gate
  against the score-plane route's skip flags.
"""
import numpy as np
import pytest
import torch

from repro.core import combi
from repro.engine import PackedScheme as JPacked
from repro.engine.routing import nearest_copy_dp as j_dp
from repro.engine.routing import resolve_policy as j_policy
from repro.kernels.provision_update import fused_update_jit
from repro_torch.engine.routing import NearestCopy, nearest_copy_dp
from repro_torch.engine.routing import resolve_policy as t_policy
from repro_torch.kernels import provision_update as pu

BATCH = 256
JAX_L = 65  # the positions every JAX batch is padded to (-1: past the path's end)
# gate -> (JAX policy, port policy)
GATES = {
    "none": (None, None),
    "routed": (j_policy("nearest_copy"), t_policy("nearest_copy")),
    "scored": (j_dp(), nearest_copy_dp()),
    "scored_depth2": (j_dp(2), nearest_copy_dp(2)),
}
# W -> servers
SERVERS = {1: 20, 3: 70, 65: 65 * 32, 257: 257 * 32}

# the CPU parity grid and the card's grid, parametrised the same in every file
PLAIN_LW = [(6, 1), (6, 3), (65, 1), (65, 3)]
PLAIN_N = [0, 100, 256, 700]
CARD_GATES = {name: tpol for name, (_, tpol) in GATES.items()}
CARD_GATES["no_lookahead"] = NearestCopy(lookahead=False)
CARD_LW = [(6, 1), (6, 3), (65, 1), (65, 3), (70, 1), (6, 65), (6, 257)]
CARD_N = [(700, 256), (256, 256), (5_000, 64)]


def _case(seed, N, L, W, eighths):
    """Seeded class inputs (numpy).  The objects' homes lie on six servers
    spread over the words, so paths have at most six subpaths; a path of
    more than 6 positions visits its objects grouped by home.  Paths draw
    from a pool of 40 objects, so batches add copies that later batches
    see."""
    rng = np.random.default_rng(seed)
    n_srv, n_obj = SERVERS[W], 300
    homes = np.sort(rng.choice(n_srv, 6, replace=False))
    shard = rng.choice(homes, n_obj).astype(np.int32)
    mask = np.zeros((n_obj, n_srv), bool)
    mask[:, homes] = rng.random((n_obj, 6)) < 0.3
    mask[np.arange(n_obj), shard] = True
    mask[:, min(31, n_srv - 1)] |= rng.random(n_obj) < 0.3   # bit 31 (the sign bit)
    words = np.asarray(JPacked.from_mask(mask, shard).words)
    lengths = rng.integers(0, L + 1, N).astype(np.int32)
    lengths[: min(N, 3)] = [0, 1, L][: min(N, 3)]
    objects = np.full((N, L), -1, np.int32)
    pool = rng.integers(0, n_obj, 40)
    for b in range(N):
        o = rng.choice(pool, lengths[b])
        objects[b, : lengths[b]] = o if L <= 6 else o[np.argsort(shard[o], kind="stable")]
    tables, counts = combi.stacked_tables(min(L - 1, 5), 1)
    t = rng.integers(0, 3, N).astype(np.int32)
    rank = np.zeros(words.shape[1] * 32, np.float32)
    if eighths:
        f = (rng.integers(1, 24, n_obj) / 8).astype(np.float32)
    else:
        f = rng.uniform(0.5, 2.0, n_obj).astype(np.float32)
    return words, objects, lengths, shard, f, tables, counts, t, rank


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _torch_case(case, device="cpu"):
    """A case's tensors, the words as int32."""
    return _t(case[0].view(np.int32), *case[1:], device=device)


def _jax_class(words, objects, lengths, shard, f, tables, counts, t, rank, pol):
    """The JAX package's fused round called batch by batch on the running
    words, each batch padded to BATCH rows of empty paths and to JAX_L
    positions (padding buys nothing: the added chosen columns must be
    empty); returns the final words and the class's per-row outputs."""
    N, L = objects.shape
    outs = []
    for i in range(0, N, BATCH):
        nb = min(BATCH, N - i)
        o = np.full((BATCH, JAX_L), -1, np.int32)
        ln = np.zeros(BATCH, np.int32)
        tb = np.zeros(BATCH, np.int32)
        o[:nb, :L], ln[:nb], tb[:nb] = objects[i:i + nb], lengths[i:i + nb], t[i:i + nb]
        res = fused_update_jit(words.copy(), o, ln, shard, f, tables, counts, tb, rank,
                               pol=pol, interpret=True)
        words = np.asarray(res[0])
        cost, no_sol, chosen, srv, skipped = (np.asarray(a)[:nb] for a in res[1:])
        assert not chosen[:, L:].any()
        outs.append([cost, no_sol, chosen[:, :L], srv, skipped])
    if not outs:
        return words, None
    return words, [np.concatenate(x) for x in zip(*outs)]


def _port_loop(words, objects, lengths, shard, f, tables, counts, t, rank, pol):
    """A loop of the port's one-round plain version over the batches."""
    outs = []
    for i in range(0, objects.shape[0], BATCH):
        sl = slice(i, i + BATCH)
        words, *rest = pu.fused_update_plain(words, objects[sl], lengths[sl], shard, f,
                                             tables, counts, t[sl], rank, pol=pol)
        outs.append([a.numpy() for a in rest])
    if not outs:
        return words, None
    return words, [np.concatenate(x) for x in zip(*outs)]


def _stats(cost, no_sol, skipped):
    return np.array([cost.astype(np.float64).sum(), no_sol.sum(), skipped.sum()])


def check_plain_matches_jax_batch_loop(gate, L, W, N):
    """The class's plain version against the JAX batch loop and the port's
    one-round loop, for both size draws."""
    jpol, tpol = GATES[gate]
    for eighths in (True, False):
        case = _case(N * 7 + L * 3 + W, N, L, W, eighths)
        words = case[0]
        acc = torch.full((3,), 0.5)
        tw = torch.from_numpy(words.view(np.int32).copy())
        g_words, *got = pu.fused_update_class_plain(tw, *_t(*case[1:]), acc, BATCH, pol=tpol)
        g_words = g_words.numpy().view(np.uint32)
        got = [a.numpy() for a in got]
        assert got[2].shape == (N, L, case[5].shape[2]) and got[3].shape[0] == N
        j_words, want = _jax_class(*case, pol=jpol)
        p_words, loop = _port_loop(torch.from_numpy(words.view(np.int32).copy()),
                                   *_t(*case[1:]), pol=tpol)
        n = words.shape[0] - 1  # the sacrificial last row is a write sink
        assert np.array_equal(g_words[:n], j_words[:n])
        assert np.array_equal(g_words[:n], p_words.numpy().view(np.uint32)[:n])
        if N == 0:
            assert torch.equal(acc, torch.full((3,), 0.5))
            continue
        for ref in (want, loop):
            g_cost, g_nosol, g_chosen, g_srv, g_skip = got
            w_cost, w_nosol, w_chosen, w_srv, w_skip = ref
            assert np.array_equal(g_chosen, w_chosen)
            assert np.array_equal(g_srv, w_srv)
            assert np.array_equal(g_nosol, w_nosol)
            assert np.array_equal(g_skip, w_skip)
            if eighths or ref is loop:
                assert np.array_equal(g_cost, w_cost)
            else:
                np.testing.assert_allclose(g_cost, w_cost, rtol=1e-6)
            np.testing.assert_allclose(acc.numpy().astype(np.float64) - 0.5,
                                       _stats(w_cost, w_nosol, w_skip), rtol=1e-5)
        if gate != "none" and N >= 256:
            assert got[4].any() and got[2].any()


def check_greedy_class_route(monkeypatch, policy):
    """``replicate_workload(fused=True)`` through the kernel backend's class
    route (``_run_update_class``: one upload, one ``fused_update_class``
    call, the resharding map built afterwards), watched on the CPU by
    letting ``kernel`` resolve there, equals the torch backend's per-batch
    loop: masks, resharding map, costs and counters, over several batches."""
    import repro_torch.core as T
    from conftest import random_workload
    from repro_torch.core import greedy
    from repro_torch.engine import backends

    ps, shard = random_workload(np.random.default_rng(0), n_paths=700)
    tps = T.PathSet(ps.objects, ps.lengths, ps.query_ids)
    f = (np.random.default_rng(1).integers(1, 16, 120) / 8).astype(np.float32)
    kw = dict(f=f, policy=policy, fused=True, track_rm=True, device="cpu", batch_size=64)
    loop, sl = T.replicate_workload(tps, shard, 5, 1, **kw)
    resolve = backends.resolve_backend
    monkeypatch.setattr(backends, "resolve_backend",
                        lambda b, d: "kernel" if b in (None, "kernel") else resolve(b, d))
    calls = []
    cls_fn = greedy.fused_update_class
    monkeypatch.setattr(greedy, "fused_update_class",
                        lambda *a, **k: calls.append(a[1].shape[0]) or cls_fn(*a, **k))
    route, sr = T.replicate_workload(tps, shard, 5, 1, **kw)
    assert calls and max(calls) > 64  # whole classes, not batches
    assert np.array_equal(route.mask, loop.mask)
    assert sr.rm == sl.rm and len(sr.rm) > 0
    assert sr.total_cost == sl.total_cost  # sizes in eighths: every sum is exact
    for c in ("replicas", "failed_paths", "routed_skips", "pruned_replicas"):
        assert getattr(sr, c) == getattr(sl, c), c


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def check_kernel_matches_plain(device, gate, L, W, N, batch):
    """The class kernel against its plain version, exactly, with one launch."""
    pol = CARD_GATES[gate]
    words, *args = _torch_case(_case(N + L + W, N, L, W, True), device)
    acc_k = torch.full((3,), 0.5, device=device)
    acc_p = acc_k.clone()
    before = pu.LAUNCHES
    got = pu.fused_update_class(words.clone(), *args, acc_k, batch_size=batch, pol=pol)
    torch.cuda.synchronize()
    assert pu.LAUNCHES == before + 1
    want = pu.fused_update_class_plain(words.clone(), *args, acc_p, batch_size=batch,
                                       pol=pol)
    assert torch.equal(got[0][:-1], want[0][:-1])  # the last row is a write sink
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    assert torch.equal(acc_k, acc_p)  # both sum in row order, in float32 steps
    assert bool(got[3].any())
