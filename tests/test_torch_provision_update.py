"""The port's DP score tables, scored walk and fused UPDATE round against
the JAX package's, on seeded random batches.

* ``_dp_score_tables`` and ``scored_walk_plain`` vs the JAX
  ``_dp_score_tables`` and ``scored_walk_pallas`` (interpret mode on the
  CPU): exact, for depths None, 0, 1 and 3.
* ``fused_update_plain`` vs ``fused_update_pallas`` (interpret mode):
  gate modes none, routed with and without lookahead (and a ranked
  queue-aware gate), scored with depth None and 2; L in {1, 6, 9}; 5, 40
  and 70 servers with bit 31 set.  ``chosen``, ``srv``, ``no_solution``,
  ``skipped`` and the words are exact.  Costs are exact when every size
  is a multiple of 1/8 (every partial sum is exact); with sizes drawn
  uniformly the two kernels sum in different orders, so costs agree to
  ``rtol=1e-6`` (float32 rounding) and the decisions stay exact.
"""
import numpy as np
import pytest
import torch

from repro.core import combi
from repro.engine import PackedScheme as JPacked
from repro.engine import backends as jb
from repro.engine.backends import pallas_prep
from repro.engine.routing import nearest_copy_dp as j_dp
from repro.engine.routing import resolve_policy as j_policy
from repro.kernels.provision_update import fused_update_jit
from repro.kernels.routed_walk import scored_walk_pallas
from repro_torch.engine import backends as tb
from repro_torch.engine.routing import nearest_copy_dp
from repro_torch.engine.routing import resolve_policy as t_policy
from repro_torch.kernels.provision_update import fused_update, fused_update_plain
from repro_torch.kernels.routed_walk import scored_walk_plain

SHAPES = [(1, 5), (6, 40), (9, 70)]


def _batch(seed, B, L, n_srv, n_obj=300, dead=False):
    """Seeded random scheme and padded path batch (numpy)."""
    rng = np.random.default_rng(seed)
    shard = rng.integers(0, n_srv, n_obj).astype(np.int32)
    mask = rng.random((n_obj, n_srv)) < 0.15
    mask[np.arange(n_obj), shard] = True
    top = min(31, n_srv - 1)
    mask[:, top] |= rng.random(n_obj) < 0.4          # bit 31 (the sign bit)
    if dead:
        mask[rng.random(n_obj) < 0.05] = False       # objects with no holder
    words = np.asarray(JPacked.from_mask(mask, shard).words)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = [0, min(1, L), L]
    objects = np.full((B, L), -1, np.int32)
    # paths over a few objects so consecutive positions share homes
    pool = rng.integers(0, n_obj, 40)
    for b in range(B):
        objects[b, : lengths[b]] = rng.choice(pool, lengths[b])
    return rng, shard, words, objects, lengths


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("depth", [None, 0, 1, 3])
@pytest.mark.parametrize("L,n_srv", SHAPES)
def test_dp_tables_and_scored_walk_match_jax(depth, L, n_srv):
    rng, shard, words, objects, lengths = _batch(L * n_srv, 300, L, n_srv, dead=True)
    d = -1 if depth is None else depth
    want_e = np.asarray(jb._dp_score_tables(objects, lengths, words, d))
    o, ln, w = _t(objects, lengths, words.view(np.int32))
    got_e = tb._dp_score_tables(o, ln, w, d)
    assert got_e.dtype == torch.float32
    assert np.array_equal(got_e.numpy(), want_e)

    start = rng.integers(-1, n_srv, len(lengths)).astype(np.int32)
    home, masks = pallas_prep(objects, lengths, words, shard)
    ws, wl = scored_walk_pallas(home, masks, lengths, start, want_e, interpret=True)
    s, l = scored_walk_plain(o, ln, w, *_t(shard, start), got_e)
    assert np.array_equal(s.numpy(), np.asarray(ws))
    assert np.array_equal(l.numpy(), np.asarray(wl))

    # the engine-level DP walk (row-chunked) equals the JAX backend's trace
    js, jl = jb.access_trace(objects, lengths, words, shard, policy=j_dp(depth))
    s2, l2 = tb.access_trace(o, ln, w, *_t(shard), policy=nearest_copy_dp(depth))
    assert np.array_equal(s2.numpy(), np.asarray(js))
    assert np.array_equal(l2.numpy(), np.asarray(jl))


def test_dp_walk_row_chunks(monkeypatch):
    """Row chunking of the DP plane changes nothing."""
    _, shard, words, objects, lengths = _batch(7, 257, 6, 40)
    args = _t(objects, lengths, words.view(np.int32), shard)
    pol = t_policy("nearest_copy_dp")
    whole = tb.access_trace(*args, policy=pol)
    monkeypatch.setattr(tb, "DP_PLANE_ELEMS", 6 * 64 * 50)  # 50 rows per chunk
    chunked = tb.access_trace(*args, policy=pol)
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


GATES = {
    "none": None,
    "routed": "nearest_copy",
    "no_lookahead": "nl",
    "queue_aware": "queue_aware",
    "scored": "nearest_copy_dp",
    "scored_depth2": "dp2",
}


def _policies(gate):
    name = GATES[gate]
    if name is None:
        return None, None
    if name == "nl":
        from repro.engine.routing import NearestCopy as JN
        from repro_torch.engine.routing import NearestCopy as TN

        return JN(lookahead=False), TN(lookahead=False)
    if name == "dp2":
        return j_dp(2), nearest_copy_dp(2)
    return j_policy(name), t_policy(name)


def _fused_case(seed, L, n_srv, gate, eighths):
    rng, shard, words, objects, lengths = _batch(seed, 200, L, n_srv)
    n_obj = shard.shape[0]
    H = max(L - 1, 1)
    tables, counts = combi.stacked_tables(H, 2 if L > 6 else 1)
    t = rng.integers(0, 3, len(lengths)).astype(np.int32)
    rank = np.zeros(words.shape[1] * 32, np.float32)
    if gate == "queue_aware":
        rank[:n_srv] = rng.integers(0, 3, n_srv)      # ties on purpose
    if eighths:
        f = (rng.integers(1, 24, n_obj) / 8).astype(np.float32)
    else:
        f = rng.uniform(0.5, 2.0, n_obj).astype(np.float32)
    return words, objects, lengths, shard, f, tables, counts, t, rank


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("L,n_srv", [(L, s) for L in (1, 6, 9) for s in (5, 40, 70)])
def test_fused_update_plain_matches_pallas(gate, L, n_srv):
    jpol, tpol = _policies(gate)
    for eighths in (True, False):
        case = _fused_case(L * 100 + n_srv, L, n_srv, gate, eighths)
        words = case[0]
        want = fused_update_jit(words.copy(), *case[1:], pol=jpol, interpret=True)
        w_words, w_cost, w_nosol, w_chosen, w_srv, w_skip = (np.asarray(a) for a in want)
        tw = torch.from_numpy(words.view(np.int32).copy())
        got = fused_update(tw, *_t(*case[1:]), pol=tpol)
        g_words, g_cost, g_nosol, g_chosen, g_srv, g_skip = (a.numpy() for a in got)
        n = words.shape[0] - 1  # the sacrificial last row is a write sink
        assert np.array_equal(g_words.view(np.uint32)[:n], w_words[:n])
        assert np.array_equal(g_chosen, w_chosen)
        assert np.array_equal(g_srv, w_srv)
        assert np.array_equal(g_nosol, w_nosol)
        assert np.array_equal(g_skip, w_skip)
        if eighths:
            assert np.array_equal(g_cost, w_cost)
        else:
            np.testing.assert_allclose(g_cost, w_cost, rtol=1e-6)
        if gate != "none" and L > 1:
            assert g_skip.any() or g_chosen.any()


@pytest.mark.parametrize("gate", ["none", "routed", "scored"])
def test_fused_update_wide_tables(gate):
    """Tables wider than L (a budget t >= L) are cut to L columns before
    the round and padded back: outputs equal the TPU kernel's on the full
    tables."""
    case = list(_fused_case(12, 6, 40, gate, True))
    case[5], case[6] = combi.stacked_tables(9, 1)       # Hp1 = 10 > L = 6
    words = case[0]
    jpol, tpol = _policies(gate)
    want = fused_update_jit(words.copy(), *case[1:], pol=jpol, interpret=True)
    got = fused_update(torch.from_numpy(words.view(np.int32).copy()), *_t(*case[1:]),
                       pol=tpol)
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got[0].numpy().view(np.uint32)[:-1], np.asarray(want[0])[:-1])
    assert got[3].shape == (200, 6, 10) and bool(got[3].any())


def test_fused_update_clipped_subpaths():
    """Paths with more subpaths than the tables hold (h > Hp1 - 1) follow
    the TPU kernel's clipping exactly."""
    case = list(_fused_case(11, 9, 40, "routed", True))
    case[5], case[6] = combi.stacked_tables(3, 1)       # Hp1 = 4 < L
    words = case[0]
    jpol, tpol = _policies("routed")
    want = fused_update_jit(words.copy(), *case[1:], pol=jpol, interpret=True)
    got = fused_update_plain(torch.from_numpy(words.view(np.int32).copy()),
                             *_t(*case[1:]), pol=tpol)
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got[0].numpy().view(np.uint32)[:-1], np.asarray(want[0])[:-1])
