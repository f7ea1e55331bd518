"""The fused UPDATE of a whole budget class under
the scored gate at depth 2 (nearest_copy_dp(2)):
the plain class against the JAX package's batch loop on the CPU, the class
kernel against its plain version on the card (cases and checks in
``update_class_cases.py``), the kernel's in-kernel gate against the
score-plane route, and the greedy's class route under the default
(home-first) policy.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import pytest
import torch

from update_class_cases import (CARD_LW, CARD_N, PLAIN_LW, PLAIN_N, _case, _torch_case,
                                check_greedy_class_route, check_kernel_matches_plain,
                                check_plain_matches_jax_batch_loop)
from update_class_cases import cuda  # noqa: F401  (fixture)
from repro_torch.core.replication import subpath_structure
from repro_torch.engine.backends import _dp_score_tables, _root_home
from repro_torch.engine.routing import nearest_copy_dp
from repro_torch.kernels import provision_update as pu
from repro_torch.kernels.routed_walk import scored_walk


@pytest.mark.parametrize("gate", ["scored_depth2"])
@pytest.mark.parametrize("L,W", PLAIN_LW)
@pytest.mark.parametrize("N", PLAIN_N)
def test_class_plain_matches_jax_batch_loop(gate, L, W, N):
    check_plain_matches_jax_batch_loop(gate, L, W, N)


@pytest.mark.parametrize("policy", [None])
def test_greedy_class_route_matches_batch_loop(monkeypatch, policy):
    check_greedy_class_route(monkeypatch, policy)


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["scored_depth2"])
@pytest.mark.parametrize("L,W", CARD_LW)
@pytest.mark.parametrize("N,batch", CARD_N)
def test_class_kernel_matches_plain(cuda, gate, L, W, N, batch):  # noqa: F811
    check_kernel_matches_plain(cuda, gate, L, W, N, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2])
@pytest.mark.parametrize("L,W", [(6, 1), (65, 3)])
def test_in_kernel_dp_gate_matches_score_plane(cuda, depth, L, W):  # noqa: F811
    """The kernel's nearest_copy_dp gate (``dp_gate`` on the path's words)
    skips exactly the rows the score-plane route skips: over budget under
    d, and within it under the scored walk (``_dp_score_tables`` and the
    ``scored_walk`` kernel) against the same words."""
    words, objects, lengths, shard, f, tables, counts, t, rank = _torch_case(
        _case(L + W + 11, 2_000, L, W, True), cuda)
    pol = nearest_copy_dp(depth)
    got = pu.fused_update(words.clone(), objects, lengths, shard, f, tables, counts, t, rank,
                          pol=pol)
    scores = _dp_score_tables(objects, lengths, words, -1 if depth is None else depth)
    _, local = scored_walk(objects, lengths, words, shard, _root_home(objects, shard), scores)
    valid = torch.arange(L, device=cuda)[None, :] < lengths[:, None]
    h_routed = (valid & ~local).sum(dim=1)
    _, _, h = subpath_structure(objects, lengths, shard)
    want = (h > t) & (h_routed <= t)
    assert torch.equal(got[5], want)
    assert bool(want.any()) and bool(((h > t) & ~want).any())
