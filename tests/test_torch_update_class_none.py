"""The fused UPDATE of a whole budget class with no gate: the plain class
against the JAX package's batch loop on the CPU, the class kernel against
its plain version on the card (cases and checks in
``update_class_cases.py``); the greedy's class route under
``nearest_copy``, and the wrapper's input checks.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import pytest
import torch

from update_class_cases import (CARD_LW, CARD_N, PLAIN_LW, PLAIN_N, _case, _torch_case,
                                check_greedy_class_route, check_kernel_matches_plain,
                                check_plain_matches_jax_batch_loop)
from update_class_cases import cuda  # noqa: F401  (fixture)
from repro_torch.kernels import provision_update as pu


@pytest.mark.parametrize("gate", ["none"])
@pytest.mark.parametrize("L,W", PLAIN_LW)
@pytest.mark.parametrize("N", PLAIN_N)
def test_class_plain_matches_jax_batch_loop(gate, L, W, N):
    check_plain_matches_jax_batch_loop(gate, L, W, N)


@pytest.mark.parametrize("policy", ["nearest_copy"])
def test_greedy_class_route_matches_batch_loop(monkeypatch, policy):
    check_greedy_class_route(monkeypatch, policy)


def test_class_rejects_bad_inputs():
    args = _torch_case(_case(4, 10, 6, 1, True))
    with pytest.raises(ValueError, match="acc must be"):
        pu.fused_update_class(*args, torch.zeros(4))
    with pytest.raises(ValueError, match="batch_size"):
        pu.fused_update_class(*args, torch.zeros(3), batch_size=0)
    with pytest.raises(ValueError, match="rank must be"):
        pu.fused_update_class(*args[:-1], args[-1][:-1], torch.zeros(3))


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["none"])
@pytest.mark.parametrize("L,W", CARD_LW)
@pytest.mark.parametrize("N,batch", CARD_N)
def test_class_kernel_matches_plain(cuda, gate, L, W, N, batch):  # noqa: F811
    check_kernel_matches_plain(cuda, gate, L, W, N, batch)
