"""The fused UPDATE of a whole budget class under the routed gate
(nearest_copy; on the card also nearest_copy without lookahead): the plain
class against the JAX package's batch loop on the CPU, the class kernel
against its plain version on the card (cases and checks in
``update_class_cases.py``); the class's snapshot batches.
"""
import pytest
import torch

from update_class_cases import (CARD_LW, CARD_N, PLAIN_LW, PLAIN_N, _case, _torch_case,
                                check_kernel_matches_plain,
                                check_plain_matches_jax_batch_loop)
from update_class_cases import cuda  # noqa: F401  (fixture)
from repro_torch.engine.routing import resolve_policy as t_policy
from repro_torch.kernels import provision_update as pu


@pytest.mark.parametrize("gate", ["routed"])
@pytest.mark.parametrize("L,W", PLAIN_LW)
@pytest.mark.parametrize("N", PLAIN_N)
def test_class_plain_matches_jax_batch_loop(gate, L, W, N):
    check_plain_matches_jax_batch_loop(gate, L, W, N)


def test_class_batches_are_snapshots():
    """The class equals its batches run one after another, and differs from
    one round over all rows (one snapshot): later batches see earlier
    batches' copies."""
    words, *args = _torch_case(_case(3, 700, 6, 1, True))
    pol = t_policy("nearest_copy")
    cls = pu.fused_update_class(words.clone(), *args, torch.zeros(3), pol=pol)
    one = pu.fused_update(words.clone(), *args, pol=pol)
    single = pu.fused_update_class(words.clone(), *args, torch.zeros(3), batch_size=700,
                                   pol=pol)
    assert all(torch.equal(a, b) for a, b in zip(one, single))
    assert not torch.equal(cls[3], one[3])
    assert int(cls[3].sum()) < int(one[3].sum())  # later batches need fewer copies


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["routed", "no_lookahead"])
@pytest.mark.parametrize("L,W", CARD_LW)
@pytest.mark.parametrize("N,batch", CARD_N)
def test_class_kernel_matches_plain(cuda, gate, L, W, N, batch):  # noqa: F811
    check_kernel_matches_plain(cuda, gate, L, W, N, batch)
