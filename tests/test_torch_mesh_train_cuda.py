"""Training on a mesh of every card: one spawned NCCL rank per card on the
(n / m, m) ``("data", "model")`` mesh (``tests/torch_sharded_ranks.py``'s
``cards_leg``).  Skips without several cards; ``chip_smoke.py``'s
mesh_train phase covers one card (a 1 x 1 mesh).

  * each f32 SMOKE LM's ``train_lm`` on the cards equals the CPU
    one-device port's within 1e-5 (both from the CPU's draw of the
    weights: a card's generator draws others);
  * qwen2-7b at full width (4 layers, 8 x 4,096 tokens, bf16) runs its
    steps on the mesh: finite, the first loss ln V + 1/2 within 0.05; its
    losses, step seconds and each card's peak memory are printed (``-s``);
  * ``elastic_drill`` from n cards to n / 2 is ``bit_exact``;
  * ``compressed_psum`` across the cards over NCCL equals it over gloo.
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import json
import math

import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
from repro_torch.configs import LM_CONFIGS
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda

TOL = 1e-5              # f32 training tolerance
FIRST_LOSS_TOL = 0.05   # chip_smoke.py's TRAIN_FIRST_LOSS_TOL
CARDS_TIMEOUT_S = 900   # every card reports within this


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs several CUDA devices (one NCCL rank per card)")
    n = torch.cuda.device_count()
    inits, cpu = {}, {}
    for arch in R.ARCHS:
        inits[arch] = {name: p.detach().numpy() for name, p in T.Transformer(
            LM_CONFIGS[arch].SMOKE, device="cpu").named_parameters()}
        r = TR.train_lm(arch, steps=R.STEPS, batch=R.BATCH, seq=R.SEQ, log_every=100,
                        device="cpu", init=inits[arch])
        cpu[arch] = (r["losses"], r["grad_norms"])
    torch.cuda.empty_cache()   # nothing of this process's cache beside card 0's rank
    got = R.spawn("cards_leg", n, tmp_path_factory.mktemp("cards"), inits, backend="nccl",
                  timeout=CARDS_TIMEOUT_S)
    return n, cpu, got


@pytest.mark.parametrize("arch", R.ARCHS)
def test_smoke_lms_on_every_card_equal_the_cpu(cards, arch):
    n, cpu, got = cards
    for rank in range(n):
        for i in (0, 1):
            np.testing.assert_allclose(got[rank]["smoke"][arch][i], cpu[arch][i],
                                       atol=TOL, rtol=TOL, err_msg=f"{arch} card {rank}")


def test_full_width_qwen2_on_every_card(cards):
    n, _, got = cards
    want = math.log(LM_CONFIGS["qwen2-7b"].FULL.vocab) + 0.5
    print(json.dumps({"cards": n, "name": torch.cuda.get_device_name(0),
                      "steps": [r["full"] for r in got]}))
    for rank in range(n):
        rows = got[rank]["full"]
        assert len(rows) == R.STEPS
        assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows)
        assert abs(rows[0]["loss"] - want) <= FIRST_LOSS_TOL, rows[0]
        assert [r["loss"] for r in rows] == [r["loss"] for r in got[0]["full"]]


def test_elastic_drill_from_every_card_to_half(cards):
    n, _, got = cards
    for rank in range(n):
        assert got[rank]["drill"]["bit_exact"], (rank, got[rank]["drill"])


def test_compressed_psum_over_nccl_equals_gloo(cards):
    n, _, got = cards
    assert [got[r]["psum_equal"] for r in range(n)] == [True] * n
