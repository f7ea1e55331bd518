"""Serving on a mesh of four cards: one spawned NCCL rank per card on the
(2, 2) ``("data", "model")`` mesh (``tests/torch_mesh_serve_ranks.py``'s
``cards_serve``).  Skips with fewer than four cards; ``chip_smoke.py``'s
mesh_serve phase covers one card (a 1 x 1 mesh, bit-equal in bf16).

qwen2-7b at full width (4 layers) under its serving layout sized to the
mesh (heads, KV heads, hidden units and vocabulary over "model", the
cache's positions over "model", the batch over "data"): prefill of 4 x
1,024 prompts into 1,040 slots, then 16 decode steps fed seeded tokens,
in f32 (TF32 off) and in bf16 from the same weights.  Each rank's logits
(its rows and vocabulary columns) against card 0's one-card run:

  * f32: within ``chip_smoke.row_scaled_err`` 2^-5 (max |err| over the
    rms of each logit row);
  * bf16: no further from the f32 one-card logits than twice the bf16
    one-card run is.  The mesh rounds each rank's partial sums to bf16
    before adding them, one card rounds once, so the two bf16 runs differ
    by as much as each differs from f32 (0.047-0.063 row-scaled at 4
    layers, 2 x 256 tokens, on the CPU), above 2^-5: that bound cannot
    tell a fault from bf16's rounding there.

Seconds per step and each card's peak memory are printed (``-s``).
"""
import torch_threads  # noqa: F401  (one torch thread per test worker)
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import torch_mesh_serve_ranks as SR
import torch_sharded_ranks as R
from repro_torch.models.parallel import chunk_range

pytestmark = pytest.mark.cuda

CARDS_TIMEOUT_S = 900


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (a 2 x 2 mesh, one NCCL rank per card)")
    return R.spawn("torch_mesh_serve_ranks:cards_serve", 4, tmp_path_factory.mktemp("serve"),
                   backend="nccl", timeout=CARDS_TIMEOUT_S)


def _slices(r, V):
    d, m = r["coord"]
    return (slice(*chunk_range(SR.CARDS_PROMPT[0], 2, d)), slice(*chunk_range(V, 2, m)))


def test_qwen2_full_width_on_a_2x2_mesh_matches_one_card(cards):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from chip_smoke import FLASH_BF16_REL, row_scaled_err

    def err(a, b):
        return row_scaled_err(torch.from_numpy(a), torch.from_numpy(b))

    one32, one16 = cards[0]["one_float32"][0], cards[0]["one_bfloat16"][0]
    V = one32[0].shape[-1]
    report = {"name": torch.cuda.get_device_name(0), "peak": [r["peak"] for r in cards],
              "one_card_s": {k: cards[0][f"one_{k}"][1] for k in ("float32", "bfloat16")},
              "mesh_s": {k: [r[f"mesh_{k}"][1] for r in cards] for k in ("float32", "bfloat16")},
              "f32_err": [], "bf16_err": [], "bf16_one_card_err": []}
    for r in cards:
        rows, cols = _slices(r, V)
        for name in ("float32", "bfloat16"):
            assert len(r[f"mesh_{name}"][0]) == SR.CARDS_DECODE + 1
        for i, (g32, g16) in enumerate(zip(r["mesh_float32"][0], r["mesh_bfloat16"][0])):
            w32, w16 = one32[i][rows, cols], one16[i][rows, cols]
            assert g32.shape == w32.shape == g16.shape
            assert np.isfinite(g32).all() and np.isfinite(g16).all()
            e32, e16, base = err(g32, w32), err(g16, w32), err(w16, w32)
            report["f32_err"].append(e32)
            report["bf16_err"].append(e16)
            report["bf16_one_card_err"].append(base)
            assert e32 <= FLASH_BF16_REL, (r["coord"], i, e32)
            assert e16 <= 2 * base, (r["coord"], i, e16, base)
    print(json.dumps(report))
