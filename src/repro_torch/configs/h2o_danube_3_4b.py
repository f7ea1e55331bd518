"""h2o-danube-3-4b  [arXiv:2401.16818]

24L d_model=3840 32H (GQA kv=8, head_dim=120) d_ff=10240 vocab=32000,
llama+mistral mix with sliding-window attention (window 4096).
"""
import torch

from repro_torch.configs import base
from repro_torch.configs.lm_family import make_bundle
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="h2o-danube-3-4b",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000,
    sliding_window=4096, rope_theta=1e4,
    dtype=torch.bfloat16, remat=True, remat_block=4,
    blockwise_from=2048, attn_block_q=1024, loss_chunk=16384,
)

SMOKE = TransformerConfig(
    name="danube-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    sliding_window=8, dtype=torch.float32, remat=False,
)


@base.register("h2o-danube-3-4b")
def bundle():
    return make_bundle("h2o-danube-3-4b", FULL, SMOKE, skip_long=False)
