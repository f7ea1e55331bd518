"""chatglm3-6b  [arXiv:2406.12793]

28L d_model=4096 32H (GQA kv=2, head_dim=128) d_ff=13696 vocab=65024,
2d RoPE (rotary applied to half the head dims).
"""
import torch

from repro_torch.configs import base
from repro_torch.configs.lm_family import make_bundle
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="chatglm3-6b",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024,
    rotary_pct=0.5, rope_theta=1e4,
    dtype=torch.bfloat16, remat=True, remat_block=4,
    blockwise_from=2048, attn_block_q=1024, loss_chunk=16384,
)

SMOKE = TransformerConfig(
    name="chatglm3-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    rotary_pct=0.5, dtype=torch.float32, remat=False,
)


@base.register("chatglm3-6b")
def bundle():
    return make_bundle("chatglm3-6b", FULL, SMOKE, skip_long=True)
