"""qwen2-7b  [arXiv:2407.10671]

28L d_model=3584 28H (GQA kv=4, head_dim=128) d_ff=18944 vocab=152064,
QKV bias.
"""
import torch

from repro_torch.configs import base
from repro_torch.configs.lm_family import make_bundle
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen2-7b",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064,
    qkv_bias=True, rope_theta=1e6,
    dtype=torch.bfloat16, remat=True, remat_block=4,
    blockwise_from=2048, attn_block_q=1024, loss_chunk=16384,
)

SMOKE = TransformerConfig(
    name="qwen2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    qkv_bias=True, dtype=torch.float32, remat=False,
)


@base.register("qwen2-7b")
def bundle():
    return make_bundle("qwen2-7b", FULL, SMOKE, skip_long=True)
