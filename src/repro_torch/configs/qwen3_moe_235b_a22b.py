"""qwen3-moe-235b-a22b  [hf:Qwen/Qwen3-235B-A22B]

94L d_model=4096 64H (GQA kv=4, head_dim=128) vocab=151936,
MoE: 128 experts top-8, moe_d_ff=1536 (no shared experts).
"""
import torch

from repro_torch.configs import base
from repro_torch.configs.lm_family import make_bundle
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=12288,  # unused (no dense layers); kept for completeness
    vocab=151936,
    n_experts=128, top_k=8, moe_d_ff=1536,
    rope_theta=1e6,
    dtype=torch.bfloat16, remat=True, remat_block=2,
    blockwise_from=2048, attn_block_q=1024, loss_chunk=16384, moe_chunk=32768,
)

SMOKE = TransformerConfig(
    name="qwen3-moe-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=256,
    n_experts=8, top_k=2, moe_d_ff=32,
    dtype=torch.float32, remat=False,
)


@base.register("qwen3-moe-235b-a22b")
def bundle():
    return make_bundle("qwen3-moe-235b-a22b", FULL, SMOKE, skip_long=True)
