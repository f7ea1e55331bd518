"""deepseek-v2-236b  [arXiv:2405.04434]

60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536, rope 64, nope 128,
v 128), vocab=102400, MoE: 160 routed experts top-6 + 2 shared,
moe_d_ff=1536, first layer dense (d_ff=12288).
"""
import torch

from repro_torch.configs import base
from repro_torch.configs.lm_family import make_bundle
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="deepseek-v2-236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288,                    # the leading dense layer's hidden
    vocab=102400,
    n_experts=160, top_k=6, moe_d_ff=1536,
    n_shared_experts=2, n_dense_layers=1,
    mla_kv_lora=512, mla_q_lora=1536, mla_rope_dim=64, mla_nope_dim=128,
    mla_v_dim=128,
    rope_theta=1e4,
    dtype=torch.bfloat16, remat=True, remat_block=4,
    blockwise_from=2048, attn_block_q=1024, loss_chunk=16384, moe_chunk=32768,
)

SMOKE = TransformerConfig(
    name="deepseek-v2-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    n_experts=8, top_k=2, moe_d_ff=32, n_shared_experts=1, n_dense_layers=1,
    mla_kv_lora=32, mla_q_lora=24, mla_rope_dim=8, mla_nope_dim=16,
    mla_v_dim=16,
    dtype=torch.float32, remat=False,
)


@base.register("deepseek-v2-236b")
def bundle():
    return make_bundle("deepseek-v2-236b", FULL, SMOKE, skip_long=True)
