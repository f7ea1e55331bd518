"""mind  [arXiv:1904.08030]: multi-interest recsys retrieval,
embed_dim=64, 4 interests, 3 capsule-routing iterations.

Item table: 2^26 rows x 64 f32 (17.2 GB); user-feature table 2^20 x 64.
"""
import torch

from repro_torch.configs import base
from repro_torch.configs.recsys_family import make_bundle
from repro_torch.models.recsys import MINDConfig

FULL = MINDConfig(
    name="mind",
    n_items=67_108_864,       # 2^26 rows
    n_user_feats=1_048_576,   # 2^20 rows
    embed_dim=64, n_interests=4, capsule_iters=3,
    hist_len=50, user_feat_len=8, d_hidden=128,
    dtype=torch.float32,
)

SMOKE = MINDConfig(
    name="mind-smoke",
    n_items=1000, n_user_feats=100,
    embed_dim=16, n_interests=3, capsule_iters=2,
    hist_len=10, user_feat_len=4, d_hidden=32,
)


@base.register("mind")
def bundle():
    return make_bundle("mind", FULL, SMOKE)
