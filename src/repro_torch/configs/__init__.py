"""Model configurations, one module per architecture.

Each LM module holds the ``FULL`` and ``SMOKE`` ``TransformerConfig`` of
its JAX counterpart in ``repro.configs``, each GNN module its
``GNNConfig``s, and ``mind`` the ``MINDConfig``s; the bundles, dry-run
cells and sharding plans there are later slices of the port.
"""
from repro_torch.configs import (chatglm3_6b, deepseek_v2_236b, egnn, graphcast,
                                 graphsage_reddit, h2o_danube_3_4b, mind, qwen2_7b,
                                 qwen3_moe_235b_a22b, schnet)

LM_CONFIGS = {
    "qwen2-7b": qwen2_7b,
    "h2o-danube-3-4b": h2o_danube_3_4b,
    "chatglm3-6b": chatglm3_6b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "deepseek-v2-236b": deepseek_v2_236b,
}

GNN_CONFIGS = {
    "egnn": egnn,
    "schnet": schnet,
    "graphsage-reddit": graphsage_reddit,
    "graphcast": graphcast,
}

__all__ = ["GNN_CONFIGS", "LM_CONFIGS", "chatglm3_6b", "deepseek_v2_236b", "egnn", "graphcast",
           "graphsage_reddit", "h2o_danube_3_4b", "mind", "qwen2_7b", "qwen3_moe_235b_a22b",
           "schnet"]
