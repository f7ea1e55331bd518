"""Architecture registry, one module per architecture (torch port of
``repro.configs``).

``get_arch(id)`` returns the ArchBundle; ``arch_ids()`` lists all ten.
Each LM module holds the ``FULL`` and ``SMOKE`` ``TransformerConfig`` of
its JAX counterpart, each GNN module its ``GNNConfig``s, and ``mind`` the
``MINDConfig``s; ``LM_CONFIGS`` and ``GNN_CONFIGS`` map ids to those
modules.
"""
from repro_torch.configs import (chatglm3_6b, deepseek_v2_236b, egnn, graphcast,
                                 graphsage_reddit, h2o_danube_3_4b, mind, qwen2_7b,
                                 qwen3_moe_235b_a22b, schnet)
from repro_torch.configs.base import ArchBundle, ShapeCell, arch_ids, get_arch

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

__all__ = ["ArchBundle", "GNN_CONFIGS", "LM_CONFIGS", "ShapeCell", "arch_ids", "chatglm3_6b",
           "deepseek_v2_236b", "egnn", "get_arch", "graphcast", "graphsage_reddit",
           "h2o_danube_3_4b", "mind", "qwen2_7b", "qwen3_moe_235b_a22b", "schnet"]
