"""Model configurations of the dense LMs, one module per architecture.

Each module holds the ``FULL`` and ``SMOKE`` ``TransformerConfig`` of its
JAX counterpart in ``repro.configs``; the bundles, dry-run cells and
sharding plans there are later slices of the port.
"""
from repro_torch.configs import chatglm3_6b, h2o_danube_3_4b, qwen2_7b

LM_CONFIGS = {
    "qwen2-7b": qwen2_7b,
    "h2o-danube-3-4b": h2o_danube_3_4b,
    "chatglm3-6b": chatglm3_6b,
}

__all__ = ["LM_CONFIGS", "chatglm3_6b", "h2o_danube_3_4b", "qwen2_7b"]
