"""Model definitions (torch): the transformer LM family (dense, MoE, MLA)
and the serving half of the MIND recsys model.

MIND's training loss and the GNN family of the JAX package are a later
slice of the port.
"""
from repro_torch.models import recsys, transformer

__all__ = ["recsys", "transformer"]
