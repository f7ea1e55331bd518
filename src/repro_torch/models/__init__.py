"""Model definitions (torch): the dense transformer LM family.

The GNN family and the MIND recsys model of the JAX package are later
slices of the port.
"""
from repro_torch.models import transformer

__all__ = ["transformer"]
