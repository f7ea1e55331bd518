"""Model definitions (torch): the transformer LM family (dense, MoE, MLA),
the MIND recsys model and the GNN family (EGNN, SchNet, GraphSAGE,
GraphCast), each with its training loss."""
from repro_torch.models import gnn, recsys, transformer

__all__ = ["gnn", "recsys", "transformer"]
