"""graphcast  [arXiv:2212.12794] — encoder-processor-decoder mesh GNN:
16L d_hidden=512, sum aggregation, n_vars=227 native input width.

Adaptation note (as in the JAX package): the icosahedral grid<->mesh
remapping of the original is replaced by per-node encoder/decoder MLPs
over the *provided* graph of each input shape; the 16-layer
interaction-network processor (edge MLP + node MLP, sum aggregation) is
faithful.
"""
from repro_torch.configs import base
from repro_torch.configs.gnn_family import make_bundle
from repro_torch.models.gnn import GNNConfig

FULL = GNNConfig(name="graphcast", arch="graphcast", n_layers=16,
                 d_hidden=512, d_in=227, n_classes=227, aggregator="sum",
                 d_edge=4)
SMOKE = GNNConfig(name="graphcast-smoke", arch="graphcast", n_layers=2,
                  d_hidden=16, d_in=8, n_classes=4, aggregator="sum")


@base.register("graphcast")
def bundle():
    return make_bundle("graphcast", FULL, SMOKE)
