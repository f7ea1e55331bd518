"""graphsage-reddit  [arXiv:1706.02216] — 2L d_hidden=128, mean aggregator,
sample sizes 25-10 (the minibatch_lg shape uses its own 15-10 fanout)."""
from repro_torch.configs import base
from repro_torch.configs.gnn_family import make_bundle
from repro_torch.models.gnn import GNNConfig

FULL = GNNConfig(name="graphsage-reddit", arch="graphsage", n_layers=2,
                 d_hidden=128, d_in=602, n_classes=41, aggregator="mean")
SMOKE = GNNConfig(name="graphsage-smoke", arch="graphsage", n_layers=2,
                  d_hidden=16, d_in=8, n_classes=4, aggregator="mean")


@base.register("graphsage-reddit")
def bundle():
    return make_bundle("graphsage-reddit", FULL, SMOKE)
