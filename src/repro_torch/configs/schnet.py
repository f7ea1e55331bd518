"""schnet  [arXiv:1706.08566] — continuous-filter convolutions:
3 interactions, d_hidden=64, 300 RBF, cutoff 10."""
from repro_torch.configs import base
from repro_torch.configs.gnn_family import make_bundle
from repro_torch.models.gnn import GNNConfig

FULL = GNNConfig(name="schnet", arch="schnet", n_layers=3, d_hidden=64,
                 d_in=32, n_classes=1, n_rbf=300, cutoff=10.0)
SMOKE = GNNConfig(name="schnet-smoke", arch="schnet", n_layers=2, d_hidden=16,
                  d_in=8, n_classes=4, n_rbf=20, cutoff=5.0)


@base.register("schnet")
def bundle():
    return make_bundle("schnet", FULL, SMOKE)
