"""egnn  [arXiv:2102.09844] — E(n)-equivariant GNN: 4L d_hidden=64."""
from repro_torch.configs import base
from repro_torch.configs.gnn_family import make_bundle
from repro_torch.models.gnn import GNNConfig

FULL = GNNConfig(name="egnn", arch="egnn", n_layers=4, d_hidden=64,
                 d_in=32, n_classes=7)
SMOKE = GNNConfig(name="egnn-smoke", arch="egnn", n_layers=2, d_hidden=16,
                  d_in=8, n_classes=4)


@base.register("egnn")
def bundle():
    return make_bundle("egnn", FULL, SMOKE)
