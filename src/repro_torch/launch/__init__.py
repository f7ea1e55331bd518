"""Launchers (torch port of ``repro.launch``): the train loop
(``launch.train``), the serve launcher (``launch.serve``), the one-card
dry-run (``launch.dryrun``, run as ``python -m repro_torch.launch.dryrun``)
and the elastic drill (``launch.elastic``).

``repro.launch`` exports its meshes, which the port refuses on one card
(``launch.mesh``), so the package exports ``train_lm`` alone.
"""
from repro_torch.launch.train import train_lm

__all__ = ["train_lm"]
