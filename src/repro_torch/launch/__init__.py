"""Launchers (torch port of ``repro.launch``): the train loop
(``launch.train``), the serve launcher (``launch.serve``), the one-card
dry-run (``launch.dryrun``, run as ``python -m repro_torch.launch.dryrun``)
and the elastic drill (``launch.elastic``).

``launch.mesh`` builds the host mesh (``make_host_mesh``); the TPU pod
meshes stay refused.  The package exports ``train_lm``.
"""
from repro_torch.launch.train import train_lm

__all__ = ["train_lm"]
