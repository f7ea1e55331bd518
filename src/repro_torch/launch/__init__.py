"""Launchers (torch port of ``repro.launch``): the training loop.

Mesh construction, the dry-run, the elastic drills and the serving
launcher of the JAX package are later slices of the port.
"""
from repro_torch.launch.train import train_lm

__all__ = ["train_lm"]
