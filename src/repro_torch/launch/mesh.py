"""Meshes (torch port of ``repro.launch.mesh``).

``make_host_mesh`` builds the ``("data", "model")`` mesh over the ranks of
the default process group, one rank per device (NCCL on the cards, gloo
with ``device="cpu"``): the counterpart of the JAX package's small mesh
over the host's devices.  The JAX package's TPU v5e pod meshes (256 chips
as (data=16, model=16), or 2 pods as (pod=2, data=16, model=16)) have no
machine here and stay refused
(:func:`~repro_torch.engine.sharding.refuse_multi_card`).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.engine.sharding import refuse_multi_card
from repro_torch.engine.streaming import resolve_device


def make_production_mesh(*, multi_pod: bool = False):
    refuse_multi_card("make_production_mesh (TPU v5e pods)")


def init_ranks(device=None) -> torch.device:
    """This rank's device, the default process group brought up if it is
    not: from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), else as a world of one over an
    in-process store.  ``device`` (default CUDA; raises without a card
    unless "cpu") picks NCCL or gloo; on a card the rank takes card
    ``LOCAL_RANK`` (else its rank modulo the cards)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dev.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK",
                                        dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    return dev


def mesh_over(ranks: list[int], device_type: str, model: int | None = None) -> DeviceMesh:
    """The ``("data", "model")`` mesh of shape (n / m, m) over ``ranks`` of
    the default group, m = ``model`` or 2 when n is even and above 1, else
    1 (the JAX rule).  Every rank of the group calls it (each takes part
    in making the mesh's groups); a rank outside ``ranks`` gets a mesh it
    has no coordinate on."""
    n = len(ranks)
    m = model or (2 if n % 2 == 0 and n > 1 else 1)
    if n % m:
        raise ValueError(f"a model axis of {m} does not divide {n} ranks")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(n // m, m),
                      mesh_dim_names=("data", "model"))


def make_host_mesh(model: int | None = None, device=None) -> DeviceMesh:
    """The ``("data", "model")`` mesh over every rank of the default
    process group (brought up by :func:`init_ranks` if need be)."""
    dev = init_ranks(device)
    return mesh_over(list(range(dist.get_world_size())), dev.type, model)
