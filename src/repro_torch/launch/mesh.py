"""Meshes (torch port of ``repro.launch.mesh``).

``make_host_mesh`` builds the ``("data", "model")`` mesh over the ranks of
the default process group, one rank per device (NCCL on the cards, gloo
with ``device="cpu"``): the counterpart of the JAX package's small mesh
over the host's devices.

``make_production_mesh`` builds the JAX package's production shapes over
the default group: 256 ranks as (data=16, model=16), or 512 as (pod=2,
data=16, model=16).  A world of 256 or 512 cards (``torchrun`` over H100
nodes, NCCL) takes it as it is.  The dry-run stands in for such a world
with :func:`init_placeholder_ranks`: one host process as rank 0 of a
placeholder group of n ranks (torch's ``fake`` backend, whose collectives
return at once and move nothing), over which a step runs on ``meta``
tensors as rank 0 would run it.  Nothing brings that group up but an
explicit call (the dry-run and the tests make it, in a process of their
own).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.engine.streaming import resolve_device

POD_SHAPES = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def init_placeholder_ranks(n: int) -> None:
    """Bring up the default process group as rank 0 of ``n`` placeholder
    ranks (torch's ``fake`` backend: every collective returns at once and
    leaves its tensors as they are).  Raises when a group is up already;
    ``dist.destroy_process_group()`` takes it down."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(n))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """The production mesh over every rank of the default process group:
    (16, 16) ``("data", "model")``, or with ``multi_pod`` (2, 16, 16)
    ``("pod", "data", "model")``, ranks in row-major order (rank r on
    coordinate ``divmod`` of r, as ``jax.make_mesh`` lays out devices).
    ``device`` (default CUDA; raises without a card unless "cpu") is the
    mesh's device type; the placeholder group of the dry-run takes
    "cpu".  Raises ``ValueError`` when no group is up or its world size is
    not 256 (512 with ``multi_pod``)."""
    dev = resolve_device(device)
    shape, axes = POD_SHAPES[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'} mesh {shape} "
                         f"needs a world of {n} ranks, the default group has {world}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


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
