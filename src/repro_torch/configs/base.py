"""Architecture bundles: the uniform interface of the dry-run (torch port
of ``repro.configs.base``).

An ArchBundle binds a model family to one architecture and exposes, for
each of its input shapes:

  * ``abstract_args(shape, multi_pod)`` — every argument of the step
    function (parameters, AdamW state, batch / cache) as ``meta`` tensors,
    the counterpart of JAX's ``ShapeDtypeStruct`` trees: shapes and
    dtypes, nothing allocated;
  * ``shardings(shape, multi_pod)`` — the ``(in_specs, out_specs)`` trees
    of :class:`~repro_torch.models.parallel.PartitionSpec` of the JAX
    package's production meshes, keyed as the port's arguments and
    results;
  * ``real_args(shape, device, seed)`` — the same leaves as real tensors
    on ``device`` (seeded parameters, zero moments, ids inside their
    tables), for a real step beside the ``meta`` one;
  * ``step_fn(shape, multi_pod)`` — the step (train step / prefill /
    decode / serve scoring), a plain function of those arguments; inside
    :func:`~repro_torch.models.parallel.use_mesh` it runs as this rank of
    that mesh, on the arguments placed by ``shardings`` (DTensors, see
    :func:`~repro_torch.models.parallel.place_tree`);
  * ``smoke_batch(rng, device)`` and ``smoke_step()`` — a reduced config
    and a tiny batch that run a real step (shape and finiteness checked in
    tests).

Conventions (the JAX package's): dp = the data-parallel mesh axes
(``("data",)`` single-pod, ``("pod", "data")`` multi-pod), tp = "model".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch



def pad_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""

    shape_id: str
    kind: str              # train | prefill | decode | serve | retrieval
    meta: dict


@dataclasses.dataclass
class ArchBundle:
    arch_id: str
    family: str                       # lm | gnn | recsys
    config: Any                       # full-size model config
    smoke_config: Any                 # reduced config
    cells: dict[str, ShapeCell]
    skip_shapes: dict[str, str]       # shape_id -> reason
    # family implementations (injected by the family module)
    _abstract_args: Callable = None
    _shardings: Callable = None
    _real_args: Callable = None
    _step_fn: Callable = None
    _smoke_batch: Callable = None
    _smoke_step: Callable = None

    def shape_ids(self) -> list[str]:
        return list(self.cells.keys())

    def abstract_args(self, shape_id: str, multi_pod: bool = False):
        return self._abstract_args(self, shape_id, multi_pod)

    def real_args(self, shape_id: str, device=None, seed: int = 0):
        return self._real_args(self, shape_id, device, seed)

    def shardings(self, shape_id: str, multi_pod: bool = False):
        return self._shardings(self, shape_id, multi_pod)

    def step_fn(self, shape_id: str, multi_pod: bool = False):
        return self._step_fn(self, shape_id, multi_pod)

    def smoke_batch(self, rng: np.random.Generator, device=None):
        return self._smoke_batch(self, rng, device)

    def smoke_step(self):
        return self._smoke_step(self)


_REGISTRY: dict[str, Callable[[], ArchBundle]] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_arch(arch_id: str) -> ArchBundle:
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch '{arch_id}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def arch_ids() -> list[str]:
    return sorted(_REGISTRY)


def dp_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def dp_size(multi_pod: bool) -> int:
    return 32 if multi_pod else 16


TP_AXIS = "model"
TP_SIZE = 16


# ---------------------------------------------------------------------------
# Helpers the family modules share
# ---------------------------------------------------------------------------
def meta(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor: the counterpart of ``jax.ShapeDtypeStruct``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def host_tensors(tree, device):
    """numpy leaves of a (nested dict / list) batch as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: host_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host_tensors(v, device) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def to_device(tree, device):
    """A (nested dict) tree of CPU tensors moved to ``device``; a leaf that
    requires grad stays a leaf that requires grad."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    out = tree.detach().to(device)
    if isinstance(tree, torch.nn.Parameter):
        return torch.nn.Parameter(out)
    return out.requires_grad_(tree.requires_grad)
