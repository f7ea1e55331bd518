"""Elastic launcher: state round-tripped through the host onto the
surviving devices (torch port of ``repro.launch.elastic``).

Two elasticity layers, as in the JAX package:

1. **Tensor-program elasticity** (this module): when the device set
   changes, rebuild the mesh, the placements and the train step for the
   new set and place the checkpointed host state onto it.  Host state is
   numpy (bf16 leaves kept bit for bit as int16), so the transition is
   placement only and training resumes exactly.  A device set is one
   device, or ranks of the default process group (one device each): the
   ``("data", "model")`` mesh over them, the parameters and AdamW moments
   placed as DTensors by ``param_specs``, the batch rows over "data".

2. **Replication-scheme elasticity** (``repro_torch.core.reshard``,
   exercised by the serve launcher): the paper's incremental §5.4 update
   keeps query latency bounds valid across reshards without re-analyzing
   the workload.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.engine.streaming import resolve_device
from repro_torch.launch.mesh import init_ranks, mesh_over
from repro_torch.launch.train import make_mesh_train_step, seeded_model
from repro_torch.models import transformer as T
from repro_torch.models.parallel import P, mesh_device, shard_tensor
from repro_torch.optim import AdamW, AdamWState, cosine_schedule
from repro_torch.optim.adamw import make_train_step


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where and as what a host leaf goes (the counterpart of a
    ``NamedSharding``): the device, the dtype, whether it is a trainable
    parameter, and on a mesh its partition spec."""
    device: torch.device
    dtype: torch.dtype
    param: bool = False
    mesh: DeviceMesh | None = None
    spec: P | None = None


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple):
        out = [_tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def build_for_devices(cfg: T.TransformerConfig, devices: list, opt: AdamW,
                      model_axis: int | None = None):
    """The train step and the placements of its parameters, optimizer state
    and batch for a device set: ``(device or mesh, params, opt_state,
    batch, step)``, the placements trees of :class:`Placement`.

    ``devices`` is one device (a device or its name), or ranks (ints) of
    the default process group: then the ``("data", "model")`` mesh of shape
    (n / m, m) over them (m = ``model_axis`` or the JAX rule), built with
    every rank of the group taking part; a rank outside ``devices`` gets
    the mesh and the placements but no coordinate on the mesh."""
    if all(isinstance(d, int) for d in devices):
        if not dist.is_initialized():
            raise ValueError("ranks (ints) are ranks of the default process group, and "
                             "none is up (launch.mesh.init_ranks brings one up)")
        return _build_on_mesh(cfg, devices, opt, model_axis)
    if len(devices) != 1:
        raise ValueError("a device set of more than one is ranks (ints) of the default "
                         "process group")
    dev = resolve_device(devices[0])
    pspecs = {name: Placement(dev, p.dtype, param=True)
              for name, p in T.init_abstract(cfg).items()}
    f32 = Placement(dev, torch.float32)
    ospecs = AdamWState(step=Placement(dev, torch.int32),
                        m={k: f32 for k in pspecs}, v={k: f32 for k in pspecs})
    ints = Placement(dev, torch.int32)
    bspecs = {"tokens": ints, "labels": ints}
    step = make_train_step(
        lambda p, b: T.loss_fn(T.Transformer(cfg, params=p), b["tokens"], b["labels"]), opt)
    return dev, pspecs, ospecs, bspecs, step


def _build_on_mesh(cfg, ranks: list[int], opt: AdamW, model_axis):
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = mesh_over(list(ranks), device_type, model_axis)
    n, m = mesh.size(0), mesh.size(1)
    specs = T.param_specs(cfg, ("data",), "model", m, n)
    dev = mesh_device(mesh)
    pspecs = {name: Placement(dev, p.dtype, param=True, mesh=mesh, spec=specs[name])
              for name, p in T.init_abstract(cfg).items()}
    st = opt.state_specs(specs)
    ospecs = AdamWState(
        step=Placement(dev, torch.int32),
        m={k: Placement(dev, torch.float32, mesh=mesh, spec=st.m[k]) for k in pspecs},
        v={k: Placement(dev, torch.float32, mesh=mesh, spec=st.v[k]) for k in pspecs})
    rows = Placement(dev, torch.int32, mesh=mesh, spec=P(("data",), None))
    bspecs = {"tokens": rows, "labels": rows}
    step = None if mesh.get_coordinate() is None else make_mesh_train_step(cfg, mesh, opt)
    return mesh, pspecs, ospecs, bspecs, step


def to_host(state):
    """A tree of tensors as numpy (bf16 as its int16 bits); a DTensor leaf
    is gathered whole first (every rank of its mesh takes part)."""
    def host(t):
        t = t.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()

    return _tree_map(host, state)


def reshard_state(state_host, placements):
    """Place host (numpy) state onto its devices — the elastic transition.
    A leaf with a mesh becomes a DTensor placed by its spec (each rank
    keeps its slice)."""
    def place(a, pl: Placement):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if pl.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        t = t.to(pl.device, pl.dtype, copy=True)  # the host state stays as it was
        if pl.mesh is not None:
            t = shard_tensor(t, pl.mesh, pl.spec)
        return nn.Parameter(t) if pl.param else t

    return _tree_map(place, state_host, placements)


def elastic_drill(cfg: T.TransformerConfig, steps_before: int = 3,
                  steps_after: int = 3, batch: int = 4, seq: int = 16,
                  seed: int = 0, device=None, init: dict | None = None,
                  ranks: list[int] | None = None) -> dict:
    """Scale-in drill: train on every device, lose half, continue.

    Trains ``steps_before`` steps, round-trips the whole state through host
    numpy onto the survivors, trains ``steps_after`` more, and compares
    the losses with a never-failed run: data is step-seeded and the
    transition is placement only, so they match.  Given ``ranks`` (of the
    default process group, every rank of which calls this) the devices
    are those ranks: a mesh of n, then of the first n / 2, every rank
    returning the same result; else the one ``device`` (the survivors are
    that device).  ``init`` (host arrays keyed as
    ``named_parameters()``) replaces the seeded draw.  ``bit_exact`` keeps
    the JAX definition (``allclose`` at rtol 1e-5); ``max_abs_gap`` is the
    largest absolute difference."""
    if ranks is not None:
        dev = init_ranks(device)
        devices = list(ranks)
    else:
        dev = resolve_device(device)
        devices = [dev]
    opt = AdamW(lr=cosine_schedule(1e-3, 2, 100))

    def make_batch(step):
        rng = np.random.default_rng(1000 + step)
        toks = rng.integers(0, cfg.vocab, (batch, seq + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run(devs, params_h, opt_h, start, n, keep_state: bool):
        _, ps, os_, bs, step = build_for_devices(cfg, devs, opt)
        if step is None:  # a rank the mesh left out
            return None, None
        params = reshard_state(params_h, ps)
        opt_state = reshard_state(opt_h, os_)
        losses = []
        for i in range(start, start + n):
            b = reshard_state(make_batch(i), bs)
            params, opt_state, m = step(params, opt_state, b)
            losses.append(float(m["loss"]))
        return losses, (to_host((params, opt_state)) if keep_state else None)

    model = seeded_model(cfg, dev, seed, init)
    params0 = dict(model.named_parameters())
    host0 = to_host((params0, opt.init(params0)))
    del model, params0

    # phase 1: full cluster
    losses1, host1 = run(devices, host0[0], host0[1], 0, steps_before, True)
    # phase 2: half the devices "survive" (one device: the same one)
    survivors = devices[: max(1, len(devices) // 2)]
    losses2, _ = run(survivors, host1[0], host1[1], steps_before, steps_after, False)
    del host1
    if ranks is not None:  # the survivors' losses to every rank
        box = [losses2]
        dist.broadcast_object_list(box, src=survivors[0])
        losses2 = box[0]
    # reference: never-failed run
    ref_losses, _ = run(devices, host0[0], host0[1], 0, steps_before + steps_after, False)
    got = np.asarray(losses1 + losses2)
    return {
        "losses_before": losses1,
        "losses_after": losses2,
        "reference": ref_losses,
        "bit_exact": bool(np.allclose(got, ref_losses, rtol=1e-5)),
        "max_abs_gap": float(np.max(np.abs(got - np.asarray(ref_losses)))),
    }
