"""Elastic launcher: state round-tripped through the host onto the
surviving devices (torch port of ``repro.launch.elastic``).

Two elasticity layers, as in the JAX package:

1. **Tensor-program elasticity** (this module): when the device set
   changes, rebuild the train step for the new set and place the
   checkpointed host state onto it.  Host state is numpy (bf16 leaves
   kept bit for bit as int16), so the transition is placement only and
   training resumes exactly.  The port runs on one card: the "survivors"
   of the drill are that same card, and a device set of more than one is
   refused (:func:`~repro_torch.engine.sharding.refuse_multi_card`).

2. **Replication-scheme elasticity** (``repro_torch.core.reshard``,
   exercised by the serve launcher): the paper's incremental §5.4 update
   keeps query latency bounds valid across reshards without re-analyzing
   the workload.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.engine.sharding import refuse_multi_card
from repro_torch.engine.streaming import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, AdamWState, cosine_schedule
from repro_torch.optim.adamw import make_train_step


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where and as what a host leaf goes (the counterpart of a
    ``NamedSharding``): the device, the dtype, and whether it is a
    trainable parameter."""
    device: torch.device
    dtype: torch.dtype
    param: bool = False


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
    and batch for a device set: ``(device, params, opt_state, batch,
    step)``, the placements trees of :class:`Placement`.  One device only."""
    del model_axis
    if len(devices) != 1:
        refuse_multi_card(f"build_for_devices over {len(devices)} devices")
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


def to_host(state):
    """A tree of tensors as numpy (bf16 as its int16 bits)."""
    def host(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()

    return _tree_map(host, state)


def reshard_state(state_host, placements):
    """Place host (numpy) state onto its devices — the elastic transition."""
    def place(a, pl: Placement):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if pl.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        t = t.to(pl.device, pl.dtype, copy=True)  # the host state stays as it was
        return nn.Parameter(t) if pl.param else t

    return _tree_map(place, state_host, placements)


def elastic_drill(cfg: T.TransformerConfig, steps_before: int = 3,
                  steps_after: int = 3, batch: int = 4, seq: int = 16,
                  seed: int = 0, device=None) -> dict:
    """Scale-in drill: train, lose the cluster, continue on the survivors.

    Trains ``steps_before`` steps, round-trips the whole state through host
    numpy onto the survivors (on one card, the same card), trains
    ``steps_after`` more, and compares the losses with a never-failed run:
    data is step-seeded and the transition is placement only, so they
    match.  ``bit_exact`` keeps the JAX definition (``allclose`` at rtol
    1e-5); ``max_abs_gap`` is the largest absolute difference."""
    devices = [resolve_device(device)]
    opt = AdamW(lr=cosine_schedule(1e-3, 2, 100))

    def make_batch(step):
        rng = np.random.default_rng(1000 + step)
        toks = rng.integers(0, cfg.vocab, (batch, seq + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run(devs, params_h, opt_h, start, n, keep_state: bool):
        _, ps, os_, bs, step = build_for_devices(cfg, devs, opt)
        params = reshard_state(params_h, ps)
        opt_state = reshard_state(opt_h, os_)
        losses = []
        for i in range(start, start + n):
            b = reshard_state(make_batch(i), bs)
            params, opt_state, m = step(params, opt_state, b)
            losses.append(float(m["loss"]))
        return losses, (to_host((params, opt_state)) if keep_state else None)

    dev = devices[0]
    model = T.Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    params0 = dict(model.named_parameters())
    host0 = to_host((params0, opt.init(params0)))
    del model, params0

    # phase 1: full cluster
    losses1, host1 = run(devices, host0[0], host0[1], 0, steps_before, True)
    # phase 2: half the devices "survive" (one card: the same one)
    survivors = devices[: max(1, len(devices) // 2)]
    losses2, _ = run(survivors, host1[0], host1[1], steps_before, steps_after, False)
    del host1
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
