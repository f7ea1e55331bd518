"""AdamW + schedules + clipping (torch port of ``repro.optim.adamw``).

The optimizer of the JAX package, step for step: ``init(params)`` builds
the state (``m``, ``v`` in float32 whatever the parameter's dtype, so bf16
parameters keep full-precision statistics), ``update`` applies one step:

  * the gradients are taken in f32 and clipped by their global norm with
    the factor min(1, grad_clip / (norm + 1e-9)); the norm returned is the
    one before clipping;
  * m and v move as ``b1 * m + (1 - b1) * g`` and ``b2 * v + (1 - b2) * g * g``;
  * the bias corrections use the step as f32;
  * weight decay applies to every leaf: ``delta = mhat / (sqrt(vhat) + eps)
    + weight_decay * p``, and ``p - lr * delta`` runs in f32 and is cast
    back to the parameter's dtype.

A tree is a dict (nested dicts allowed) of tensors.  The update is plain
tensor ops leaf by leaf, in the JAX package's order of operations
(``torch.optim.AdamW`` orders and decays differently).  It writes the
parameters and ``m``, ``v`` in place, so one leaf's f32 copies are the
only transient memory; the arithmetic is the same as writing new tensors.

On a mesh the leaves are DTensors: ``m`` and ``v`` take each parameter's
placement (:meth:`AdamW.state_specs`), each leaf's update runs on the
local shards, and the global norm (so the clip factor) is the whole
gradient's: each leaf's sum of squares is summed over the ranks holding
parts of it before the leaves are added.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.parallel import P, local


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    m: Any                 # tree like params (float32)
    v: Any                 # tree like params (float32)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dict trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree, *rest) -> list:
    """The leaves in insertion order; with ``rest``, tuples of the leaves
    of each tree at the same key."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k], *(r[k] for r in rest))]
    return [(tree, *rest)] if rest else [tree]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0          # global-norm clip; 0 disables

    def init(self, params) -> AdamWState:
        """Zero m and v in f32 beside each parameter (placed as it is on a
        mesh), step 0."""
        dev = tree_leaves(params)[0].device

        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32, requires_grad=False)

        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

    def state_specs(self, param_specs) -> AdamWState:
        """Partition specs of the state: each moment as its parameter, the
        step whole (the JAX ``state_specs``)."""
        return AdamWState(step=P(), m=param_specs, v=param_specs)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step: (params, state, global norm of the gradients before
        clipping).  ``params`` and the state's ``m`` and ``v`` are written
        in place and returned; the step is a new tensor."""
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        gnorm = global_norm(grads)
        scale = None
        if self.grad_clip > 0:
            scale = torch.clamp_max(self.grad_clip / (gnorm + 1e-9), 1.0)
        stepf = step.float()
        bc1 = 1 - torch.pow(torch.tensor(self.b1, dtype=torch.float32, device=stepf.device),
                            stepf)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, dtype=torch.float32, device=stepf.device),
                            stepf)
        for p, g, m, v in tree_leaves(params, grads, state.m, state.v):
            p, g, m, v = local(p), local(g), local(m), local(v)
            g32 = g.float()
            if scale is not None:
                g32 = g32 * scale
            m.copy_(self.b1 * m + (1 - self.b1) * g32)
            v.copy_(self.b2 * v + (1 - self.b2) * g32 * g32)
            del g32
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p32 = p.float()
            delta = delta + self.weight_decay * p32
            p.copy_((p32 - lr * delta).to(p.dtype))
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    s = torch.sum(x.float() ** 2)
    if not isinstance(s, DTensor):
        return s
    # summed over one mesh dim after the other (the partial sums of the
    # ranks that split the leaf), replicated ones left as they are
    pl = list(s.placements)
    for i, p in enumerate(pl):
        if p.is_partial():
            pl[i] = Replicate()
            s = s.redistribute(s.device_mesh, pl)
    return s.to_local()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), in f32; a DTensor leaf's
    sum is its whole tensor's (summed over the ranks that split it)."""
    return torch.sqrt(sum(_sum_sq(x) for x in tree_leaves(tree)))


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``; a function of the step
    tensor, returning an f32 tensor."""
    def lr(step):
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def make_train_step(loss_fn, opt: AdamW, report=None):
    """The step of the JAX package's train loops: ``loss_fn(params, batch)``
    -> scalar loss, its gradients with respect to the leaves of ``params``
    (a dict tree of tensors that require grad), then ``opt.update``.
    Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``; the parameters are updated in place.  On a
    mesh ``loss_fn`` gives this rank's share of the loss and ``report``
    (e.g. ``MeshParallel.sum_data``) the loss from it."""

    def train_step(params, opt_state, batch):
        loss = loss_fn(params, batch)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach gets a zero gradient, as in JAX
        it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        loss = loss.detach() if report is None else report(loss)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
