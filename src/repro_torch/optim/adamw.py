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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch


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
        """Zero m and v in f32 beside each parameter, step 0."""
        dev = tree_leaves(params)[0].device

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), in f32."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree_leaves(tree)))


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


def make_train_step(loss_fn, opt: AdamW):
    """The step of the JAX package's train loops: ``loss_fn(params, batch)``
    -> scalar loss, its gradients with respect to the leaves of ``params``
    (a dict tree of tensors that require grad), then ``opt.update``.
    Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``; the parameters are updated in place."""

    def train_step(params, opt_state, batch):
        loss = loss_fn(params, batch)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach gets a zero gradient, as in JAX
        it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step
