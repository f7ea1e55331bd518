"""The train loop with checkpoint / restart and a failure
drill (torch port of ``repro.launch.train``).

Runs a registered LM architecture on one device, or, given ``mesh=``, on
a ``("data", "model")`` mesh of
:func:`~repro_torch.launch.mesh.make_host_mesh` (one rank per device;
``main()`` builds it when ``torchrun`` started the program):

  * the train step: the loss, its gradients by autograd, one AdamW step
    (:func:`~repro_torch.optim.adamw.make_train_step`); on the mesh the
    parameters and the AdamW moments are DTensors placed by
    ``param_specs`` / ``state_specs`` and the batch by ``shard_batch``
    (the rows over "data"), the loss is the global batch's;
  * deterministic per-step synthetic data (restart-exact), prefetched on a
    host thread;
  * asynchronous checkpoints every ``ckpt_every`` steps and restore on
    start; a checkpoint holds whole tensors (the one-device file format),
    written by rank 0 and read back by every rank into its shards;
  * ``fail_at``: a simulated failure after that step's update, for the
    restore-and-continue drill.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --steps 20 \\
      --device cpu   # the SMOKE config (default), on the CPU
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --device cpu   # the same on a 2 x 2 gloo mesh (NCCL without --device)
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs import LM_CONFIGS
from repro_torch.data import Prefetcher, lm_batch_fn, shard_batch
from repro_torch.distsys import CheckpointManager
from repro_torch.engine.streaming import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.models.parallel import MeshParallel, P, local, local_slice, mesh_device, \
    shard_tensor
from repro_torch.optim import AdamW, AdamWState, cosine_schedule
from repro_torch.optim.adamw import make_train_step, tree_map

BATCH_SPECS = {"tokens": P(("data",), None), "labels": P(("data",), None)}


def seeded_model(cfg, dev, seed: int = 0, init: dict | None = None) -> T.Transformer:
    """The model drawn from ``seed`` on ``dev``, or holding the host arrays
    ``init`` (keyed as ``named_parameters()``)."""
    model = T.Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    if init is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.from_numpy(np.asarray(init[name], dtype=np.float32)))
    return model


def make_mesh_train_step(cfg, mesh, opt: AdamW):
    """The train step on ``mesh``: the model bound to the DTensor parameters
    computes this rank's share of the global batch's loss; the loss
    reported is its sum over "data"."""
    par = MeshParallel(mesh)
    return make_train_step(
        lambda p, b: T.loss_fn(T.Transformer(cfg, params=p, par=par), b["tokens"], b["labels"]),
        opt, report=par.sum_data)


class _OneDevice:
    """The loop's state on one device."""

    def __init__(self, cfg, opt: AdamW, device, init):
        dev = resolve_device(device)
        model = seeded_model(cfg, dev, init=init)
        self.params = dict(model.named_parameters())
        self.opt_state = opt.init(self.params)
        self.step = make_train_step(
            lambda p, b: T.loss_fn(model, b["tokens"], b["labels"]), opt)
        self.put = lambda hb: shard_batch(hb, dev)
        self.writer = True

    def snapshot(self):
        return self.params, self.opt_state

    def restore(self, tree):
        with torch.no_grad():
            for name, value in tree[0].items():
                self.params[name].copy_(value)
        self.opt_state = tree[1]


class _OnMesh:
    """The loop's state on the host mesh: every rank draws the whole model
    (the same seed as one device) and keeps its shards, the parameters
    placed by ``param_specs`` and the AdamW moments by ``state_specs``."""

    def __init__(self, cfg, opt: AdamW, mesh, init):
        self.mesh = mesh
        self.pspecs = T.param_specs(cfg, ("data",), "model", mesh.size(1), mesh.size(0))
        self.sspecs = opt.state_specs(self.pspecs)
        model = seeded_model(cfg, mesh_device(mesh), init=init)
        self.params = {name: nn.Parameter(shard_tensor(p.detach(), mesh, self.pspecs[name]))
                       for name, p in model.named_parameters()}
        del model
        self.opt_state = opt.init(self.params)   # each moment placed as its parameter
        self.step = make_mesh_train_step(cfg, mesh, opt)
        self.put = lambda hb: shard_batch(hb, mesh, BATCH_SPECS)
        self.writer = dist.get_rank() == 0

    def snapshot(self):
        """The whole state on the host (every rank takes part)."""
        whole = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).cpu()
        return tree_map(whole, self.params), AdamWState(
            step=self.opt_state.step.cpu(), m=tree_map(whole, self.opt_state.m),
            v=tree_map(whole, self.opt_state.v))

    def restore(self, tree):
        """Whole host tensors copied into this rank's shards."""
        params, state = tree
        with torch.no_grad():
            for group, got, specs in ((self.params, params, self.pspecs),
                                      (self.opt_state.m, state.m, self.sspecs.m),
                                      (self.opt_state.v, state.v, self.sspecs.v)):
                for name, value in got.items():
                    local(group[name]).copy_(local_slice(value, specs[name], self.mesh))
        self.opt_state = self.opt_state._replace(step=state.step.to(self.opt_state.step.device))

    def like(self):
        """Host tensors of the whole shapes, for ``restore_latest``."""
        empty = lambda t: torch.empty(t.shape, dtype=t.dtype)
        return tree_map(empty, self.params), AdamWState(
            step=torch.empty((), dtype=torch.int32), m=tree_map(empty, self.opt_state.m),
            v=tree_map(empty, self.opt_state.v))


def train_lm(arch: str, steps: int = 20, smoke: bool = True,
             ckpt_dir: str | None = None, ckpt_every: int = 10,
             batch: int = 8, seq: int = 32, log_every: int = 5,
             fail_at: int | None = None, device=None, init: dict | None = None,
             mesh=None) -> dict:
    """Train an LM config (``smoke``: its SMOKE config) for ``steps`` steps
    on ``device`` (default CUDA; raises without a card unless "cpu"), or,
    given ``mesh`` (a ``("data", "model")`` mesh of ``make_host_mesh``,
    whose every rank calls this), on that mesh.  ``init`` (host arrays
    keyed as ``named_parameters()``) replaces the seeded draw.  Returns
    the metrics and ``losses`` / ``grad_norms``, each step's in order."""
    mod = LM_CONFIGS[arch]
    cfg = mod.SMOKE if smoke else mod.FULL
    opt = AdamW(lr=cosine_schedule(3e-4, 10, max(steps, 100)))
    run = _OneDevice(cfg, opt, device, init) if mesh is None else _OnMesh(cfg, opt, mesh, init)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None:
        if isinstance(run, _OnMesh):
            dist.barrier()  # rank 0's last write is on disk before anyone reads
        restored, at = mgr.restore_latest(run.like() if isinstance(run, _OnMesh)
                                          else run.snapshot())
        if restored is not None:
            run.restore(restored)
            start = at + 1
            if run.writer:
                print(f"[train] restored checkpoint step {at}")

    pf = Prefetcher(lm_batch_fn(cfg.vocab, batch, seq), start_step=start)
    losses, norms = [], []
    t0 = time.perf_counter()
    try:
        for step, host_batch in pf:
            if step >= steps:
                break
            _, run.opt_state, metrics = run.step(run.params, run.opt_state, run.put(host_batch))
            if fail_at is not None and step == fail_at:
                raise RuntimeError("injected failure")
            loss = float(metrics["loss"])
            losses.append(loss)
            norms.append(float(metrics["grad_norm"]))
            if step % log_every == 0 and run.writer:
                print(f"[train] step {step} loss {loss:.4f} gnorm {norms[-1]:.3f}")
            if mgr is not None and (step + 1) % ckpt_every == 0:
                state = run.snapshot()
                if run.writer:
                    mgr.save_async(step, state)
    finally:
        pf.close()
        if mgr is not None:
            mgr.wait()
    dt = time.perf_counter() - t0
    return {
        "steps": len(losses),
        "first_loss": losses[0] if losses else float("nan"),
        "last_loss": losses[-1] if losses else float("nan"),
        "losses": losses,
        "grad_norms": norms,
        "wall_s": dt,
        "restored_from": start,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    # under torchrun: the mesh over its ranks
    mesh = (make_host_mesh(device=args.device)
            if "RANK" in os.environ and "WORLD_SIZE" in os.environ else None)
    out = train_lm(args.arch, args.steps, args.smoke, args.ckpt_dir,
                   batch=args.batch, seq=args.seq, device=args.device, mesh=mesh)
    if mesh is None or dist.get_rank() == 0:
        print("[train] done:", out)
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
