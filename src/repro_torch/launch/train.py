"""The train loop with checkpoint / restart and a failure
drill (torch port of ``repro.launch.train``).

Runs a registered LM architecture on one device:

  * the train step: the loss, its gradients by autograd, one AdamW step
    (:func:`make_train_step`);
  * deterministic per-step synthetic data (restart-exact), prefetched on a
    host thread;
  * asynchronous checkpoints every ``ckpt_every`` steps and restore on
    start;
  * ``fail_at``: a simulated failure after that step's update, for the
    restore-and-continue drill.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --steps 20 \\
      --device cpu   # the SMOKE config (default), on the CPU
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import LM_CONFIGS
from repro_torch.data import Prefetcher, lm_batch_fn, shard_batch
from repro_torch.distsys import CheckpointManager
from repro_torch.engine.streaming import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import make_train_step


def train_lm(arch: str, steps: int = 20, smoke: bool = True,
             ckpt_dir: str | None = None, ckpt_every: int = 10,
             batch: int = 8, seq: int = 32, log_every: int = 5,
             fail_at: int | None = None, device=None) -> dict:
    """Train an LM config (``smoke``: its SMOKE config) for ``steps`` steps
    on ``device`` (default CUDA; raises without a card unless "cpu").
    Returns the metrics and ``losses``, each step's loss in order."""
    dev = resolve_device(device)
    mod = LM_CONFIGS[arch]
    cfg = mod.SMOKE if smoke else mod.FULL
    opt = AdamW(lr=cosine_schedule(3e-4, 10, max(steps, 100)))
    model = T.Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    step_fn = make_train_step(lambda p, b: T.loss_fn(model, b["tokens"], b["labels"]), opt)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None:
        restored, at = mgr.restore_latest((params, opt_state))
        if restored is not None:
            with torch.no_grad():
                for name, value in restored[0].items():
                    params[name].copy_(value)
            opt_state = restored[1]
            start = at + 1
            print(f"[train] restored checkpoint step {at}")

    pf = Prefetcher(lm_batch_fn(cfg.vocab, batch, seq), start_step=start)
    losses = []
    t0 = time.perf_counter()
    try:
        for step, host_batch in pf:
            if step >= steps:
                break
            _, opt_state, metrics = step_fn(params, opt_state, shard_batch(host_batch, dev))
            if fail_at is not None and step == fail_at:
                raise RuntimeError("injected failure")
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if mgr is not None and (step + 1) % ckpt_every == 0:
                mgr.save_async(step, (params, opt_state))
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
    out = train_lm(args.arch, args.steps, args.smoke, args.ckpt_dir,
                   batch=args.batch, seq=args.seq, device=args.device)
    print("[train] done:", out)


if __name__ == "__main__":
    main()
