"""RecSys-family bundle (MIND x 4 shapes; torch port of
``repro.configs.recsys_family``).

Shapes:
  train_batch    — sampled-softmax training, batch 65536
  serve_p99      — online inference, batch 512, 100 candidates each
  serve_bulk     — offline scoring, batch 262144, 100 candidates each
  retrieval_cand — 1 user x 1,048,576 candidates (1M padded to 2^20),
                   batched-dot retrieval scoring

The parameter tree is ``MIND.named_parameters()``; each step binds a model
to it (``MIND(cfg, params=...)``), on the mesh in use
(``parallel.use_mesh``) with the arguments placed by ``shardings`` (the
JAX layouts: the tables row-split over "model", the users over the data
axes, the retrieval corpus over every axis), else on their device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import base
from repro_torch.engine.streaming import resolve_device
from repro_torch.models import recsys as R
from repro_torch.models.parallel import P, mesh_parallel
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import make_train_step as _opt_step

OPT = AdamW(lr=cosine_schedule(1e-3, 500, 50_000), weight_decay=0.0)

N_CANDIDATES_ONLINE = 100
N_CANDIDATES_RETRIEVAL = 1_048_576   # 1M padded to 2^20

SHAPES = {
    "train_batch": base.ShapeCell("train_batch", "train", {"batch": 65536}),
    "serve_p99": base.ShapeCell("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": base.ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": base.ShapeCell(
        "retrieval_cand", "retrieval",
        {"batch": 1, "n_candidates": N_CANDIDATES_RETRIEVAL}),
}


def make_train_step(cfg: R.MINDConfig, par=None):
    """The train step, on one device or (``par``) this rank of a mesh."""
    return _opt_step(lambda p, b: R.loss_fn(R.MIND(cfg, params=p, par=par), b), OPT,
                     report=None if par is None else par.sum_data)


def _batch_leaves(cfg: R.MINDConfig, cell) -> dict:
    """The batch of a cell as (shape, dtype, id bound) leaves."""
    B = cell.meta["batch"]
    leaves = {
        "hist": ((B, cfg.hist_len), torch.int32, cfg.n_items),
        "hist_mask": ((B, cfg.hist_len), torch.bool, None),
        "user_feats": ((B, cfg.user_feat_len), torch.int32, cfg.n_user_feats),
    }
    if cell.kind == "train":
        leaves["target"] = ((B,), torch.int32, cfg.n_items)
    elif cell.kind == "serve":
        leaves["candidates"] = ((B, N_CANDIDATES_ONLINE), torch.int32, cfg.n_items)
    else:
        leaves["candidate_ids"] = ((cell.meta["n_candidates"],), torch.int32, cfg.n_items)
    return leaves


def abstract_args(bundle, shape_id: str, multi_pod: bool = False):
    cfg: R.MINDConfig = bundle.config
    cell = bundle.cells[shape_id]
    params = R.init_abstract(cfg)
    batch = {k: base.meta(shape, dt) for k, (shape, dt, _) in _batch_leaves(cfg, cell).items()}
    if cell.kind == "train":
        return (params, OPT.init(params), batch)
    return (params, batch)


def real_args(bundle, shape_id: str, device=None, seed: int = 0):
    """:func:`abstract_args`' leaves on ``device``: seeded parameters (the
    tables drawn in place), zero moments, ids inside their tables, 80% of
    the history slots valid."""
    dev = resolve_device(device)
    cfg: R.MINDConfig = bundle.config
    cell = bundle.cells[shape_id]
    g = torch.Generator(device=dev).manual_seed(seed)
    params = dict(R.MIND(cfg, device=dev, generator=g).named_parameters())
    batch = {}
    for k, (shape, dt, bound) in _batch_leaves(cfg, cell).items():
        batch[k] = (torch.rand(shape, generator=g, device=dev) < 0.8 if bound is None else
                    torch.randint(0, bound, shape, generator=g, device=dev, dtype=dt))
    if cell.kind == "train":
        return (params, OPT.init(params), batch)
    return (params, batch)


def shardings(bundle, shape_id: str, multi_pod: bool = False):
    """``(in_specs, out_specs)`` of the cell on the production mesh (the
    JAX ``shardings``), keyed as the port's arguments and results."""
    cfg: R.MINDConfig = bundle.config
    cell = bundle.cells[shape_id]
    dp = base.dp_axes(multi_pod)
    dpn = base.dp_size(multi_pod)
    pspecs = R.param_specs(cfg, base.TP_AXIS)
    B = cell.meta["batch"]
    bs = dp if B % dpn == 0 else None
    user = {"hist": P(bs, None), "hist_mask": P(bs, None), "user_feats": P(bs, None)}
    if cell.kind == "train":
        ospecs = OPT.state_specs(pspecs)
        return ((pspecs, ospecs, {**user, "target": P(bs)}),
                (pspecs, ospecs, {"loss": P(), "grad_norm": P()}))
    if cell.kind == "serve":
        return (pspecs, {**user, "candidates": P(bs, None)}), P(bs, None)
    cand = dp + (base.TP_AXIS,)
    return (pspecs, {**user, "candidate_ids": P(cand)}), P(None, cand)


def step_fn(bundle, shape_id: str, multi_pod: bool = False):
    cfg: R.MINDConfig = bundle.config
    cell = bundle.cells[shape_id]
    if cell.kind == "train":
        return lambda params, opt_state, batch: make_train_step(
            cfg, mesh_parallel(batch["hist"]))(params, opt_state, batch)
    if cell.kind == "serve":
        return lambda params, batch: R.MIND(
            cfg, params=params, par=mesh_parallel(batch["hist"])).serve_score(batch)
    return lambda params, batch: R.MIND(
        cfg, params=params, par=mesh_parallel(batch["hist"])).retrieval_score(batch)


def smoke_batch(bundle, rng: np.random.Generator, device=None):
    cfg = bundle.smoke_config
    B = 8
    return base.host_tensors({
        "hist": rng.integers(0, cfg.n_items, (B, cfg.hist_len)).astype(np.int32),
        "hist_mask": rng.random((B, cfg.hist_len)) < 0.8,
        "user_feats": rng.integers(0, cfg.n_user_feats,
                                   (B, cfg.user_feat_len)).astype(np.int32),
        "target": rng.integers(0, cfg.n_items, (B,)).astype(np.int32),
        "candidates": rng.integers(0, cfg.n_items, (B, 16)).astype(np.int32),
    }, resolve_device(device))


def smoke_step(bundle):
    """``run(batch)`` on the batch's device: parameters drawn on the CPU from
    seed 0, one train step, then the serve scores."""
    cfg = bundle.smoke_config

    def run(batch):
        dev = batch["hist"].device
        params = base.to_device(dict(R.MIND(cfg, device="cpu").named_parameters()), dev)
        opt_state = OPT.init(params)
        train_batch = {k: batch[k] for k in ("hist", "hist_mask", "user_feats", "target")}
        params, opt_state, metrics = make_train_step(cfg)(params, opt_state, train_batch)
        serve_batch = {k: batch[k] for k in ("hist", "hist_mask", "user_feats", "candidates")}
        scores = R.MIND(cfg, params=params).serve_score(serve_batch)
        return {"loss": metrics["loss"], "scores": scores}

    return run


def make_bundle(arch_id: str, config: R.MINDConfig,
                smoke_config: R.MINDConfig) -> base.ArchBundle:
    config.validate()
    smoke_config.validate()
    return base.ArchBundle(
        arch_id=arch_id, family="recsys", config=config,
        smoke_config=smoke_config, cells=dict(SHAPES), skip_shapes={},
        _abstract_args=abstract_args, _shardings=shardings, _real_args=real_args,
        _step_fn=step_fn, _smoke_batch=smoke_batch, _smoke_step=smoke_step,
    )
