"""GNN-family bundle implementation (4 archs x 4 shapes; torch port of
``repro.configs.gnn_family``).

Shapes (input-feature dim / labels follow the public dataset each shape
names; padded as the JAX package pads them):
  full_graph_sm — cora-size full-batch: N=2708, E=10556, F=1433, 7 classes
  minibatch_lg  — reddit-size sampled training: 1024 seeds, fanout 15-10,
                  F=602, 41 classes (neighbor-sampler blocks)
  ogb_products  — full-batch large: N=2449029, E=61859140, F=100, 47 cls
                  (padded to multiples of 512)
  molecule      — 128 graphs x 30 nodes x 64 edges, regression

Geometric archs (egnn/schnet) receive synthetic 3-D positions on
non-molecular graphs, as in the JAX package.  ``ogb_products`` turns
``remat`` on and sets ``agg_axes`` (the sharded
aggregation, on the mesh in use; dense on one device:
``repro_torch.models.gnn.make_agg``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import base
from repro_torch.engine.streaming import resolve_device
from repro_torch.models import gnn as G
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import make_train_step as _opt_step

OPT = AdamW(lr=cosine_schedule(1e-3, 100, 10_000), weight_decay=0.0)

SHAPES = {
    "full_graph_sm": base.ShapeCell(
        "full_graph_sm", "train",
        {"n": 2708, "e": 10556, "f": 1433, "classes": 7, "pad": 1}),
    "minibatch_lg": base.ShapeCell(
        "minibatch_lg", "train",
        {"batch": 1024, "fanouts": (15, 10), "f": 602, "classes": 41,
         "n_table": 232965}),
    "ogb_products": base.ShapeCell(
        "ogb_products", "train",
        {"n": 2449029, "e": 61859140, "f": 100, "classes": 47, "pad": 512}),
    "molecule": base.ShapeCell(
        "molecule", "train",
        {"batch": 128, "n": 30, "e": 64, "f": 32, "classes": 1}),
}


def cfg_for_cell(bundle, shape_id: str) -> G.GNNConfig:
    cell = SHAPES[shape_id]
    kw = dict(d_in=cell.meta["f"], n_classes=cell.meta["classes"],
              remat=shape_id == "ogb_products")
    if shape_id == "ogb_products":
        # the sharded aggregation over the edge axes (GNNConfig.agg_axes)
        kw.update(agg_axes=("data", "model"))
    return dataclasses.replace(bundle.config, **kw)


def _needs_pos(arch: str) -> bool:
    return arch in ("egnn", "schnet")


def make_train_step(cfg: G.GNNConfig):
    return _opt_step(lambda p, b: G.loss_fn(p, b, cfg), OPT)


def _graph_leaves(arch: str, N: int, E: int, F: int, lead: tuple = ()) -> dict:
    """(shape, dtype, id bound) of a graph batch's leaves; ``lead`` is the
    molecule cell's graph axis (its edges index nodes within a graph, so
    the bound of the ids is ``N`` either way)."""
    leaves = {
        "x": ((*lead, N, F), torch.float32, None),
        "senders": ((*lead, E), torch.int32, N),
        "receivers": ((*lead, E), torch.int32, N),
    }
    if _needs_pos(arch):
        leaves["pos"] = ((*lead, N, 3), torch.float32, None)
    if arch == "graphcast":
        leaves["edge_feat"] = ((*lead, E, 4), torch.float32, None)
    return leaves


def _batch_leaves(cfg: G.GNNConfig, shape_id: str) -> dict:
    """The batch of a cell as (shape, dtype, bound) leaves: ints below
    ``bound``, floats normal, bools random (a list for the sampler's hops)."""
    m = SHAPES[shape_id].meta
    arch = cfg.arch
    if shape_id in ("full_graph_sm", "ogb_products"):
        pad = m.get("pad", 1)
        N = base.pad_up(m["n"], pad)
        leaves = _graph_leaves(arch, N, base.pad_up(m["e"], pad), m["f"])
        leaves["labels"] = ((N,), torch.int32, m["classes"])
        return leaves
    if shape_id == "minibatch_lg":
        B = m["batch"]
        f1, f2 = m["fanouts"]
        if arch == "graphsage":
            return {
                "seed_x": ((B, m["f"]), torch.float32, None),
                "layer_x": [((B, f1, m["f"]), torch.float32, None),
                            ((B, f1 * f2, m["f"]), torch.float32, None)],
                "layer_mask": [((B, f1), torch.bool, None),
                               ((B, f1 * f2), torch.bool, None)],
                "labels": ((B,), torch.int32, m["classes"]),
            }
        # non-sampling archs run the flat (gathered) graph form: blocks
        # flattened to a node set + block-local edges
        N = B * (1 + f1 + f1 * f2)
        leaves = _graph_leaves(arch, N, B * (f1 + f1 * f2), m["f"])
        leaves["labels"] = ((N,), torch.int32, m["classes"])
        return leaves
    B = m["batch"]  # molecule
    leaves = _graph_leaves(arch, m["n"], m["e"], m["f"], lead=(B,))
    leaves["labels"] = ((B,), torch.float32, None)
    return leaves


def _build(leaves, make):
    if isinstance(leaves, dict):
        return {k: _build(v, make) for k, v in leaves.items()}
    if isinstance(leaves, list):
        return [_build(v, make) for v in leaves]
    return make(*leaves)


def abstract_args(bundle, shape_id: str):
    cfg = cfg_for_cell(bundle, shape_id)
    params = G.init_abstract(cfg)
    batch = _build(_batch_leaves(cfg, shape_id), lambda shape, dt, _: base.meta(shape, dt))
    return (params, OPT.init(params), batch)


def real_args(bundle, shape_id: str, device=None, seed: int = 0):
    """:func:`abstract_args`' leaves on ``device``: seeded parameters, zero
    moments, node and class ids inside their bounds, normal features."""
    dev = resolve_device(device)
    cfg = cfg_for_cell(bundle, shape_id)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = G.init(cfg, generator=g, device=dev)

    def make(shape, dt, bound):
        if bound is not None:
            return torch.randint(0, bound, shape, generator=g, device=dev, dtype=dt)
        if dt == torch.bool:
            return torch.rand(shape, generator=g, device=dev) < 0.8
        return torch.randn(shape, generator=g, device=dev, dtype=dt)

    return (params, OPT.init(params), _build(_batch_leaves(cfg, shape_id), make))


def step_fn(bundle, shape_id: str):
    return make_train_step(cfg_for_cell(bundle, shape_id))


def smoke_batch(bundle, rng: np.random.Generator, device=None):
    cfg = bundle.smoke_config
    N, E, F = 24, 60, cfg.d_in
    batch = {
        "x": rng.normal(size=(N, F)).astype(np.float32),
        "senders": rng.integers(0, N, E).astype(np.int32),
        "receivers": rng.integers(0, N, E).astype(np.int32),
        "labels": rng.integers(0, cfg.n_classes, N).astype(np.int32),
    }
    if _needs_pos(cfg.arch):
        batch["pos"] = rng.normal(size=(N, 3)).astype(np.float32)
    if cfg.arch == "graphcast":
        batch["edge_feat"] = rng.normal(size=(E, 4)).astype(np.float32)
    return base.host_tensors(batch, resolve_device(device))


def smoke_step(bundle):
    """``run(batch)`` on the batch's device: parameters drawn on the CPU from
    seed 0, one train step, then the forward's logits."""
    cfg = bundle.smoke_config

    def run(batch):
        dev = batch["x"].device
        params = base.to_device(
            G.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu"), dev)
        opt_state = OPT.init(params)
        params, opt_state, metrics = make_train_step(cfg)(params, opt_state, batch)
        with torch.no_grad():
            logits = G.forward(params, batch, cfg)
        return {"loss": metrics["loss"], "logits": logits}

    return run


def make_bundle(arch_id: str, config: G.GNNConfig,
                smoke_config: G.GNNConfig) -> base.ArchBundle:
    config.validate()
    smoke_config.validate()
    return base.ArchBundle(
        arch_id=arch_id, family="gnn", config=config,
        smoke_config=smoke_config, cells=dict(SHAPES), skip_shapes={},
        _abstract_args=abstract_args, _real_args=real_args,
        _step_fn=step_fn, _smoke_batch=smoke_batch, _smoke_step=smoke_step,
    )
